#!/usr/bin/env python3
"""The spread of a family path's costs between seeds on the card, through the
one-launch rollout (K7r's untraced forward, one noise draw an iteration) and
through the per-step route (K7 a step, a noise draw a step), beside the JAX
package's recorded costs.

    python3 scripts/route_seed_spread.py [--families op pctsp smtwtp sop mkp] [--seeds 10]
        [--out FILE]

For each family it runs ``chip_smoke.py``'s phase-14 path (the golden set at
the family's ``FAMILY_PATHS`` scale, its checkpoint, 20 ants, T=1 and 10)
with ``evaluate_family`` for seeds 0..``--seeds``-1 on both routes: the
family as it is, and the family with its plug-in's ``fused`` field stripped.
It prints one JSON line a family: each route's per-seed cost@T1 and
cost@T10, their averages, standard errors and ranges, how many seeds lie
within ``chip_smoke.JAX_COST_SPAN`` of ``chip_smoke.JAX_COSTS`` at both T,
and each route's wall a run. The two routes draw different numbers from the
same law, so they agree in law only: the gap between the averages is read
against the standard errors. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--families", nargs="+",
                        default=["op", "pctsp", "smtwtp", "sop", "mkp"])
    parser.add_argument("--seeds", type=int, default=10)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("route_seed_spread: needs a CUDA device")
    import chip_smoke as cs
    from deepaco_tpu_torch import families
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.train import drivers

    dev = torch.device("cuda")
    lines = []
    for name in args.families:
        fam = families.FAMILIES[name]
        net, ds = cs.family_inputs(ROOT, dev, name)
        n = cs.FAMILY_PATHS[name][0]
        stripped = lambda *a, spec=fam.spec: spec(*a)._replace(fused=None)
        per_step = fam._replace(spec=stripped, construct=lambda tau, heu, inst, a, gen, ops,
                                spec=stripped: rollout(spec(tau, heu, inst, a), gen,
                                                       pick=ops.pick).paths)
        out = {"family": name, "N": n, "A": cs.A, "T": list(cs.T_VALUES), "seeds": args.seeds,
               "jax_costs": cs.JAX_COSTS.get(name), "span": cs.JAX_COST_SPAN}
        for route, family in (("k7r", fam), ("per_step", per_step)):
            families.FAMILIES[name] = family
            costs, walls = [], []
            try:
                for seed in range(args.seeds):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    means, _ = drivers.evaluate_family(name, ds, n_nodes=n, net=net,
                                                       n_ants=cs.A, t_values=cs.T_VALUES,
                                                       seed=seed, device=dev)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    costs.append([float(v) for v in means])
            finally:
                families.FAMILIES[name] = fam
            cols = list(zip(*costs))
            jax = cs.JAX_COSTS.get(name)
            near = (sum(all(abs(c - j) <= cs.JAX_COST_SPAN * abs(j) for c, j in zip(row, jax))
                        for row in costs) if jax else None)
            out[route] = {"per_seed": costs,
                          "mean": [statistics.fmean(c) for c in cols],
                          "stderr": [statistics.stdev(c) / len(c) ** 0.5 for c in cols],
                          "range": [[min(c), max(c)] for c in cols],
                          "seeds_near_jax": near, "wall_s_median": statistics.median(walls)}
        print(json.dumps(out), flush=True)
        lines.append(out)
    if args.out:
        args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
