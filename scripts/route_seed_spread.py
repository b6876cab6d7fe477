#!/usr/bin/env python3
"""The spread of a path's costs between seeds on the card, through the
one-launch rollout (K7r's untraced forward, one noise draw an iteration) and
through the per-step route (K7 a step, a noise draw a step), beside the JAX
package's recorded costs.

    python3 scripts/route_seed_spread.py [--families op pctsp smtwtp sop mkp mkp_items rcpsp]
        [--seeds 10] [--out FILE]

For each family it runs ``chip_smoke.py``'s phase-14 or phase-16 path (the
golden set at the family's ``FAMILY_PATHS`` scale, its checkpoint, 20 ants,
T=1 and 10) with ``evaluate_family`` for seeds 0..``--seeds``-1 on both
routes: the family as it is, and the family with its plug-in's ``fused``
field stripped. ``rcpsp`` runs phase 17's path instead (``evaluate_rcpsp``
on the seeded j120 archive that ``chip_smoke.write_psplib_archive`` writes
under ``build/``, ``rcpsp120_selftrained``, 20 ants, elitist MAX-MIN), the
per-step route with ``rcpsp_spec``'s ``fused`` stripped. It prints one JSON
line a path: each route's per-seed cost@T1 and cost@T10, their averages,
standard errors and ranges, the gap between the averages in standard errors
of the difference, how many seeds lie within ``chip_smoke.JAX_COST_SPAN`` of
``chip_smoke.JAX_COSTS`` at both T (RCPSP has no JAX anchor on its seeded
instances), and each route's wall a run. The two routes draw different
numbers from the same law, so they agree in law only: the gap is read
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


def spread(run, seeds: int) -> dict:
    """``run(seed) -> costs at T`` for seeds 0..``seeds``-1 on the card: the
    per-seed costs, their averages, standard errors and ranges, and the
    median wall of a run."""
    import torch

    costs, walls = [], []
    for seed in range(seeds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means = run(seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        costs.append([float(v) for v in means])
    cols = list(zip(*costs))
    return {"per_seed": costs, "mean": [statistics.fmean(c) for c in cols],
            "stderr": [statistics.stdev(c) / len(c) ** 0.5 for c in cols],
            "range": [[min(c), max(c)] for c in cols],
            "wall_s_median": statistics.median(walls)}


def gap(one: dict, other: dict) -> list:
    """The gap between two routes' averages at each T, in standard errors of
    the difference."""
    return [(m1 - m2) / (s1 ** 2 + s2 ** 2) ** 0.5 if s1 or s2 else 0.0
            for m1, m2, s1, s2 in zip(one["mean"], other["mean"], one["stderr"], other["stderr"])]


def family_routes(cs, dev, name: str, seeds: int) -> dict:
    """A family path's costs on both routes (``evaluate_family``)."""
    from deepaco_tpu_torch import families
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.train import drivers

    fam = families.FAMILIES[name]
    net, ds = cs.family_inputs(ROOT, dev, name)
    n = cs.FAMILY_PATHS[name][0]
    stripped = lambda *a, spec=fam.spec: spec(*a)._replace(fused=None)
    per_step = fam._replace(spec=stripped, construct=lambda tau, heu, inst, a, gen, ops,
                            spec=stripped: rollout(spec(tau, heu, inst, a), gen,
                                                   pick=ops.pick).paths)
    out = {"family": name, "N": n, "A": cs.A, "T": list(cs.T_VALUES), "seeds": seeds,
           "jax_costs": cs.JAX_COSTS.get(name), "span": cs.JAX_COST_SPAN}
    run = lambda seed: drivers.evaluate_family(name, ds, n_nodes=n, net=net, n_ants=cs.A,
                                               t_values=cs.T_VALUES, seed=seed,
                                               device=dev)[0]
    jax = cs.JAX_COSTS.get(name)
    for route, family in (("k7r", fam), ("per_step", per_step)):
        families.FAMILIES[name] = family
        try:
            out[route] = spread(run, seeds)
        finally:
            families.FAMILIES[name] = fam
        out[route]["seeds_near_jax"] = (
            sum(all(abs(c - j) <= cs.JAX_COST_SPAN * abs(j) for c, j in zip(row, jax))
                for row in out[route]["per_seed"]) if jax else None)
    return out


def rcpsp_routes(cs, dev, seeds: int) -> dict:
    """RCPSP j120's costs on both routes (``evaluate_rcpsp`` on phase 17's
    seeded archive and checkpoint)."""
    import shutil
    import tempfile

    from deepaco_tpu_torch.aco.problems import rcpsp as apr
    from deepaco_tpu_torch.core.rcpsp import load_psplib
    from deepaco_tpu_torch.eval.rcpsp import evaluate_rcpsp, rcpsp_net
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        test = load_psplib(str(cs.write_psplib_archive(tmp)), f"j{cs.RCPSP_N}rcp", device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    net = rcpsp_net(load_checkpoint(str(ROOT / cs.RCPSP_CKPT))).to(dev)
    spec = apr.rcpsp_spec
    out = {"family": "rcpsp", "N": test[0].n, "B": len(test), "A": cs.A,
           "T": list(cs.T_VALUES), "seeds": seeds, "jax_costs": None}
    run = lambda seed: evaluate_rcpsp(test, net, n_ants=cs.A, t_values=cs.T_VALUES, seed=seed,
                                      device=dev)[0]
    for route, fn in (("k7r", spec), ("per_step",
                                       lambda *a: spec(*a)._replace(fused=None))):
        apr.rcpsp_spec = fn
        try:
            out[route] = spread(run, seeds)
        finally:
            apr.rcpsp_spec = spec
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--families", nargs="+",
                        default=["op", "pctsp", "smtwtp", "sop", "mkp", "mkp_items", "rcpsp"])
    parser.add_argument("--seeds", type=int, default=10)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("route_seed_spread: needs a CUDA device")
    import chip_smoke as cs

    dev = torch.device("cuda")
    lines = []
    for name in args.families:
        out = (rcpsp_routes(cs, dev, args.seeds) if name == "rcpsp"
               else family_routes(cs, dev, name, args.seeds))
        out["gap_in_stderr"] = gap(out["k7r"], out["per_step"])
        print(json.dumps(out), flush=True)
        lines.append(out)
    if args.out:
        args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
