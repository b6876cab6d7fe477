#!/usr/bin/env python3
"""How far the port's ``evaluate_family`` lies from the JAX package's in law,
next to the spread of each between seeds, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/family_law_spread.py [--families op pctsp smtwtp]
        [--arms neural classic] [--seeds 10] [--instances 100] [--ants 10]

For each family and arm it runs both packages' ``evaluate_family`` on the
first ``--instances`` golden instances of the family's smallest scale (OP100,
PCTSP20, SMTWTP50; the neural arm with that scale's committed checkpoint) at
T=1 and 4 for seeds 0..``--seeds``-1, the same seed on each side, and prints
one JSON line: the per-seed means of each package, their averages over the
seeds, the standard error of each average, and each package's range over the
seeds. The sampling streams of the two packages differ, so they agree in law
only: the gap between the averages is read against the standard errors, and
a single seed's gap against each package's own range. Both packages run here,
so this script imports JAX; the port itself never does.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--families", nargs="+", default=["op", "pctsp", "smtwtp"])
    parser.add_argument("--arms", nargs="+", default=["neural", "classic"])
    parser.add_argument("--seeds", type=int, default=10)
    parser.add_argument("--instances", type=int, default=100)
    parser.add_argument("--ants", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from deepaco_tpu.train import drivers as jdrivers
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.utils import golden
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

    t_values = (1, 4)
    for name in args.families:
        n = golden.SCALES[name][0]
        ds = {k: v[:args.instances] for k, v in golden.GOLDEN[name](n).items()}
        for arm in args.arms:
            variables = net = None
            if arm == "neural":
                tree = load_checkpoint(str(ROOT / f"checkpoints/{name}{n}_selftrained.msgpack"))
                variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
                net = drivers.family_model(get_family(name), variables)
            runs = {"jax": [], "port": []}
            for seed in range(args.seeds):
                ref, _ = jdrivers.evaluate_family(name, ds, n_nodes=n, variables=variables,
                                                  n_ants=args.ants, t_values=t_values,
                                                  seed=seed)
                got, _ = drivers.evaluate_family(name, ds, n_nodes=n, net=net,
                                                 n_ants=args.ants, t_values=t_values,
                                                 seed=seed, device="cpu")
                runs["jax"].append(np.asarray(ref, np.float64))
                runs["port"].append(got.numpy().astype(np.float64))
            out = {"family": name, "n": n, "arm": arm, "instances": args.instances,
                   "ants": args.ants, "t": list(t_values), "seeds": args.seeds}
            for side, vals in runs.items():
                vals = np.stack(vals)
                out[side] = {"per_seed": vals.tolist(), "mean": vals.mean(0).tolist(),
                             "sem": (vals.std(0, ddof=1) / np.sqrt(len(vals))).tolist(),
                             "min": vals.min(0).tolist(), "max": vals.max(0).tolist()}
            out["gap_rel"] = [(p - j) / j for p, j in zip(out["port"]["mean"], out["jax"]["mean"])]
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
