"""The control of a solve cell's check: the plain reference put in the
program's place, computed one precision below what the configuration
states (``acobench.reference.aco.PRECISIONS["lower"]``), judged by the same
comparison as a run's sampled requests. The check has to find it not
correct. ``--precision stated`` judges the reference at the stated
precisions instead, which the check has to pass.

    python -m acobench.control --workload <cell> --seeds <n> [<n> ...] [--precision lower|stated]

Runs at the cell's own size on the card (the tests run a smaller copy of
the cell on the CPU) and prints one JSON line a seed:
each number, its limit, and whether every number held. A run of the
benchmark does not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def judge_control(spec: dict, seed: int, precision: str, device: str) -> dict:
    """The control of the cell's kind at ``seed``; the numbers beside the
    limits."""
    if spec["workload"]["kind"] == "train":
        return judge_train_control(spec, seed, precision, device)
    return judge_solve_control(spec, seed, precision, device)


def judge_train_control(spec: dict, seed: int, precision: str, device: str) -> dict:
    """The cell's first three training steps taken by the reference one
    precision lower (from the configuration's weights, its own tours on
    instances drawn as the cell draws them from ``seed``) and judged as a
    run judges the program's."""
    import torch

    from acobench import traffic
    from acobench.reference import msgpack, train
    from acobench.spec import root

    cfg, tr = spec["config"], spec["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = msgpack.load(str(root() / cfg["checkpoint"]))
    ref_cfg = {"k_sparse": cfg["k_sparse"], "n_nodes": cfg["n_nodes"],
               "local_search": cfg["local_search"],
               "aco": {**cfg["aco"], "n_ants": tr["n_ants"]}, "train": tr}
    if precision != "lower":
        raise ValueError("a training cell's control runs one precision lower only")
    t0 = time.perf_counter()
    run = train.control_steps(tree, ref_cfg, 3, traffic.request_seed(seed, 0, stream=5),
                              device)
    solve_s = time.perf_counter() - t0
    failed, numbers = train.judge(run["captures"], run["losses"], run["first_moment"],
                                  run["after"], tree, ref_cfg, device)
    limits = spec["workload"]["check"]["limits"]
    held = failed == 0 and all(numbers.get(k, 1e30) <= v for k, v in limits.items())
    return {"workload": spec["name"], "seed": seed, "precision": precision,
            "failed": failed, "numbers": numbers, "limits": limits, "correct": bool(held),
            "solve_s": solve_s, "check_s": time.perf_counter() - t0 - solve_s}


def judge_solve_control(spec: dict, seed: int, precision: str, device: str) -> dict:
    """One request of the cell, drawn as request 0 of ``seed``, solved by the
    reference at ``precision`` and judged; the numbers beside the limits."""
    import numpy as np
    import torch

    from acobench import traffic
    from acobench.reference import aco, check, msgpack
    from acobench.spec import root

    cfg, tr = spec["config"], spec["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = msgpack.load(str(root() / cfg["checkpoint"]))
    coords_np = traffic.instance_pool(seed, 1, tr["batch"], cfg["n_nodes"])[0]
    coords = torch.as_tensor(coords_np, device=device)
    rseed = traffic.request_seed(seed, 0)
    t0 = time.perf_counter()
    cap = aco.run_search(tree, coords, cfg, tr["iterations"], rseed, precision)
    solve_s = time.perf_counter() - t0
    cap["sweeps"] = [p.to(torch.int16) for p in cap["sweeps"]]
    cap["ls"] = [p.to(torch.int16) for p in cap["ls"]]
    wrong, gap = check.validate(coords_np, cap["best"].cpu().numpy(),
                                cap["curve"][:, -1].cpu().numpy().astype(np.float64))
    numbers = {"cost_gap": gap, **check.judge(cap, coords, tree, cfg, rseed)}
    limits = spec["workload"]["check"]["limits"]
    held = wrong == 0 and all(numbers.get(k, check.SENTINEL) <= v for k, v in limits.items())
    return {"workload": spec["name"], "seed": seed, "precision": precision,
            "wrong_instances": wrong, "numbers": numbers, "limits": limits,
            "correct": bool(held), "solve_s": solve_s,
            "check_s": time.perf_counter() - t0 - solve_s}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m acobench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--precision", choices=("lower", "stated"), default="lower")
    args = parser.parse_args(argv)
    from acobench.spec import cell_spec

    spec = cell_spec(args.workload)
    for seed in args.seeds:
        print(json.dumps(judge_control(spec, seed, args.precision, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
