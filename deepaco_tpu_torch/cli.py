"""Command line of the port: ``python -m deepaco_tpu_torch test tsp --sparse ...``
(counterpart of ``deepaco_tpu/cli.py``).

The parser keeps the JAX package's ``test`` subcommand with the flags the
large-N sparse TSP protocol reads. Only that protocol is ported so far;
every other command, problem or flag exits naming ROADMAP.md §1 item 10.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from deepaco_tpu_torch.aco.large_tsp import (KERNEL_OPS, LargeOps,
                                             classic_knn_heuristic, knn_support,
                                             run_anytime_knn)
from deepaco_tpu_torch.aco.runner import ACOConfig
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

PROBLEMS = ["tsp", "cvrp", "op", "pctsp", "smtwtp", "mkp", "mkp_items", "bpp",
            "sop", "rcpsp"]
NOT_PORTED = "is not ported to deepaco_tpu_torch yet (ROADMAP.md §1 item 10)"
SPARSE_SEED, SPARSE_INSTANCES = 123456, 30      # cli.py:289-291


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deepaco_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    for name in ("train", "solve-cvrp"):
        sub.add_parser(name, help=f"{name} {NOT_PORTED}").add_argument(
            "rest", nargs=argparse.REMAINDER)

    te = sub.add_parser("test", help="anytime evaluation")
    te.add_argument("problem", choices=PROBLEMS)
    te.add_argument("-n", "--nodes", type=int, default=100)
    te.add_argument("-k", "--k-sparse", type=int, default=None)
    te.add_argument("-a", "--ants", type=int, default=20)
    te.add_argument("-t", "--t-aco", type=int, nargs="+",
                    default=[1, 10, 20, 30, 40, 50, 100])
    te.add_argument("-c", "--ckpt", default=None,
                    help=".msgpack checkpoint (default checkpoints/tsp<n>.msgpack)")
    te.add_argument("--classic", action="store_true",
                    help="classic-ACO baseline (no model)")
    te.add_argument("--limit", type=int, default=None,
                    help="evaluate only the first N instances")
    te.add_argument("--seed", type=int, default=0)
    te.add_argument("--local-search", choices=["2opt", "nls", "swapstar"],
                    default=None, help="with --sparse: 2opt on every tour")
    te.add_argument("--sparse", action="store_true",
                    help="TSP only: the large-N O(N*K) path (aco/large_tsp) on "
                         "fixed-seed uniform instances for n > 1000")
    te.add_argument("--b-chunk", type=int, default=None, help=NOT_PORTED)
    te.add_argument("--per-instance", action="store_true", help=NOT_PORTED)
    te.add_argument("--backfill", action="store_true", help=NOT_PORTED)
    return p


def _load_net(args) -> Net:
    """The ``--ckpt`` weights, or ``checkpoints/tsp<n>.msgpack`` without it.
    A decode error surfaces in the exit message, with its cause chained."""
    path = args.ckpt
    if path is None:
        path = f"checkpoints/{args.problem}{args.nodes}.msgpack"
        if not os.path.exists(path):
            raise SystemExit(f"no checkpoint for {args.problem}{args.nodes}: pass "
                             f"--ckpt, --classic, or train one (looked at {[path]})")
    if path.endswith(".pt"):
        raise SystemExit(f"{path}: reference .pt checkpoints wait for the .pt loader "
                         "(ROADMAP.md §1 item 2); pass a .msgpack")
    try:
        variables = load_checkpoint(path)
    except ValueError as err:
        raise SystemExit(f"cannot decode checkpoint {path}: {err}") from err
    return Net.from_jax_variables(variables)


def _cmd_test_tsp_sparse(args, *, device=None, stats: dict | None = None,
                         _ops: LargeOps = KERNEL_OPS):
    """The large-N sparse-state TSP protocol (cli.py:270-339), batched over
    instances: k-NN support, heuristic (neural over the support, or classic
    ``1/d``), then ``run_anytime_knn``. Instances are the JAX CLI's
    fixed-seed uniform ones for n > 1000; for n <= 1000 it reads the
    reference's golden TSP sets, which this repository does not hold, so it
    exits. Prints the JAX CLI's three output lines and returns ``(means,
    curves)``. ``stats``, when given, also receives the run's fallback and
    off-support counts and each instance's best tour."""
    n = args.nodes
    if n <= 1000:
        raise SystemExit(f"test tsp --sparse at n={n} <= 1000 reads the reference's "
                         "golden TSP sets (golden.tsp_test -> load_tsp_dataset), which "
                         "this repository does not hold; use n > 1000")
    dev = resolve_device(device)
    k = args.k_sparse or max(n // 10, 3)
    coords_all = np.random.default_rng(SPARSE_SEED).random(
        (args.limit or SPARSE_INSTANCES, n, 2)).astype(np.float32)
    net = None if args.classic else _load_net(args).to(dev).eval()
    cfg = ACOConfig(n_ants=args.ants)
    t_values = args.t_aco
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    coords = torch.as_tensor(coords_all, device=dev)
    with _ops.timer("heuristic"):
        nbr = knn_support(coords, k)
        heu = (classic_knn_heuristic(coords, nbr) if net is None
               else _ops.heuristic(net, coords, nbr))
    curves, best = run_anytime_knn(coords, nbr, heu, cfg, max(t_values),
                                   args.local_search, generator, device=dev,
                                   stats=stats, _ops=_ops)
    means = curves[:, [t - 1 for t in t_values]].mean(dim=0).cpu().numpy()
    duration = time.time() - t0
    if stats is not None:
        stats.update(best=best, coords=coords)
    print(f"total duration: {duration:.2f}s")
    for t, v in zip(t_values, means):
        print(f"T={t}, average cost is {v:.6f}.")
    print(json.dumps({"problem": "tsp_sparse", "n": n,
                      "instances": int(coords_all.shape[0]),
                      "t_aco": t_values, "means": means.tolist(),
                      "duration_s": duration}))
    return means, curves


def cmd_test(args, *, device=None):
    unported = [f for f in ("b_chunk", "per_instance", "backfill") if getattr(args, f)]
    if unported:
        raise SystemExit(f"--{unported[0].replace('_', '-')} {NOT_PORTED}")
    if args.problem != "tsp" or not args.sparse:
        raise SystemExit(f"test {args.problem}{' --sparse' if args.sparse else ''} "
                         f"{NOT_PORTED}; only test tsp --sparse is")
    return _cmd_test_tsp_sparse(args, device=device)


def main(argv=None, *, device=None):
    """Parse ``argv`` and run the command on ``device`` (the card unless the
    caller passes ``"cpu"``). Returns what the command returns."""
    args = build_parser().parse_args(argv)
    if args.command != "test":
        raise SystemExit(f"{args.command} {NOT_PORTED}")
    return cmd_test(args, device=device)
