"""Command line of the port: ``python -m deepaco_tpu_torch {train,test} <problem> ...``
(counterpart of ``deepaco_tpu/cli.py``).

The parser keeps the JAX package's ``train``, ``test`` and ``solve-cvrp``
subcommands and their flags. Ported so far: ``train
tsp|cvrp|op|pctsp|smtwtp|sop|bpp|mkp|mkp_items`` through the family trainer
(``train.drivers.train_family``), ``train tsp --local-search 2opt|nls``
through ``train.reinforce.train_tsp``, ``train cvrp --local-search
swapstar`` through ``train.special.train_cvrp_nls``, ``test
cvrp|op|pctsp|smtwtp|sop|bpp|mkp|mkp_items`` on the golden sets through
``train.drivers.evaluate_family``, ``test cvrp --local-search swapstar``
(the CVRP-NLS protocol with the native SWAP* engine), ``test tsp --sparse``
(the large-N sparse TSP protocol) and ``solve-cvrp`` (the engine's hybrid
genetic search on a CVRPLib file). Every other command, problem or flag
exits naming its ROADMAP.md item.
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
from deepaco_tpu_torch.aco.problems.cvrp import validate_routes
from deepaco_tpu_torch.aco.problems.cvrp_nls import CVRPNLSACO
from deepaco_tpu_torch.aco.runner import ACOConfig
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.families import FAMILIES, get_family
from deepaco_tpu_torch.ls.hgs import solve_cvrp
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.train import drivers
from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig
from deepaco_tpu_torch.train.drivers import evaluate_family, family_model, train_family
from deepaco_tpu_torch.train.reinforce import nls_local_search, train_tsp
from deepaco_tpu_torch.train.special import cvrp_nls_heuristic, train_cvrp_nls
from deepaco_tpu_torch.utils import golden
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from deepaco_tpu_torch.utils.convert import parse_cvrplib

PROBLEMS = ["tsp", "cvrp", "op", "pctsp", "smtwtp", "mkp", "mkp_items", "bpp",
            "sop", "rcpsp"]
NOT_PORTED = "is not ported to deepaco_tpu_torch yet (ROADMAP.md §1 item 10)"
SPARSE_SEED, SPARSE_INSTANCES = 123456, 30      # cli.py:289-291
CVRP_NLS_K = 5                                  # the customer k-NN width (cvrp_nls/utils.py:35)
CVRP_NLS_EPS = 1e-10                            # the test heuristic's offset (cli.py:403)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deepaco_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    tr = sub.add_parser("train", help="REINFORCE-train a neural heuristic")
    tr.add_argument("problem", choices=PROBLEMS)
    tr.add_argument("-n", "--nodes", type=int, default=100)
    tr.add_argument("-k", "--k-sparse", type=int, default=None)
    tr.add_argument("-a", "--ants", type=int, default=20)
    tr.add_argument("-e", "--epochs", type=int, default=5)
    tr.add_argument("-s", "--steps", type=int, default=128)
    tr.add_argument("-b", "--batch-size", type=int, default=1)
    tr.add_argument("--lr", type=float, default=3e-4)
    tr.add_argument("--weight-decay", type=float, default=None,
                    help="AdamW weight decay; default: the family's reference value "
                         "(0 for mkp, mkp/train.py:78; torch's 1e-2 elsewhere)")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("-o", "--output", default=None, help="checkpoint path (.msgpack)")
    tr.add_argument("--val-instances", type=int, default=0,
                    help="per-epoch validation on a held-out batch of this size, "
                         "with best/last checkpoints (tsp_nls/train.py:99-122)")
    tr.add_argument("--val-t", type=int, default=10,
                    help="ACO iterations of the validation sweep")
    tr.add_argument("--local-search", choices=["2opt", "nls", "swapstar"], default=None,
                    help="tsp: NLS-shaped advantage with 2-opt or NLS on every ant "
                         "(tsp_nls/train.py); cvrp: the LS-only advantage with the native "
                         "SWAP* engine (cvrp_nls/train.py)")

    te = sub.add_parser("test", help="anytime evaluation")
    te.add_argument("problem", choices=PROBLEMS)
    te.add_argument("-n", "--nodes", type=int, default=100)
    te.add_argument("-k", "--k-sparse", type=int, default=None)
    te.add_argument("-a", "--ants", type=int, default=20)
    te.add_argument("-t", "--t-aco", type=int, nargs="+",
                    default=[1, 10, 20, 30, 40, 50, 100])
    te.add_argument("-c", "--ckpt", default=None,
                    help=".msgpack checkpoint (default checkpoints/<problem><n>.msgpack)")
    te.add_argument("--classic", action="store_true",
                    help="classic-ACO baseline (no model)")
    te.add_argument("--limit", type=int, default=None,
                    help="evaluate only the first N instances")
    te.add_argument("--seed", type=int, default=0)
    te.add_argument("--local-search", choices=["2opt", "nls", "swapstar"],
                    default=None, help="tsp with --sparse: 2opt on every tour; cvrp: "
                    "swapstar, the native SWAP* top-k refine (cvrp_nls/test.py:80-96)")
    te.add_argument("--sparse", action="store_true",
                    help="TSP only: the large-N O(N*K) path (aco/large_tsp) on "
                         "fixed-seed uniform instances for n > 1000")
    te.add_argument("--b-chunk", type=int, default=None, help=NOT_PORTED)
    te.add_argument("--per-instance", action="store_true", help=NOT_PORTED)
    te.add_argument("--backfill", action="store_true", help=NOT_PORTED)

    sv = sub.add_parser("solve-cvrp", help="the native engine's hybrid genetic search on a "
                        "CVRPLib .vrp file (the reference's HGS binary)")
    sv.add_argument("instance", help="CVRPLib .vrp file")
    sv.add_argument("--max-iters", type=int, default=5000)
    sv.add_argument("--no-improve", type=int, default=1000)
    sv.add_argument("--time-limit", type=float, default=0.0, help="seconds; 0 disables")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--round", action="store_true",
                    help="round distances to integers (CVRPLib convention)")
    return p


def _load_net(args) -> Net:
    """The ``--ckpt`` weights, or ``checkpoints/<problem><n>.msgpack`` without
    it, in the family's ``Net`` (SMTWTP's and SOP's without the node
    update). A decode error surfaces in the exit message, with its cause
    chained."""
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
    return family_model(get_family(args.problem), variables)


def _report(t_values, means: np.ndarray, duration: float, record: dict) -> None:
    """The JAX CLI's three output lines: the duration, the mean cost at each
    T, and one JSON record ending in ``duration_s``."""
    print(f"total duration: {duration:.2f}s")
    for t, v in zip(t_values, means):
        print(f"T={t}, average cost is {v:.6f}.")
    print(json.dumps({**record, "t_aco": t_values, "means": means.tolist(),
                      "duration_s": duration}))


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
    _report(t_values, means, duration, {"problem": "tsp_sparse", "n": n,
                                        "instances": int(coords_all.shape[0])})
    return means, curves


def _cmd_test_family(args, *, device=None):
    """A family's anytime protocol (cli.py:505-549): the golden set of scale
    ``n`` (``utils.golden``, the first ``--limit`` instances), the ``--ckpt``
    net or the classic heuristic, then ``evaluate_family``. Prints the JAX
    CLI's three output lines (for OP, BPP and MKP the mean objective, which
    they maximize) and returns ``(means, curves)``. BPP's and MKP's writers
    take any ``n``; the others make their golden scales only."""
    problem, n = args.problem, args.nodes
    scales = golden.SCALES.get(problem)
    if scales is not None and n not in scales:
        raise SystemExit(f"test {problem} -n {n}: the golden {problem.upper()} writer makes "
                         f"the scales {scales} only")
    dev = resolve_device(device)
    ds = golden.GOLDEN[problem](n)
    if args.limit:
        ds = {k: v[:args.limit] for k, v in ds.items()}
    net = None if args.classic else _load_net(args)
    t0 = time.time()
    means, curves = evaluate_family(problem, ds, n_nodes=n, net=net, k_sparse=args.k_sparse,
                                    n_ants=args.ants, t_values=tuple(args.t_aco),
                                    seed=args.seed, device=dev)
    means = means.cpu().numpy()
    _report(args.t_aco, means, time.time() - t0, {"problem": problem, "n": n})
    return means, curves


def cvrp_nls_checkpoint(n: int) -> str:
    """The committed ``checkpoints/cvrp_nls{n}_selftrained.msgpack``, else
    the 500's, else the 100's, as the JAX CLI falls back (cli.py:363-370)."""
    cands = [f"checkpoints/cvrp_nls{m}_selftrained.msgpack" for m in (n, 500, 100)]
    for path in cands:
        if os.path.exists(path):
            return path
    raise SystemExit(f"no cvrp_nls checkpoint found (looked at {cands}); pass --ckpt")


def _cmd_test_cvrp_ls(args, *, device=None, stats: dict | None = None,
                      _ops: drivers.FamilyOps = drivers.KERNEL_OPS):
    """The CVRP-NLS anytime protocol (cli.py:342-438, cvrp_nls/test.py:80-96):
    the golden ``cvrp_nls`` set of ``n`` customers (the first ``--limit``),
    the ``--ckpt`` net (default :func:`cvrp_nls_checkpoint`) on the two-block
    graph, batched over the instances (eval mode, offset 1e-10), then per
    instance a :class:`CVRPNLSACO` with seed ``--seed + i`` that refines its
    8 cheapest ants an iteration; every final solution is route-validated.
    Prints a line an instance and the JAX CLI's three lines, and returns
    ``(means, curves [B, len(T)])``. ``stats``, when given, also receives
    each instance's best path ``best [B, L]``. ``_ops`` (``FamilyOps``)
    swaps in the plain versions or a timer around each phase
    (``"heuristic"`` and those of ``CVRPNLSACO.run``)."""
    if args.classic:
        raise SystemExit("test cvrp --local-search swapstar runs a checkpoint (cli.py:342-438); "
                         "--classic does not apply")
    n, ts = args.nodes, args.t_aco
    dev = resolve_device(device)
    try:
        # each instance's draws follow the last one's, so the first --limit
        # instances are the full set's
        ds = golden.cvrp_nls_test(n, count=min(args.limit or 100, 100))
    except ValueError as err:
        raise SystemExit(f"test cvrp -n {n} --local-search swapstar: {err}") from err
    b = ds["coords"].shape[0]
    path = args.ckpt or cvrp_nls_checkpoint(n)
    if path.endswith(".pt"):
        raise SystemExit(f"{path}: reference .pt checkpoints wait for the .pt loader "
                         "(ROADMAP.md §1 item 2); pass a .msgpack")
    try:
        net = Net.from_jax_variables(load_checkpoint(path)).to(dev)
    except ValueError as err:
        raise SystemExit(f"cannot decode checkpoint {path}: {err}") from err
    dist_all = torch.as_tensor(ds["dist"][:b], device=dev)
    demand_all = torch.as_tensor(ds["demand"][:b], device=dev)
    curves, best = [], []
    t0 = time.time()
    with _ops.timer("heuristic"), torch.no_grad():
        heu_all = cvrp_nls_heuristic(net.eval(), demand_all, dist_all,
                                     args.k_sparse or CVRP_NLS_K, CVRP_NLS_EPS)
    for i in range(b):
        ti = time.time()
        aco = CVRPNLSACO(dist_all[i], demand_all[i], capacity=1.0, n_ants=args.ants,
                         heuristic=heu_all[i], seed=args.seed + i, device=dev, ops=_ops)
        curve, done = [], 0
        for t in ts:
            aco.run(t - done)
            done = t
            curve.append(aco.best_cost)
        if not bool(validate_routes(aco.best_path[:, None], demand_all[i], 1.0)[0]):
            raise RuntimeError(f"instance {i}: invalid best solution")
        curves.append(torch.stack(curve))
        best.append(aco.best_path)
        print(f"inst {i}: {time.time() - ti:.1f}s", flush=True)
    curves = torch.stack(curves)
    means = curves.mean(dim=0).cpu().numpy()
    if stats is not None:
        stats.update(best=torch.stack(best))
    _report(ts, means, time.time() - t0, {"problem": "cvrp_nls", "n": n, "instances": b})
    return means, curves


def cmd_test(args, *, device=None):
    unported = [f for f in ("b_chunk", "per_instance", "backfill") if getattr(args, f)]
    if unported:
        raise SystemExit(f"--{unported[0].replace('_', '-')} {NOT_PORTED}")
    if args.problem == "tsp" and args.sparse:
        return _cmd_test_tsp_sparse(args, device=device)
    if args.problem == "cvrp" and args.local_search and not args.sparse:
        if args.local_search != "swapstar":
            raise SystemExit(f"test cvrp --local-search {args.local_search}: cvrp's local "
                             "search is the native SWAP* engine (swapstar)")
        return _cmd_test_cvrp_ls(args, device=device)
    if args.problem in FAMILIES and args.problem != "tsp" and not args.sparse:
        if args.local_search:
            raise SystemExit(f"test {args.problem} --local-search: local search applies "
                             "to tsp and cvrp")
        return _cmd_test_family(args, device=device)
    tested = [p for p in FAMILIES if p != "tsp"]
    raise SystemExit(f"test {args.problem}{' --sparse' if args.sparse else ''} "
                     f"{NOT_PORTED}; only test {'|'.join(tested)}, test cvrp --local-search "
                     "swapstar and test tsp --sparse are")


def _epoch_printer(val_t: int | None = None):
    """``progress(epoch, mean cost[, val])`` printing the JAX CLI's line an
    epoch, ``epoch {ep}: mean cost {c}[, val best@T={val_t} {val}] ({s}s)``."""
    t0 = time.time()

    def prog(ep, cost, val=None):
        extra = "" if val is None else f", val best@T={val_t} {val:.4f}"
        print(f"epoch {ep}: mean cost {cost:.4f}{extra} ({time.time() - t0:.1f}s)",
              flush=True)
    return prog


def _cmd_train_tsp_ls(args, *, device=None):
    """TSP training with the NLS-shaped advantage (cli.py:144-168,
    tsp_nls/train.py): the one-hot start ``Net``, ``train_tsp`` with NLS
    (``--local-search nls``) or 2-opt (NLS without perturbation) on every
    ant; writes ``-o`` or ``checkpoints/tsp_nls<n>.msgpack``."""
    cfg = ProblemConfig(
        name="tsp_nls", n_nodes=args.nodes,
        k_sparse=args.k_sparse or max(args.nodes // 10, 3),
        aco=ACOSettings(n_ants=args.ants),
        train=TrainConfig(lr=args.lr, epochs=args.epochs, steps_per_epoch=args.steps,
                          batch_size=args.batch_size, seed=args.seed))
    ls = nls_local_search() if args.local_search == "nls" else nls_local_search(t_nls=0)
    prog, per_epoch = _epoch_printer(), args.steps

    def each_step(i, info):
        if (i + 1) % per_epoch == 0:
            prog(i // per_epoch, info.mean_cost.item())

    state = train_tsp(Net(feats=1), cfg, local_search=ls, progress=each_step,
                      device=device)
    out = args.output or f"checkpoints/tsp_nls{args.nodes}.msgpack"
    save_checkpoint(out, state)
    print(f"saved {out}")
    return state


def _cmd_train_cvrp_ls(args, *, device=None):
    """CVRP training with the LS-only advantage of the native SWAP* engine
    (cli.py:169-180, cvrp_nls/train.py): ``train_cvrp_nls`` with the
    flags' scale, epochs, steps, rate, ants, k (default 5) and seed; writes
    ``-o`` or ``checkpoints/cvrp_nls<n>.msgpack``, the JAX ``TrainState``
    that ``test cvrp --local-search swapstar --ckpt`` reads."""
    _, state = train_cvrp_nls(args.nodes, epochs=args.epochs, steps_per_epoch=args.steps,
                              lr=args.lr, n_ants=args.ants,
                              k_sparse=args.k_sparse or CVRP_NLS_K, seed=args.seed,
                              progress=_epoch_printer(), device=device)
    out = args.output or f"checkpoints/cvrp_nls{args.nodes}.msgpack"
    save_checkpoint(out, state)
    print(f"saved {out}")
    return state


def cmd_solve_cvrp(args, *, device=None):
    """Solve one CVRPLib instance with the native engine's hybrid genetic
    search (cli.py:647-670) and print the solution as the reference binary
    exports it (``Route #i: ...``, ``Cost ...``), then ``Time ...``. The
    search is host code; like every entry point it refuses to start without
    a card unless the caller passes a device. Returns ``(routes, cost)``."""
    resolve_device(device)
    with open(args.instance) as f:
        inst = parse_cvrplib(f.read())
    coords = inst["coords"]
    dist = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    if args.round:
        dist = np.round(dist)
    t0 = time.time()
    routes, cost = solve_cvrp(inst["demands"], dist, capacity=inst["capacity"],
                              max_iters=args.max_iters, no_improve_limit=args.no_improve,
                              time_limit_s=args.time_limit, seed=args.seed)
    duration = time.time() - t0
    for i, r in enumerate(routes):
        print(f"Route #{i + 1}: " + " ".join(str(int(c)) for c in r))
    print(f"Cost {cost:.2f}")
    print(f"Time {duration:.2f}")
    return routes, cost


def cmd_train(args, *, device=None):
    """``train <problem>`` (cli.py:106-141): the family trainer with the
    JAX CLI's configuration, a checkpoint at ``-o`` or
    ``checkpoints/<problem><n>.msgpack`` (and ``-best`` / ``-last`` beside
    it with ``--val-instances``)."""
    if args.local_search == "swapstar":
        if args.problem != "cvrp":
            raise SystemExit(f"train {args.problem} --local-search swapstar: the native "
                             "SWAP* engine applies to cvrp")
        return _cmd_train_cvrp_ls(args, device=device)
    if args.local_search:
        if args.problem != "tsp":
            raise SystemExit(f"train {args.problem} --local-search {args.local_search}: "
                             "2-opt and NLS training apply to tsp")
        return _cmd_train_tsp_ls(args, device=device)
    if args.problem not in FAMILIES:
        raise SystemExit(f"train {args.problem} {NOT_PORTED}")
    wd = args.weight_decay
    if wd is None:
        # the reference's one per-family optimizer setting: the GNN MKP
        # trainer sets weight_decay=0 (mkp/train.py:78), every other one
        # keeps torch's AdamW default
        wd = 0.0 if args.problem == "mkp" else 1e-2
    cfg = ProblemConfig(
        name=args.problem, n_nodes=args.nodes,
        k_sparse=args.k_sparse or max(args.nodes // 10, 3),
        aco=ACOSettings(n_ants=args.ants),
        train=TrainConfig(lr=args.lr, weight_decay=wd, epochs=args.epochs,
                          steps_per_epoch=args.steps, batch_size=args.batch_size,
                          seed=args.seed))
    out = args.output or f"checkpoints/{args.problem}{args.nodes}.msgpack"
    state = train_family(args.problem, cfg, progress=_epoch_printer(args.val_t),
                         val_instances=args.val_instances, val_t=args.val_t,
                         ckpt_path=out if args.val_instances else None, device=device)
    save_checkpoint(out, state)
    print(f"saved {out}")
    return state


def main(argv=None, *, device=None):
    """Parse ``argv`` and run the command on ``device`` (the card unless the
    caller passes ``"cpu"``). Returns what the command returns."""
    args = build_parser().parse_args(argv)
    if args.command == "train":
        return cmd_train(args, device=device)
    if args.command == "test":
        return cmd_test(args, device=device)
    return cmd_solve_cvrp(args, device=device)
