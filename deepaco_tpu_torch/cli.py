"""Command line of the port: ``python -m deepaco_tpu_torch {train,test} <problem> ...``
(counterpart of ``deepaco_tpu/cli.py``).

The parser keeps the JAX package's ``train``, ``test`` and ``solve-cvrp``
subcommands and their flags, all ported: ``train
tsp|cvrp|op|pctsp|smtwtp|sop|bpp|mkp|mkp_items`` through the family trainer
(``train.drivers.train_family``), ``train tsp --local-search 2opt|nls``
through ``train.reinforce.train_tsp``, ``train cvrp --local-search
swapstar`` through ``train.special.train_cvrp_nls``, ``train rcpsp``
through ``train.special.train_rcpsp``; ``test
tsp|cvrp|op|pctsp|smtwtp|sop|bpp|mkp|mkp_items`` on the golden sets through
``train.drivers.evaluate_family``, ``test tsp --local-search 2opt|nls``
(batched through ``eval.anytime.evaluate_tsp``, or ``--per-instance``
through the ``aco.runner.ACO`` facade), ``test cvrp --local-search
swapstar`` (the CVRP-NLS protocol with the native SWAP* engine), ``test tsp
--sparse`` (the large-N sparse TSP protocol), ``test rcpsp`` (with
``--backfill``) on a PSPLIB archive, and ``solve-cvrp`` (the engine's
hybrid genetic search on a CVRPLib file). ``--b-chunk`` (a TPU watchdog
workaround) exits.

``--ckpt`` takes a msgpack train state or a reference ``.pt`` state dict
(``models.torch_compat.load_reference_checkpoint``), and each command loads
it into the net the JAX command builds, which ignores what else the file
holds. Without ``--ckpt`` a command takes the reference's pretrained file
first, as the JAX CLI does (cli.py:440-454), when ``$DEEPACO_REFERENCE_ROOT``
is set and ``pretrained/<layout>`` exists under it, else the committed
msgpack it names.

The reference's data are read only from where the JAX CLI's variables
point, and only when they are set: the PSPLIB archive from
``$DEEPACO_REFERENCE_ROOT/data/rcpsp/psplib.tar.gz`` (cli.py:185-198) and
the golden TSP files from ``$DEEPACO_REFERENCE_DATA/tsp/`` (datasets.py:18-38).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from deepaco_tpu_torch.aco.large_tsp import (KERNEL_OPS, LargeOps,
                                             classic_knn_heuristic, knn_support,
                                             run_anytime_knn)
from deepaco_tpu_torch.aco.problems.cvrp import validate_routes
from deepaco_tpu_torch.aco.problems.cvrp_nls import CVRPNLSACO
from deepaco_tpu_torch.aco.runner import ACO, ACOConfig
from deepaco_tpu_torch.core.builders import start_node_features
from deepaco_tpu_torch.core.rcpsp import load_psplib
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.eval.anytime import dense_heuristic, evaluate_tsp
from deepaco_tpu_torch.eval.rcpsp import evaluate_rcpsp, rcpsp_net
from deepaco_tpu_torch.families import get_family
from deepaco_tpu_torch.ls.hgs import solve_cvrp
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.models.torch_compat import load_reference_checkpoint
from deepaco_tpu_torch.train import drivers
from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig
from deepaco_tpu_torch.train.drivers import evaluate_family, family_model, train_family
from deepaco_tpu_torch.train.reinforce import nls_local_search, train_tsp
from deepaco_tpu_torch.train.special import cvrp_nls_heuristic, train_cvrp_nls, train_rcpsp
from deepaco_tpu_torch.utils import golden
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from deepaco_tpu_torch.utils.convert import parse_cvrplib
from deepaco_tpu_torch.utils.datasets import reference_path

PROBLEMS = ["tsp", "cvrp", "op", "pctsp", "smtwtp", "mkp", "mkp_items", "bpp",
            "sop", "rcpsp"]
B_CHUNK = ("a TPU watchdog workaround of the JAX CLI; the port runs the whole instance set "
           "as one batch")
SPARSE_SEED, SPARSE_INSTANCES = 123456, 30      # cli.py:289-291
CVRP_NLS_K = 5                                  # the customer k-NN width (cvrp_nls/utils.py:35)
CVRP_NLS_EPS = 1e-10                            # the test heuristic's offset (cli.py:403)
# the reference's pretrained files that do not follow <problem>/<problem><n>.pt
# (cli.py:443-445)
REFERENCE_LAYOUT = {"mkp_items": "mkp_transformer/mkp{n}.pt", "rcpsp": "rcpsp/rcpsp{n}-5.pt"}


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
                    help=".msgpack or reference .pt checkpoint (default: the reference's "
                         "pretrained .pt under $DEEPACO_REFERENCE_ROOT, else "
                         "checkpoints/<problem><n>.msgpack)")
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
    te.add_argument("--b-chunk", type=int, default=None, help=B_CHUNK + "; exits")
    te.add_argument("--per-instance", action="store_true",
                    help="tsp with --local-search: the reference-style ACO facade, one "
                         "instance at a time, instead of the whole batch")
    te.add_argument("--backfill", action="store_true",
                    help="rcpsp: decode with the gap-filling SSGS variant instead of the "
                         "reference's append-only decoder")

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


def golden_set(problem: str, n: int, limit: int | None) -> dict:
    """The first ``limit`` instances of ``problem``'s golden set of scale
    ``n``; a missing reference file (TSP's) exits naming it or its
    variable."""
    try:
        ds = golden.GOLDEN[problem](n)
    except FileNotFoundError as err:
        raise SystemExit(f"test {problem} -n {n}: {err}") from err
    return {k: v[:limit] for k, v in ds.items()} if limit else ds


def psplib_instances(args, split: str):
    """The ``j<n>rcp`` instances of the PSPLIB archive under
    ``$DEEPACO_REFERENCE_ROOT`` (cli.py:185-198): the test split's first
    ``--limit``, or the train split; exits naming the variable when it is
    unset, or the archive when it is missing."""
    try:
        archive = reference_path("DEEPACO_REFERENCE_ROOT", "data", "rcpsp", "psplib.tar.gz")
    except FileNotFoundError as err:
        raise SystemExit(str(err)) from err
    insts = load_psplib(archive, f"j{args.nodes}rcp", split=split,
                        limit=getattr(args, "limit", None) if split == "test" else None)
    if not insts:
        raise SystemExit(f"{archive} holds no j{args.nodes}rcp {split} instance")
    return insts


def default_checkpoint(what: str, reference: list[str], committed: list[str]) -> str:
    """The first checkpoint that exists: each of the reference's
    ``pretrained/`` files ``reference`` under ``$DEEPACO_REFERENCE_ROOT``
    (looked at only when the variable is set), then each of the
    ``committed`` msgpack files, the JAX CLI's order (cli.py:296-302,
    363-370, 440-454, 566-571). Exits naming what it looked at when none
    does."""
    root = os.environ.get("DEEPACO_REFERENCE_ROOT")
    cands = [os.path.join(root, "pretrained", r) for r in reference] if root else []
    cands += committed
    for path in cands:
        if os.path.exists(path):
            return path
    raise SystemExit(f"no checkpoint for {what}: pass --ckpt or train one (looked at {cands})")


def read_variables(path: str) -> dict:
    """The Flax tree of a checkpoint: a reference ``.pt`` state dict, or a
    msgpack train state. A file that cannot be read or decoded exits naming
    it and the error, with its cause chained."""
    try:
        if path.endswith(".pt"):
            return load_reference_checkpoint(path)
        return load_checkpoint(path)
    except (OSError, ValueError, RuntimeError, pickle.UnpicklingError) as err:
        raise SystemExit(f"cannot read checkpoint {path}: {err}") from err


def _load_net(args, reference: list[str] | None = None) -> torch.nn.Module:
    """The ``--ckpt`` weights, or without it :func:`default_checkpoint` of
    ``reference`` (by default the problem's reference layout) and
    ``checkpoints/<problem><n>.msgpack``, in the family's ``Net`` (SMTWTP's
    and SOP's without the node update; RCPSP's single-head, with its node
    features padded to 5)."""
    problem, n = args.problem, args.nodes
    layout = REFERENCE_LAYOUT.get(problem, "{p}/{p}{n}.pt").format(p=problem, n=n)
    path = args.ckpt or default_checkpoint(f"{problem}{n}", reference or [layout],
                                           [f"checkpoints/{problem}{n}.msgpack"])
    variables = read_variables(path)
    if problem == "rcpsp":
        return rcpsp_net(variables)
    return family_model(get_family(problem), variables)


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
    fixed-seed uniform ones for n > 1000 and the reference's golden TSP set
    for n <= 1000 (``$DEEPACO_REFERENCE_DATA``; without it the command
    exits). Prints the JAX CLI's three output lines and returns ``(means,
    curves)``. ``stats``, when given, also receives the run's fallback and
    off-support counts and each instance's best tour."""
    n = args.nodes
    dev = resolve_device(device)
    if n <= 1000:
        coords_all = golden_set("tsp", n, args.limit)["coords"]
    else:
        coords_all = np.random.default_rng(SPARSE_SEED).random(
            (args.limit or SPARSE_INSTANCES, n, 2)).astype(np.float32)
    k = args.k_sparse or max(n // 10, 3)
    # the largest reference TSP file first (cli.py:296-302); the dual-head
    # TSP Net (cli.py:307)
    net = None if args.classic else _load_net(
        args, [f"tsp/tsp{m}.pt" for m in (n, 500, 100)]).to(dev).eval()
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


def _cmd_test_family(args, *, device=None, stats: dict | None = None):
    """A family's anytime protocol (cli.py:505-549): the golden set of scale
    ``n`` (``utils.golden``, the first ``--limit`` instances; TSP's the
    reference's files under ``$DEEPACO_REFERENCE_DATA``), the ``--ckpt``
    net or the classic heuristic, then ``evaluate_family``. Prints the JAX
    CLI's three output lines (for OP, BPP and MKP the mean objective, which
    they maximize) and returns ``(means, curves)``; ``stats``, when given,
    also receives each instance's best solution (``best``). BPP's and
    MKP's writers take any ``n``; the others make their golden scales
    only."""
    problem, n = args.problem, args.nodes
    scales = golden.SCALES.get(problem)
    if scales is not None and n not in scales:
        raise SystemExit(f"test {problem} -n {n}: the golden {problem.upper()} writer makes "
                         f"the scales {scales} only")
    dev = resolve_device(device)
    ds = golden_set(problem, n, args.limit)
    net = None if args.classic else _load_net(args)
    t0 = time.time()
    means, curves, state = evaluate_family(problem, ds, n_nodes=n, net=net,
                                           k_sparse=args.k_sparse, n_ants=args.ants,
                                           t_values=tuple(args.t_aco), seed=args.seed,
                                           device=dev, return_state=True)
    means = means.cpu().numpy()
    if stats is not None:
        stats.update(best=state.best_path)
    _report(args.t_aco, means, time.time() - t0, {"problem": problem, "n": n})
    return means, curves


def cvrp_nls_checkpoint(n: int) -> str:
    """The reference's ``pretrained/cvrp_nls/cvrp{n,500,100}.pt`` under
    ``$DEEPACO_REFERENCE_ROOT`` (cli.py:363-370), else the committed
    ``checkpoints/cvrp_nls{n,500,100}_selftrained.msgpack``: the first that
    exists."""
    return default_checkpoint("cvrp_nls", [f"cvrp_nls/cvrp{m}.pt" for m in (n, 500, 100)],
                              [f"checkpoints/cvrp_nls{m}_selftrained.msgpack"
                               for m in (n, 500, 100)])


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
    # the single-head Net (cli.py:394)
    net = Net.from_jax_variables(read_variables(path), dual_heads=False).to(dev)
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


def _cmd_test_rcpsp(args, *, device=None, stats: dict | None = None,
                    _ops: drivers.FamilyOps = drivers.KERNEL_OPS):
    """The RCPSP anytime protocol (cli.py:201-268, rcpsp/test.ipynb cells
    0-5): the first ``--limit`` of the 100 test instances of ``j<n>rcp``,
    elitist MAX-MIN with ``--ants`` ants, the ``--ckpt`` net or the classic
    prior, the reference's decoder or ``--backfill``'s. Prints the JAX
    CLI's three lines and returns ``(means, curves)``; ``stats``, when
    given, also receives the batched instances and each best activity list
    (``data``, ``best``)."""
    dev = resolve_device(device)
    insts = psplib_instances(args, "test")
    net = None if args.classic else _load_net(args)
    t0 = time.time()
    means, curves, data, state = evaluate_rcpsp(
        insts, net, n_ants=args.ants, t_values=tuple(args.t_aco), seed=args.seed,
        backfill=args.backfill, device=dev, return_state=True, _ops=_ops)
    means = means.cpu().numpy()
    if stats is not None:
        stats.update(data=data, best=state.best_path)
    _report(args.t_aco, means, time.time() - t0,
            {"problem": "rcpsp", "n": args.nodes, "instances": len(insts),
             "backfill": bool(args.backfill)})
    return means, curves


def _cmd_test_tsp_ls(args, *, device=None, stats: dict | None = None):
    """The TSP-NLS protocol (cli.py:552-646, tsp_nls/test.py:17-56) on the
    golden TSP set: local search (``2opt`` or ``nls``) on every ant, the
    ``--ckpt`` net on the one-hot start graph (default
    ``checkpoints/tsp_nls<n>.msgpack``) or the classic ``1/d`` on the k
    nearest. The whole batch through ``evaluate_tsp(ls=...)``, or with
    ``--per-instance`` the reference-style :class:`~deepaco_tpu_torch.aco.
    runner.ACO` facade an instance at a time, seeds ``--seed + i``. Prints
    the JAX CLI's three lines and returns ``(means, curves)``; ``stats``,
    when given, also receives each instance's best tour (``best [B, n]``)."""
    n, ts = args.nodes, args.t_aco
    dev = resolve_device(device)
    ds = golden_set("tsp", n, args.limit)
    k = args.k_sparse or max(n // 10, 3)
    net = None
    if not args.classic:
        # the reference's tsp_nls weights first (cli.py:566-571); the
        # single-head Net on the one-hot start graph (cli.py:575)
        path = args.ckpt or default_checkpoint(
            f"tsp_nls{n}", [f"tsp_nls/tsp{n}.pt", f"tsp_nls/tsp_nls{n}.pt"],
            [f"checkpoints/tsp_nls{n}.msgpack"])
        net = Net.from_jax_variables(read_variables(path), dual_heads=False).to(dev).eval()
    coords_all = torch.as_tensor(ds["coords"], device=dev)
    t0 = time.time()
    if not args.per_instance:
        found = {}
        _, curves = evaluate_tsp(coords_all, net=net, k_sparse=k,
                                 cfg=ACOConfig(n_ants=args.ants), t_values=tuple(ts),
                                 seed=args.seed, ls=args.local_search, device=dev, stats=found)
        best = found["best"]
        curves = curves[:, [t - 1 for t in ts]]
    else:
        dist_all = torch.as_tensor(ds["dist"], device=dev)
        heu_all = None
        if net is not None:
            heu_all = dense_heuristic(net, start_node_features(coords_all), coords_all,
                                      dist_all, k)
        curves, best = [], []
        for i in range(coords_all.shape[0]):
            aco = ACO(dist_all[i], n_ants=args.ants,
                      heuristic=None if heu_all is None else heu_all[i],
                      local_search=args.local_search, seed=args.seed + i,
                      coords=coords_all[i], device=dev)
            if heu_all is None:
                aco.sparsify(k)
            curve, done = [], 0
            for t in ts:
                aco.run(t - done)
                done = t
                curve.append(aco.lowest_cost)
            curves.append(torch.stack(curve))
            best.append(aco.shortest_path)
        curves, best = torch.stack(curves), torch.stack(best)
    means = curves.mean(dim=0).cpu().numpy()
    if stats is not None:
        stats.update(best=best)
    _report(ts, means, time.time() - t0, {"problem": "tsp_" + args.local_search, "n": n})
    return means, curves


def cmd_test(args, *, device=None):
    if args.b_chunk:
        raise SystemExit(f"--b-chunk is {B_CHUNK}")
    if args.sparse and args.problem != "tsp":
        raise SystemExit("--sparse applies to tsp")
    if args.per_instance and not (args.problem == "tsp" and args.local_search):
        raise SystemExit("--per-instance applies to test tsp with --local-search")
    if args.problem == "rcpsp":
        return _cmd_test_rcpsp(args, device=device)
    if args.problem == "tsp" and args.sparse:
        return _cmd_test_tsp_sparse(args, device=device)
    if args.local_search == "swapstar":
        if args.problem != "cvrp":
            raise SystemExit(f"test {args.problem} --local-search swapstar: the native "
                             "SWAP* engine applies to cvrp")
        return _cmd_test_cvrp_ls(args, device=device)
    if args.local_search:
        if args.problem != "tsp":
            raise SystemExit(f"test {args.problem} --local-search {args.local_search}: "
                             "2-opt and NLS apply to tsp")
        return _cmd_test_tsp_ls(args, device=device)
    return _cmd_test_family(args, device=device)


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


def _cmd_train_rcpsp(args, *, device=None):
    """RCPSP training (cli.py:183-198, rcpsp/train.ipynb): the train split
    of ``j<n>rcp`` on one horizon, ``train_rcpsp`` with the flags' epochs,
    steps, ants, rate and seed, a line an epoch; writes ``-o`` or
    ``checkpoints/rcpsp<n>.msgpack``, which ``test rcpsp --ckpt`` reads."""
    device = resolve_device(device)
    insts = psplib_instances(args, "train")
    t0 = time.time()
    _, state = train_rcpsp(
        insts, epochs=args.epochs, steps_per_epoch=args.steps, n_ants=args.ants, lr=args.lr,
        seed=args.seed, device=device,
        progress=lambda ep, c: print(f"epoch {ep}: mean makespan {c:.2f} "
                                     f"({time.time() - t0:.1f}s)", flush=True))
    out = args.output or f"checkpoints/rcpsp{args.nodes}.msgpack"
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
    if args.problem == "rcpsp":
        return _cmd_train_rcpsp(args, device=device)
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
