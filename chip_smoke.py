#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, one JSON line each:

1. build: the card's name and power limit (``nvidia-smi``), then ``nvcc``
   builds every kernel from ``deepaco_tpu_torch/csrc/``;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B=100 instances, N=500, K=50, A=20): K1 ``allclose`` at
   rtol 1e-4 / atol 1e-5 (the kernel sums in another order) and ``log(heu)``
   on each row's K nearest columns within 1e-4, K2 greedy paths
   exactly equal and stochastic tours that are permutations with a mean cost
   within 2% of the plain sweep's, K3 (the update with the next bf16 score
   on an iteration of the main path) tau' and costs at rtol 1e-6, its best
   state and score bit-equal to what ``track_best`` and ``next_score`` make
   of its own costs and tau';
3. K1 on the NLS configuration, then K4 (2-opt) and K5 (NLS) against their
   plain versions, tours exactly equal and permutations: on the NLS path's
   own inputs (its B=16 instances, N=500, tours that K2 samples from city 0
   on the ``tsp_nls500_selftrained`` heuristic, A=20, budget 10000, t_nls
   10, t_p 20), and at N=1100 on random permutations (A=2, budget 50,
   t_nls 1, t_p 5); K5 with the real asymmetric metric ``heuristic_dist``,
   and timed once more with t_nls 0 (its Euclidean descents alone);
4. the main path: ``evaluate_tsp`` on the neural arm with the
   ``tsp500_selftrained`` weights (T=1 and 10), its phase times and each
   kernel's launches in that run; the classic arm on the same batch; and the
   plain path on the card, whose cost@T10 the kernel path must match to 1%;
5. the NLS path: ``evaluate_tsp(ls="nls")`` with ``tsp_nls500_selftrained``
   on the first B=16 instances (N=500, K=50, A=20, T=1 and 10) through the
   kernels and through the plain versions, whose cost@T10 it must match to
   1%, and the classic arm with ``ls="2opt"``; NLS cost@T1 must lie below
   the main path's cost@T10;
6. the training kernels against their plain versions at the TSP-NLS
   training shapes (B=20, N=500, K=50, U=32, real k-NN neighbours): K6's
   forward (``agg``, ``pre``) and backward (all six input gradients under a
   mixed loss, and the backward entry on the same cotangents), K6's forward
   without ``pre`` (TPU kernel row 8, ``gated_mean_aggregate``), and K7 on
   [600, 500] rows mid-rollout with the same noise (actions exactly equal);
7. one training step in each configuration, kernel arm against plain arm
   from the same weights and instances: the kernel arm samples with
   ``rollout(require_prob=True)`` through K6, K7 (and K5 for NLS), the plain
   arm replays its paths through ``path_log_probs`` with the plain layer;
   loss, every gradient, the running statistics and the updated weights
   must agree;
8. ``train_tsp`` in both configurations at full width, nothing cut: TSP500
   (dual-head Net, 50 ants, batch 1, lr 3e-4, 4 steps) and TSP500-NLS (the
   one-hot start Net, 30 ants, batch 20, lr 6e-4 cosine over 20x20 steps,
   NLS advantage, 2 steps), per step its loss, mean cost, gradient norm,
   wall and phase times; the kernels' counts are set to 0 just before the
   NLS run and read just after. The NLS state is saved with
   ``save_checkpoint``, read back with ``load_checkpoint`` and
   ``Net.from_jax_variables`` and evaluated with ``evaluate_tsp`` (4
   instances, T=1);
9. K8 (``tour_deposit``) against its plain version (``scatter_add_``) at the
   CVRP path's shape (B=100, L=1001, A=20, n=501, routes that K7 samples on
   ``1/d`` and that park on the depot) and at the main path's (K2's tours,
   B=100, N=500, A=20, cyclic): equal bits to ``scatter_add_`` on the CPU,
   equal bits on a second launch, and within the rounding of two sums in
   other orders (2k 2^-24 of an entry of k terms) of ``scatter_add_`` on
   the card; its time (the median of 5 means of 20 launches, timed in
   turns with ``torch.scatter_add``, which is timed the same way) must lie
   below ``torch.scatter_add``'s at both shapes; K7 on that rollout's own [2000, 501] score, depot and
   capacity mask and noise at four of its steps, actions exactly equal;
   K7c (``cvrp_construct``, the whole construction of an iteration) on
   ``1/d`` at the same shape, stochastic and greedy, paths bit-equal to its
   plain version's and valid, with its time and the bound of the steps the
   ants take; K6's forward at the CVRP shape (K = N = 501, the coming CVRP
   training's) against its plain version; K9 (``embnet_layers``, the CVRP
   heuristic's layer stack) on the golden set's dense graph (B=100, K = N
   = 501) against its plain version, the heuristic head's output at rtol
   1e-4 / atol 1e-5, as on the sparse path;
10. the CVRP path: ``evaluate_family("cvrp")`` with ``cvrp500_selftrained``
   on the golden CVRP500 set (100 instances, 500 customers, A=20, T=1 and
   10) in three arms: kernels (K9, K7c, K8), plain versions on the card
   (``embnet_layers_plain``, ``cvrp_construct_plain``, ``deposit_plain``),
   and classic (``1/d``: K7c, K8); per arm the costs, wall, phase times,
   the kernels' launches (K9 once, K6 and K7 never, K7c once an iteration)
   and the peak device memory. Every best route must be valid and cost what
   the run says; the kernel arm's cost@T1 must lie within 1e-4 of the plain
   arm's (the same Philox noise), its cost@T10 within 1% of the plain
   arm's, within 1% of the per-step construction's recorded 60.5116
   (``PER_STEP_CVRP_T10``) and below the classic arm's;
11. K9 (``embnet_layers``) against its plain version on the sparse path's
   own inputs (``tsp500_selftrained``, the CLI's 30 fixed-seed TSP2000
   instances, their k=200 support and neighbour distances, E=1), held on
   both heads' outputs at rtol 1e-4 / atol 1e-5 (sums in another order);
   row 9 (``tsp_sweep_construct``, K2 at B=1 with f32 scores) against
   ``dense_sweep`` on the main path's first instance (N=500, A=20): greedy
   tours exactly equal, stochastic ones permutations;
12. the sparse path: ``cli._cmd_test_tsp_sparse`` (``test tsp --sparse -n
   2000``, k=200, 20 ants, T=1 and 10) in a kernel arm (K9), a plain arm
   (``large_tsp.PLAIN_OPS``, same instances and seed), a classic arm
   (``1/d``) and a classic arm with ``--local-search 2opt`` (K4) on the
   first 4 instances at T=1 and 2; per arm the costs, the CLI's lines, wall,
   phase times, peak device memory, launches and the fallback and
   dropped-deposit rates. Every best tour must be a permutation costing
   what the run reports, and the kernel arm's cost@T1 must lie within 1e-4
   of the plain arm's (the same noise; only K9's rounding parts them);
13. ``{"kernels": [...]}``: per kernel its launches (K1-K3 from the main
   path, K4 from the 2-opt arm, K5 from the NLS arm, K6 and K7 from the
   TSP500-NLS training run, K7c and K8 from the CVRP path's kernel arm, K9
   from the sparse and the CVRP paths' kernel arms together; row 9 is on no
   path of either package, so its count is 0), error, times and bound.

Every path's cost (main cost@T10, NLS, CVRP and sparse cost@T1 and
cost@T10, and both for the plain arms of the main, NLS and sparse paths)
must equal the one recorded in ``RECORDED_COSTS`` to the 4 decimals
recorded: the kernels are exact or held to their plain versions, and the
inputs and seeds are fixed. K1's and K9's ``{"phase": "kernel"}`` lines
also carry ``design_floor_ms``, the time their streamed edge state takes
at the memory rate, computed from the shapes. Then the ``nvidia-smi`` line
again and, last, ``{"ok": true, "device": ...}``.
Any failed check exits non-zero. Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, K, A, B, T_VALUES, SEED = 500, 50, 20, 100, (1, 10), 0
CKPT = "checkpoints/tsp500_selftrained.msgpack"
NLS_CKPT = "checkpoints/tsp_nls500_selftrained.msgpack"
B_NLS, N_LARGE, LS_BUDGET = 16, 1100, 10000
B_TRAIN, A_TRAIN_NLS, A_TRAIN = 20, 30, 50     # the two training envelopes
TRAIN_STEPS = {"tsp500": 4, "tsp500_nls": 2}
CVRP_N, CVRP_CKPT = 500, "checkpoints/cvrp500_selftrained.msgpack"
CVRP_PICK_AT = (0.0, 0.15, 0.4, 0.7)   # K7's CVRP checks, as shares of the horizon
SPARSE_N, SPARSE_B, SPARSE_LS_B = 2000, 30, 4    # the CLI's TSP2000 set; 2-opt arm's cut
SPARSE_T, SPARSE_LS_T = (1, 10), (1, 2)
# each path's cost@T1 and cost@T10 as recorded on an NVIDIA H100 80GB HBM3
# (None: not recorded), through the kernels and, for the main, NLS and sparse
# paths, through the plain versions (no kernel runs there); the inputs and
# seeds are fixed and the kernels exact or held to their plain versions, so
# they reproduce to the digit
RECORDED_COSTS = {"main": (None, 19.6391), "main_plain": (20.6735, 19.6335),
                  "nls": (17.1227, 16.9536), "nls_plain": (17.1133, 16.9749),
                  "cvrp": (61.7577, 60.5177),
                  "sparse": (48.2913, 45.1827), "sparse_plain": (48.2913, 45.1980)}
# the CVRP kernel arm's cost@T10 as recorded through the per-step
# construction (K7 a step, torch.rand noise); the one-pass construction
# samples the same law and is held within 1% of it
PER_STEP_CVRP_T10 = 60.5116
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
# f32 products on the tensor cores as three TF32 products (495 TFLOP/s dense)
TF32X3_OPS_PER_S = 495e12 / 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float, product_ops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: its bytes at the memory rate, or its
    f32 operations, ``product_ops`` of them in matrix products that the
    tensor cores can take in 3xTF32 and the rest at the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S + product_ops / TF32X3_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k3_work(b: int, n: int, a: int, score_bytes: int) -> tuple[float, float]:
    """K3's bytes and f32 operations for ``bound``: tau and log_heu read once,
    tau' and the score (``score_bytes`` an entry) written once, the B*A*N
    distances of the tours' edges, the tours at 4 bytes a city id, the costs,
    the best cost and tour read and written; the update's multiply and add,
    the score's clamp, log, multiply and add, and each edge's cost and two
    deposit adds."""
    nbytes = (4 * 3 + score_bytes) * b * n * n + 4 * b * a * n + 4 * b * n * a + 4 * b * a \
        + 2 * 4 * (b + b * n)
    return nbytes, 6 * b * n * n + 3 * b * a * n


def k6_forward_work(b: int, r: int, n: int, k: int, u: int, write_pre: bool = True):
    """K6's forward bytes, f32 operations and tensor-core product operations
    for ``bound`` over ``b`` instances of ``r`` rows (``n`` nodes): w and
    pre, x2/x3/x4 and agg, nbr (int32), ew, eb; the edge product (2 U^2 an
    edge, 3xTF32) and the gate, mean and sums (5 U an edge). Without pre
    (row 8): w, x2, agg and nbr; the gate, product and sum (4 U an edge)."""
    edges = b * r * k
    if not write_pre:
        return 4 * (edges * u + 2 * b * n * u) + 4 * edges, 4 * edges * u, 0
    return (4 * (2 * edges * u + 4 * b * n * u + edges + u * u + u), 5 * edges * u,
            2 * edges * u * u)


def k6_backward_work(b: int, n: int, k: int, u: int):
    """K6's backward bytes, f32 operations and tensor-core product
    operations for ``bound``: w, d_pre, x2, d_agg, nbr and the reverse
    adjacency in; d_w, d_x2, d_x3, d_x4, d_ew, d_eb out; d_pre @ ew^T (2 U^2
    an edge, 3xTF32), w^T d_pre (2 U^2 an edge, f32, a PyTorch product) and
    about 10 U an edge for the gate, sums and scatters."""
    edges = b * n * k
    return (4 * (3 * edges * u + 5 * b * n * u + 2 * edges + b * (n + 1) + 2 * u * u + 2 * u),
            2 * edges * u * u + 10 * edges * u, 2 * edges * u * u)


def k9_work(b: int, n: int, k: int, e: int, layers: int, u: int):
    """K9's bytes, f32 operations and tensor-core product operations for
    ``bound``, and the bytes its design streams: e_lin0 (E multiply-adds and
    a SiLU, about 5 operations, a feature), each layer's node pass (2 U 4U a
    node) and about 10 U an edge for the gate, the sums, the affine, SiLU
    and residual; the per-edge 32x32 products (2 U^2) at the tensor cores'
    3xTF32 rate; bytes: edge features, int32 ids and x in, the edge state
    out. The design writes the edge state in e_lin0, then each layer reads
    and writes it once."""
    edges = b * n * k
    ops = edges * u * (2 * e + 5) + layers * (2 * b * n * u * 4 * u + edges * 10 * u)
    nbytes = 4 * (edges * e + edges + b * n * u + edges * u)
    floor_bytes = 4 * (edges * e + edges * u * (1 + 2 * layers))
    return nbytes, ops, layers * edges * 2 * u * u, floor_bytes


def main_path_inputs(root: Path, dev, ls: str | None = None):
    """The path's weights (``tsp500_selftrained``, or ``tsp_nls500_selftrained``
    when ``ls`` is set) and its seeded instances of N uniform cities (B of
    them, or the first B_NLS with ``ls``)."""
    import torch

    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
    from deepaco_tpu_torch.utils.datasets import uniform_coords

    ckpt = CKPT if ls is None else NLS_CKPT
    net = Net.from_jax_variables(load_checkpoint(str(root / ckpt))).to(dev)
    coords = uniform_coords(N, torch.Generator().manual_seed(SEED), batch=B,
                            device=dev)
    return net, coords if ls is None else coords[:B_NLS]


def drive(net, coords, ops=None, ls: str | None = None):
    """One call of the paths' entry point, ``evaluate_tsp`` (``net=None`` is
    the classic arm, ``ls`` the local search); ``ops`` swaps in the plain
    versions or a timer."""
    from deepaco_tpu_torch.aco.batched_tsp import KERNEL_OPS
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.eval.anytime import evaluate_tsp

    return evaluate_tsp(coords, net=net, k_sparse=K, cfg=ACOConfig(n_ants=A),
                        t_values=T_VALUES, seed=SEED, ls=ls,
                        _ops=ops or KERNEL_OPS)


def cvrp_inputs(root: Path, dev):
    """The CVRP path's weights (``cvrp500_selftrained``: 12 layers, 32 units,
    demand as the node feature) and the golden CVRP500 set (numpy)."""
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.train.drivers import family_model
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
    from deepaco_tpu_torch.utils.golden import cvrp_test

    net = family_model(get_family("cvrp"), load_checkpoint(str(root / CVRP_CKPT)))
    return net.to(dev), cvrp_test(CVRP_N)


def drive_cvrp(net, ds, ops=None):
    """One call of the CVRP path's entry point, ``evaluate_family`` (``net=None``
    is the classic arm); returns ``(means, curves, final state)``."""
    from deepaco_tpu_torch.train.drivers import KERNEL_OPS, evaluate_family

    return evaluate_family("cvrp", ds, n_nodes=CVRP_N, net=net, n_ants=A,
                           t_values=T_VALUES, seed=SEED, return_state=True,
                           _ops=ops or KERNEL_OPS)


def sparse_args(root: Path, *extra: str, t_values=None, limit: int | None = None):
    """The CLI's arguments for the sparse path at TSP2000 (k = n/10 = 200) on
    its first ``limit`` instances (all 30 by default): the neural arm with
    ``tsp500_selftrained`` unless ``extra`` says ``--classic``."""
    from deepaco_tpu_torch import cli

    argv = ["test", "tsp", "--sparse", "-n", str(SPARSE_N), "-a", str(A),
            "--seed", str(SEED), "-t", *map(str, t_values or SPARSE_T), *extra]
    if "--classic" not in extra:
        argv += ["--ckpt", str(root / CKPT)]
    argv += ["--limit", str(limit or SPARSE_B)]
    return cli.build_parser().parse_args(argv)


def sparse_inputs(root: Path, dev):
    """K9's inputs on the sparse path: the weights and the graph over the
    CLI's 30 fixed-seed instances (coordinates, k-NN support, neighbour
    distances)."""
    import numpy as np
    import torch

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.large_tsp import knn_support, sparse_tsp_graph
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

    net = Net.from_jax_variables(load_checkpoint(str(root / CKPT))).to(dev).eval()
    coords = torch.as_tensor(np.random.default_rng(cli.SPARSE_SEED).random(
        (SPARSE_B, SPARSE_N, 2)).astype(np.float32), device=dev)
    return net, sparse_tsp_graph(coords, knn_support(coords, SPARSE_N // 10))


def drive_sparse(args, ops=None, stats: dict | None = None):
    """One call of the sparse path's entry point, ``cli._cmd_test_tsp_sparse``;
    returns ``(means, curves, the CLI's printed lines)``."""
    import io

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.large_tsp import KERNEL_OPS

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        means, curves = cli._cmd_test_tsp_sparse(args, stats=stats, _ops=ops or KERNEL_OPS)
    return means, curves, out.getvalue().splitlines()


def check_embnet_layers(cuda_ms, net, g, config: str) -> dict:
    """K9 against its plain version on a path's own inputs (``config``: the
    sparse path's graph, or the CVRP path's dense one), on every head of
    ``net``; emits its line and returns K9's entry of the kernels' line."""
    import torch

    from deepaco_tpu_torch.ops import fused_gnn

    f = fused_gnn.fold_embnet_params(net.emb_net)
    x = fused_gnn._node_embedding(f, g.x)
    b, n, k = g.nbr.shape
    e, layers, u = g.edge.shape[-1], f.bv.shape[0], net.emb_net.units
    heads = ("phe", "heu") if net.dual_heads else ("heu",)

    def outputs(stack):
        out = fused_gnn.net_forward_fast(net, g.x, g.nbr, g.edge, heads=heads, layers=stack)
        return out if isinstance(out, tuple) else (out,)

    with torch.no_grad():
        got, want = outputs(fused_gnn.embnet_layers), outputs(fused_gnn.embnet_layers_plain)
        ok = all(bool(torch.allclose(a, r, rtol=1e-4, atol=1e-5)) for a, r in zip(got, want))
        err = max((a - r).abs().max().item() for a, r in zip(got, want))
        # the score reads log(heu + 1e-10)
        log_err = ((got[-1] + 1e-10).log() - (want[-1] + 1e-10).log()).abs().max().item()
        score_flips = ((got[-1] + 1e-10).log().to(torch.bfloat16)
                       != (want[-1] + 1e-10).log().to(torch.bfloat16)).float().mean().item()
        del got, want
        ms = cuda_ms(lambda: fused_gnn.embnet_layers(f, x, g.nbr, g.edge, k=k), 3)
        plain_ms = cuda_ms(lambda: fused_gnn.embnet_layers_plain(f, x, g.nbr, g.edge, k=k), 1)
    nbytes, ops, product_ops, floor_bytes = k9_work(b, n, k, e, layers, u)
    emit({"phase": "kernel", "name": "embnet_layers", "config": config, "B": b, "N": n,
          "K": k, "E": e, "layers": layers, "passed": ok, "max_abs_err": err,
          "max_log_heu_err": log_err, "bf16_score_entries_differing": score_flips,
          "ms": ms, "plain_ms": plain_ms,
          "design_floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3,
          "tolerance": f"heads {heads} rtol 1e-4, atol 1e-5 (sums in another order over "
                       "12 layers)"})
    return {"name": "embnet_layers", "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/embnet_layers.cu",
            "replaces": "deepaco_tpu/ops/fused_gnn.py:242",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "passed": ok, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops, product_ops)))}


def check_row9(dev, cuda_ms, score) -> dict:
    """Row 9, ``tsp_sweep_construct`` (K2 at B=1, f32 scores), against
    ``dense_sweep`` on one instance's ``score [N, N]``: greedy tours exactly
    equal, stochastic tours permutations from their starts."""
    import torch

    from deepaco_tpu_torch.aco import batched_tsp as bt

    n = score.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    start = torch.randint(0, n, (A,), generator=gen, device=dev)
    greedy = bt.tsp_sweep_construct(score, start, gen, stochastic=False)
    want = bt.dense_sweep(score[None], start[None], gen, stochastic=False)[0]
    paths = bt.tsp_sweep_construct(score, start, gen)
    perms = bool(torch.equal(torch.sort(paths, dim=0).values,
                             torch.arange(n, device=dev)[:, None].expand(n, A)))
    ok = bool(torch.equal(greedy, want)) and perms and bool(torch.equal(paths[0], start))
    ms = cuda_ms(lambda: bt.tsp_sweep_construct(score, start, gen), 10)
    plain_ms = cuda_ms(lambda: bt.dense_sweep(score[None], start[None], gen)[0], 1)
    emit({"phase": "kernel", "name": "tsp_sweep_construct", "N": n, "A": A, "passed": ok,
          "greedy_equal": bool(torch.equal(greedy, want)), "permutations": perms,
          "ms": ms, "plain_ms": plain_ms,
          "tolerance": "greedy tours exact; stochastic tours permutations"})
    return {"name": "tsp_sweep_construct", "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/sweep.cu (K2 at B=1, f32 scores)",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:606",
            "max_abs_err": (greedy - want).abs().max().item(), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "passed": ok,
            # f32 scores, starts and int32 tours; a select, an add and a
            # compare per candidate column of each step
            **dict(zip(("bound_ms", "bound_by"), bound(4 * n * n + 4 * A + 4 * n * A,
                                                        2 * A * (n - 1) * n)))}


def cvrp_rollout(dev, ds):
    """One CVRP rollout on ``1/d`` at the path's shape (B=100, A=20, n=501),
    each step through K7; returns its paths, their ``1/cost`` amounts and the
    pick's inputs ``(step, score, mask, noise)``, [B*A, n] each, at the
    shares CVRP_PICK_AT of the horizon."""
    import torch

    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems.cvrp import cvrp_spec, route_cost
    from deepaco_tpu_torch.families import CVRP_CAPACITY
    from deepaco_tpu_torch.ops import pick

    dist = torch.as_tensor(ds["dist"], device=dev)
    demand = torch.as_tensor(ds["demand"], device=dev)
    spec = cvrp_spec(torch.ones_like(dist), 1.0 / dist, demand, CVRP_CAPACITY, A)
    at = {int(f * spec.horizon) for f in CVRP_PICK_AT}
    steps = iter(range(spec.horizon))
    captured = []

    def capture(score, mask, noise):
        step = next(steps)
        if step in at:
            captured.append((step, score.clone(), mask.clone(), noise.clone()))
        return pick.fused_pick(score, mask, noise)

    paths = rollout(spec, torch.Generator(device=dev).manual_seed(SEED + 5),
                    pick=capture).paths
    return paths, 1.0 / route_cost(dist, paths), captured


def check_pick_at_cvrp_shape(cuda_ms, captured) -> dict:
    """K7 against its plain version on the CVRP rollout's own score, mask
    (depot and capacity) and noise at several steps: actions exactly equal
    and allowed, logp rtol 1e-5 / atol 1e-5."""
    import torch

    from deepaco_tpu_torch.ops import pick

    steps, ok, err = [], True, 0.0
    with torch.no_grad():
        for s, score, mask, noise in captured:
            act_k, logp_k = pick.fused_pick(score, mask, noise)
            act_p, logp_p = pick.fused_pick_plain(score, mask, noise)
            equal = bool(torch.equal(act_k, act_p))
            close = bool(torch.allclose(logp_k, logp_p, rtol=1e-5, atol=1e-5))
            allowed = bool((mask.gather(1, act_k[:, None]) > 0).all())
            open_cols = mask.sum(1)
            steps.append({"step": s, "actions_equal": equal, "logp_close": close,
                          "actions_allowed": allowed,
                          "open_per_row": [int(open_cols.min()), int(open_cols.max())],
                          "logp_max_abs_err": (logp_k - logp_p).abs().max().item()})
            ok &= equal and close and allowed
            err = max(err, steps[-1]["logp_max_abs_err"])
        _, score, mask, noise = captured[len(captured) // 2]
        ms = cuda_ms(lambda: pick.fused_pick(score, mask, noise), 50)
        plain_ms = cuda_ms(lambda: pick.fused_pick_plain(score, mask, noise), 20)
    rows, n = score.shape
    return {"rows": rows, "N": n, "passed": len(captured) == len(CVRP_PICK_AT) and ok,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "steps": steps,
            **dict(zip(("bound_ms", "bound_by"), bound(3 * 4 * rows * n + 12 * rows,
                                                        6 * rows * n)))}


def check_cvrp_construct(dev, cuda_ms, ds) -> dict:
    """K7c (``cvrp_construct``) against its plain version at the CVRP path's
    shape (B=100, N=501, A=20, capacity 50) on ``1/d``: paths bit-equal from
    equal generator states, stochastic and greedy, and valid; its time, the
    plain version's and the bound for the steps this run's ants take."""
    import torch

    from deepaco_tpu_torch.aco.problems.cvrp import validate_routes
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.families import CVRP_CAPACITY
    from deepaco_tpu_torch.ops import cvrp_construct as cc

    dist = torch.as_tensor(ds["dist"], device=dev)
    demand = torch.as_tensor(ds["demand"], device=dev)
    score = score_matrix(torch.ones_like(dist), 1.0 / dist, 1.0, 1.0)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 9)
    modes = {}
    for stochastic in (True, False):
        got = cc.cvrp_construct(score, demand, CVRP_CAPACITY, A, gen(), stochastic=stochastic)
        want = cc.cvrp_construct_plain(score, demand, CVRP_CAPACITY, A, gen(),
                                       stochastic=stochastic)
        modes["stochastic" if stochastic else "greedy"] = {
            "equal": bool(torch.equal(got, want)),
            "valid": bool(validate_routes(got, demand, CVRP_CAPACITY).all()),
            "differing_entries": int((got != want).sum()),
            "max_abs_err": (got - want).abs().max().item()}
        if stochastic:
            paths = got
    b, rows, a = paths.shape
    n = score.shape[-1]
    # the steps each ant takes before it is back at the depot for good
    served = (paths != 0).long() * torch.arange(rows, device=dev)[None, :, None]
    steps = int((served.amax(dim=1) + 1).sum())
    g = gen()
    ms = cuda_ms(lambda: cc.cvrp_construct(score, demand, CVRP_CAPACITY, A, g), 10)
    plain_ms = cuda_ms(lambda: cc.cvrp_construct_plain(score, demand, CVRP_CAPACITY, A, g), 1)
    ok = all(m["equal"] and m["valid"] for m in modes.values())
    # score read once, demand read once, paths written once; per entry of
    # the steps taken: the uniform's add and multiply, two logarithms, the
    # noise add, the capacity compare, the mask select and the running-max
    # compare
    nbytes = 4 * b * n * n + 4 * b * n + 8 * b * rows * a
    emit({"phase": "kernel", "name": "cvrp_construct", "B": b, "N": n, "A": a,
          "capacity": CVRP_CAPACITY, "passed": ok, **modes, "steps_taken": steps,
          "steps_bound": b * a * (rows - 1), "ms": ms, "plain_ms": plain_ms,
          "tolerance": "paths bit-equal to the plain version (the same Philox noise)"})
    return {"name": "cvrp_construct", "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/cvrp_sweep.cu",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:65 (the CVRP construction scan, "
                        "deepaco_tpu/aco/engine.py:104-129)",
            "max_abs_err": max(m["max_abs_err"] for m in modes.values()),
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, "passed": ok,
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 8 * steps * n)))}


def check_deposit(dev, cuda_ms, tsp_paths, tsp_amounts, cvrp_paths, cvrp_amounts) -> dict:
    """K8 against ``scatter_add_`` at the CVRP path's shape (routes sampled by
    K7 on ``1/d``) and at the main path's (K2's tours); returns K8's entry of
    the kernels' line and emits one line."""
    import torch

    from deepaco_tpu_torch.ops import deposit

    cases = {"cvrp": (cvrp_paths, cvrp_amounts, CVRP_N + 1, False),
             "tsp": (tsp_paths, tsp_amounts, N, True)}
    out = {}
    for name, (p, w, n, cyclic) in cases.items():
        b, l, a = p.shape
        got = deposit.tour_deposit(p, w, n, cyclic=cyclic)
        again = deposit.tour_deposit(p, w, n, cyclic=cyclic)
        plain = deposit.tour_deposit_plain(p, w, n, cyclic=cyclic)
        cpu = deposit.tour_deposit_plain(p.cpu(), w.cpu(), n, cyclic=cyclic)
        u, v = deposit.tour_edges(p, cyclic)
        index, values = (u * n + v).flatten(-2), w[..., None].expand(u.shape).flatten(-2)
        zeros = torch.zeros((b, n * n), device=dev)
        edges = index.shape[-1]
        # k, the terms of each entry: two sums of k positive terms in other
        # orders differ by at most 2 k 2^-24 of their value
        k = deposit.tour_deposit_plain(p, torch.ones_like(w), n, cyclic=cyclic)
        # K8 and scatter_add take a tenth of a millisecond, so a stall of the
        # host between launches shows in a mean: both are timed the same way,
        # in turns, and each reports the median of 5 means of 20 launches
        means = {"ms": [], "library_ms": []}
        for _ in range(5):
            means["ms"].append(cuda_ms(lambda: deposit.tour_deposit(p, w, n, cyclic=cyclic), 20))
            means["library_ms"].append(
                cuda_ms(lambda: torch.scatter_add(zeros, -1, index, values), 20))
        out[name] = {
            "B": b, "L": l, "A": a, "n": n, "cyclic": cyclic,
            "self_loops_per_instance": ((u == v).sum() / b).item(),
            "max_terms_an_entry": k.max().item(),
            "equal_to_cpu_scatter": torch.equal(got.cpu(), cpu),
            "deterministic": torch.equal(got, again),
            "close_to_card_scatter": bool(((got - plain).abs()
                                           <= 2 * k * 2.0 ** -24 * got).all()),
            "max_rel_err_card_scatter": ((got - plain).abs() / got.clamp_min(1e-30)).max().item(),
            "max_abs_err": (got - plain).abs().max().item(),
            "ms": statistics.median(means["ms"]),
            "plain_ms": cuda_ms(lambda: deposit.tour_deposit_plain(p, w, n, cyclic=cyclic), 5),
            "library_ms": statistics.median(means["library_ms"]),
            "means_ms": means,
            # paths (int64) and amounts read once, D written once; one add an edge
            **dict(zip(("bound_ms", "bound_by"), bound(
                8 * b * l * a + 4 * b * a + 4 * b * n * n, b * edges)))}
        out[name]["passed"] = all(out[name][k] for k in (
            "equal_to_cpu_scatter", "deterministic", "close_to_card_scatter"))
    emit({"phase": "kernel", "name": "tour_deposit", **out,
          "tolerance": "equal bits to scatter_add_ on the CPU (ant-major, one add at a "
                       "time) and on a second launch; to scatter_add_ on the card (atomics "
                       "in any order) within 2 k 2^-24 of each entry, k its terms"})
    c = out["cvrp"]
    return {"name": "tour_deposit", "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/tour_deposit.cu",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:340",
            "max_abs_err": max(r["max_abs_err"] for r in out.values()),
            "passed": all(r["passed"] for r in out.values()),
            "tsp_ms": out["tsp"]["ms"], "tsp_library_ms": out["tsp"]["library_ms"],
            "below_library": all(r["ms"] < r["library_ms"] for r in out.values()),
            **{k: c[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def check_layer_at_cvrp_width(dev, cuda_ms, net, ds) -> dict:
    """K6's forward at the CVRP path's shape (B=100, N = K = 501, U=32) on
    the first layer's real inputs, against its plain version."""
    import torch
    from torch.nn import functional as F

    from deepaco_tpu_torch.core.builders import cvrp_graph
    from deepaco_tpu_torch.ops import gnn_layer

    emb = net.emb_net
    g = cvrp_graph(torch.as_tensor(ds["demand"], device=dev),
                   torch.as_tensor(ds["dist"], device=dev))
    b, n, k = g.nbr.shape
    u = emb.units
    with torch.no_grad():
        x = F.silu(emb.v_lin0(g.x))
        w = F.silu(emb.e_lin0(g.edge))
        index = gnn_layer.reverse_adjacency(g.nbr)
        lin = emb.e_lins0[0]
        args = (emb.v_lins2[0](x), emb.v_lins3[0](x), emb.v_lins4[0](x), g.nbr, w,
                lin.weight.T, lin.bias, index)
        got = gnn_layer.fused_gnn_layer(*args)
        want = gnn_layer.fused_gnn_layer_plain(*args)
        ok = all(bool(torch.allclose(a, r, rtol=1e-5, atol=1e-5)) for a, r in zip(got, want))
        err = max((a - r).abs().max().item() for a, r in zip(got, want))
        del got, want
        ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer(*args), 5)
        plain_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer_plain(*args), 2)
    return {"B": b, "N": n, "K": k, "passed": ok, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **dict(zip(("bound_ms", "bound_by"), bound(
                *k6_forward_work(b, n, n, k, u))))}


def ls_bound(n: int, b: int, a: int, scans: dict, metric_bytes: int):
    """K4/K5's least time for the scans the plain version counted: each scan
    evaluates (n-1)(n-2)/2 pairs at 3 add/sub and a compare, the pair's two
    entries read from a matrix: the bf16 metric, or the instance's f32
    distance matrix, built once at B*n*n distances of 7 operations (2 sub,
    2 mul, 2 add, 1 sqrt). Bytes: the metric, the distance matrix, the
    coordinates, and the tours read and written at 4 bytes a city."""
    pairs = (n - 1) * (n - 2) / 2
    ops = 4 * pairs * (scans.get("true", 0) + scans.get("perturb", 0)) + 7 * b * n * n
    return bound(metric_bytes + 4 * b * n * n + 4 * b * n * 2 + 2 * 4 * b * a * n,
                 ops)


def train_configs():
    """The two training envelopes, at full width: name -> (config, Net
    arguments, local-search hook). TSP500: tsp/train.ipynb's envelope, which
    trained ``tsp500_selftrained`` (RESULTS.md:177); TSP500-NLS:
    ``scripts/train_tsp_nls500.py``'s (tsp_nls/train.py:138-141), which
    trained ``tsp_nls500_selftrained``."""
    from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig
    from deepaco_tpu_torch.train.reinforce import nls_local_search

    tsp = ProblemConfig(
        n_nodes=N, k_sparse=K, aco=ACOSettings(n_ants=A_TRAIN),
        train=TrainConfig(lr=3e-4, weight_decay=1e-2, grad_clip=3.0, epochs=5,
                          steps_per_epoch=128, batch_size=1,
                          cosine_schedule=False, seed=SEED))
    nls = ProblemConfig(
        name="tsp_nls", n_nodes=N, k_sparse=K, aco=ACOSettings(n_ants=A_TRAIN_NLS),
        train=TrainConfig(lr=6e-4, weight_decay=1e-2, grad_clip=3.0, epochs=20,
                          steps_per_epoch=20, batch_size=B_TRAIN,
                          cosine_schedule=True, seed=SEED))
    return {"tsp500": (tsp, {"dual_heads": True}, None),
            "tsp500_nls": (nls, {"feats": 1}, nls_local_search())}


def norm_err(got, ref) -> float:
    """``max |got - ref|`` over ``max |ref|``."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def check_training_kernels(dev, cuda_ms, kernels: list) -> bool:
    """K6 (forward, backward), row 8 through K6 and K7 against their plain
    versions at the TSP-NLS training shapes; appends K6's and K7's entries
    to ``kernels``, emits one line each and returns whether row 8 passed."""
    import torch

    from deepaco_tpu_torch.aco.engine import gumbel
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.ops import gnn_layer, pick
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    b, u = B_TRAIN, gnn_layer.UNITS
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    coords = uniform_coords(N, torch.Generator().manual_seed(SEED + 4), batch=b, device=dev)
    dist = distance_matrix(coords)
    nbr = topk_smallest(dist, K)[1]
    index = gnn_layer.reverse_adjacency(nbr)
    x2, x3, x4, w = rnd(b, N, u), rnd(b, N, u), rnd(b, N, u), rnd(b, N, K, u)
    ew, eb = rnd(u, u) * 0.1, rnd(u) * 0.1
    args = (x2, x3, x4, nbr, w, ew, eb, index)

    with torch.no_grad():
        agg_k, pre_k = gnn_layer.fused_gnn_layer(*args)
        agg_p, pre_p = gnn_layer.fused_gnn_layer_plain(*args)
    fwd_err = max((agg_k - agg_p).abs().max().item(), (pre_k - pre_p).abs().max().item())
    fwd_ok = bool(torch.allclose(agg_k, agg_p, rtol=1e-5, atol=1e-5)
                  and torch.allclose(pre_k, pre_p, rtol=1e-5, atol=1e-5))

    # all six input gradients under the mixed loss of
    # tests/test_pallas_kernels.py:223-235, through autograd on both sides
    ca, cp = rnd(b, N, u), rnd(b, N, K, u)

    def grads(layer):
        leaves = [t.clone().requires_grad_(True) for t in (x2, x3, x4, w, ew, eb)]
        agg, pre = layer(leaves[0], leaves[1], leaves[2], nbr, leaves[3], leaves[4],
                         leaves[5], index)
        ((agg * ca).sum() + (torch.tanh(pre) * cp).sum()).backward()
        return [t.grad for t in leaves]

    names = ("x2", "x3", "x4", "w", "ew", "eb")
    g_k, g_p = grads(gnn_layer.fused_gnn_layer), grads(gnn_layer.fused_gnn_layer_plain)
    grad_errs = {n: norm_err(a, r) for n, a, r in zip(names, g_k, g_p)}
    # the backward entry itself on identical cotangents
    b_k = gnn_layer.fused_gnn_layer_backward(x2, index, w, ew, ca, cp)
    b_p = gnn_layer.fused_gnn_layer_backward_plain(x2, nbr, w, ew, ca, cp)
    order = ("x2", "x3", "x4", "w", "ew", "eb")
    entry_errs = {n: norm_err(a, r) for n, a, r in zip(order, b_k, b_p)}
    close = lambda a, r: bool(torch.allclose(a, r, rtol=1e-4,
                                             atol=1e-5 * r.abs().max().item()))
    bwd_ok = all(close(a, r) for a, r in zip(g_k, g_p)) and all(
        close(a, r) for a, r in zip(b_k, b_p))
    bwd_err = max((a - r).abs().max().item() for a, r in zip(b_k, b_p))

    agg_only = gnn_layer.gated_mean_aggregate(x2, nbr, w)
    row8_ok = bool(torch.allclose(agg_only, agg_p, rtol=1e-5, atol=1e-5))
    row8 = {"phase": "kernel", "name": "gated_mean_aggregate", "route": "cuda (K6, pre skipped)",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:114", "B": b, "N": N, "K": K,
            "passed": row8_ok, "max_abs_err": (agg_only - agg_p).abs().max().item(),
            "ms": cuda_ms(lambda: gnn_layer.gated_mean_aggregate(x2, nbr, w), 20),
            "plain_ms": cuda_ms(lambda: gnn_layer.gated_mean_aggregate_plain(x2, nbr, w), 5),
            "tolerance": "rtol 1e-5, atol 1e-5 (sum order of the mean)"}
    row8.update(zip(("bound_ms", "bound_by"), bound(*k6_forward_work(b, N, N, K, u, False))))
    emit(row8)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer(*args), 20)
        fwd_plain_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer_plain(*args), 5)
    bwd_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer_backward(x2, index, w, ew, ca, cp), 20)
    bwd_plain_ms = cuda_ms(
        lambda: gnn_layer.fused_gnn_layer_backward_plain(x2, nbr, w, ew, ca, cp), 5)
    kernels.append({
        "name": "fused_gnn_layer", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/gnn_layer.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:203",
        "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
        "library_ms": None, "passed": fwd_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(*k6_forward_work(b, N, N, K, u))))})
    kernels.append({
        "name": "fused_gnn_layer_backward", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/gnn_layer.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:275 (fused_gnn_layer_ad, _fused_ad_bwd 290)",
        "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "library_ms": None, "passed": bwd_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(*k6_backward_work(b, N, K, u))))})
    emit({"phase": "kernel", "name": "fused_gnn_layer", "B": b, "N": N, "K": K, "U": u,
          "forward_passed": fwd_ok, "backward_passed": bwd_ok,
          "forward_max_abs_err": fwd_err, "autograd_grad_err": grad_errs,
          "backward_entry_err": entry_errs,
          "tolerance": "forward rtol 1e-5, atol 1e-5 (sum order of 32-term products "
                       "and the K-term mean); gradients rtol 1e-4 (JAX's own test), "
                       "atol 1e-5 of the largest entry (d_x2, d_x4 and d_ew sum "
                       "hundreds to 500,000 terms, the plain scatter with atomics)"})

    # K7 on [600, 500] rows in the middle of a rollout: the score rows of the
    # instances' -log(distance), each with a random share of its columns visited
    rows = B_TRAIN * A_TRAIN_NLS
    score = torch.log(1.0 / dist).reshape(-1, N)[:rows].contiguous()
    visited_count = torch.randint(1, N, (rows, 1), generator=g, device=dev)
    rank = torch.argsort(torch.argsort(torch.rand((rows, N), generator=g, device=dev), dim=1), dim=1)
    mask = (rank >= visited_count).float()
    noise = gumbel((rows, N), g, dev)
    with torch.no_grad():
        act_k, logp_k = pick.fused_pick(score, mask, noise)
        act_p, logp_p = pick.fused_pick_plain(score, mask, noise)
    c = rnd(rows)

    def pick_grad(fn):
        sc = score.clone().requires_grad_(True)
        (fn(sc, mask, noise)[1] * c).sum().backward()
        return sc.grad

    d_k, d_p = pick_grad(pick.fused_pick), pick_grad(pick.fused_pick_plain)
    k7_err = (logp_k - logp_p).abs().max().item()
    k7_ok = bool(torch.equal(act_k, act_p)
                 and torch.allclose(logp_k, logp_p, rtol=1e-5, atol=1e-5)
                 and torch.allclose(d_k, d_p, rtol=1e-5, atol=1e-6)
                 and bool((mask.gather(1, act_k[:, None]) > 0).all()))
    with torch.no_grad():
        k7_ms = cuda_ms(lambda: pick.fused_pick(score, mask, noise), 50)
        k7_plain_ms = cuda_ms(lambda: pick.fused_pick_plain(score, mask, noise), 20)
    kernels.append({
        "name": "fused_pick", "route": "cuda", "source": "deepaco_tpu_torch/csrc/pick.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:65",
        "max_abs_err": k7_err, "ms": k7_ms, "plain_ms": k7_plain_ms,
        "library_ms": None, "passed": k7_ok,
        # three [R, N] f32 reads, action (8 bytes) and logp out; a select,
        # an add, a compare, a subtract, an exp and an add per entry
        **dict(zip(("bound_ms", "bound_by"), bound(3 * 4 * rows * N + 12 * rows,
                                                    6 * rows * N)))})
    emit({"phase": "kernel", "name": "fused_pick", "rows": rows, "N": N,
          "passed": k7_ok, "actions_equal": bool(torch.equal(act_k, act_p)),
          "logp_max_abs_err": k7_err, "d_rows_max_abs_err": (d_k - d_p).abs().max().item(),
          "open_per_row": [int(mask.sum(1).min()), int(mask.sum(1).max())],
          "tolerance": "actions exact; logp rtol 1e-5, atol 1e-5 and d_rows rtol 1e-5, "
                       "atol 1e-6 (logsumexp order, expf/logf against torch's)"})
    return row8_ok


def train_step_arms(dev, name: str) -> dict:
    """One training step of configuration ``name`` from the same weights and
    instances: the kernel arm samples through K6, K7 (and K5), the plain arm
    replays its paths with the plain layer. Returns the comparison."""
    import copy

    import torch

    from deepaco_tpu_torch.models.gnn import Net, init_like_flax
    from deepaco_tpu_torch.train import reinforce as tr
    from deepaco_tpu_torch.utils.datasets import uniform_coords

    cfg, net_kwargs, ls = train_configs()[name]
    net_k = init_like_flax(Net(**net_kwargs).to(dev),
                           torch.Generator(device=dev).manual_seed(SEED))
    net_p = copy.deepcopy(net_k)
    before = copy.deepcopy(net_k.state_dict())
    coords = uniform_coords(N, torch.Generator().manual_seed(SEED + 2),
                            batch=cfg.train.batch_size, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    arms = {}
    out_k = tr.tsp_loss(net_k, coords, cfg, gen, local_search=ls)
    out_k.loss.backward()
    replay_ls = (lambda *a: out_k.ls_costs) if ls is not None else None
    out_p = tr.tsp_loss(net_p, coords, cfg, gen, local_search=replay_ls,
                        paths=out_k.paths, _ops=tr.PLAIN_OPS)
    out_p.loss.backward()
    for arm, net in (("kernel", net_k), ("plain", net_p)):
        arms[arm] = {n: (p.grad.detach().clone() if p.grad is not None
                         else torch.zeros_like(p)) for n, p in net.named_parameters()}
    biggest = max(g.abs().max().item() for g in arms["plain"].values())
    # a leaf whose gradient is rounding noise (a bias that a BatchNorm
    # cancels: exact gradient 0) is held against 1e-2 of the largest gradient
    grad_errs = {n: ((arms["kernel"][n] - g).abs().max()
                     / max(g.abs().max().item(), 1e-2 * biggest)).item()
                 for n, g in arms["plain"].items()}
    cost_dev = out_k.costs - out_k.costs.mean(dim=-1, keepdim=True)
    if out_k.ls_costs is not None:
        ls_dev = out_k.ls_costs - out_k.ls_costs.mean(dim=-1, keepdim=True)
        cost_dev = 0.95 * ls_dev + 0.05 * cost_dev
    scale = (cost_dev.abs() * out_k.log_probs.sum(dim=-2).abs()).sum(-1).mean().item() \
        / cfg.aco.n_ants
    loss_err = abs(out_k.loss.item() - out_p.loss.item())
    state_k = tr.TrainState(net_k, tr.make_optimizer(net_k, cfg), 0, cfg.train.cosine_schedule)
    state_p = tr.TrainState(net_p, tr.make_optimizer(net_p, cfg), 0, cfg.train.cosine_schedule)
    tr.optimizer_update(state_k, cfg)
    tr.optimizer_update(state_p, cfg)
    lr, wd = cfg.train.lr, cfg.train.weight_decay
    param_ok, param_err = True, 0.0
    for n, p in net_p.named_parameters():
        g = arms["plain"][n]
        got = dict(net_k.named_parameters())[n].detach()
        signal = g.abs() > 1e-4 * biggest
        if bool(signal.any()):
            param_err = max(param_err, (got - p)[signal].abs().max().item())
            param_ok &= bool(torch.allclose(got[signal], p.detach()[signal], rtol=1e-5, atol=1e-6))
        moved = (got - before[n]).abs()
        param_ok &= bool((moved <= lr * (1 + 1e-3) + lr * wd * before[n].abs()).all())
    stats = lambda net: {k: v for k, v in net.state_dict().items() if "running" in k}
    bn_err = max(norm_err(a, b) for a, b in zip(stats(net_k).values(), stats(net_p).values()))
    ok = (loss_err <= 1e-5 * scale and max(grad_errs.values()) <= 1e-3 and param_ok
          and bn_err <= 1e-4 and bool(torch.isfinite(out_k.loss)))
    worst = max(grad_errs, key=grad_errs.get)
    return {"phase": "train_step", "config": name, "passed": ok,
            "B": cfg.train.batch_size, "N": N, "K": K, "A": cfg.aco.n_ants,
            "loss_kernel": out_k.loss.item(), "loss_plain": out_p.loss.item(),
            "loss_abs_err": loss_err, "loss_term_scale": scale,
            "mean_cost": out_k.mean_cost.item(), "grad_max_norm_err": grad_errs[worst],
            "grad_worst_leaf": worst, "param_max_abs_err": param_err,
            "running_stats_norm_err": bn_err, "gradient_leaves": len(grad_errs),
            "tolerance": "loss within 1e-5 of sum |advantage * sum log p| / A; each "
                         "gradient within 1e-3 of its largest entry, or of 1e-2 of the "
                         "largest gradient where that is larger (the biases a BatchNorm "
                         "cancels have gradient 0 plus rounding noise); weights after "
                         "AdamW rtol 1e-5 / atol 1e-6 where |g| > 1e-4 of the largest "
                         "gradient (a first Adam step moves by lr * sign(g)), else moved "
                         "at most lr; running statistics within 1e-4"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost
    from deepaco_tpu_torch.aco.runner import ACOConfig, track_best
    from deepaco_tpu_torch.core.builders import cvrp_graph, start_node_features
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.eval.anytime import evaluate_tsp
    from deepaco_tpu_torch.models.gnn import Net, init_like_flax
    from deepaco_tpu_torch.aco.problems.cvrp import route_cost, validate_routes
    from deepaco_tpu_torch.families import CVRP_CAPACITY
    from deepaco_tpu_torch.ops import _build, deposit, fused_gnn, gnn_layer, pick, two_opt
    from deepaco_tpu_torch.ops import cvrp_construct as cc
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.train import reinforce as tr
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # ---- 1. build
    built = _build.build()
    _build.library()
    emit({"phase": "build", "card": card, "nvcc_seconds": built["seconds"],
          "library": str(_build.LIB_PATH.relative_to(root))})
    print(built["log"], file=sys.stderr)

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def timed(fn):
        """One run of ``fn`` between CUDA events: (result, ms)."""
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # ---- 2. K1-K3 against their plain versions, at the main path's shapes
    net, coords = main_path_inputs(root, dev)
    dist = distance_matrix(coords)
    kernels = []

    heu = fused_gnn.tsp_dense_heuristic(net, coords, dist, K)
    heu_plain = fused_gnn.tsp_dense_heuristic_plain(net, coords, dist, K)
    k1_err = (heu - heu_plain).abs().max().item()
    # The score takes log(heu), so the K on-support entries of each row are
    # also held in log space, where a small sigmoid output counts as much as
    # a large one; the 1e-10 fill off the support matches exactly.
    support = topk_smallest(dist, K)[1]
    on_k, on_p = heu.gather(2, support), heu_plain.gather(2, support)
    k1_log_err = (on_k.log() - on_p.log()).abs().max().item()
    k1_ok = bool(torch.allclose(heu, heu_plain, rtol=1e-4, atol=1e-5)
                 and k1_log_err <= 1e-4)
    feats = coords.shape[-1]
    layers, u = net.emb_net.depth, net.emb_net.units
    # multiply-adds of the node pass and one compare per candidate column
    # for each row's top-K selection; the edge products and the head's two
    # at the tensor cores' 3xTF32 rate
    k1_ops = layers * 2 * B * N * u * 4 * u + B * N * N
    k1_products = layers * 2 * B * N * K * u * u + 4 * B * N * K * u * u
    k1_bytes = 4 * (2 * B * N * N + B * N * feats)
    # the design streams the edge state: the k-NN pass reads dist and writes
    # it, each layer reads and writes it, the head reads it and writes heu
    k1_floor = 4 * (2 * B * N * N + B * N * K * u * (2 + 2 * layers))
    kernels.append({
        "name": "tsp_dense_heuristic", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/dense_heuristic.cu",
        "replaces": "deepaco_tpu/ops/fused_gnn.py:416",
        "max_abs_err": k1_err,
        "ms": cuda_ms(lambda: fused_gnn.tsp_dense_heuristic(net, coords, dist, K), 5),
        "plain_ms": cuda_ms(lambda: fused_gnn.tsp_dense_heuristic_plain(net, coords, dist, K), 2),
        "library_ms": None, "passed": k1_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(k1_bytes, k1_ops, k1_products)))})
    emit({"phase": "kernel", "name": "tsp_dense_heuristic", "passed": k1_ok,
          "max_abs_err": k1_err, "max_log_err_on_support": k1_log_err,
          "support_min": on_p.min().item(),
          "support_median": on_p.median().item(),
          "design_floor_ms": k1_floor / HBM_BYTES_PER_S * 1e3,
          "tolerance": "rtol 1e-4, atol 1e-5; log(heu) on the support "
                       "atol 1e-4 (sum order)"})

    score = torch.log(torch.clamp(heu, min=1e-30)).to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = torch.randint(0, N, (B, A), generator=gen, device=dev)
    greedy_k = bt.dense_sweep_fused(score, start, gen, stochastic=False)
    greedy_p = bt.dense_sweep(score, start, gen, stochastic=False)
    k2_greedy_ok = bool(torch.equal(greedy_k, greedy_p))
    paths_k = bt.dense_sweep_fused(score, start, gen)
    paths_p = bt.dense_sweep(score, start, gen)
    ident = torch.arange(N, device=dev)[None, :, None]
    perms_ok = bool((torch.sort(paths_k, dim=1).values == ident).all())
    cost_k = tour_cost(dist, paths_k).mean().item()
    cost_p = tour_cost(dist, paths_p).mean().item()
    k2_ok = k2_greedy_ok and perms_ok and abs(cost_k - cost_p) <= 0.02 * cost_p
    # bound counts tour indices at 4 bytes, as many as a city id needs
    k2_ops = 2 * B * A * (N - 1) * N
    k2_bytes = 2 * B * N * N + 4 * B * A + 4 * B * N * A
    kernels.append({
        "name": "dense_sweep_fused", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/sweep.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:522",
        "max_abs_err": (greedy_k - greedy_p).abs().max().item(),
        "ms": cuda_ms(lambda: bt.dense_sweep_fused(score, start, gen), 5),
        "plain_ms": cuda_ms(lambda: bt.dense_sweep(score, start, gen), 1),
        "library_ms": None, "passed": k2_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(k2_bytes, k2_ops)))})
    emit({"phase": "kernel", "name": "dense_sweep_fused", "passed": k2_ok,
          "greedy_equal": k2_greedy_ok, "permutations": perms_ok,
          "mean_cost_kernel": cost_k, "mean_cost_plain": cost_p,
          "tolerance": "greedy exact; stochastic mean cost within 2%"})

    # K3 on an iteration of the main path: K2's tours, tau in [0.5, 1.5),
    # the heuristic's log, a fresh best state (every instance improves)
    tau = 0.5 + torch.rand((B, N, N), generator=gen, device=dev)
    log_heu = torch.log(torch.clamp(heu, min=1e-30))
    state = bt._batched_init(B, N, ACOConfig(n_ants=A), dev)
    state = state._replace(phe=state.phe._replace(tau=tau))
    k3_args = (state, paths_k, dist)
    k3_kw = {"decay": 0.9, "q": 1.0, "log_heu": log_heu}
    got, costs_k, score_k = bt.fused_tsp_update(*k3_args, **k3_kw)
    ref, costs_p, score_p = bt.fused_tsp_update_plain(*k3_args, **k3_kw)
    own = track_best(state, paths_k, costs_k)
    k3_best_ok = bool(torch.equal(got.best_cost, own.best_cost)
                      and torch.equal(got.best_path, own.best_path))
    k3_score_ok = bool(torch.equal(score_k, bt.next_score(got.phe.tau, log_heu, 1.0,
                                                          torch.bfloat16)))
    k3_ok = bool(torch.allclose(got.phe.tau, ref.phe.tau, rtol=1e-6, atol=0)
                 and torch.allclose(costs_k, costs_p, rtol=1e-6, atol=0)
                 and k3_best_ok and k3_score_ok)
    # the unstaged variant (K3 past 19,000 cities) gives the staged one's bits
    un, costs_u, score_u = bt.fused_tsp_update(*k3_args, **k3_kw, staged=False)
    k3_unstaged_ok = bool(torch.equal(un.phe.tau, got.phe.tau) and torch.equal(costs_u, costs_k)
                          and torch.equal(un.best_cost, got.best_cost)
                          and torch.equal(un.best_path, got.best_path)
                          and torch.equal(score_u, score_k))
    del un, costs_u, score_u
    k3_ok = k3_ok and k3_unstaged_ok
    k3_err = max((got.phe.tau - ref.phe.tau).abs().max().item(),
                 (costs_k - costs_p).abs().max().item())
    k3_score_vs_plain = int((score_k != score_p).sum().item())
    del got, ref, score_k, score_p, own
    # library yardstick: one index_put_ of the 2*B*A*N deposits onto decay*tau
    bi = torch.arange(B, device=dev)[:, None, None].expand(B, A, N).reshape(-1)
    uu = paths_k.transpose(1, 2)
    vv = torch.roll(uu, 1, dims=-1)
    amounts = (1.0 / costs_p)[..., None].expand(B, A, N).reshape(-1)
    index = (torch.cat([bi, bi]), torch.cat([uu.reshape(-1), vv.reshape(-1)]),
             torch.cat([vv.reshape(-1), uu.reshape(-1)]))
    values = torch.cat([amounts, amounts])
    decayed = tau * 0.9
    kernels.append({
        "name": "fused_tsp_update", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/as_update.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:401",
        "max_abs_err": k3_err,
        "ms": cuda_ms(lambda: bt.fused_tsp_update(*k3_args, **k3_kw), 20),
        "plain_ms": cuda_ms(lambda: bt.fused_tsp_update_plain(*k3_args, **k3_kw), 5),
        "library_ms": cuda_ms(lambda: decayed.clone().index_put_(
            index, values, accumulate=True), 20),
        "passed": k3_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(*k3_work(B, N, A, 2))))})
    emit({"phase": "kernel", "name": "fused_tsp_update", "passed": k3_ok,
          "max_abs_err": k3_err, "best_state_equal": k3_best_ok,
          "score_equal": k3_score_ok, "score_entries_differing_from_plain": k3_score_vs_plain,
          "unstaged_equal": k3_unstaged_ok,
          "unstaged_ms": cuda_ms(lambda: bt.fused_tsp_update(*k3_args, **k3_kw, staged=False), 20),
          "tolerance": "tau' and costs at rtol 1e-6; best state and bf16 score bit-equal to "
                       "track_best and next_score of the kernel's own costs and tau'; the "
                       "unstaged variant bit-equal to the staged one"})

    # ---- 3. K4 and K5 against their plain versions
    nls_net, _ = main_path_inputs(root, dev, ls="nls")
    is_perm = lambda t: torch.equal(torch.sort(t, dim=-1).values,
                                    torch.arange(t.shape[-1], device=dev).expand_as(t))

    def ls_case(c, heu, tours, budgets):
        """K4 and K5 on one input; the plain versions count their scans."""
        b, a, n = tours.shape
        hd = two_opt.heuristic_dist(heu)
        budget, t_nls, t_p = budgets
        out = {}
        for name, kern, plain, args, metric_bytes in (
                ("batched_two_opt_euclid", two_opt.batched_two_opt_euclid,
                 two_opt.batched_two_opt_euclid_plain, (c, tours, budget), 0),
                ("batched_nls_euclid", two_opt.batched_nls_euclid,
                 two_opt.batched_nls_euclid_plain,
                 (c, hd, tours, budget, t_nls, t_p), 2 * b * n * n)):
            got = kern(*args)
            scans = {}
            want, plain_ms = timed(lambda: plain(*args, scans=scans))
            ok = bool(torch.equal(got, want) and is_perm(got))
            out[name] = {"passed": ok, "max_abs_err": (got - want).abs().max().item(),
                         "scans": scans, "plain_ms": plain_ms,
                         "ms": cuda_ms(lambda: kern(*args), 3),
                         "bound": ls_bound(n, b, a, scans, metric_bytes)}
            if metric_bytes:   # K5's Euclidean descents alone
                out[name]["ms_t_nls_0"] = cuda_ms(lambda: kern(c, hd, tours, budget, 0, t_p), 3)
            emit({"phase": "kernel", "name": name, "N": n, "B": b, "A": a,
                  "budgets": budgets, "passed": ok, "scans": scans,
                  "ms": out[name]["ms"], "plain_ms": plain_ms,
                  "ms_t_nls_0": out[name].get("ms_t_nls_0"),
                  "bound_ms": out[name]["bound"][0], "bound_by": out[name]["bound"][1],
                  "tolerance": "tours exactly equal, each a permutation"})
        return out

    # the NLS path's own inputs: its B_NLS instances, A ants from city 0
    c_nls = coords[:B_NLS]
    d_nls = distance_matrix(c_nls)
    x_nls = start_node_features(c_nls)
    heu_nls = fused_gnn.tsp_dense_heuristic(nls_net, x_nls, d_nls, K)
    heu_nls_plain = fused_gnn.tsp_dense_heuristic_plain(nls_net, x_nls, d_nls, K)
    k1_nls_ok = bool(torch.allclose(heu_nls, heu_nls_plain, rtol=1e-4, atol=1e-5))
    emit({"phase": "kernel", "name": "tsp_dense_heuristic", "config": "tsp_nls500, one-hot x",
          "B": B_NLS, "passed": k1_nls_ok,
          "max_abs_err": (heu_nls - heu_nls_plain).abs().max().item(),
          "tolerance": "rtol 1e-4, atol 1e-5 (sum order)"})
    if not k1_nls_ok:
        fail("K1 on the NLS configuration disagrees with its plain version")
    score_nls = torch.log(torch.clamp(heu_nls, min=1e-30)).to(torch.bfloat16)
    start_nls = torch.zeros((B_NLS, A), dtype=torch.int64, device=dev)
    sampled = bt.dense_sweep_fused(score_nls, start_nls, gen).transpose(1, 2).contiguous()
    at_500 = ls_case(c_nls, heu_nls, sampled, (LS_BUDGET, 10, 20))
    c_large = uniform_coords(N_LARGE, torch.Generator().manual_seed(SEED + 1),
                             batch=1, device=dev)
    heu_large = fused_gnn.tsp_dense_heuristic(
        nls_net, start_node_features(c_large), distance_matrix(c_large), N_LARGE // 10)
    perms = torch.stack([torch.randperm(N_LARGE, generator=gen, device=dev)
                         for _ in range(2)])[None]
    at_large = ls_case(c_large, heu_large, perms, (50, 1, 5))
    sources = {
        "batched_two_opt_euclid": "deepaco_tpu/ops/pallas_two_opt.py:591 batched_two_opt_euclid; "
                                  "deepaco_tpu/ops/pallas_two_opt.py:535 _tiled_two_opt_call",
        "batched_nls_euclid": "deepaco_tpu/ops/pallas_two_opt.py:631 batched_nls_euclid "
                              "(_nls_kernel:200; _tiled_nls_kernel:476)"}
    for name, replaces in sources.items():
        r = at_500[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/two_opt.cu", "replaces": replaces,
            "max_abs_err": max(r["max_abs_err"], at_large[name]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": None,
            **({"ms_t_nls_0": r["ms_t_nls_0"]} if "ms_t_nls_0" in r else {}),
            "passed": r["passed"] and at_large[name]["passed"],
            **dict(zip(("bound_ms", "bound_by"), r["bound"]))})

    # ---- 4. the main path at full width
    counted = (fused_gnn.tsp_dense_heuristic, bt.dense_sweep_fused,
               bt.fused_tsp_update, two_opt.batched_two_opt_euclid,
               two_opt.batched_nls_euclid, gnn_layer.fused_gnn_layer,
               gnn_layer.fused_gnn_layer_backward, pick.fused_pick,
               deposit.tour_deposit, cc.cvrp_construct, fused_gnn.embnet_layers)

    class PhaseTimer:
        """CUDA events around each phase; read after the run has synchronised."""

        def __init__(self):
            self.events = {}

        @contextlib.contextmanager
        def __call__(self, name):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self.events.setdefault(name, []).append((start, end))

        def ms(self):
            return {k: sum(s.elapsed_time(e) for s, e in v)
                    for k, v in self.events.items()}

        def take(self):
            """The phases' ms since the last take, then forget them."""
            out, self.events = self.ms(), {}
            return out

    def run(net_arg, ops=bt.KERNEL_OPS, inputs=coords, ls=None):
        """One call of the path; the kernels' counts are set to 0 just before
        it and read just after."""
        timer = PhaseTimer()
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, curves = drive(net_arg, inputs, ops._replace(timer=timer), ls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (not bool(torch.isfinite(curves).all())
                or curves.shape != (inputs.shape[0], max(T_VALUES))):
            fail(f"bad curves {tuple(curves.shape)}")
        if not bool((curves[:, 1:] <= curves[:, :-1]).all()):
            fail("an anytime curve rose")
        return (means.tolist(), {fn.__name__: fn.launches for fn in counted},
                wall, timer.ms())

    run(net)                                   # first touch of every path
    means, launches, wall, phase_ms = run(net)
    classic, _, classic_wall, _ = run(None)
    plain, _, plain_wall, _ = run(net, bt.PLAIN_OPS)
    tours = B * max(T_VALUES) * A
    emit({"phase": "main_path", "B": B, "N": N, "K": K, "A": A,
          "T": list(T_VALUES), "neural_cost": means, "classic_cost": classic,
          "plain_cost": plain, "wall_s": wall, "tours_per_s": tours / wall,
          "phase_ms": phase_ms, "launches": launches,
          "classic_wall_s": classic_wall, "plain_wall_s": plain_wall})

    # ---- 5. the NLS path: neural + NLS through the kernels and the plain
    # versions, classic + 2-opt through the kernels
    nls_coords = coords[:B_NLS]
    arms = {}
    for arm, net_arg, ls, ops in (("nls", nls_net, "nls", bt.KERNEL_OPS),
                                  ("classic_2opt", None, "2opt", bt.KERNEL_OPS),
                                  ("nls_plain", nls_net, "nls", bt.PLAIN_OPS)):
        cost, counts, arm_wall, arm_ms = run(net_arg, ops, nls_coords, ls)
        arms[arm] = {"cost": cost, "launches": counts, "wall_s": arm_wall,
                     "tours_per_s": B_NLS * max(T_VALUES) * A / arm_wall,
                     "phase_ms": arm_ms}
    emit({"phase": "nls_path", "B": B_NLS, "N": N, "K": K, "A": A,
          "T": list(T_VALUES), "ls_budget": LS_BUDGET, **arms})
    # ---- 6. the training kernels against their plain versions
    row8_ok = check_training_kernels(dev, cuda_ms, kernels)

    # ---- 7. one training step, kernel arm against plain arm
    step_checks = [train_step_arms(dev, name) for name in TRAIN_STEPS]
    for check in step_checks:
        emit(check)

    # ---- 8. train_tsp in both configurations, then save, reload, evaluate
    def train_run(name):
        """``train_tsp`` on the card (its default device); the kernels'
        counts are set to 0 just before it and read just after."""
        cfg, net_kwargs, ls = train_configs()[name]
        timer, rows = PhaseTimer(), []
        last = [0.0]

        def progress(i, info):
            torch.cuda.synchronize()
            now = time.perf_counter()
            rows.append({"step": i, "loss": info.loss.item(),
                         "mean_cost": info.mean_cost.item(),
                         "grad_norm": info.grad_norm.item(),
                         "wall_ms": (now - last[0]) * 1e3, "phase_ms": timer.take()})
            last[0] = time.perf_counter()

        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        state = tr.train_tsp(Net(**net_kwargs), cfg, local_search=ls, progress=progress,
                             max_steps=TRAIN_STEPS[name],
                             _ops=tr.KERNEL_OPS._replace(timer=timer))
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counted}
        start = init_like_flax(Net(**net_kwargs).to(dev),
                               torch.Generator(device=dev).manual_seed(cfg.train.seed))
        moved = all(not torch.equal(a, b) for (k, a), b in zip(
            start.state_dict().items(), state.net.state_dict().values())
            if a.dim() == 2 or "running" in k)
        finite = all(math.isfinite(r[key]) for r in rows
                     for key in ("loss", "mean_cost", "grad_norm"))
        emit({"phase": "train", "config": name, "B": cfg.train.batch_size, "N": N,
              "K": K, "A": cfg.aco.n_ants, "lr": cfg.train.lr,
              "cosine": cfg.train.cosine_schedule, "steps": rows, "launches": counts,
              "weights_moved": moved, "finite": finite})
        if not (moved and finite and len(rows) == TRAIN_STEPS[name]):
            fail(f"training {name}: moved {moved}, finite {finite}, {len(rows)} steps")
        return state, counts

    train_runs = {name: train_run(name) for name in TRAIN_STEPS}
    nls_state, train_launches = train_runs["tsp500_nls"]
    ckpt = root / "build" / "chip_smoke" / "tsp500_nls_trained.msgpack"
    save_checkpoint(str(ckpt), nls_state)
    tree = load_checkpoint(str(ckpt))
    reloaded = Net.from_jax_variables(tree).to(dev)
    same = all(torch.equal(a, b) for a, b in zip(nls_state.net.state_dict().values(),
                                                   reloaded.state_dict().values()))
    restored = tr.restore_train_state(tree, Net(feats=1).to(dev), train_configs()["tsp500_nls"][0])
    reload_cost, reload_curves = evaluate_tsp(coords[:4], net=reloaded, k_sparse=K,
                                              cfg=ACOConfig(n_ants=A), t_values=(1,),
                                              seed=SEED, ls="nls")
    reload_ok = (same and restored.step == TRAIN_STEPS["tsp500_nls"]
                 and bool(torch.isfinite(reload_curves).all()))
    emit({"phase": "checkpoint", "file": str(ckpt.relative_to(root)),
          "bytes": ckpt.stat().st_size, "weights_equal": same, "step": int(tree["step"]),
          "evaluate_tsp_nls_cost": reload_cost.tolist(), "passed": reload_ok})

    # ---- 9. K8, K7, K7c, K6 and K9 at the CVRP path's shapes
    cvrp_net, cvrp_ds = cvrp_inputs(root, dev)
    cvrp_paths, cvrp_amounts, cvrp_picks = cvrp_rollout(dev, cvrp_ds)
    kernels.append(check_deposit(dev, cuda_ms, paths_k, 1.0 / costs_p, cvrp_paths,
                                 cvrp_amounts))
    pick_501 = check_pick_at_cvrp_shape(cuda_ms, cvrp_picks)
    emit({"phase": "kernel", "name": "fused_pick", "config": "cvrp500 rollout, N = 501",
          **pick_501, "tolerance": "actions exact and allowed; logp rtol 1e-5, atol 1e-5 "
                                   "(logsumexp order, expf/logf against torch's)"})
    kernels.append(check_cvrp_construct(dev, cuda_ms, cvrp_ds))
    layer_501 = check_layer_at_cvrp_width(dev, cuda_ms, cvrp_net, cvrp_ds)
    emit({"phase": "kernel", "name": "fused_gnn_layer", "config": "cvrp500, K = N = 501",
          **layer_501, "tolerance": "rtol 1e-5, atol 1e-5 (sum order)"})
    k9_501 = check_embnet_layers(cuda_ms, cvrp_net, cvrp_graph(
        torch.as_tensor(cvrp_ds["demand"], device=dev),
        torch.as_tensor(cvrp_ds["dist"], device=dev)), "cvrp500, K = N = 501")

    # ---- 10. the CVRP path: kernel, plain and classic arms
    cvrp_dist = torch.as_tensor(cvrp_ds["dist"], device=dev)
    cvrp_demand = torch.as_tensor(cvrp_ds["demand"], device=dev)
    cvrp_b = cvrp_dist.shape[0]

    def cvrp_run(net_arg, ops):
        """One call of the CVRP path; the kernels' counts are set to 0 just
        before it and read just after."""
        timer = PhaseTimer()
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cost, curves, state = drive_cvrp(net_arg, cvrp_ds, ops._replace(timer=timer))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (not bool(torch.isfinite(curves).all())
                or curves.shape != (cvrp_b, max(T_VALUES))):
            fail(f"bad CVRP curves {tuple(curves.shape)}")
        if not bool((curves[:, 1:] <= curves[:, :-1]).all()):
            fail("a CVRP anytime curve rose")
        best = state.best_path[..., None]
        valid = validate_routes(best, cvrp_demand, CVRP_CAPACITY)[:, 0]
        recost = route_cost(cvrp_dist, best)[:, 0]
        return {"cost": cost.tolist(), "wall_s": wall, "phase_ms": timer.ms(),
                "launches": {fn.__name__: fn.launches for fn in (
                    fused_gnn.embnet_layers, gnn_layer.fused_gnn_layer, pick.fused_pick,
                    deposit.tour_deposit, cc.cvrp_construct)},
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "valid_best_routes": int(valid.sum()),
                "best_cost_is_route_cost": bool(torch.allclose(recost, state.best_cost,
                                                               rtol=1e-5))}

    cvrp_arms = {"kernel": cvrp_run(cvrp_net, drivers.KERNEL_OPS),
                 "plain": cvrp_run(cvrp_net, drivers.PLAIN_OPS),
                 "classic": cvrp_run(None, drivers.KERNEL_OPS)}
    emit({"phase": "cvrp_path", "B": cvrp_b, "N": CVRP_N + 1, "A": A,
          "T": list(T_VALUES), "capacity": CVRP_CAPACITY, **cvrp_arms})

    # ---- 11. K9 and row 9 against their plain versions
    sparse_net, sparse_g = sparse_inputs(root, dev)
    kernels.append(check_embnet_layers(cuda_ms, sparse_net, sparse_g, "sparse tsp2000, K = 200"))
    del sparse_net, sparse_g
    kernels.append(check_row9(dev, cuda_ms, torch.log(heu[0])))

    # ---- 12. the sparse path: kernel, plain, classic and classic + 2-opt arms
    from deepaco_tpu_torch.aco import large_tsp

    sparse_counted = (fused_gnn.embnet_layers, two_opt.batched_two_opt_euclid,
                      bt.tsp_sweep_construct)

    def sparse_run(args, ops):
        """One call of the sparse path; the kernels' counts are set to 0 just
        before it and read just after."""
        timer, stats = PhaseTimer(), {}
        for fn in counted + sparse_counted:
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        means, curves, lines = drive_sparse(args, ops._replace(timer=timer), stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b, t_max = curves.shape
        if not bool(torch.isfinite(curves).all()) or t_max != max(args.t_aco):
            fail(f"bad sparse curves {tuple(curves.shape)}")
        if not bool((curves[:, 1:] <= curves[:, :-1]).all()):
            fail("a sparse anytime curve rose")
        best = stats["best"]
        ident = torch.arange(SPARSE_N, device=dev).expand_as(best)
        recost = large_tsp.tour_cost_coords(stats["coords"], best[..., None])[:, 0]
        return {"B": b, "T": list(args.t_aco), "cost": means.tolist(), "cli": lines,
                "wall_s": wall, "tours_per_s": b * t_max * A / wall,
                "phase_ms": timer.ms(),
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "launches": {fn.__name__: fn.launches for fn in sparse_counted},
                "fallback_rate": stats["fallback_steps"] / stats["ant_steps"],
                "dropped_deposit_rate": stats["off_support_edges"] / stats["tour_edges"],
                "valid_best_tours": int((torch.sort(best, dim=1).values == ident).all(1).sum()),
                "best_cost_is_tour_cost": bool(torch.allclose(recost, curves[:, -1], rtol=1e-5))}

    sparse_arms = {
        "kernel": sparse_run(sparse_args(root), large_tsp.KERNEL_OPS),
        "plain": sparse_run(sparse_args(root), large_tsp.PLAIN_OPS),
        "classic": sparse_run(sparse_args(root, "--classic"), large_tsp.KERNEL_OPS),
        "classic_2opt": sparse_run(sparse_args(root, "--classic", "--local-search", "2opt",
                                               t_values=SPARSE_LS_T, limit=SPARSE_LS_B),
                                   large_tsp.KERNEL_OPS)}
    emit({"phase": "sparse_path", "N": SPARSE_N, "K": SPARSE_N // 10, "A": A,
          "ckpt": CKPT, "jax_recorded": {"fallback_rate": 0.00387,
                                         "dropped_deposit_rate": 0.00432,
                                         "classic_cost_t5_one_instance": 164.003},
          **sparse_arms})

    path_launches = {**launches,
                     "embnet_layers": (sparse_arms["kernel"]["launches"]["embnet_layers"]
                                       + cvrp_arms["kernel"]["launches"]["embnet_layers"]),
                     "tsp_sweep_construct": sparse_arms["kernel"]["launches"]["tsp_sweep_construct"],
                     "tour_deposit": cvrp_arms["kernel"]["launches"]["tour_deposit"],
                     "cvrp_construct": cvrp_arms["kernel"]["launches"]["cvrp_construct"],
                     "batched_two_opt_euclid": arms["classic_2opt"]["launches"]["batched_two_opt_euclid"],
                     "batched_nls_euclid": arms["nls"]["launches"]["batched_nls_euclid"],
                     **{fn.__name__: train_launches[fn.__name__] for fn in (
                         gnn_layer.fused_gnn_layer, gnn_layer.fused_gnn_layer_backward,
                         pick.fused_pick)}}
    for entry in kernels:
        entry["launches"] = path_launches[entry["name"]]

    # ---- 13. the kernels' line
    emit({"kernels": kernels})
    failed = [k["name"] for k in kernels if not k["passed"]]
    if failed:
        fail(f"kernels disagree with their plain versions: {failed}")
    if not row8_ok:
        fail("gated_mean_aggregate (row 8, K6 without pre) disagrees with its plain version")
    on_paths = {k: v for k, v in path_launches.items() if k != "tsp_sweep_construct"}
    if min(on_paths.values()) <= 0:
        fail(f"a kernel never launched on its path: {path_launches}")
    if abs(means[-1] - plain[-1]) > 0.01 * plain[-1]:
        fail(f"kernel path cost@T10 {means[-1]} vs plain {plain[-1]}")
    if not means[-1] < classic[-1]:
        fail(f"neural cost@T10 {means[-1]} not below classic {classic[-1]}")
    nls, nls_plain = arms["nls"]["cost"], arms["nls_plain"]["cost"]
    if abs(nls[-1] - nls_plain[-1]) > 0.01 * nls_plain[-1]:
        fail(f"NLS kernel path cost@T10 {nls[-1]} vs plain {nls_plain[-1]}")
    if not nls[0] < means[-1]:
        fail(f"NLS cost@T1 {nls[0]} not below the main path's cost@T10 {means[-1]}")
    failed_steps = [c["config"] for c in step_checks if not c["passed"]]
    if failed_steps:
        fail(f"kernel and plain train steps disagree: {failed_steps}")
    if not reload_ok:
        fail("the saved training state did not reload and evaluate")
    k8 = next(k for k in kernels if k["name"] == "tour_deposit")
    if not k8["below_library"]:
        fail(f"K8 is not faster than scatter_add: {k8['ms']} / {k8['library_ms']} ms (CVRP), "
             f"{k8['tsp_ms']} / {k8['tsp_library_ms']} ms (TSP)")
    if not layer_501["passed"]:
        fail("K6 disagrees with its plain version at K = N = 501")
    if not k9_501["passed"]:
        fail("K9 disagrees with its plain version on the CVRP path's graph")
    if not pick_501["passed"]:
        fail("K7 disagrees with its plain version on the CVRP rollout's rows")
    ck, cp, cc = (cvrp_arms[arm]["cost"] for arm in ("kernel", "plain", "classic"))
    # the two arms draw the same noise, so at T1 only K9's rounding (1e-6)
    # can part them; a wrong pick moves cost@T1 by far more than 1e-4
    if abs(ck[0] - cp[0]) > 1e-4 * cp[0]:
        fail(f"CVRP kernel path cost@T1 {ck[0]} vs plain {cp[0]}")
    if abs(ck[-1] - cp[-1]) > 0.01 * cp[-1]:
        fail(f"CVRP kernel path cost@T10 {ck[-1]} vs plain {cp[-1]}")
    if abs(ck[-1] - PER_STEP_CVRP_T10) > 0.01 * PER_STEP_CVRP_T10:
        fail(f"CVRP kernel path cost@T10 {ck[-1]} vs the per-step route's {PER_STEP_CVRP_T10}")
    if not ck[-1] < cc[-1]:
        fail(f"CVRP neural cost@T10 {ck[-1]} not below classic {cc[-1]}")
    for arm, r in cvrp_arms.items():
        if r["valid_best_routes"] != cvrp_b or not r["best_cost_is_route_cost"]:
            fail(f"CVRP {arm} arm: {r['valid_best_routes']} of {cvrp_b} best routes valid, "
                 f"costs match {r['best_cost_is_route_cost']}")
    t_max = max(T_VALUES)
    want = {"kernel": {"embnet_layers": 1, "fused_gnn_layer": 0, "fused_pick": 0,
                       "tour_deposit": t_max, "cvrp_construct": t_max},
            "plain": {"embnet_layers": 0, "fused_gnn_layer": 0, "fused_pick": 0,
                      "tour_deposit": 0, "cvrp_construct": 0},
            "classic": {"embnet_layers": 0, "fused_gnn_layer": 0, "fused_pick": 0,
                        "tour_deposit": t_max, "cvrp_construct": t_max}}
    for arm, counts in want.items():
        if cvrp_arms[arm]["launches"] != counts:
            fail(f"CVRP {arm} arm launched {cvrp_arms[arm]['launches']}, expected {counts}")
    sk, sp = sparse_arms["kernel"]["cost"], sparse_arms["plain"]["cost"]
    # the two arms draw the same noise; only K9's rounding parts them
    if abs(sk[0] - sp[0]) > 1e-4 * sp[0]:
        fail(f"sparse kernel path cost@T1 {sk[0]} vs plain {sp[0]}")
    if abs(sk[-1] - sp[-1]) > 0.01 * sp[-1]:
        fail(f"sparse kernel path cost@T10 {sk[-1]} vs plain {sp[-1]}")
    sparse_want = {"kernel": {"embnet_layers": 1, "batched_two_opt_euclid": 0},
                   "plain": {"embnet_layers": 0, "batched_two_opt_euclid": 0},
                   "classic": {"embnet_layers": 0, "batched_two_opt_euclid": 0},
                   "classic_2opt": {"embnet_layers": 0,
                                    "batched_two_opt_euclid": max(SPARSE_LS_T)}}
    for arm, r in sparse_arms.items():
        if r["valid_best_tours"] != r["B"] or not r["best_cost_is_tour_cost"]:
            fail(f"sparse {arm} arm: {r['valid_best_tours']} of {r['B']} best tours valid, "
                 f"costs match {r['best_cost_is_tour_cost']}")
        got = {k: r["launches"][k] for k in sparse_want[arm]}
        if got != sparse_want[arm]:
            fail(f"sparse {arm} arm launched {r['launches']}, expected {sparse_want[arm]}")
    if not sparse_arms["classic_2opt"]["cost"][0] < sparse_arms["classic"]["cost"][0]:
        fail("2-opt did not shorten the classic arm's tours at T1")
    costs = {"main": means, "main_plain": plain, "nls": nls, "nls_plain": nls_plain,
             "cvrp": ck, "sparse": sk, "sparse_plain": sp}
    for path, recorded in RECORDED_COSTS.items():
        for got, want in zip(costs[path], recorded):
            if want is not None and round(got, 4) != want:
                fail(f"{path} path cost {costs[path]} differs from the recorded {recorded}")
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
