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
   within 2% of the plain sweep's, K3 tau' and costs at rtol 1e-6;
3. K1 on the NLS configuration, then K4 (2-opt) and K5 (NLS) against their
   plain versions, tours exactly equal and permutations: on the NLS path's
   own inputs (its B=16 instances, N=500, tours that K2 samples from city 0
   on the ``tsp_nls500_selftrained`` heuristic, A=20, budget 10000, t_nls
   10, t_p 20), and at N=1100 on random permutations (A=2, budget 50,
   t_nls 1, t_p 5); K5 with the real asymmetric metric ``heuristic_dist``;
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
9. ``{"kernels": [...]}``: per kernel its launches (K1-K3 from the main
   path, K4 from the 2-opt arm, K5 from the NLS arm, K6 and K7 from the
   TSP500-NLS training run), error, times and bound.

Then the ``nvidia-smi`` line again and, last, ``{"ok": true, "device": ...}``.
Any failed check exits non-zero. Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import json
import math
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    edges = b * N * K

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
    row8.update(zip(("bound_ms", "bound_by"), bound(
        4 * (edges * u + 2 * b * N * u) + 4 * edges, 4 * edges * u)))
    emit(row8)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer(*args), 20)
        fwd_plain_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer_plain(*args), 5)
    bwd_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer_backward(x2, index, w, ew, ca, cp), 20)
    bwd_plain_ms = cuda_ms(
        lambda: gnn_layer.fused_gnn_layer_backward_plain(x2, nbr, w, ew, ca, cp), 5)
    # forward: w and pre, x2/x3/x4/agg, nbr (int32), ew, eb; the edge
    # product (2 U^2 an edge) and the gate, mean and sums (5 U an edge)
    fwd_bytes = 4 * (2 * edges * u + 4 * b * N * u + edges + u * u + u)
    fwd_ops = 2 * edges * u * u + 5 * edges * u
    # backward: w, d_pre, x2, d_agg, nbr and the reverse adjacency in; d_w,
    # d_x2, d_x3, d_x4, d_ew, d_eb out; d_pre @ ew^T and w^T d_pre (2 U^2 an
    # edge each) and about 10 U an edge for the gate, sums and scatters
    bwd_bytes = 4 * (3 * edges * u + 5 * b * N * u + 2 * edges + b * (N + 1)
                     + 2 * u * u + 2 * u)
    bwd_ops = 4 * edges * u * u + 10 * edges * u
    kernels.append({
        "name": "fused_gnn_layer", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/gnn_layer.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:203",
        "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
        "library_ms": None, "passed": fwd_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(fwd_bytes, fwd_ops)))})
    kernels.append({
        "name": "fused_gnn_layer_backward", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/gnn_layer.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:275 (fused_gnn_layer_ad, _fused_ad_bwd 290)",
        "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "library_ms": None, "passed": bwd_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(bwd_bytes, bwd_ops)))})
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
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.eval.anytime import evaluate_tsp
    from deepaco_tpu_torch.models.gnn import Net, init_like_flax
    from deepaco_tpu_torch.ops import _build, fused_gnn, gnn_layer, pick, two_opt
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
    # multiply-adds of the node pass, the edge products and the head, and
    # one compare per candidate column for each row's top-K selection
    k1_ops = (layers * (2 * B * N * u * 4 * u + 2 * B * N * K * u * u)
              + 4 * B * N * K * u * u + B * N * N)
    k1_bytes = 4 * (2 * B * N * N + B * N * feats)
    kernels.append({
        "name": "tsp_dense_heuristic", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/dense_heuristic.cu",
        "replaces": "deepaco_tpu/ops/fused_gnn.py:416",
        "max_abs_err": k1_err,
        "ms": cuda_ms(lambda: fused_gnn.tsp_dense_heuristic(net, coords, dist, K), 5),
        "plain_ms": cuda_ms(lambda: fused_gnn.tsp_dense_heuristic_plain(net, coords, dist, K), 2),
        "library_ms": None, "passed": k1_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(k1_bytes, k1_ops)))})
    emit({"phase": "kernel", "name": "tsp_dense_heuristic", "passed": k1_ok,
          "max_abs_err": k1_err, "max_log_err_on_support": k1_log_err,
          "support_min": on_p.min().item(),
          "support_median": on_p.median().item(),
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

    tau = 0.5 + torch.rand((B, N, N), generator=gen, device=dev)
    tau_k, costs_k = bt.fused_tsp_update(tau, paths_k, dist, decay=0.9, q=1.0)
    tau_p, costs_p = bt.fused_tsp_update_plain(tau, paths_k, dist, decay=0.9, q=1.0)
    k3_ok = bool(torch.allclose(tau_k, tau_p, rtol=1e-6, atol=0)
                 and torch.allclose(costs_k, costs_p, rtol=1e-6, atol=0))
    k3_err = max((tau_k - tau_p).abs().max().item(),
                 (costs_k - costs_p).abs().max().item())
    # library yardstick: one index_put_ of the 2*B*A*N deposits onto decay*tau
    bi = torch.arange(B, device=dev)[:, None, None].expand(B, A, N).reshape(-1)
    uu = paths_k.transpose(1, 2)
    vv = torch.roll(uu, 1, dims=-1)
    amounts = (1.0 / costs_p)[..., None].expand(B, A, N).reshape(-1)
    index = (torch.cat([bi, bi]), torch.cat([uu.reshape(-1), vv.reshape(-1)]),
             torch.cat([vv.reshape(-1), uu.reshape(-1)]))
    values = torch.cat([amounts, amounts])
    decayed = tau * 0.9
    k3_bytes = 4 * (2 * B * N * N + B * A * N + B * A) + 4 * B * N * A
    k3_ops = 2 * B * N * N + 3 * B * A * N
    kernels.append({
        "name": "fused_tsp_update", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/as_update.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:401",
        "max_abs_err": k3_err,
        "ms": cuda_ms(lambda: bt.fused_tsp_update(tau, paths_k, dist, decay=0.9, q=1.0), 20),
        "plain_ms": cuda_ms(lambda: bt.fused_tsp_update_plain(
            tau, paths_k, dist, decay=0.9, q=1.0), 5),
        "library_ms": cuda_ms(lambda: decayed.clone().index_put_(
            index, values, accumulate=True), 20),
        "passed": k3_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(k3_bytes, k3_ops)))})
    emit({"phase": "kernel", "name": "fused_tsp_update", "passed": k3_ok,
          "max_abs_err": k3_err, "tolerance": "tau' and costs at rtol 1e-6"})

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
            emit({"phase": "kernel", "name": name, "N": n, "B": b, "A": a,
                  "budgets": budgets, "passed": ok, "scans": scans,
                  "ms": out[name]["ms"], "plain_ms": plain_ms,
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
            "passed": r["passed"] and at_large[name]["passed"],
            **dict(zip(("bound_ms", "bound_by"), r["bound"]))})

    # ---- 4. the main path at full width
    counted = (fused_gnn.tsp_dense_heuristic, bt.dense_sweep_fused,
               bt.fused_tsp_update, two_opt.batched_two_opt_euclid,
               two_opt.batched_nls_euclid, gnn_layer.fused_gnn_layer,
               gnn_layer.fused_gnn_layer_backward, pick.fused_pick)

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

    path_launches = {**launches,
                     "batched_two_opt_euclid": arms["classic_2opt"]["launches"]["batched_two_opt_euclid"],
                     "batched_nls_euclid": arms["nls"]["launches"]["batched_nls_euclid"],
                     **{fn.__name__: train_launches[fn.__name__] for fn in (
                         gnn_layer.fused_gnn_layer, gnn_layer.fused_gnn_layer_backward,
                         pick.fused_pick)}}
    for entry in kernels:
        entry["launches"] = path_launches[entry["name"]]

    # ---- 9. the kernels' line
    emit({"kernels": kernels})
    failed = [k["name"] for k in kernels if not k["passed"]]
    if failed:
        fail(f"kernels disagree with their plain versions: {failed}")
    if not row8_ok:
        fail("gated_mean_aggregate (row 8, K6 without pre) disagrees with its plain version")
    if min(path_launches.values()) <= 0:
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
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
