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
3. the main path: ``evaluate_tsp`` on the neural arm with the
   ``tsp500_selftrained`` weights (T=1 and 10), its phase times and each
   kernel's launches in that run; the classic arm on the same batch; and the
   plain path on the card, whose cost@T10 the kernel path must match to 1%;
4. ``{"kernels": [...]}``: per kernel its launches, error, times and bound.

Then the ``nvidia-smi`` line again and, last, ``{"ok": true, "device": ...}``.
Any failed check exits non-zero. Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

N, K, A, B, T_VALUES, SEED = 500, 50, 20, 100, (1, 10), 0
CKPT = "checkpoints/tsp500_selftrained.msgpack"
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


def main_path_inputs(root: Path, dev):
    """The main path's weights (``tsp500_selftrained``) and its B seeded
    instances of N uniform cities."""
    import torch

    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
    from deepaco_tpu_torch.utils.datasets import uniform_coords

    net = Net.from_jax_variables(load_checkpoint(str(root / CKPT))).to(dev)
    coords = uniform_coords(N, torch.Generator().manual_seed(SEED), batch=B,
                            device=dev)
    return net, coords


def drive(net, coords, ops=None):
    """One call of the main path's entry point, ``evaluate_tsp`` (``net=None``
    is the classic arm); ``ops`` swaps in the plain versions or a timer."""
    from deepaco_tpu_torch.aco.batched_tsp import KERNEL_OPS
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.eval.anytime import evaluate_tsp

    return evaluate_tsp(coords, net=net, k_sparse=K, cfg=ACOConfig(n_ants=A),
                        t_values=T_VALUES, seed=SEED, _ops=ops or KERNEL_OPS)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.ops import _build, fused_gnn
    from deepaco_tpu_torch.utils.datasets import distance_matrix

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

    # ---- 2. each kernel against its plain version, at the main path's shapes
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

    # ---- 3. the main path at full width
    counted = (fused_gnn.tsp_dense_heuristic, bt.dense_sweep_fused,
               bt.fused_tsp_update)

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

    def run(net_arg, ops=bt.KERNEL_OPS):
        timer = PhaseTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, curves = drive(net_arg, coords, ops._replace(timer=timer))
        torch.cuda.synchronize()
        return means.tolist(), curves, time.perf_counter() - t0, timer.ms()

    run(net)                                   # first touch of every path
    for fn in counted:
        fn.launches = 0
    means, curves, wall, phase_ms = run(net)
    launches = {fn.__name__: fn.launches for fn in counted}
    if not bool(torch.isfinite(curves).all()) or curves.shape != (B, max(T_VALUES)):
        fail(f"bad curves {tuple(curves.shape)}")
    if not bool((curves[:, 1:] <= curves[:, :-1]).all()):
        fail("an anytime curve rose")
    classic, _, classic_wall, _ = run(None)
    plain, _, plain_wall, _ = run(net, bt.PLAIN_OPS)
    tours = B * max(T_VALUES) * A
    emit({"phase": "main_path", "B": B, "N": N, "K": K, "A": A,
          "T": list(T_VALUES), "neural_cost": means, "classic_cost": classic,
          "plain_cost": plain, "wall_s": wall, "tours_per_s": tours / wall,
          "phase_ms": phase_ms, "launches": launches,
          "classic_wall_s": classic_wall, "plain_wall_s": plain_wall})
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]

    # ---- 4. the kernels' line
    emit({"kernels": kernels})
    failed = [k["name"] for k in kernels if not k["passed"]]
    if failed:
        fail(f"kernels disagree with their plain versions: {failed}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if abs(means[-1] - plain[-1]) > 0.01 * plain[-1]:
        fail(f"kernel path cost@T10 {means[-1]} vs plain {plain[-1]}")
    if not means[-1] < classic[-1]:
        fail(f"neural cost@T10 {means[-1]} not below classic {classic[-1]}")
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
