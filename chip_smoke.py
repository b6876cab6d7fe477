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
6. ``{"kernels": [...]}``: per kernel its launches (K1-K3 from the main
   path, K4 from the 2-opt arm, K5 from the NLS arm), error, times and bound.

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
NLS_CKPT = "checkpoints/tsp_nls500_selftrained.msgpack"
B_NLS, N_LARGE, LS_BUDGET = 16, 1100, 10000
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost
    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.ops import _build, fused_gnn, two_opt
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
               two_opt.batched_nls_euclid)

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
    path_launches = {**launches,
                     "batched_two_opt_euclid": arms["classic_2opt"]["launches"]["batched_two_opt_euclid"],
                     "batched_nls_euclid": arms["nls"]["launches"]["batched_nls_euclid"]}
    for entry in kernels:
        entry["launches"] = path_launches[entry["name"]]

    # ---- 6. the kernels' line
    emit({"kernels": kernels})
    failed = [k["name"] for k in kernels if not k["passed"]]
    if failed:
        fail(f"kernels disagree with their plain versions: {failed}")
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
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
