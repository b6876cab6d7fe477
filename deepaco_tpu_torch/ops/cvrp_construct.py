"""The CVRP construction of one ACO iteration, every step of every ant
(counterpart, on the inference path, of the construction scan
``deepaco_tpu/aco/engine.py:104-129`` over ``deepaco_tpu/aco/problems/cvrp.py``,
whose step is ``deepaco_tpu/ops/pallas_kernels.py:65 fused_pick_pallas``).

It computes ``engine.rollout(cvrp_spec(...)).paths`` in the same law: over
``score [B, N, N]`` f32 (``score_matrix(tau, heu, alpha, beta)``), ``demand
[B, N]`` (0 at the depot) and ``capacity``, each of ``A`` ants an instance
starts at node 0 and at each of ``2(N-1)`` steps

    open   = not visited(c) and demand[c] <= capacity - used      (f32)
    logits = where(open, score[b, cur, :], -1e30)
    pick   = first argmax(logits + g)                 NaN above every number

where the depot counts as visited right after a depot pick while customers
remain, ``used`` resets at a depot pick and then adds the pick's demand.
The noise ``g`` is :func:`~deepaco_tpu_torch.ops.philox.philox_gumbel`:
``gumbel_f32_from_bits`` of Philox4x32-10 keyed by one 62-bit seed drawn
from the caller's generator per call, with the counter ``(column // 4,
step, b * A + a, 0)`` and word ``column % 4``, as kernel K2 draws its f32
noise (``ops/philox.py``, the counterpart of ``csrc/common.cuh``).

- :func:`cvrp_construct_plain`: that loop in PyTorch, the noise of a chunk
  of steps drawn in one call;
- :func:`cvrp_construct`: the wrapper. A CPU tensor takes the plain version;
  a CUDA tensor launches kernel K7c (``csrc/cvrp_sweep.cu``) or raises. At
  equal generator state their paths are equal, bit for bit.

K7c takes N <= 4096 (:func:`cvrp_construct_supported`); past that the CVRP
family constructs step by step through K7 (``aco/problems/cvrp.cvrp_paths``).
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.ops import _build
from deepaco_tpu_torch.ops.philox import draw_seed, philox_gumbel

NEG_INF = -1e30
CVRP_CONSTRUCT_MAX_N = 4096     # 8 groups of 4 columns a thread, 4 warps an ant
_CHUNK_COUNTERS = 1 << 22       # Philox counters a chunk of the plain version's noise


def cvrp_construct_supported(n: int) -> bool:
    """Whether K7c takes ``n`` nodes (the depot and ``n - 1`` customers)."""
    return 1 <= n <= CVRP_CONSTRUCT_MAX_N


@torch.no_grad()
def cvrp_construct_plain(score: torch.Tensor, demand: torch.Tensor, capacity: float,
                         n_ants: int, generator: torch.Generator, *,
                         stochastic: bool = True) -> torch.Tensor:
    """Plain version of K7c: paths ``[B, 2(N-1)+1, A]`` int64, row 0 the
    depot. Once every ant of the batch is back at the depot with every
    customer served (at the end of a chunk of steps) and no instance's
    ``score[b, 0, 0]`` lies below -1e30, the remaining picks are the depot's
    with certainty and are written without drawing."""
    b, n, _ = score.shape
    dev = score.device
    key = int(draw_seed(generator, dev).item())
    r = b * n_ants
    rows = 2 * (n - 1) + 1
    base = torch.arange(b, device=dev).repeat_interleave(n_ants) * n    # [R]
    flat_score = score.reshape(b * n, n)
    dem_flat = demand.reshape(-1)
    dem_rows = demand.repeat_interleave(n_ants, dim=0)                   # [R, N]
    park = not bool((score[:, 0, 0] < NEG_INF).any())
    zero = torch.zeros((r,), dtype=torch.int64, device=dev)
    closed = torch.zeros((r, n), dtype=torch.bool, device=dev)           # visited; col 0: depot
    left = torch.full((r,), n - 1, dtype=torch.int64, device=dev)
    used = torch.zeros((r,), dtype=score.dtype, device=dev)

    def step(cur, left, used):
        """The plug-in's state update for the picks ``cur [R]``."""
        was = closed.gather(1, cur[:, None])[:, 0]
        left = left - ((cur != 0) & ~was).long()
        closed.scatter_(1, cur[:, None], True)
        used = torch.where(cur == 0, 0.0, used) + dem_flat[base + cur]
        closed[:, 0] = (cur == 0) & (left > 0)
        return left, used

    cur = zero
    left, used = step(cur, left, used)
    picks = [cur]
    chunk = max(1, _CHUNK_COUNTERS // (r * ((n + 3) // 4)))
    s = 0
    while s < rows - 1:
        if park and bool(((cur == 0) & (left == 0)).all()):
            break
        steps = min(chunk, rows - 1 - s)
        noise = philox_gumbel(key, s, steps, r, n, dev) if stochastic else None
        for i in range(steps):
            rows_now = flat_score.index_select(0, base + cur)
            open_ = ~closed & (dem_rows <= (capacity - used)[:, None])
            logits = torch.where(open_, rows_now, NEG_INF)
            if stochastic:
                logits = logits + noise[i]
            cur = torch.argmax(logits, dim=-1)
            left, used = step(cur, left, used)
            picks.append(cur)
        s += steps
    picks += [zero] * (rows - len(picks))
    return torch.stack(picks, dim=0).reshape(rows, b, n_ants).transpose(0, 1).contiguous()


def cvrp_construct(score: torch.Tensor, demand: torch.Tensor, capacity: float,
                   n_ants: int, generator: torch.Generator, *,
                   stochastic: bool = True) -> torch.Tensor:
    """:func:`cvrp_construct_plain` as one launch of kernel K7c (one to four
    warps walk each ant through all its steps; the same Philox noise)."""
    if score.device.type == "cpu":
        return cvrp_construct_plain(score, demand, capacity, n_ants, generator,
                                    stochastic=stochastic)
    _build.require_cuda("cvrp_construct", score, demand)
    b, n, _ = score.shape
    if score.shape != (b, n, n) or demand.shape != (b, n):
        raise ValueError("cvrp_construct: expected score [B, N, N] and demand [B, N]")
    if score.dtype != torch.float32 or demand.dtype != torch.float32:
        raise ValueError("cvrp_construct: K7c takes f32 score and demand")
    if not cvrp_construct_supported(n):
        raise ValueError(f"cvrp_construct: K7c takes N <= {CVRP_CONSTRUCT_MAX_N}, got {n}")
    paths = _launch(score.contiguous(), demand.contiguous(), capacity, n_ants, generator,
                    stochastic)
    cvrp_construct.launches += 1
    return paths


def _launch(score, demand, capacity, n_ants, generator, stochastic):
    """Allocate the paths, draw the seed and call K7c's entry point."""
    b, n, _ = score.shape
    dev = score.device
    paths = torch.empty((b, 2 * (n - 1) + 1, n_ants), dtype=torch.int64, device=dev)
    seed = draw_seed(generator, dev)
    if b * n_ants == 0:
        return paths
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("deepaco_cvrp_sweep", [P] * 4 + [F] + [I] * 4 + [P])
    rc = fn(score.data_ptr(), demand.data_ptr(), paths.data_ptr(), seed.data_ptr(),
            capacity, b, n, n_ants, int(stochastic), _build.stream_ptr(dev))
    _build.check(rc, "deepaco_cvrp_sweep")
    return paths


cvrp_construct.launches = 0
