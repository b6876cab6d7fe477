"""A whole sampled construction with its log-probabilities, every step of
every ant in one launch forward and one launch backward: kernel K7r, the
training counterpart of the construction scan
``deepaco_tpu/aco/engine.py:104-129`` (``rollout(require_prob=True)``),
whose step is ``deepaco_tpu/ops/pallas_kernels.py:65 fused_pick_pallas``.

Over ``score [B, N, N]`` f32 (``score_matrix(tau, heu, alpha, beta)``,
differentiable), ``start [B, A]`` and ``noise [T, B, A, N]``, each ant at
each step ``t < T``

    open_t   = TSP:  not visited_t(c)
               CVRP: visit_mask_t(c) and demand[c] <= capacity - used_t
    logits_t = where(open_t, score[b, cur_t, :], -1e30)
    a_{t+1}  = first argmax(logits_t + noise[t])      NaN above every number
    logp_t   = logits_t[a_{t+1}] - logsumexp(logits_t)

with the state of ``aco/problems/tsp.py``'s and ``aco/problems/cvrp.py``'s
plug-ins: the CVRP load ``used`` resets at a depot pick and then adds the
pick's demand in f32, and the depot closes right after a depot pick while
customers remain. The outputs are ``paths [B, T+1, A]`` (row 0 the start)
and ``log_probs [B, T, A]``, as ``engine.Rollout`` holds them. The backward
of ``sum(g * log_probs)`` in ``score`` is

    d_score[b, r, c] = sum over (a, t) with cur_t = r of
                       g[b, t, a] * (1[c = a_{t+1}] - softmax(logits_t)[c]) * open_t(c)

- :func:`fused_rollout_plain`: the step loop over ``fused_pick_plain``
  that ``engine.rollout`` runs, with ``noise[t]`` at step ``t``; autograd
  differentiates it. It is K7r's oracle.
- :func:`rollout_backward_plain`: the backward above in PyTorch, from the
  paths; the oracle of K7r's backward.
- :func:`fused_rollout`: the wrapper. A CPU tensor takes the step loop over
  ``fused_pick`` (K7's plain forward and its PyTorch backward, a step), the
  route ``engine.rollout`` took before; a CUDA tensor launches K7r's forward
  (:func:`fused_rollout_forward`, ``csrc/rollout.cu``), and its backward
  K7r's backward (:func:`fused_rollout_backward`), or raises.

K7r takes 2 <= N <= 4096 (:func:`fused_rollout_supported`); past that the
engine steps through K7.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from deepaco_tpu_torch.ops import _build
from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain

NEG_INF = -1e30
FUSED_ROLLOUT_MAX_N = 4096      # 16 columns a thread, 8 warps an ant


class RolloutShape(NamedTuple):
    """Which plug-in's state the rollout keeps: ``"tsp"`` (the visited set),
    or ``"cvrp"`` with ``demand [B, N]`` (0 at the depot, node 0) and the
    vehicle's ``capacity``."""

    kind: str
    demand: torch.Tensor | None = None
    capacity: float = 0.0


TSP_SHAPE = RolloutShape("tsp")


class RolloutTrace(NamedTuple):
    """What K7r's forward leaves for its backward: ``paths [B, T+1, A]``,
    each step's ``lse [B, T, A]`` (the logsumexp of its logits), ``pos [B,
    A, N]`` int32 (the path index where each node was first reached, ``T +
    1`` if never); for CVRP ``rem [B, T, A]`` (``capacity - used_t`` in f32)
    and each ant's depot departures ``dep [B, A, T]`` int32 (``2 t + 1`` if
    no customer was left at step ``t``, else ``2 t``), ``ndep [B, A]`` of
    them. Parked steps (an ant back at the depot with every customer
    served, whose pick and log-probability 0 are certain) are left out."""

    paths: torch.Tensor
    lse: torch.Tensor
    pos: torch.Tensor
    rem: torch.Tensor | None
    dep: torch.Tensor | None
    ndep: torch.Tensor | None


def fused_rollout_supported(n: int) -> bool:
    """Whether K7r takes ``n`` nodes."""
    return 2 <= n <= FUSED_ROLLOUT_MAX_N


class _Walk:
    """The plug-in's state for ``B x A`` ants from ``start [B, A]``: the
    visited set and, for CVRP, the load, the customers left and the depot
    rule, as ``cvrp_construct_plain`` keeps them."""

    def __init__(self, start: torch.Tensor, n: int, shape: RolloutShape):
        self.shape = shape
        self.closed = torch.zeros((*start.shape, n), dtype=torch.bool, device=start.device)
        if shape.kind == "cvrp":
            self.left = torch.full(start.shape, n - 1, dtype=torch.int64, device=start.device)
            self.used = torch.zeros(start.shape, dtype=torch.float32, device=start.device)
        self.step(start)

    def open(self) -> torch.Tensor:
        """``[B, A, N]`` bool: the columns this step may pick."""
        if self.shape.kind == "tsp":
            return ~self.closed
        rem = self.shape.capacity - self.used
        return ~self.closed & (self.shape.demand[:, None, :] <= rem[..., None])

    def step(self, act: torch.Tensor) -> None:
        if self.shape.kind == "tsp":
            self.closed.scatter_(-1, act[..., None], True)
            return
        was = self.closed.gather(-1, act[..., None])[..., 0]
        self.left = self.left - ((act != 0) & ~was).long()
        self.closed.scatter_(-1, act[..., None], True)
        self.used = torch.where(act == 0, 0.0, self.used) + torch.gather(self.shape.demand, 1, act)
        self.closed[..., 0] = (act == 0) & (self.left > 0)


def _step_loop(score, start, noise, shape: RolloutShape, pick):
    """``engine.rollout``'s loop, one ``pick`` a step on the rows
    ``score[b, cur, :]`` (gathered as ``tsp.row_gatherer`` does)."""
    from deepaco_tpu_torch.aco.problems.tsp import row_gatherer

    b, n, _ = score.shape
    a = start.shape[1]
    rows = row_gatherer(b, n, score.device)
    walk = _Walk(start, n, shape)
    cur, actions, log_probs = start, [start], []
    for t in range(noise.shape[0]):
        mask = walk.open().to(score.dtype)
        act, logp = pick(rows(score, cur).reshape(b * a, n), mask.reshape(b * a, n),
                         noise[t].reshape(b * a, n))
        cur = act.reshape(b, a)
        walk.step(cur)
        actions.append(cur)
        log_probs.append(logp.reshape(b, a))
    return torch.stack(actions, dim=1), torch.stack(log_probs, dim=1)


def fused_rollout_plain(score: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
                        shape: RolloutShape = TSP_SHAPE):
    """``(paths [B, T+1, A] int64, log_probs [B, T, A])`` in PyTorch, a
    ``fused_pick_plain`` a step; ``log_probs`` differentiable in ``score``."""
    return _step_loop(score, start, noise, shape, fused_pick_plain)


def rollout_backward_plain(score: torch.Tensor, paths: torch.Tensor, g: torch.Tensor,
                           shape: RolloutShape = TSP_SHAPE) -> torch.Tensor:
    """``d_score [B, N, N]`` of ``sum(g * log_probs)`` for ``paths [B, T+1,
    A]`` and ``g [B, T, A]``: the plug-in's state replayed along the paths,
    each step's ``g * (onehot - softmax) * open`` added into its rows."""
    b, n, _ = score.shape
    a = paths.shape[2]
    score = score.detach()
    flat = score.reshape(b * n, n)
    inst = torch.arange(b, device=score.device)[:, None] * n
    d = torch.zeros_like(flat)
    walk = _Walk(paths[:, 0], n, shape)
    for t in range(paths.shape[1] - 1):
        cur, nxt = paths[:, t], paths[:, t + 1]
        open_ = walk.open()
        ids = (inst + cur).reshape(-1)
        logits = torch.where(open_, flat.index_select(0, ids).reshape(b, a, n), NEG_INF)
        rows = -torch.softmax(logits, dim=-1)
        rows.scatter_add_(-1, nxt[..., None], torch.ones_like(rows[..., :1]))
        rows = torch.where(open_, rows * g[:, t, :, None], 0.0)
        d.index_add_(0, ids, rows.reshape(b * a, n))
        walk.step(nxt)
    return d.reshape(b, n, n)


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _check(name, score, start, noise, shape):
    _build.require_cuda(name, score, start, noise,
                        *(() if shape.kind == "tsp" else (shape.demand,)))
    b, n, _ = score.shape
    if score.shape != (b, n, n) or start.dim() != 2 or start.shape[0] != b \
            or noise.shape != (noise.shape[0], b, start.shape[1], n):
        raise ValueError(f"{name}: expected score [B, N, N], start [B, A] and noise [T, B, A, N]")
    if score.dtype != torch.float32 or noise.dtype != torch.float32:
        raise ValueError(f"{name}: K7r takes f32 score and noise")
    if shape.kind not in ("tsp", "cvrp"):
        raise ValueError(f"{name}: unknown rollout shape {shape.kind!r}")
    if shape.kind == "cvrp" and (shape.demand.shape != (b, n)
                                 or shape.demand.dtype != torch.float32):
        raise ValueError(f"{name}: expected f32 demand [B, N]")
    if not fused_rollout_supported(n):
        raise ValueError(f"{name}: K7r takes 2 <= N <= {FUSED_ROLLOUT_MAX_N}, got {n}")


def fused_rollout_forward(score: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
                          shape: RolloutShape = TSP_SHAPE, *, warps: int = 0):
    """One launch of K7r's forward on CUDA tensors: ``(paths, log_probs,
    trace)``, no gradient. ``warps`` (1, 2, 4 or 8 an ant, at least N / 512;
    0 chooses) changes no path."""
    _check("fused_rollout", score, start, noise, shape)
    b, n, _ = score.shape
    a, t = start.shape[1], noise.shape[0]
    dev = score.device
    cvrp = shape.kind == "cvrp"
    paths = torch.empty((b, t + 1, a), dtype=torch.int64, device=dev)
    logp = torch.empty((b, t, a), dtype=torch.float32, device=dev)
    lse = torch.empty((b, t, a), dtype=torch.float32, device=dev)
    pos = torch.empty((b, a, n), dtype=torch.int32, device=dev)
    rem = torch.empty((b, t, a), dtype=torch.float32, device=dev) if cvrp else None
    dep = torch.empty((b, a, t), dtype=torch.int32, device=dev) if cvrp else None
    ndep = torch.empty((b, a), dtype=torch.int32, device=dev) if cvrp else None
    trace = RolloutTrace(paths, lse, pos, rem, dep, ndep)
    if b * a == 0:
        return paths, logp, trace
    # the inputs held contiguous until the launch is queued
    score, start, noise = score.contiguous(), start.contiguous(), noise.contiguous()
    demand = shape.demand.contiguous() if cvrp else None
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("deepaco_rollout_fwd", [P] * 4 + [F] + [I] * 6 + [P] * 7 + [P])
    rc = fn(score.data_ptr(), start.data_ptr(), noise.data_ptr(), _ptr(demand),
            float(shape.capacity), b, n, a, t, int(cvrp), warps, paths.data_ptr(), logp.data_ptr(),
            lse.data_ptr(), pos.data_ptr(), _ptr(rem), _ptr(dep), _ptr(ndep),
            _build.stream_ptr(dev))
    _build.check(rc, "deepaco_rollout_fwd")
    fused_rollout.launches += 1
    return paths, logp, trace


def fused_rollout_backward(score: torch.Tensor, trace: RolloutTrace, g: torch.Tensor,
                           shape: RolloutShape = TSP_SHAPE) -> torch.Tensor:
    """``d_score [B, N, N]`` of ``sum(g * log_probs)``. A CPU tensor takes
    :func:`rollout_backward_plain` on ``trace.paths``; a CUDA tensor
    launches K7r's backward, a block 32 columns of a row whose four warps
    each sum a fixed share of the ants' steps, then add in order, with no
    atomics: a repeat gives equal bits."""
    if score.device.type == "cpu":
        return rollout_backward_plain(score, trace.paths, g, shape)
    _build.require_cuda("fused_rollout_backward", score, g, *trace[:3])
    b, n, _ = score.shape
    t, a = g.shape[1], g.shape[2]
    if g.shape != (b, t, a) or trace.paths.shape != (b, t + 1, a):
        raise ValueError("fused_rollout_backward: expected g [B, T, A] for paths [B, T+1, A]")
    cvrp = shape.kind == "cvrp"
    score, g = score.contiguous(), g.float().contiguous()
    demand = shape.demand.contiguous() if cvrp else None
    d = torch.empty_like(score)
    P, I = _build.P, _build.I
    fn = _build.function("deepaco_rollout_bwd", [P] * 9 + [I] * 5 + [P] + [P])
    rc = fn(score.data_ptr(), trace.paths.data_ptr(), g.data_ptr(), trace.lse.data_ptr(),
            trace.pos.data_ptr(), _ptr(trace.rem), _ptr(trace.dep), _ptr(trace.ndep),
            _ptr(demand), b, n, a, t, int(cvrp), d.data_ptr(), _build.stream_ptr(score.device))
    _build.check(rc, "deepaco_rollout_bwd")
    fused_rollout_backward.launches += 1
    return d


class FusedRollout(torch.autograd.Function):
    """K7r forward on CUDA tensors, K7r backward for the gradient in
    ``score``; ``start``, ``noise`` and the shape take none."""

    @staticmethod
    def forward(ctx, score, start, noise, shape):
        paths, logp, trace = fused_rollout_forward(score, start, noise, shape)
        ctx.shape = shape
        ctx.save_for_backward(score, *(x for x in trace if x is not None))
        ctx.mark_non_differentiable(paths)
        return paths, logp

    @staticmethod
    def backward(ctx, _d_paths, d_logp):
        score, *saved = ctx.saved_tensors
        trace = RolloutTrace(*saved, *[None] * (len(RolloutTrace._fields) - len(saved)))
        return fused_rollout_backward(score, trace, d_logp, ctx.shape), None, None, None


def fused_rollout(score: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
                  shape: RolloutShape = TSP_SHAPE):
    """``(paths [B, T+1, A] int64, log_probs [B, T, A])`` of the rollout,
    ``log_probs`` differentiable in ``score``; on CUDA one K7r launch
    forward and one backward, on the CPU a ``fused_pick`` a step."""
    if score.device.type == "cpu":
        return _step_loop(score, start, noise, shape, fused_pick)
    return FusedRollout.apply(score, start, noise, shape)


fused_rollout.launches = 0
fused_rollout_backward.launches = 0
