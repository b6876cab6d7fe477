"""Batched 2-opt and neural-guided local search (NLS) (counterpart of
``deepaco_tpu/ops/two_opt.py`` and ``deepaco_tpu/ops/pallas_two_opt.py``).

Plain versions, over ``dist [..., n, n]`` and tours ``[..., A, n]``:

- :func:`batched_two_opt`: best-improvement 2-opt of every tour to its fixed
  point or ``max_iterations``. For tour ``t`` and ``P[i, j] = dist[t_i, t_j]``
  the move ``(i, j)`` reverses ``t[i..j]`` and changes the length by
  ``delta = ((P[i-1, j] + P[i, j+1]) - P[i-1, i]) - P[j, j+1]`` (``j + 1``
  wraps to 0), over ``1 <= i < j <= n-1``. Each iteration takes the first
  flat argmin of ``delta``, applies it only if ``delta < -1e-6`` and stops
  otherwise. Every tour stops on its own, as ``vmap(while_loop)`` freezes a
  converged ant.
- :func:`batched_nls`: the NLS of the reference (tsp_nls/aco.py:241-258): a
  descent on ``dist``, then ``t_nls`` rounds of a ``t_p``-move descent on the
  perturbation metric followed by a descent on ``dist``; the running tour
  carries across rounds and replaces the best one on a strictly lower cost.

Kernels, each beside its plain version, over coordinates ``[..., n, 2]``:

- K4, :func:`batched_two_opt_euclid` (``csrc/two_opt.cu``), n <= 4096; plain
  version :func:`batched_two_opt_euclid_plain`;
- K5, :func:`batched_nls_euclid` (``csrc/two_opt.cu``), n <= 2048, with the
  perturbation metric rounded to bf16 as the TPU kernel rounds it; plain
  version :func:`batched_nls_euclid_plain`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises; above its cap (:func:`ls_supported`) a wrapper runs the dense
descent on either device, as the JAX package does, and launches nothing.
Tour costs inside NLS are summed in one fixed order (:func:`_tour_lengths`)
that K5 repeats, so the kernel keeps the same best tour as its plain version
bit for bit.
"""
from __future__ import annotations

import math
import warnings

import torch

from deepaco_tpu_torch.ops import _build
from deepaco_tpu_torch.utils.datasets import distance_matrix
from deepaco_tpu_torch.utils.metrics import count, counter_buffer, tracing

# f32(-1e-6) as a Python float, so the test is the f32 compare of the kernels
IMPROVE = float(torch.tensor(-1e-6, dtype=torch.float32))
LS_CAPS = {"2opt": 4096, "nls": 2048}
# K5's device counters, in the order the kernel adds them: the scans of a
# descent on the Euclidean distances and on the metric (each descent's last,
# which finds no move, included) and the moves applied; the plain version's
# ``scans`` keys for the same counts
NLS_COUNTERS = ("euclid_scans", "metric_scans", "moves")
PLAIN_SCANS = ("true", "perturb", "moves")


def heuristic_dist(heu: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Perturbation metric from the learned heuristic (tsp_nls/aco.py:228-232):
    ``1 / (heu / rowmax + eps)``, asymmetric because each row is normalised
    by its own maximum."""
    return 1.0 / (heu / torch.amax(heu, dim=-1, keepdim=True) + eps)


def _flatten(dist: torch.Tensor, tours: torch.Tensor):
    """``dist [..., n, n]``, ``tours [..., A, n]`` → ``dist [B, n, n]``, the
    tours as rows ``[B*A, n]`` int64 and each row's instance ``[B*A]``."""
    n = tours.shape[-1]
    lead = tours.shape[:-2]
    if dist.shape != (*lead, n, n):
        raise ValueError(f"expected dist {(*lead, n, n)} for tours "
                         f"{tuple(tours.shape)}, got {tuple(dist.shape)}")
    b, a = math.prod(lead), tours.shape[-2]
    inst = torch.arange(b, device=tours.device).repeat_interleave(a)
    return dist.reshape(b, n, n), tours.reshape(b * a, n).long(), inst


def _best_moves(metric: torch.Tensor, inst: torch.Tensor, tours: torch.Tensor):
    """``two_opt_once``'s move for each tour ``[m, n]`` over ``metric[inst]``:
    ``(delta, i, j)`` of the first flat argmin of the masked delta matrix."""
    m, n = tours.shape
    rows = metric.reshape(-1, n)[inst[:, None] * n + tours]          # [m, n, n]
    p = torch.gather(rows, 2, tours[:, None, :].expand(m, n, n))     # P[t_i, t_j]
    p_up = torch.roll(p, 1, dims=1)                                  # P[i-1, j]
    p_right = torch.roll(p, -1, dims=2)                              # P[i, j+1]
    c_i = torch.diagonal(p_up, dim1=1, dim2=2)                       # P[i-1, i]
    c_j = torch.diagonal(p_right, dim1=1, dim2=2)                    # P[j, j+1]
    delta = p_up + p_right - c_i[:, :, None] - c_j[:, None, :]
    idx = torch.arange(n, device=tours.device)
    valid = (idx[:, None] >= 1) & (idx[None, :] > idx[:, None])
    delta = torch.where(valid, delta, float("inf")).reshape(m, -1)
    flat = delta.argmin(dim=1)
    return delta.gather(1, flat[:, None])[:, 0], flat // n, flat % n


def _flip(tours: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Reverse ``tours[k, i_k..j_k]`` for every row ``k``."""
    idx = torch.arange(tours.shape[1], device=tours.device)
    i, j = i[:, None], j[:, None]
    rev = torch.where((idx >= i) & (idx <= j), i + j - idx, idx)
    return torch.gather(tours, 1, rev)


def _descent(metric: torch.Tensor, inst: torch.Tensor, tours: torch.Tensor,
             max_iterations: int, scans: dict | None, kind: str) -> torch.Tensor:
    """``two_opt`` of every row of ``tours [m, n]`` on its own: each iteration
    works on the rows still running; ``scans[kind]`` adds the iterations
    taken, the final one that finds no move included, and ``scans["moves"]``
    the moves applied."""
    tours = tours.clone()
    it = torch.zeros(tours.shape[0], dtype=torch.int64, device=tours.device)
    active = torch.full_like(it, max_iterations > 0, dtype=torch.bool)
    while True:
        act = active.nonzero()[:, 0]
        if act.numel() == 0:
            return tours
        if scans is not None:
            scans[kind] = scans.get(kind, 0) + act.numel()
        t = tours[act]
        g, i, j = _best_moves(metric, inst[act], t)
        improved = g < IMPROVE
        if scans is not None:
            scans["moves"] = scans.get("moves", 0) + int(improved.sum())
        tours[act] = torch.where(improved[:, None], _flip(t, i, j), t)
        it[act] += 1
        active[act] = improved & (it[act] < max_iterations)


def _tour_lengths(dist: torch.Tensor, inst: torch.Tensor,
                  tours: torch.Tensor) -> torch.Tensor:
    """Cyclic lengths of ``tours [m, n]``: the edges ``dist[t_k, t_{k-1}]``,
    ``k = 0..n-1``, of the JAX ``_tour_lengths``, added one by one from
    ``k = 0`` in f32, the order K5 repeats. NLS compares these costs
    strictly, and a tour and its reverse, summed in other orders, can differ
    by an ulp; XLA's fused gather and sum keeps no fixed order, so against
    the JAX package a tour can differ only on such a tie."""
    n = tours.shape[1]
    prev = torch.roll(tours, 1, dims=1)
    e = dist.reshape(-1)[(inst[:, None] * n + tours) * n + prev]
    total = e[:, 0]
    for k in range(1, n):
        total = total + e[:, k]
    return total


@torch.no_grad()
def two_opt_once(dist: torch.Tensor, tour: torch.Tensor):
    """One best-improvement move of ``tour [n]`` over ``dist [n, n]``:
    ``(new tour, delta)``, delta 0.0 when no move improves."""
    inst = torch.zeros(1, dtype=torch.int64, device=tour.device)
    t = tour.long()[None]
    g, i, j = _best_moves(dist[None], inst, t)
    improved = g < IMPROVE
    new = torch.where(improved[:, None], _flip(t, i, j), t)
    return new[0], torch.where(improved, g, torch.zeros_like(g))[0]


def two_opt(dist: torch.Tensor, tour: torch.Tensor,
            max_iterations: int) -> torch.Tensor:
    """``tour [n]`` to its 2-opt fixed point, at most ``max_iterations``
    moves."""
    return batched_two_opt(dist, tour[None], max_iterations)[0]


@torch.no_grad()
def batched_two_opt(dist: torch.Tensor, tours: torch.Tensor,
                    max_iterations: int, *, scans: dict | None = None) -> torch.Tensor:
    """2-opt of every tour ``[..., A, n]`` over ``dist [..., n, n]``; int64
    tours of the same shape. ``scans``, when given, counts the iterations
    under ``"true"``."""
    d, flat, inst = _flatten(dist, tours)
    return _descent(d, inst, flat, max_iterations, scans, "true").reshape(tours.shape)


@torch.no_grad()
def batched_nls(dist: torch.Tensor, heu_dist: torch.Tensor, tours: torch.Tensor,
                max_iterations: int, t_nls: int = 10, t_p: int = 20, *,
                scans: dict | None = None) -> torch.Tensor:
    """NLS of every tour ``[..., A, n]``: true metric ``dist`` and
    perturbation metric ``heu_dist``, both ``[..., n, n]`` and taken as
    given. ``scans`` counts the iterations under ``"true"`` and
    ``"perturb"``, and the moves applied under ``"moves"``."""
    d, flat, inst = _flatten(dist, tours)
    hd = heu_dist.reshape(d.shape)
    best = _descent(d, inst, flat, max_iterations, scans, "true")
    best_cost = _tour_lengths(d, inst, best)
    new = best
    for _ in range(t_nls):
        pert = _descent(hd, inst, new, t_p, scans, "perturb")
        new = _descent(d, inst, pert, max_iterations, scans, "true")
        cost = _tour_lengths(d, inst, new)
        better = cost < best_cost
        best = torch.where(better[:, None], new, best)
        best_cost = torch.where(better, cost, best_cost)
    return best.reshape(tours.shape)


def batched_two_opt_euclid_plain(coords: torch.Tensor, tours: torch.Tensor,
                                 max_iterations: int, *,
                                 scans: dict | None = None) -> torch.Tensor:
    """Plain version of K4: :func:`batched_two_opt` on ``distance_matrix``."""
    return batched_two_opt(distance_matrix(coords), tours, max_iterations,
                           scans=scans)


def batched_nls_euclid_plain(coords: torch.Tensor, heu_dist: torch.Tensor,
                             tours: torch.Tensor, max_iterations: int,
                             t_nls: int = 10, t_p: int = 20, *,
                             scans: dict | None = None) -> torch.Tensor:
    """Plain version of K5: :func:`batched_nls` on ``distance_matrix`` with
    the perturbation metric rounded to bf16 (pallas_two_opt.py:19-21).
    While tracing is on it adds K5's counters (``nls.*``: the call's shape
    and its ``scans``) to the open span, as K5 does."""
    return _counted_nls(distance_matrix(coords), heu_dist.to(torch.bfloat16).float(),
                        tours, max_iterations, t_nls, t_p, scans)


def _counted_nls(dist: torch.Tensor, heu_dist: torch.Tensor, tours: torch.Tensor,
                 max_iterations: int, t_nls: int, t_p: int,
                 scans: dict | None) -> torch.Tensor:
    """:func:`batched_nls`, counting its scans while tracing is on (or into
    ``scans`` when given) and adding them to K5's counters."""
    counts = scans if scans is not None else ({} if tracing() else None)
    before = dict(counts or {})
    out = batched_nls(dist, heu_dist, tours, max_iterations, t_nls, t_p, scans=counts)
    if counts is not None:
        _count_call(tours, **{c: counts.get(k, 0) - before.get(k, 0)
                              for c, k in zip(NLS_COUNTERS, PLAIN_SCANS)})
    return out


def _count_call(tours: torch.Tensor, **counts: int) -> None:
    """Add one NLS call on ``tours [..., A, n]`` to the open span's counters
    ``nls.calls``, ``nls.instances``, ``nls.tours``, ``nls.n`` (summed over
    calls) and ``counts``, while tracing is on; else nothing."""
    if not tracing():
        return
    a, n = tours.shape[-2:]
    b = math.prod(tours.shape[:-2])
    count("nls", calls=1, instances=b, tours=b * a, n=n, **counts)


def ls_supported(n: int, ls: str = "nls") -> bool:
    """Whether the kernel of ``ls`` (``"2opt"`` or ``"nls"``) takes ``n``
    cities: 2-opt to 4096, NLS to 2048, the caps of the JAX package's
    kernels. Above them the wrappers take the dense descent on either
    device, as the JAX package does (pallas_two_opt.py:598-611, 641-646)."""
    return n <= LS_CAPS[ls]


@torch.no_grad()
def batched_two_opt_euclid(coords: torch.Tensor, tours: torch.Tensor,
                           max_iterations: int) -> torch.Tensor:
    """2-opt of tours ``[..., A, n]`` on Euclidean instances ``coords
    [..., n, 2]``; one launch of kernel K4 on CUDA. Above K4's cap it warns
    and runs :func:`batched_two_opt` on ``distance_matrix(coords)``, which
    builds an ``[N, N]`` matrix."""
    n = coords.shape[-2]
    if not ls_supported(n, "2opt"):
        warnings.warn(f"batched_two_opt_euclid: n={n} exceeds K4's cap "
                      f"({LS_CAPS['2opt']}); taking the dense descent, which "
                      "builds an [N, N] distance matrix", stacklevel=2)
        return batched_two_opt(distance_matrix(coords), tours, max_iterations)
    if coords.device.type == "cpu":
        return batched_two_opt_euclid_plain(coords, tours, max_iterations)
    out = _launch("deepaco_two_opt", coords, None, tours, max_iterations, 0, 0)
    batched_two_opt_euclid.launches += 1
    return out


@torch.no_grad()
def batched_nls_euclid(coords: torch.Tensor, heu_dist: torch.Tensor,
                       tours: torch.Tensor, max_iterations: int,
                       t_nls: int = 10, t_p: int = 20) -> torch.Tensor:
    """NLS of tours ``[..., A, n]`` on Euclidean instances ``coords
    [..., n, 2]`` with the perturbation metric ``heu_dist [..., n, n]``
    rounded to bf16; one launch of kernel K5 on CUDA. Above K5's cap it
    runs :func:`batched_nls` on ``distance_matrix(coords)`` with
    ``heu_dist`` as it is, not rounded. While tracing is on
    (``utils/metrics``) K5 adds its scans and moves into the open span's
    device counters (``NLS_COUNTERS``), read once by the report, and the
    call's shape goes to its host counters (the dense descent above the cap
    counts the same on the host); off, nothing is counted."""
    if not ls_supported(coords.shape[-2], "nls"):
        return _counted_nls(distance_matrix(coords), heu_dist, tours,
                            max_iterations, t_nls, t_p, None)
    if coords.device.type == "cpu":
        return batched_nls_euclid_plain(coords, heu_dist, tours,
                                        max_iterations, t_nls, t_p)
    out = _launch("deepaco_nls", coords, heu_dist, tours, max_iterations,
                  t_nls, t_p)
    batched_nls_euclid.launches += 1
    return out


def _launch(entry: str, coords: torch.Tensor, metric: torch.Tensor | None,
            tours: torch.Tensor, max_iterations: int, t_nls: int,
            t_p: int) -> torch.Tensor:
    """Check and flatten the inputs, allocate the tours out and call the
    K4 (``metric=None``) or K5 entry point; K5 with the tracer's counter
    buffer while tracing is on, else a null pointer."""
    tensors = (coords, tours) if metric is None else (coords, metric, tours)
    _build.require_cuda(entry, *tensors)
    n, a = coords.shape[-2], tours.shape[-2]
    lead = tours.shape[:-2]
    if coords.shape != (*lead, n, 2) or tours.shape[-1] != n:
        raise ValueError(f"{entry}: expected coords [..., n, 2] and tours "
                         f"[..., A, n], got {tuple(coords.shape)} and "
                         f"{tuple(tours.shape)}")
    if metric is not None and metric.shape != (*lead, n, n):
        raise ValueError(f"{entry}: expected heu_dist {(*lead, n, n)}, got "
                         f"{tuple(metric.shape)}")
    b = math.prod(lead)
    xy = coords.float().reshape(b, n, 2).contiguous()
    t = tours.long().reshape(b, a, n).contiguous()
    out = torch.empty_like(t)
    if out.numel() == 0:
        return out.reshape(tours.shape)
    P, I = _build.P, _build.I
    if metric is None:
        fn = _build.function(entry, [P] * 3 + [I] * 4 + [P])
        rc = fn(xy.data_ptr(), t.data_ptr(), out.data_ptr(), b, a, n,
                max_iterations, _build.stream_ptr(xy.device))
    else:
        m = metric.to(torch.bfloat16).reshape(b, n, n).contiguous()
        # K5's scratch: the 16 least entries of each row and column of the
        # metric, and a flag an instance
        keys = torch.empty((b, 2, n, 16), dtype=torch.int32, device=xy.device)
        negative = torch.empty(b, dtype=torch.int32, device=xy.device)
        counts = counter_buffer("nls", NLS_COUNTERS, xy.device)
        fn = _build.function(entry, [P] * 6 + [I] * 6 + [P, P])
        rc = fn(xy.data_ptr(), m.data_ptr(), keys.data_ptr(), negative.data_ptr(),
                t.data_ptr(), out.data_ptr(), b, a, n, max_iterations, t_nls, t_p,
                None if counts is None else counts.data_ptr(),
                _build.stream_ptr(xy.device))
    _build.check(rc, entry)
    if metric is not None:
        _count_call(tours)
    return out.reshape(tours.shape)


batched_two_opt_euclid.launches = 0
batched_nls_euclid.launches = 0
