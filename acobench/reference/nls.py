"""The plain reference of neural-guided local search (NLS), DeepACO's
tsp_nls/aco.py:226-258, as the configuration states it.

2-opt descent of a tour ``t`` over a metric ``P[i, j] = m[t_i, t_j]``: the
move ``(i, j)``, ``1 <= i < j <= n-1``, reverses ``t[i..j]`` and changes the
length by ``((P[i-1, j] + P[i, j+1]) - P[i-1, i]) - P[j, j+1]`` (``j + 1``
wraps to 0); each iteration takes the first flat argmin and applies it if
it is below f32(-1e-6), else the tour stops. NLS: a descent on the
distances, then ``t_nls`` rounds of a ``t_p``-move descent on the
perturbation metric ``1 / (heu / rowmax + 1e-5)`` (rounded to bf16 as
stated) followed by a descent on the distances; the running tour carries
across rounds and replaces the best on a strictly lower f32 length, summed
edge by edge from position 0.
"""
from __future__ import annotations

import torch

IMPROVE = float(torch.tensor(-1e-6, dtype=torch.float32))


def perturbation_metric(heu: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``1 / (heu / rowmax + eps)``, asymmetric: each row by its own maximum."""
    return 1.0 / (heu / torch.amax(heu, dim=-1, keepdim=True) + eps)


def _best_moves(metric: torch.Tensor, inst: torch.Tensor, tours: torch.Tensor):
    m, n = tours.shape
    rows = metric.reshape(-1, n)[inst[:, None] * n + tours]
    p = torch.gather(rows, 2, tours[:, None, :].expand(m, n, n))
    p_up = torch.roll(p, 1, dims=1)
    p_right = torch.roll(p, -1, dims=2)
    c_i = torch.diagonal(p_up, dim1=1, dim2=2)
    c_j = torch.diagonal(p_right, dim1=1, dim2=2)
    delta = p_up + p_right - c_i[:, :, None] - c_j[:, None, :]
    idx = torch.arange(n, device=tours.device)
    valid = (idx[:, None] >= 1) & (idx[None, :] > idx[:, None])
    delta = torch.where(valid, delta, float("inf")).reshape(m, -1)
    flat = delta.argmin(dim=1)
    return delta.gather(1, flat[:, None])[:, 0], flat // n, flat % n


def _flip(tours: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(tours.shape[1], device=tours.device)
    i, j = i[:, None], j[:, None]
    return torch.gather(tours, 1, torch.where((idx >= i) & (idx <= j), i + j - idx, idx))


def descent(metric: torch.Tensor, inst: torch.Tensor, tours: torch.Tensor,
            max_iterations: int, block: int = 64) -> torch.Tensor:
    """Every row of ``tours [m, n]`` to its 2-opt fixed point or
    ``max_iterations`` moves, on its own; ``block`` rows a pass at most."""
    tours = tours.clone()
    it = torch.zeros(tours.shape[0], dtype=torch.int64, device=tours.device)
    active = torch.full_like(it, max_iterations > 0, dtype=torch.bool)
    while True:
        act = active.nonzero()[:, 0]
        if act.numel() == 0:
            return tours
        for s in range(0, act.numel(), block):
            rows = act[s:s + block]
            t = tours[rows]
            g, i, j = _best_moves(metric, inst[rows], t)
            improved = g < IMPROVE
            tours[rows] = torch.where(improved[:, None], _flip(t, i, j), t)
            it[rows] += 1
            active[rows] = improved & (it[rows] < max_iterations)


def lengths(dist: torch.Tensor, inst: torch.Tensor, tours: torch.Tensor) -> torch.Tensor:
    """Cyclic f32 lengths of ``tours [m, n]``, the edges ``dist[t_k, t_{k-1}]``
    added one by one from ``k = 0``."""
    n = tours.shape[1]
    prev = torch.roll(tours, 1, dims=1)
    e = dist.reshape(-1)[(inst[:, None] * n + tours) * n + prev]
    total = e[:, 0]
    for k in range(1, n):
        total = total + e[:, k]
    return total


def nls(dist: torch.Tensor, metric: torch.Tensor, tours: torch.Tensor,
        budget: int, t_nls: int, t_p: int) -> torch.Tensor:
    """NLS of ``tours [B, A, n]`` over ``dist`` and ``metric [B, n, n]``."""
    b, a, n = tours.shape
    inst = torch.arange(b, device=tours.device).repeat_interleave(a)
    flat = tours.reshape(b * a, n).long()
    best = descent(dist, inst, flat, budget)
    best_cost = lengths(dist, inst, best)
    new = best
    for _ in range(t_nls):
        new = descent(dist, inst, descent(metric, inst, new, t_p), budget)
        cost = lengths(dist, inst, new)
        better = cost < best_cost
        best = torch.where(better[:, None], new, best)
        best_cost = torch.where(better, cost, best_cost)
    return best.reshape(b, a, n)


def nls_paths(coords: torch.Tensor, heu: torch.Tensor, paths: torch.Tensor, ls: dict,
              dist_dtype=torch.float32, metric_dtype=torch.bfloat16) -> torch.Tensor:
    """NLS of ``paths [B, N, A]`` on the instances ``coords [B, N, 2]`` with
    the heuristic ``heu [B, N, N]``: improved paths ``[B, N, A]``. The
    distances in ``dist_dtype`` and the metric in ``metric_dtype`` (the
    control's lower ones saturate at their largest finite value)."""
    from acobench.reference.aco import rnd
    from acobench.reference.gnn import distance_matrix

    dist = rnd(distance_matrix(coords), dist_dtype)
    metric = rnd(perturbation_metric(heu), metric_dtype)
    out = nls(dist, metric, paths.transpose(1, 2), ls["budget"], ls["t_nls"], ls["t_p"])
    return out.transpose(1, 2)
