"""TSP plug-in for the rollout engine, scores and tour costs (counterpart of
``deepaco_tpu/aco/problems/tsp.py``), batched over instances.

State: ``(cur [B, A], mask [B, A, N])``. The horizon is N-1 steps after the
start city; the start is uniform per ant, drawn from the caller's generator
(tsp/aco.py:141), or a fixed city for the NLS pipeline (tsp_nls/aco.py:191).
``alpha*log(tau) + beta*log(eta)`` is folded into one score matrix outside
the construction, so each step gathers one row per ant.
"""
from __future__ import annotations

import torch


def clear_onehot(mask: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``mask[..., a, actions[..., a]] = 0`` as a compare and select."""
    n = mask.shape[-1]
    hit = torch.arange(n, device=mask.device) == actions[..., None]
    return torch.where(hit, 0.0, mask)


def score_matrix(phe: torch.Tensor, heu: torch.Tensor, alpha: float,
                 beta: float) -> torch.Tensor:
    """Combined log-score matrix, floored away from subnormals."""
    return (alpha * torch.log(torch.clamp(phe, min=1e-30))
            + beta * torch.log(torch.clamp(heu, min=1e-30)))


def row_gatherer(b: int, n: int, device):
    """``rows(m [B, N, M], cur [B, A]) -> [B, A, M]``: the row ``cur`` of
    each instance's matrix for every ant, by ``index_select``, which keeps
    only ``[B*A]`` ids for the backward, not a ``[B, A, M]`` gather index."""
    inst = torch.arange(b, device=device)[:, None] * n

    def rows(m: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        flat = (inst + cur).reshape(-1)
        return m.reshape(b * n, -1).index_select(0, flat).reshape(b, -1, m.shape[-1])

    return rows


def tsp_spec(phe: torch.Tensor, heu: torch.Tensor, n_ants: int,
             fixed_start: int | None = None, alpha: float = 1.0,
             beta: float = 1.0):
    """The engine's plug-in for ``phe, heu [B, N, N]`` and ``n_ants`` ants
    per instance; ``score`` stays differentiable in ``phe`` and ``heu``, and
    the spec carries it for the engine's one-launch route (K7r)."""
    from deepaco_tpu_torch.aco.engine import RolloutSpec
    from deepaco_tpu_torch.ops.rollout import TSP_SHAPE

    b, n, _ = phe.shape
    score = score_matrix(phe, heu, alpha, beta)
    rows = row_gatherer(b, n, phe.device)

    def start(generator: torch.Generator) -> torch.Tensor:
        if fixed_start is None:
            return torch.randint(0, n, (b, n_ants), generator=generator,
                                 device=generator.device).to(phe.device)
        return torch.full((b, n_ants), fixed_start, dtype=torch.int64,
                          device=phe.device)

    def init(start_cities: torch.Tensor):
        mask = clear_onehot(torch.ones((b, start_cities.shape[1], n),
                                       dtype=phe.dtype, device=phe.device),
                            start_cities)
        return start_cities, mask

    def step(state, actions):
        _, mask = state
        return actions, clear_onehot(mask, actions)

    return RolloutSpec(horizon=n - 1, start=start, init=init,
                       prob_rows=lambda state: (rows(phe, state[0]),
                                                rows(heu, state[0])),
                       mask=lambda state: state[1], step=step,
                       score_rows=lambda state: rows(score, state[0]),
                       fused=(score, TSP_SHAPE))


def tour_cost(dist: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Cyclic tour lengths ``[..., A]``: ``paths`` is ``[..., N, A]`` and
    ``dist`` ``[..., N, N]``; edge ``i`` of ant ``a`` is
    ``(paths[i, a], paths[i - 1, a])``."""
    u = paths.transpose(-1, -2).long()                    # [..., A, N]
    v = torch.roll(u, shifts=1, dims=-1)
    n = dist.shape[-1]
    edges = torch.gather(dist.flatten(-2), -1, (u * n + v).flatten(-2))
    return edges.reshape(u.shape).sum(dim=-1)
