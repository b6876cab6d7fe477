"""TSP scores and tour costs (counterpart of ``deepaco_tpu/aco/problems/tsp.py``)."""
from __future__ import annotations

import torch


def score_matrix(phe: torch.Tensor, heu: torch.Tensor, alpha: float,
                 beta: float) -> torch.Tensor:
    """Combined log-score matrix, floored away from subnormals."""
    return (alpha * torch.log(torch.clamp(phe, min=1e-30))
            + beta * torch.log(torch.clamp(heu, min=1e-30)))


def tour_cost(dist: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Cyclic tour lengths ``[..., A]``: ``paths`` is ``[..., N, A]`` and
    ``dist`` ``[..., N, N]``; edge ``i`` of ant ``a`` is
    ``(paths[i, a], paths[i - 1, a])``."""
    u = paths.transpose(-1, -2).long()                    # [..., A, N]
    v = torch.roll(u, shifts=1, dims=-1)
    n = dist.shape[-1]
    edges = torch.gather(dist.flatten(-2), -1, (u * n + v).flatten(-2))
    return edges.reshape(u.shape).sum(dim=-1)
