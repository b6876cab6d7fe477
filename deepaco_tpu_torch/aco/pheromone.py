"""Pheromone state and the Ant System update (counterpart of
``deepaco_tpu/aco/pheromone.py``). Every function takes leading batch
dimensions: ``tau [..., N, N]``, ``paths [..., L, A]``, ``amounts [..., A]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PheromoneState(NamedTuple):
    """Matrix pheromone and the MAX-MIN bound (``tau_max < 0``: unset)."""

    tau: torch.Tensor
    tau_max: torch.Tensor


def init_pheromone(n: int, min_max: bool = False, tau_min: float = 0.1, *,
                   batch: tuple = (), dtype=torch.float32,
                   device=None) -> PheromoneState:
    """Ones (reference tsp/aco.py:37-42); MAX-MIN starts at ``tau_min``."""
    tau = torch.ones((*batch, n, n), dtype=dtype, device=device)
    if min_max:
        tau = tau * tau_min
    return PheromoneState(tau=tau, tau_max=torch.full(batch, -1.0, dtype=dtype,
                                                      device=device))


def tour_edges(paths: torch.Tensor, cyclic: bool = True):
    """Edge endpoints ``(u, v)``, each ``[..., A, L']``: the ``L`` cyclic
    edges ``(path[i], path[i-1])`` or the ``L-1`` directed consecutive ones."""
    u = paths.transpose(-1, -2).long()
    if cyclic:
        return u, torch.roll(u, shifts=1, dims=-1)
    return u[..., :-1], u[..., 1:]


def deposit(tau: torch.Tensor, paths: torch.Tensor, amounts: torch.Tensor, *,
            cyclic: bool = True, symmetric: bool = True) -> torch.Tensor:
    """``tau + D`` (``+ D^T`` when symmetric), where ``D[u, v]`` sums
    ``amounts[a]`` over every edge ``(u, v)`` of ant ``a``; repeated edges
    accumulate once per occurrence."""
    u, v = tour_edges(paths, cyclic)
    n = tau.shape[-1]
    w = amounts[..., None].expand(u.shape).to(tau.dtype)
    d = torch.zeros_like(tau).flatten(-2)
    d.scatter_add_(-1, (u * n + v).flatten(-2), w.flatten(-2))
    d = d.reshape(tau.shape)
    if symmetric:
        d = d + d.transpose(-1, -2)
    return tau + d


def as_update(state: PheromoneState, paths: torch.Tensor, costs: torch.Tensor,
              *, decay: float, cyclic: bool = True, symmetric: bool = True,
              q: float = 1.0, maximize: bool = False, div_ants: bool = False,
              cost_offset: float = 0.0) -> PheromoneState:
    """Ant System: evaporate, then every ant deposits ``q/(cost + offset)``
    (``q*objective`` when maximizing; divided by the ant count when
    ``div_ants``)."""
    amounts = q * costs if maximize else q / (costs + cost_offset)
    if div_ants:
        amounts = amounts / costs.shape[-1]
    tau = deposit(state.tau * decay, paths, amounts,
                  cyclic=cyclic, symmetric=symmetric)
    return state._replace(tau=tau)
