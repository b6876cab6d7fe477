"""Pheromone state and the Ant System update (counterpart of
``deepaco_tpu/aco/pheromone.py``). Every function takes leading batch
dimensions: ``tau [..., N, N]``, ``paths [..., L, A]``, ``amounts [..., A]``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from deepaco_tpu_torch.ops.deposit import tour_deposit, tour_deposit_plain


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


def _add_deposit(tau: torch.Tensor, d: torch.Tensor, symmetric: bool) -> torch.Tensor:
    if symmetric:
        d = d + d.transpose(-1, -2)
    return tau + d


def deposit(tau: torch.Tensor, paths: torch.Tensor, amounts: torch.Tensor, *,
            cyclic: bool = True, symmetric: bool = True) -> torch.Tensor:
    """``tau + D`` (``+ D^T`` when symmetric), where ``D[u, v]`` sums
    ``amounts[a]`` over every edge ``(u, v)`` of ant ``a``; repeated edges
    accumulate once per occurrence. ``D`` is :func:`tour_deposit`, kernel K8
    on the card."""
    return _add_deposit(tau, tour_deposit(paths, amounts, tau.shape[-1], cyclic=cyclic),
                        symmetric)


def deposit_plain(tau: torch.Tensor, paths: torch.Tensor, amounts: torch.Tensor, *,
                  cyclic: bool = True, symmetric: bool = True) -> torch.Tensor:
    """:func:`deposit` with ``D`` from ``scatter_add_`` on any device."""
    return _add_deposit(tau, tour_deposit_plain(paths, amounts, tau.shape[-1],
                                                cyclic=cyclic), symmetric)


def as_update(state: PheromoneState, paths: torch.Tensor, costs: torch.Tensor,
              *, decay: float, cyclic: bool = True, symmetric: bool = True,
              q: float = 1.0, maximize: bool = False, div_ants: bool = False,
              cost_offset: float = 0.0,
              deposit: Callable = deposit) -> PheromoneState:
    """Ant System: evaporate, then every ant deposits ``q/(cost + offset)``
    (``q*objective`` when maximizing; divided by the ant count when
    ``div_ants``) through ``deposit`` (:func:`deposit` or
    :func:`deposit_plain`)."""
    amounts = q * costs if maximize else q / (costs + cost_offset)
    if div_ants:
        amounts = amounts / costs.shape[-1]
    tau = deposit(state.tau * decay, paths, amounts,
                  cyclic=cyclic, symmetric=symmetric)
    return state._replace(tau=tau)
