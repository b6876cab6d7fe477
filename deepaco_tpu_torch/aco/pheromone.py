"""Pheromone state, the Ant System and elitist updates and MAX-MIN's bounds
(counterpart of ``deepaco_tpu/aco/pheromone.py``). Every function takes leading batch
dimensions: ``tau [..., N, N]`` (or the per-item vector ``[..., N]`` of
MKP's PH_items), ``paths [..., L, A]``, ``amounts [..., A]``.
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
                   batch: tuple = (), dtype=torch.float32, device=None,
                   vector: bool = False) -> PheromoneState:
    """Ones (reference tsp/aco.py:37-42), ``[..., n, n]`` or with ``vector``
    the per-item ``[..., n]`` (mkp_transformer/aco.py:44); MAX-MIN starts
    at ``tau_min``."""
    tau = torch.ones((*batch, n) if vector else (*batch, n, n), dtype=dtype, device=device)
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


def elitist_update(state: PheromoneState, paths: torch.Tensor, costs: torch.Tensor,
                   *, decay: float, cyclic: bool = True, symmetric: bool = True,
                   q: float | torch.Tensor = 1.0, maximize: bool = False,
                   div_ants: bool = False, cost_offset: float = 0.0,
                   deposit: Callable = deposit) -> PheromoneState:
    """Elitist (tsp/aco.py:103-107): evaporate, then only each instance's
    iteration-best ant (the first best) deposits ``q/(cost + offset)`` (``q
    * objective`` when maximizing), through ``deposit`` with one ant;
    ``div_ants`` does not apply, as in the JAX package."""
    best = torch.argmax(costs, dim=-1) if maximize else torch.argmin(costs, dim=-1)
    best_path = paths.gather(-1, best[..., None, None].expand(*paths.shape[:-1], 1))
    best_cost = costs.gather(-1, best[..., None])
    amounts = q * best_cost if maximize else q / (best_cost + cost_offset)
    return state._replace(tau=deposit(state.tau * decay, best_path, amounts,
                                      cyclic=cyclic, symmetric=symmetric))


def _per_instance(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-instance value ``[...]`` broadcast against tau ``like``."""
    return t.reshape(*t.shape, *([1] * (like.dim() - t.dim())))


def min_max_clamp(state: PheromoneState, tau_min: float) -> PheromoneState:
    """Clamp into ``[tau_min, tau_max]`` where the bound is set (``tau_max >
    0``; tsp/aco.py:116-118)."""
    tau_max = _per_instance(state.tau_max, state.tau)
    tau = torch.where(tau_max > 0, torch.minimum(torch.clamp(state.tau, min=tau_min), tau_max),
                      state.tau)
    return state._replace(tau=tau)


def min_max_on_new_best(state: PheromoneState, best_cost: torch.Tensor,
                        scale: float | torch.Tensor, maximize: bool = False) -> PheromoneState:
    """The bound of a new best (``best_cost [...]``): ``tau_max = scale /
    best`` (minimization, tsp/aco.py:84-88) or ``scale * best``
    (maximization, op/aco.py:121-124); the first time (no bound yet) tau is
    rescaled so that its largest entry equals the bound."""
    new_max = (scale * best_cost if maximize else scale / best_cost).to(state.tau.dtype)
    cur_max = state.tau.flatten(start_dim=state.tau_max.dim()).amax(dim=-1)
    rescaled = state.tau * _per_instance(new_max, state.tau) / _per_instance(cur_max, state.tau)
    tau = torch.where(_per_instance(state.tau_max, state.tau) > 0, state.tau, rescaled)
    return PheromoneState(tau=tau, tau_max=new_max)


def vector_deposit(tau: torch.Tensor, picks: torch.Tensor, amounts: torch.Tensor) -> torch.Tensor:
    """PH_items: ``amounts[a]`` added to ``tau [..., M]`` at every item of
    ``picks [..., L, A]`` (mkp_transformer/aco.py:85-99), in a fixed order
    on every device: each item takes its ants' amounts one after another in
    the order of the step at which each ant first picked it, then by ant,
    an ant that picked it ``c`` times adding ``c * amount`` at once. For an
    item that each ant picks at most once (every real MKP item) this is the
    step-then-ant order in which the JAX package's ``tau.at[picks].add``
    adds, so the bits agree; no atomic add decides an order on the card."""
    m = tau.shape[-1]
    length, a = picks.shape[-2:]
    p = picks.transpose(-1, -2).long()                               # [..., A, L]
    lead = p.shape[:-2]
    counts = torch.zeros((*lead, a, m), dtype=tau.dtype, device=tau.device)
    counts.scatter_add_(-1, p, torch.ones_like(p, dtype=tau.dtype))
    first = torch.full((*lead, a, m), length, dtype=torch.int64, device=tau.device)
    first.scatter_reduce_(-1, p, torch.arange(length, device=tau.device).expand_as(p), "amin")
    order = torch.argsort(first * a + torch.arange(a, device=tau.device)[:, None], dim=-2)
    contrib = torch.gather(counts * amounts[..., :, None], -2, order)
    for r in range(a):
        tau = tau + contrib[..., r, :]
    return tau
