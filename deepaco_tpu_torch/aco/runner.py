"""ACO configuration, search state and the per-iteration update
(counterpart of ``deepaco_tpu/aco/runner.py``).

This slice ports the plain Ant System branch. The other strategy flags
raise ``NotImplementedError`` until their slice lands (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from deepaco_tpu_torch.aco import pheromone as ph


class ACOConfig(NamedTuple):
    """Strategy flags with the reference constructor defaults (tsp/aco.py:6-49)."""

    n_ants: int = 20
    decay: float = 0.9
    alpha: float = 1.0
    beta: float = 1.0
    elitist: bool = False
    min_max: bool = False
    tau_min: float = 0.1
    q: float = 1.0
    maximize: bool = False
    cyclic: bool = True
    symmetric: bool = True
    floor: float = 0.0
    mm_scale: float | None = None
    mm_static_max: float | None = None
    vector_pheromone: bool = False
    deposit_div_ants: bool = False
    cost_offset: float = 0.0


_UNPORTED = ("elitist", "min_max", "vector_pheromone", "maximize",
             "deposit_div_ants")


def check_ported(cfg: ACOConfig) -> None:
    """Raise for a strategy flag this slice does not port."""
    on = [f for f in _UNPORTED if getattr(cfg, f)]
    if cfg.cost_offset != 0.0:
        on.append("cost_offset")
    if on:
        raise NotImplementedError(
            f"ACOConfig flags {on} are not ported to deepaco_tpu_torch yet; "
            "see ROADMAP.md")


class SearchState(NamedTuple):
    phe: ph.PheromoneState
    best_cost: torch.Tensor
    best_path: torch.Tensor


def init_search(n: int, horizon: int, cfg: ACOConfig,
                tau: torch.Tensor | None = None, *, batch: tuple = (),
                device=None) -> SearchState:
    """Fresh state with leading ``batch`` dimensions: tau of ones, best cost
    +inf, best path zeros ``[..., horizon + 1]``."""
    check_ported(cfg)
    phe = ph.init_pheromone(n, batch=batch, device=device)
    if tau is not None:
        phe = phe._replace(tau=tau)
    return SearchState(
        phe=phe,
        best_cost=torch.full(batch, float("inf"), device=device),
        best_path=torch.zeros((*batch, horizon + 1), dtype=torch.int64,
                              device=device))


def track_best(state: SearchState, paths: torch.Tensor,
               costs: torch.Tensor) -> SearchState:
    """Best-so-far update: the iteration's first cheapest ant replaces the
    best when it is strictly cheaper."""
    it_best = torch.argmin(costs, dim=-1)
    it_cost = torch.gather(costs, -1, it_best[..., None])[..., 0]
    improved = it_cost < state.best_cost
    idx = it_best[..., None, None].expand(*paths.shape[:-1], 1)
    bpath = torch.gather(paths, -1, idx)[..., 0]
    return state._replace(
        best_cost=torch.where(improved, it_cost, state.best_cost),
        best_path=torch.where(improved[..., None], bpath, state.best_path))


def search_update(cfg: ACOConfig, state: SearchState, paths: torch.Tensor,
                  costs: torch.Tensor, q: float | None = None) -> SearchState:
    """Best-so-far tracking and the Ant System update for scored solutions
    (``paths [..., L, A]``, ``costs [..., A]``)."""
    check_ported(cfg)
    q = cfg.q if q is None else q
    state = track_best(state, paths, costs)
    phe = ph.as_update(state.phe, paths, costs, decay=cfg.decay,
                       cyclic=cfg.cyclic, symmetric=cfg.symmetric, q=q)
    if cfg.floor > 0.0:
        phe = phe._replace(tau=torch.clamp(phe.tau, min=cfg.floor))
    return state._replace(phe=phe)
