"""ACO configuration, search state, the per-iteration update and the anytime
loop (counterpart of ``deepaco_tpu/aco/runner.py``), batched over instances.

The plain Ant System branch is ported, with CVRP's pheromone ``floor``,
maximization (OP: deposit ``q * objective``, the best is the largest),
``cost_offset`` (SMTWTP: deposit ``q / (cost + 1)``),
``deposit_div_ants`` (BPP: each ant deposits ``q * fitness / A``) and the
per-item vector pheromone (MKP's PH_items, ``vector_pheromone``). The
other strategy flags raise ``NotImplementedError`` until their slice lands
(ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple

import torch

from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.aco.engine import rollout


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


# each flag not ported yet, with the ROADMAP.md §1 item that takes it
_UNPORTED = {"elitist": "item 4 (rcpsp)", "min_max": "item 4 (rcpsp)"}


def check_ported(cfg: ACOConfig) -> None:
    """Raise for a strategy flag that is not ported yet, naming its item."""
    on = [f for f in _UNPORTED if getattr(cfg, f)]
    if on:
        raise NotImplementedError(
            f"ACOConfig flags {on} are not ported to deepaco_tpu_torch yet: "
            + "; ".join(f"{f} waits for ROADMAP.md §1 {_UNPORTED[f]}" for f in on))


class SearchState(NamedTuple):
    phe: ph.PheromoneState
    best_cost: torch.Tensor
    best_path: torch.Tensor


def init_search(n: int, horizon: int, cfg: ACOConfig,
                tau: torch.Tensor | None = None, *, batch: tuple = (),
                device=None) -> SearchState:
    """Fresh state with leading ``batch`` dimensions: tau of ones (``[...,
    n, n]``, or ``[..., n]`` for ``vector_pheromone``), best cost +inf (-inf
    when maximizing), best path zeros ``[..., horizon + 1]``."""
    check_ported(cfg)
    phe = ph.init_pheromone(n, batch=batch, device=device, vector=cfg.vector_pheromone)
    if tau is not None:
        phe = phe._replace(tau=tau)
    return SearchState(
        phe=phe,
        best_cost=torch.full(batch, -math.inf if cfg.maximize else math.inf,
                             device=device),
        best_path=torch.zeros((*batch, horizon + 1), dtype=torch.int64,
                              device=device))


def track_best(state: SearchState, paths: torch.Tensor, costs: torch.Tensor,
               maximize: bool = False) -> SearchState:
    """Best-so-far update: the iteration's first best ant (cheapest, or with
    the largest objective when ``maximize``) replaces the best when it is
    strictly better."""
    sign = -1.0 if maximize else 1.0
    it_best = torch.argmin(sign * costs, dim=-1)
    it_cost = torch.gather(costs, -1, it_best[..., None])[..., 0]
    improved = sign * it_cost < sign * state.best_cost
    idx = it_best[..., None, None].expand(*paths.shape[:-1], 1)
    bpath = torch.gather(paths, -1, idx)[..., 0]
    return state._replace(
        best_cost=torch.where(improved, it_cost, state.best_cost),
        best_path=torch.where(improved[..., None], bpath, state.best_path))


def search_update(cfg: ACOConfig, state: SearchState, paths: torch.Tensor,
                  costs: torch.Tensor, q: float | torch.Tensor | None = None, *,
                  deposit: Callable = ph.deposit) -> SearchState:
    """Best-so-far tracking and the Ant System update for scored solutions
    (``paths [..., L, A]``, ``costs [..., A]``); ``q`` overrides ``cfg.q``
    with a number or a per-instance tensor ``[...]`` (OP's ``1/sum(prizes)``);
    ``deposit`` is :func:`~deepaco_tpu_torch.aco.pheromone.deposit` (K8 on
    the card) or its plain version. With ``vector_pheromone`` every ant
    deposits ``q * objective`` (``q / cost`` when minimizing) on each item
    it picked, through :func:`~deepaco_tpu_torch.aco.pheromone.vector_deposit`
    on any device (runner.py:124-133)."""
    check_ported(cfg)
    q = cfg.q if q is None else q
    if isinstance(q, torch.Tensor):
        q = q[..., None]                          # one value an instance, [..., 1]
    state = track_best(state, paths, costs, cfg.maximize)
    if cfg.vector_pheromone:
        amounts = q * costs if cfg.maximize else q / costs
        if cfg.deposit_div_ants:
            amounts = amounts / costs.shape[-1]
        phe = state.phe._replace(tau=ph.vector_deposit(state.phe.tau * cfg.decay, paths,
                                                       amounts))
    else:
        phe = ph.as_update(state.phe, paths, costs, decay=cfg.decay,
                           cyclic=cfg.cyclic, symmetric=cfg.symmetric, q=q,
                           maximize=cfg.maximize, div_ants=cfg.deposit_div_ants,
                           cost_offset=cfg.cost_offset, deposit=deposit)
    if cfg.floor > 0.0:
        phe = phe._replace(tau=torch.clamp(phe.tau, min=cfg.floor))
    return state._replace(phe=phe)


def _no_timer(_name: str):
    return contextlib.nullcontext()


def aco_iteration(construct: Callable[[torch.Tensor, torch.Generator], torch.Tensor],
                  cost_fn: Callable[[torch.Tensor], torch.Tensor], cfg: ACOConfig,
                  state: SearchState, generator: torch.Generator, *,
                  q: float | torch.Tensor | None = None,
                  deposit: Callable = ph.deposit,
                  timer: Callable = _no_timer) -> SearchState:
    """One no-grad iteration over ``B`` instances (reference
    tsp/aco.py:75-91): construct every ant's solution from the current
    pheromone (``construct(tau, generator) -> paths``: the family's
    construction, ``families.Family.construct``), score it, track the best
    and update. ``q`` is :func:`search_update`'s; ``deposit`` takes the
    update's deposit (K8 or its plain version); ``timer(name)`` wraps the
    phases ``"construction"`` and ``"update"``."""
    with timer("construction"):
        paths = construct(state.phe.tau, generator)
    with timer("update"):
        return search_update(cfg, state, paths, cost_fn(paths), q, deposit=deposit)


@torch.no_grad()
def run_anytime(construct: Callable[[torch.Tensor, torch.Generator], torch.Tensor],
                cost_fn: Callable[[torch.Tensor], torch.Tensor], cfg: ACOConfig,
                state: SearchState, generator: torch.Generator, n_iterations: int,
                *, q: float | torch.Tensor | None = None,
                deposit: Callable = ph.deposit, timer: Callable = _no_timer
                ) -> tuple[SearchState, torch.Tensor]:
    """``n_iterations`` of :func:`aco_iteration`: the final state and the
    anytime curve ``[B, n_iterations]`` of best-so-far costs (objectives
    when maximizing). ``q`` is :func:`search_update`'s: the family's
    ``extras`` (``Family.extras``)."""
    curve = []
    for _ in range(n_iterations):
        state = aco_iteration(construct, cost_fn, cfg, state, generator, q=q,
                              deposit=deposit, timer=timer)
        curve.append(state.best_cost)
    return state, torch.stack(curve, dim=1)


def as_instance(values, device) -> torch.Tensor:
    """One instance's array as an f32 tensor on ``device`` with a batch axis
    of 1 in front, the layout the plug-ins take."""
    return torch.as_tensor(values, dtype=torch.float32, device=device)[None]


class ProblemACO:
    """Base of the reference-style facades over one instance (counterpart
    of ``deepaco_tpu/aco/runner.py:319-398``; ``CVRPACO``, ``OPACO``,
    ``PCTSPACO``, ``SMTWTPACO``, ``SOPACO``, ``BPPACO``, ``MKPACO``,
    ``MKPItemsACO``, ``CVRPNLSACO``). A subclass holds its instance's arrays with
    a batch axis of 1 (:func:`as_instance`) and ``heuristic``, and provides
    ``spec(tau, heu)`` (the rollout plug-in), ``cost(paths)`` (``[1, A]``),
    ``extras()`` (the update's ``q``) and, where inference constructs
    otherwise than a pick a step, ``construct``. The search starts from the
    pheromone ``tau`` (ones by default), runs on ``device`` and draws from
    ``generator``, by default a ``torch.Generator`` seeded with ``seed``,
    which advances with every call. ``elitist`` and ``min_max`` are not
    ported and raise."""

    def __init__(self, cfg: ACOConfig, n_states: int, horizon: int, seed: int = 0, *,
                 device, generator: torch.Generator | None = None,
                 tau: torch.Tensor | None = None):
        self.cfg = cfg
        self.state = init_search(n_states, horizon, cfg, tau, batch=(1,), device=device)
        self.generator = (torch.Generator(device=device).manual_seed(seed)
                          if generator is None else generator)

    def spec(self, tau: torch.Tensor, heu: torch.Tensor):
        raise NotImplementedError

    def cost(self, paths: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def extras(self) -> dict:
        return {}

    def construct(self, tau: torch.Tensor, heu: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
        """One iteration's solutions: the rollout of ``spec``, K7 a step."""
        return rollout(self.spec(tau, heu), generator).paths

    def sample(self, require_prob: bool = True):
        """One construction on the current pheromone, a pick a step (K7 on
        the card): ``(costs [A], log_probs [horizon, A], paths [horizon+1,
        A])``, the log-probabilities differentiable in the heuristic."""
        ro = rollout(self.spec(self.state.phe.tau, self.heuristic), self.generator,
                     require_prob=require_prob)
        return self.cost(ro.paths)[0], ro.log_probs[0], ro.paths[0]

    @torch.no_grad()
    def run(self, n_iterations: int) -> torch.Tensor:
        """``n_iterations`` of ``construct`` and Ant System update (K8);
        returns the best so far."""
        heu = self.heuristic.detach()
        self.state, _ = run_anytime(lambda tau, gen: self.construct(tau, heu, gen),
                                    self.cost, self.cfg, self.state, self.generator,
                                    n_iterations, **self.extras())
        return self.best_cost

    @property
    def best_cost(self) -> torch.Tensor:
        return self.state.best_cost[0]

    # the reference's names
    lowest_cost = alltime_best_obj = best_cost

    @property
    def best_path(self) -> torch.Tensor:
        """The best solution ``[horizon + 1]`` so far."""
        return self.state.best_path[0]
