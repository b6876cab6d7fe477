"""ACO configuration, search state, the per-iteration update and the anytime
loop (counterpart of ``deepaco_tpu/aco/runner.py``), batched over instances.

Every strategy of the JAX runner: the plain Ant System and the elitist
update (only the iteration-best deposits), MAX-MIN (tau starts at
``tau_min``; ``tau_max`` is ``mm_scale / best``, or ``mm_scale * best``
when maximizing, set on each new best, the first time with the matrix
rescaled to it, or pinned by ``mm_static_max``; tau is clamped into
``[tau_min, tau_max]``), CVRP's pheromone ``floor``, maximization (OP:
deposit ``q * objective``, the best is the largest), ``cost_offset``
(SMTWTP: deposit ``q / (cost + 1)``), ``deposit_div_ants`` (BPP: each ant
deposits ``q * fitness / A``) and the per-item vector pheromone (MKP's
PH_items, ``vector_pheromone``). :class:`ProblemACO` is the base of the
families' reference-style facades.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple

import torch

from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.aco.engine import rollout
from deepaco_tpu_torch.aco.problems.tsp import tour_cost, tsp_spec
from deepaco_tpu_torch.core.graph import sparse_distance_matrix


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


class SearchState(NamedTuple):
    phe: ph.PheromoneState
    best_cost: torch.Tensor
    best_path: torch.Tensor


def init_search(n: int, horizon: int, cfg: ACOConfig,
                tau: torch.Tensor | None = None, *, batch: tuple = (),
                device=None) -> SearchState:
    """Fresh state with leading ``batch`` dimensions: tau of ones (``[...,
    n, n]``, or ``[..., n]`` for ``vector_pheromone``; ``tau_min`` under
    MAX-MIN) unless ``tau`` is given, ``tau_max`` unset or
    ``mm_static_max``, best cost +inf (-inf when maximizing), best path
    zeros ``[..., horizon + 1]``."""
    phe = ph.init_pheromone(n, cfg.min_max, cfg.tau_min, batch=batch, device=device,
                            vector=cfg.vector_pheromone)
    if tau is not None:
        phe = phe._replace(tau=tau)
    if cfg.min_max and cfg.mm_static_max is not None:
        phe = phe._replace(tau_max=torch.full(batch, cfg.mm_static_max, device=device))
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
                  costs: torch.Tensor, q: float | torch.Tensor | None = None,
                  mm_scale: float | torch.Tensor | None = None, *,
                  deposit: Callable = ph.deposit) -> SearchState:
    """Best-so-far tracking and the pheromone update for scored solutions
    (``paths [..., L, A]``, ``costs [..., A]``), in the JAX runner's order
    (runner.py:100-141): the best, MAX-MIN's new bound on an improvement,
    the deposit (every ant, or the iteration-best under ``elitist``), the
    MAX-MIN clamp, the floor. ``q`` overrides ``cfg.q`` and ``mm_scale``
    the bound's scale (``cfg.mm_scale``, else the pheromone's size) with a
    number or a per-instance tensor ``[...]`` (OP's ``1/sum(prizes)`` and
    ``(n-1)/sum(prizes)``); ``deposit`` is
    :func:`~deepaco_tpu_torch.aco.pheromone.deposit` (K8 on the card) or its
    plain version. With ``vector_pheromone`` every ant (the iteration-best
    under ``elitist``) deposits ``q * objective`` (``q / cost`` when
    minimizing) on each item it picked, through
    :func:`~deepaco_tpu_torch.aco.pheromone.vector_deposit` on any device
    (runner.py:124-133)."""
    q = cfg.q if q is None else q
    if isinstance(q, torch.Tensor):
        q = q[..., None]                          # one value an instance, [..., 1]
    sign = -1.0 if cfg.maximize else 1.0
    it_best = torch.argmin(sign * costs, dim=-1)
    improved = sign * costs.gather(-1, it_best[..., None])[..., 0] < sign * state.best_cost
    state = track_best(state, paths, costs, cfg.maximize)
    phe = state.phe
    if cfg.min_max and cfg.mm_static_max is None:
        scale = mm_scale if mm_scale is not None else (
            cfg.mm_scale if cfg.mm_scale is not None else phe.tau.shape[-1])
        bounded = ph.min_max_on_new_best(phe, state.best_cost, scale, cfg.maximize)
        keep = improved.reshape(*improved.shape, *([1] * (phe.tau.dim() - improved.dim())))
        phe = ph.PheromoneState(torch.where(keep, bounded.tau, phe.tau),
                                torch.where(improved, bounded.tau_max, phe.tau_max))
    if cfg.vector_pheromone:
        amounts = q * costs if cfg.maximize else q / costs
        if cfg.elitist:
            amounts = torch.where(torch.arange(costs.shape[-1], device=costs.device)
                                  == it_best[..., None], amounts, 0.0)
        elif cfg.deposit_div_ants:
            amounts = amounts / costs.shape[-1]
        phe = phe._replace(tau=ph.vector_deposit(phe.tau * cfg.decay, paths, amounts))
    else:
        update = ph.elitist_update if cfg.elitist else ph.as_update
        phe = update(phe, paths, costs, decay=cfg.decay, cyclic=cfg.cyclic,
                     symmetric=cfg.symmetric, q=q, maximize=cfg.maximize,
                     div_ants=cfg.deposit_div_ants, cost_offset=cfg.cost_offset,
                     deposit=deposit)
    if cfg.min_max:
        phe = ph.min_max_clamp(phe, cfg.tau_min)
    if cfg.floor > 0.0:
        phe = phe._replace(tau=torch.clamp(phe.tau, min=cfg.floor))
    return state._replace(phe=phe)


def _no_timer(_name: str):
    return contextlib.nullcontext()


def aco_iteration(construct: Callable[[torch.Tensor, torch.Generator], torch.Tensor],
                  cost_fn: Callable[[torch.Tensor], torch.Tensor], cfg: ACOConfig,
                  state: SearchState, generator: torch.Generator, *,
                  q: float | torch.Tensor | None = None,
                  mm_scale: float | torch.Tensor | None = None,
                  deposit: Callable = ph.deposit,
                  timer: Callable = _no_timer) -> SearchState:
    """One no-grad iteration over ``B`` instances (reference
    tsp/aco.py:75-91): construct every ant's solution from the current
    pheromone (``construct(tau, generator) -> paths``: the family's
    construction, ``families.Family.construct``), score it, track the best
    and update. ``q`` and ``mm_scale`` are :func:`search_update`'s; ``deposit`` takes the
    update's deposit (K8 or its plain version); ``timer(name)`` wraps the
    phases ``"construction"`` and ``"update"``."""
    with timer("construction"):
        paths = construct(state.phe.tau, generator)
    with timer("update"):
        return search_update(cfg, state, paths, cost_fn(paths), q, mm_scale, deposit=deposit)


@torch.no_grad()
def run_anytime(construct: Callable[[torch.Tensor, torch.Generator], torch.Tensor],
                cost_fn: Callable[[torch.Tensor], torch.Tensor], cfg: ACOConfig,
                state: SearchState, generator: torch.Generator, n_iterations: int,
                *, q: float | torch.Tensor | None = None,
                mm_scale: float | torch.Tensor | None = None,
                deposit: Callable = ph.deposit, timer: Callable = _no_timer
                ) -> tuple[SearchState, torch.Tensor]:
    """``n_iterations`` of :func:`aco_iteration`: the final state and the
    anytime curve ``[B, n_iterations]`` of best-so-far costs (objectives
    when maximizing). ``q`` and ``mm_scale`` are :func:`search_update`'s:
    the family's ``extras`` (``Family.extras``) or a facade's."""
    curve = []
    for _ in range(n_iterations):
        state = aco_iteration(construct, cost_fn, cfg, state, generator, q=q,
                              mm_scale=mm_scale, deposit=deposit, timer=timer)
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
    which advances with every call."""

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
        """One iteration's solutions: the rollout of ``spec`` (K7r's
        untraced forward for a plug-in that carries ``fused``, else K7 a
        step)."""
        return rollout(self.spec(tau, heu), generator).paths

    def sample(self, require_prob: bool = True):
        """One construction on the current pheromone (K7r on the card for
        a plug-in that carries ``fused``, else K7 a step): ``(costs [A], log_probs
        [horizon, A], paths [horizon+1, A])``, the log-probabilities
        differentiable in the heuristic."""
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


class ACO(ProblemACO):
    """The reference-style TSP facade (tsp/aco.py:4-177; ``deepaco_tpu/aco/
    runner.py:162-312``) over one instance ``distances [n, n]`` with the
    heuristic ``1/d`` unless given. Each iteration constructs through
    ``tsp_spec``'s rollout (K7r's untraced forward on the card) from
    uniform starts, or from ``fixed_start`` (0 under local search,
    tsp_nls/aco.py:191), runs
    ``local_search`` (``"2opt"`` or ``"nls"``) on every ant to its fixed
    point (budget 10000), and updates (K8, cyclic and symmetric). With
    ``coords [n, 2]`` the local search is K4 or K5 on the card (their plain
    versions for CPU tensors; the dense descent past their caps); without,
    the dense descent on ``distances``."""

    LS_BUDGET = 10000                     # inference: the descent's fixed point

    def __init__(self, distances, n_ants: int = 20, decay: float = 0.9, alpha: float = 1.0,
                 beta: float = 1.0, elitist: bool = False, min_max: bool = False,
                 pheromone=None, heuristic=None, tau_min: float = 0.1, seed: int = 0,
                 fixed_start: int | None = None, local_search: str | None = None,
                 coords=None, *, device=None, generator: torch.Generator | None = None):
        from deepaco_tpu_torch.device import resolve_device

        if local_search not in (None, "2opt", "nls"):
            raise ValueError(f"local_search must be None, '2opt' or 'nls', got {local_search!r}")
        dev = resolve_device(device)
        self.distances = as_instance(distances, dev)
        self.n = n = self.distances.shape[-1]
        self.coords = (as_instance(coords, dev)
                       if coords is not None and local_search is not None else None)
        self.heuristic = (1.0 / self.distances if heuristic is None
                          else as_instance(heuristic, dev))
        self.local_search_type = local_search
        self.fixed_start = 0 if (local_search and fixed_start is None) else fixed_start
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta, elitist=elitist,
                        min_max=min_max, tau_min=tau_min)
        tau = None if pheromone is None else as_instance(pheromone, dev)
        super().__init__(cfg, n, n - 1, seed, device=dev, generator=generator, tau=tau)

    def sparsify(self, k_sparse: int) -> None:
        """The classic heuristic over each row's ``k_sparse`` nearest
        (tsp/aco.py:51-67): ``1 / sparse_distance_matrix``."""
        self.heuristic = 1.0 / sparse_distance_matrix(self.distances, k_sparse)

    def spec(self, tau, heu):
        cfg = self.cfg
        return tsp_spec(tau, heu, cfg.n_ants, self.fixed_start, cfg.alpha, cfg.beta)

    def cost(self, paths):
        return tour_cost(self.distances, paths)

    def _local_search(self, paths: torch.Tensor, budget: int) -> torch.Tensor:
        """Every ant's tour of ``paths [1, n, A]`` through the facade's local
        search with at most ``budget`` improving moves."""
        from deepaco_tpu_torch.aco.batched_tsp import KERNEL_OPS, _batched_ls_fn

        ls = _batched_ls_fn(self.local_search_type, self.coords, self.distances,
                            self.heuristic, budget, KERNEL_OPS)
        return ls(paths)

    def construct(self, tau, heu, generator):
        paths = rollout(self.spec(tau, heu), generator).paths
        if self.local_search_type is None:
            return paths
        return self._local_search(paths, self.LS_BUDGET)

    def sample_2opt(self, paths: torch.Tensor):
        """This facade's local search on ``paths [n, A]`` with the training
        budget ``n // 4`` (tsp_nls/aco.py:92-95): ``(costs [A], paths)``."""
        out = self._local_search(paths[None], max(self.n // 4, 1))
        return self.cost(out)[0], out[0]

    @property
    def shortest_path(self) -> torch.Tensor:
        return self.best_path

