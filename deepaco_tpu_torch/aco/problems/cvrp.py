"""CVRP plug-in for the rollout engine, route costs and the route validator
(counterpart of ``deepaco_tpu/aco/problems/cvrp.py``), batched over
instances.

Node 0 is the depot and every ant starts there. The visit mask clears
visited customers but keeps the depot open, except right after a depot visit
while customers remain (cvrp/aco.py:176-180); the capacity mask forbids
customers whose demand exceeds the remaining capacity, which resets at every
depot visit (cvrp/aco.py:182-202). The horizon is the static worst case
``2(n-1)`` steps; an ant that has served every customer parks on the depot
self-loop, whose cost is the distance matrix's 1e-10 diagonal.

State: ``(cur [B, A], visit_mask [B, A, N], used [B, A], cap_mask [B, A, N])``.

:class:`CVRPACO` is the reference-style facade over one instance.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.engine import rollout
from deepaco_tpu_torch.aco.problems.tsp import clear_onehot, row_gatherer, score_matrix
from deepaco_tpu_torch.aco.runner import ACOConfig, ProblemACO, as_instance
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.ops.cvrp_construct import cvrp_construct, cvrp_construct_supported
from deepaco_tpu_torch.ops.pick import fused_pick
from deepaco_tpu_torch.ops.rollout import RolloutShape


def cvrp_spec(phe: torch.Tensor, heu: torch.Tensor, demand: torch.Tensor,
              capacity: float, n_ants: int, alpha: float = 1.0,
              beta: float = 1.0):
    """The engine's plug-in for ``phe, heu [B, N, N]`` (N = customers + 1),
    ``demand [B, N]`` (0 at the depot) and ``n_ants`` ants per instance;
    the spec carries the score matrix and the capacity state for the
    engine's one-launch route (K7r)."""
    from deepaco_tpu_torch.aco.engine import RolloutSpec

    b, n, _ = phe.shape
    score = score_matrix(phe, heu, alpha, beta)
    rows = row_gatherer(b, n, phe.device)

    def visit_update(visit_mask, actions):
        visit_mask = clear_onehot(visit_mask, actions)
        work = (actions == 0) & (visit_mask[..., 1:] > 0).any(dim=-1)
        visit_mask[..., 0] = torch.where(work, 0.0, 1.0)
        return visit_mask

    def capacity_update(used, actions):
        used = torch.where(actions == 0, 0.0, used) + torch.gather(demand, 1, actions)
        cap_mask = (demand[:, None, :] <= (capacity - used)[..., None]).to(phe.dtype)
        return used, cap_mask

    def start(_generator: torch.Generator) -> torch.Tensor:
        return torch.zeros((b, n_ants), dtype=torch.int64, device=phe.device)

    def init(start_nodes: torch.Tensor):
        a = start_nodes.shape[1]
        visit_mask = visit_update(torch.ones((b, a, n), dtype=phe.dtype,
                                             device=phe.device), start_nodes)
        used, cap_mask = capacity_update(torch.zeros((b, a), dtype=phe.dtype,
                                                     device=phe.device), start_nodes)
        return start_nodes, visit_mask, used, cap_mask

    def step(state, actions):
        _, visit_mask, used, _ = state
        used, cap_mask = capacity_update(used, actions)
        return actions, visit_update(visit_mask, actions), used, cap_mask

    return RolloutSpec(horizon=2 * (n - 1), start=start, init=init,
                       prob_rows=lambda state: (rows(phe, state[0]),
                                                rows(heu, state[0])),
                       mask=lambda state: state[1] * state[3], step=step,
                       score_rows=lambda state: rows(score, state[0]),
                       fused=(score, RolloutShape("cvrp", demand, capacity)))


def cvrp_paths(phe: torch.Tensor, heu: torch.Tensor, demand: torch.Tensor,
               capacity: float, n_ants: int, generator: torch.Generator, *,
               construct, pick, alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """One iteration's routes ``[B, 2(N-1)+1, A]``, the ``paths`` of
    ``rollout(cvrp_spec(..., alpha, beta))`` in law: ``construct`` (K7c or
    its plain version, ``ops/cvrp_construct.py``) on the score matrix where
    K7c takes N, else the rollout with ``pick`` (K7 or its plain version) a
    step."""
    if cvrp_construct_supported(phe.shape[-1]):
        return construct(score_matrix(phe, heu, alpha, beta), demand, capacity, n_ants,
                         generator)
    spec = cvrp_spec(phe, heu, demand, capacity, n_ants, alpha, beta)
    return rollout(spec, generator, pick=pick).paths


def route_cost(dist: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Open route lengths ``[..., A]`` (cvrp/aco.py:132-136): the sum of
    ``dist[path[i], path[i+1]]`` over ``paths [..., L, A]``, no wrap."""
    u = paths.transpose(-1, -2).long()                     # [..., A, L]
    n = dist.shape[-1]
    edges = torch.gather(dist.flatten(-2), -1, (u[..., :-1] * n + u[..., 1:]).flatten(-2))
    return edges.reshape(*u.shape[:-1], -1).sum(dim=-1)


def validate_routes(paths: torch.Tensor, demand: torch.Tensor,
                    capacity: float) -> torch.Tensor:
    """Feasibility per ant ``[..., A]`` (cvrp_nls/test.py:20-37): every
    customer visited exactly once, and no trip's load above ``capacity``
    (1e-6 slack). ``paths [..., L, A]``, ``demand [..., N]``. Loads are
    prefix sums in f64 taken back at each depot visit, exact for the integer
    demands of the generators."""
    n = demand.shape[-1]
    p = paths.transpose(-1, -2).long()                     # [..., A, L]
    counts = torch.zeros((*p.shape[:-1], n), dtype=torch.int64, device=p.device)
    counts.scatter_add_(-1, p, torch.ones_like(p))
    covered = (counts[..., 1:] == 1).all(dim=-1)
    dem = torch.gather(demand.double()[..., None, :].expand(*p.shape[:-1], n), -1, p)
    total = torch.cumsum(dem, dim=-1)
    at_depot = torch.where(p == 0, total, torch.zeros_like(total))
    load = total - torch.cummax(at_depot, dim=-1).values
    return covered & (load <= capacity + 1e-6).all(dim=-1)


class CVRPACO(ProblemACO):
    """Reference-style facade (cvrp/aco.py:9-205; ``deepaco_tpu/aco/problems/
    cvrp.py:85-162``) over one instance: ``distances [N, N]``, ``demand
    [N]``, an optional ``heuristic`` (default ``1 / distances``) and
    ``pheromone`` (default ones). ``sample`` steps through K7, ``run``
    constructs through K7c (``cvrp_paths``) and deposits through K8;
    ``lowest_cost`` and ``shortest_path`` are the best so far."""

    def __init__(self, distances, demand, capacity: float = 50.0, n_ants: int = 20,
                 decay: float = 0.9, alpha: float = 1.0, beta: float = 1.0,
                 elitist: bool = False, min_max: bool = False, heuristic=None,
                 pheromone=None, seed: int = 0, *, device=None,
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        self.distances = as_instance(distances, dev)
        self.demand = as_instance(demand, dev)
        self.capacity = float(capacity)
        self.n = self.distances.shape[-1]
        self.heuristic = (1.0 / self.distances if heuristic is None
                          else as_instance(heuristic, dev))
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                        elitist=elitist, min_max=min_max, cyclic=False,
                        symmetric=False, floor=1e-10)
        super().__init__(cfg, self.n, 2 * (self.n - 1), seed, device=dev, generator=generator,
                         tau=None if pheromone is None else as_instance(pheromone, dev))

    def spec(self, tau, heu):
        cfg = self.cfg
        return cvrp_spec(tau, heu, self.demand, self.capacity, cfg.n_ants, cfg.alpha, cfg.beta)

    def construct(self, tau, heu, generator):
        cfg = self.cfg
        return cvrp_paths(tau, heu, self.demand, self.capacity, cfg.n_ants, generator,
                          construct=cvrp_construct, pick=fused_pick, alpha=cfg.alpha,
                          beta=cfg.beta)

    def cost(self, paths):
        return route_cost(self.distances, paths)

    shortest_path = ProblemACO.best_path
