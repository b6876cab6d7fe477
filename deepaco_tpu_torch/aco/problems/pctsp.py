"""Prize-Collecting TSP plug-in for the rollout engine, its objective and the
reference-style facade (counterpart of ``deepaco_tpu/aco/problems/pctsp.py``),
batched over instances.

Node 0 is the depot and every ant starts there. The depot is gated shut
until the ant has collected more than ``min_prizes`` of prize or visited
every node (pctsp/aco.py:172-184); arriving at the depot parks the ant:
every other node is masked and the depot's self-loop stays open, so the
path repeats the depot to the static horizon ``n + 1``. The objective is
the length of the path plus the penalties of the nodes never visited
(pctsp/aco.py:120-129), minimized. The prior heuristic is ``(1e-10 +
prize) / dist`` with a 1e9 diagonal (pctsp/aco.py:54-56).

State: ``(cur [B, A], visit_mask [B, A, N], depot_mask [B, A, N],
collected [B, A])``.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.problems.tsp import clear_onehot, row_gatherer, score_matrix
from deepaco_tpu_torch.aco.runner import ACOConfig, ProblemACO, as_instance
from deepaco_tpu_torch.device import resolve_device


def pctsp_spec(phe: torch.Tensor, heu: torch.Tensor, prizes: torch.Tensor,
               min_prizes: float, n_ants: int, alpha: float = 1.0, beta: float = 1.0):
    """The engine's plug-in for ``phe, heu [B, N, N]`` (N = nodes + 1, the
    depot first), ``prizes [B, N]`` (0 at the depot) and the prize gate
    ``min_prizes``. The spec carries PCTSP's shape for the engine's
    one-launch route (K7r)."""
    from deepaco_tpu_torch.aco.engine import RolloutSpec
    from deepaco_tpu_torch.ops.rollout import RolloutShape

    b, n, _ = phe.shape
    score = score_matrix(phe, heu, alpha, beta)
    rows = row_gatherer(b, n, phe.device)

    def update_masks(visit_mask, depot_mask, cur, collected):
        visit_mask = clear_onehot(visit_mask, cur)
        at_depot = (cur == 0)[..., None]
        # at the depot: park (the depot open, every other node masked)
        parked = torch.zeros_like(visit_mask)
        parked[..., 0] = 1.0
        visit_mask = torch.where(at_depot, parked, visit_mask)
        all_visited = (visit_mask[..., 1:] == 0.0).all(dim=-1)
        open_depot = ~at_depot[..., 0] & ((collected > min_prizes) | all_visited)
        depot_mask = depot_mask.clone()
        depot_mask[..., 0] = torch.where(open_depot, 1.0, depot_mask[..., 0])
        return visit_mask, depot_mask

    def start(_generator: torch.Generator) -> torch.Tensor:
        return torch.zeros((b, n_ants), dtype=torch.int64, device=phe.device)

    def init(start_nodes: torch.Tensor):
        # the reference's gen_sol does not update the masks before the first
        # pick: the depot gate alone keeps node 0 shut, and visit_mask[..., 0]
        # stays 1 so that the depot opens with the gate (pctsp/aco.py:135-146)
        a = start_nodes.shape[1]
        visit_mask = torch.ones((b, a, n), dtype=phe.dtype, device=phe.device)
        depot_mask = visit_mask.clone()
        depot_mask[..., 0] = 0.0
        collected = torch.zeros((b, a), dtype=phe.dtype, device=phe.device)
        return start_nodes, visit_mask, depot_mask, collected

    def step(state, actions):
        _, visit_mask, depot_mask, collected = state
        collected = collected + torch.gather(prizes, 1, actions)
        visit_mask, depot_mask = update_masks(visit_mask, depot_mask, actions, collected)
        return actions, visit_mask, depot_mask, collected

    return RolloutSpec(horizon=n + 1, start=start, init=init,
                       prob_rows=lambda state: (rows(phe, state[0]), rows(heu, state[0])),
                       mask=lambda state: state[1] * state[2], step=step,
                       score_rows=lambda state: rows(score, state[0]),
                       fused=(score, RolloutShape("pctsp", prizes=prizes,
                                                  min_prizes=min_prizes)))


def pctsp_objective(dist: torch.Tensor, prizes: torch.Tensor, penalties: torch.Tensor,
                    paths: torch.Tensor) -> torch.Tensor:
    """Path length plus the penalties of unvisited nodes ``[..., A]``
    (pctsp/aco.py:107-129) for ``paths [..., L, A]``, ``dist [..., N, N]``
    and ``prizes, penalties [..., N]``."""
    u = paths.transpose(-1, -2).long()                              # [..., A, L]
    n = dist.shape[-1]
    lead, a = u.shape[:-2], u.shape[-2]
    idx = (u[..., :-1] * n + u[..., 1:]).reshape(*lead, -1)
    length = torch.gather(dist.flatten(-2), -1, idx).reshape(*lead, a, -1).sum(dim=-1)
    visited = torch.zeros((*lead, a, n), dtype=torch.bool, device=u.device)
    visited.scatter_(-1, u, True)
    unvisited = torch.where(visited, 0.0, penalties[..., None, :])
    return length + unvisited.sum(dim=-1)


def validate_pctsp(paths: torch.Tensor, prizes: torch.Tensor, min_prizes: float) -> torch.Tensor:
    """Feasibility per ant ``[..., A]`` of ``paths [..., L, A]`` (``prizes
    [..., N]``, the depot first): it starts at the depot, visits no node
    twice, ends parked on the depot, and collected more than ``min_prizes``
    (f64 sums) or visited every node."""
    n = prizes.shape[-1]
    p = paths.transpose(-1, -2).long()                              # [..., A, L]
    counts = torch.zeros((*p.shape[:-1], n), dtype=torch.int64, device=p.device)
    counts.scatter_add_(-1, p, torch.ones_like(p))
    once = (counts[..., 1:] <= 1).all(dim=-1)
    home = p[..., 1:] == 0
    parked = (home[..., 1:] >= home[..., :-1]).all(dim=-1) & home[..., -1]
    collected = torch.where(counts[..., 1:] > 0, prizes.double()[..., None, 1:], 0.0).sum(-1)
    gate = (collected > min_prizes) | (counts[..., 1:] > 0).all(dim=-1)
    return (p[..., 0] == 0) & once & parked & gate


def pctsp_default_heuristic(dist: torch.Tensor, prizes: torch.Tensor) -> torch.Tensor:
    """The classic prior ``(1e-10 + prize[j]) / dist[i, j]`` with the diagonal
    at 1e9 (pctsp/aco.py:54-56)."""
    n = dist.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    return (1e-10 + prizes[..., None, :]) / torch.where(eye, 1e9, dist)


class PCTSPACO(ProblemACO):
    """Reference-style facade (pctsp/aco.py; ``deepaco_tpu/aco/problems/pctsp.py:85-119``)
    over one instance: ``distances [N, N]``, ``prizes`` and ``penalties
    [N]`` (the depot first) and a ``heuristic`` (default the classic prior).
    Its prize gate is ``N / 4``, as JAX's facade sets it."""

    def __init__(self, distances, prizes, penalties, n_ants: int = 20, decay: float = 0.9,
                 alpha: float = 1.0, beta: float = 1.0, elitist: bool = False,
                 min_max: bool = False, heuristic=None, seed: int = 0, *, device=None,
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        self.dist, self.prizes = as_instance(distances, dev), as_instance(prizes, dev)
        self.penalties = as_instance(penalties, dev)
        n = self.dist.shape[-1]
        self.heuristic = (pctsp_default_heuristic(self.dist, self.prizes) if heuristic is None
                          else as_instance(heuristic, dev))
        self.min_prizes = n / 4.0
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                        elitist=elitist, min_max=min_max, cyclic=False, symmetric=False,
                        mm_scale=float(n - 1))
        super().__init__(cfg, n, n + 1, seed, device=dev, generator=generator)

    def spec(self, tau, heu):
        cfg = self.cfg
        return pctsp_spec(tau, heu, self.prizes, self.min_prizes, cfg.n_ants, cfg.alpha,
                          cfg.beta)

    def cost(self, paths):
        return pctsp_objective(self.dist, self.prizes, self.penalties, paths)
