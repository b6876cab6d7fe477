"""Orienteering Problem plug-in for the rollout engine, its objective and the
reference-style facade (counterpart of ``deepaco_tpu/aco/problems/op.py``),
batched over instances.

Node 0 is the start and end depot; a dummy terminal node ``n`` is appended
(op/aco.py:65-86) with distance 0 from every node, 1e10 back to the real
nodes, heuristic 0 from the dummy to a real node and 1 into the dummy, so a
finished ant sinks there at no cost. The mask forbids every candidate from
which the ant could not get back to the depot within ``max_len``
(op/aco.py:199-220). The objective is the sum of the collected prizes,
maximized; an iteration deposits ``q * objective`` with ``q = 1/sum(prizes)``
(op/aco.py:53, 130-145), the family's ``extras``.

State: ``(cur [B, A], travel [B, A], mask [B, A, n+1])``.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.problems.tsp import clear_onehot, row_gatherer, score_matrix
from deepaco_tpu_torch.aco.runner import ACOConfig, ProblemACO, as_instance
from deepaco_tpu_torch.core.graph import sparse_distance_matrix
from deepaco_tpu_torch.device import resolve_device


def extend_op_instance(dist: torch.Tensor, prizes: torch.Tensor, heu: torch.Tensor):
    """Append the dummy terminal node (op/aco.py:65-86) to ``dist, heu [...,
    n, n]`` and ``prizes [..., n]``: ``[..., n+1, n+1]`` and ``[..., n+1]``."""
    n = dist.shape[-1]
    lead = dist.shape[:-2]
    row = lambda t, v: torch.full((*lead, 1, n), v, dtype=t.dtype, device=t.device)
    col = lambda t, v: torch.full((*lead, n + 1, 1), v, dtype=t.dtype, device=t.device)
    dist = torch.cat([torch.cat([dist, row(dist, 1e10)], dim=-2), col(dist, 0.0)], dim=-1)
    heu = torch.cat([torch.cat([heu, row(heu, 0.0)], dim=-2), col(heu, 1.0)], dim=-1)
    prizes = torch.cat([prizes, prizes.new_zeros((*prizes.shape[:-1], 1))], dim=-1)
    return dist, prizes, heu


def op_spec(phe: torch.Tensor, heu: torch.Tensor, dist: torch.Tensor,
            max_len: torch.Tensor, n_ants: int, alpha: float = 1.0, beta: float = 1.0):
    """The engine's plug-in for the extended ``phe, heu, dist [B, n+1, n+1]``
    and ``max_len [B]`` (or a number); every ant starts at the depot. The
    spec carries OP's shape for the engine's one-launch route (K7r)."""
    from deepaco_tpu_torch.aco.engine import RolloutSpec
    from deepaco_tpu_torch.ops.rollout import RolloutShape

    b, m, _ = phe.shape
    dummy = m - 1
    score = score_matrix(phe, heu, alpha, beta)
    rows = row_gatherer(b, m, phe.device)
    back = dist[..., :, 0][:, None, :]                              # [B, 1, m]
    lengths = torch.as_tensor(max_len, dtype=dist.dtype, device=dist.device).reshape(-1)
    lengths = lengths.expand(b).contiguous()
    limit = lengths[:, None, None]

    def update_mask(mask, travel, cur):
        mask = clear_onehot(mask, cur)
        # can the ant go to each candidate and still get back to the depot?
        # (added in JAX's order, so that a path at the boundary agrees)
        trails = travel[..., None] + rows(dist, cur) + back
        feasible = (trails <= limit).to(mask.dtype)
        real = mask.clone()
        real[..., dummy] = 0.0
        mask = torch.where((cur == dummy)[..., None], mask, real * feasible)
        mask[..., dummy] = (mask[..., :dummy] == 0.0).all(dim=-1).to(mask.dtype)
        return mask

    def start(_generator: torch.Generator) -> torch.Tensor:
        return torch.zeros((b, n_ants), dtype=torch.int64, device=phe.device)

    def init(start_nodes: torch.Tensor):
        a = start_nodes.shape[1]
        travel = torch.zeros((b, a), dtype=dist.dtype, device=dist.device)
        mask = update_mask(torch.ones((b, a, m), dtype=phe.dtype, device=phe.device),
                           travel, start_nodes)
        return start_nodes, travel, mask

    flat = dist.reshape(b, m * m)

    def step(state, actions):
        cur, travel, mask = state
        travel = travel + torch.gather(flat, 1, cur * m + actions)
        return actions, travel, update_mask(mask, travel, actions)

    return RolloutSpec(horizon=m, start=start, init=init,
                       prob_rows=lambda state: (rows(phe, state[0]), rows(heu, state[0])),
                       mask=lambda state: state[2], step=step,
                       score_rows=lambda state: rows(score, state[0]),
                       fused=(score, RolloutShape("op", dist=dist, max_len=lengths,
                                                  dummy=dummy)))


def op_objective(prizes: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Collected prize per ant ``[..., A]`` (op/aco.py:151-158): ``prizes
    [..., n+1]`` (the extended ones; the dummy's is 0) summed over ``paths
    [..., L, A]``."""
    u = paths.transpose(-1, -2).long()                              # [..., A, L]
    lead, a, l = u.shape[:-2], u.shape[-2], u.shape[-1]
    got = torch.gather(prizes, -1, u.reshape(*lead, a * l)).reshape(*lead, a, l)
    return got.sum(dim=-1)


def validate_op(paths: torch.Tensor, dist: torch.Tensor, max_len) -> torch.Tensor:
    """Feasibility per ant ``[..., A]`` of extended paths ``[..., L, A]``
    (``dist [..., n, n]``, the real nodes; ``max_len [...]`` or a number):
    it starts at the depot, visits no real node twice, stays on the dummy
    node ``n`` once there, and its tour back to the depot is at most
    ``max_len`` long (1e-5 relative slack for the f32 sums)."""
    n = dist.shape[-1]
    p = paths.transpose(-1, -2).long()                              # [..., A, L]
    real = p < n
    counts = torch.zeros((*p.shape[:-1], n + 1), dtype=torch.int64, device=p.device)
    counts.scatter_add_(-1, p, torch.ones_like(p))
    once = (counts[..., :n] <= 1).all(dim=-1)
    settled = (real[..., 1:] <= real[..., :-1]).all(dim=-1)         # no real node after the dummy
    node = torch.where(real, p, 0)
    step = torch.gather(dist.flatten(-2).unsqueeze(-2).expand(*p.shape[:-1], n * n), -1,
                        node[..., :-1] * n + node[..., 1:])
    length = torch.where(real[..., 1:], step, 0.0).double().sum(dim=-1)
    last = torch.gather(node, -1, real.long().sum(dim=-1, keepdim=True) - 1)[..., 0]
    length = length + torch.gather(dist[..., :, 0].unsqueeze(-2).expand(*p.shape[:-1], n),
                                   -1, last[..., None])[..., 0].double()
    limit = torch.as_tensor(max_len, dtype=torch.float64, device=p.device)
    if limit.dim():
        limit = limit[..., None]
    return (p[..., 0] == 0) & once & settled & (length <= limit * (1 + 1e-5))


def op_default_heuristic(dist: torch.Tensor, prizes: torch.Tensor, k_sparse: int):
    """The classic prior ``prizes / sparsified dist`` (op/aco.py:90-107)."""
    return prizes[..., None, :] / sparse_distance_matrix(dist, k_sparse)


class OPACO(ProblemACO):
    """Reference-style facade (op/aco.py; ``deepaco_tpu/aco/problems/op.py:94-134``)
    over one instance: ``distances [n, n]``, ``prizes [n]``, ``max_len``, and
    a ``heuristic`` (without one, the classic prior on ``k_sparse`` nearest
    nodes). ``run`` and ``best_cost`` report the collected prize, maximized."""

    def __init__(self, distances, prizes, max_len, n_ants: int = 20, decay: float = 0.9,
                 alpha: float = 1.0, beta: float = 1.0, elitist: bool = False,
                 min_max: bool = False, heuristic=None, k_sparse: int | None = None,
                 seed: int = 0, *, device=None, generator: torch.Generator | None = None):
        dev = resolve_device(device)
        distances, prizes = as_instance(distances, dev), as_instance(prizes, dev)
        if heuristic is None:
            if not k_sparse:
                raise ValueError("the classic OP prior needs k_sparse (op/aco.py:60-62)")
            heuristic = op_default_heuristic(distances, prizes, k_sparse)
        else:
            heuristic = as_instance(heuristic, dev)
        dist_e, prizes_e, heu_e = extend_op_instance(distances, prizes, heuristic)
        m = dist_e.shape[-1]
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                        elitist=elitist, min_max=min_max, maximize=True,
                        cyclic=False, symmetric=False)
        self.dist, self.prizes, self.heuristic = dist_e, prizes_e, heu_e
        self.max_len = torch.full((1,), float(max_len), device=dev)
        self.q = 1.0 / prizes.sum(dim=-1)
        super().__init__(cfg, m, m, seed, device=dev, generator=generator)

    def spec(self, tau, heu):
        cfg = self.cfg
        return op_spec(tau, heu, self.dist, self.max_len, cfg.n_ants, cfg.alpha, cfg.beta)

    def cost(self, paths):
        return op_objective(self.prizes, paths)

    def extras(self) -> dict:
        """``q = 1/sum(prizes)`` and MAX-MIN's scale ``n q`` (op/aco.py:121-124)."""
        return {"q": self.q, "mm_scale": (self.dist.shape[-1] - 1) * self.q}
