"""Sequential Ordering Problem plug-in for the rollout engine, its cost, the
validator and the reference-style facade (counterpart of
``deepaco_tpu/aco/problems/sop.py``), batched over instances.

Every ant starts at node 0 and visits each node once, a node only after all
of its predecessors (``prec[j, k] = 1`` iff ``k`` must precede ``j``,
sop/utils.py:31-38). The reference carries a dense ``[ants, n, n]``
precedence state (sop/aco.py:128-180); here, as in the JAX package, it is
the count of each node's unvisited predecessors ``[B, A, n]``: visiting
``k`` subtracts ``prec[:, k]``, and a node is open when its count is 0. The
cost is the directed path sum without wraparound (sop/aco.py:101-112), and
an update deposits on the directed consecutive pairs.

State: ``(cur [B, A], visit_mask [B, A, n], counts [B, A, n])``.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.problems.cvrp import route_cost
from deepaco_tpu_torch.aco.problems.tsp import clear_onehot, row_gatherer, score_matrix
from deepaco_tpu_torch.aco.runner import ACOConfig, ProblemACO, as_instance
from deepaco_tpu_torch.device import resolve_device


def sop_spec(phe: torch.Tensor, heu: torch.Tensor, prec: torch.Tensor, n_ants: int,
             alpha: float = 1.0, beta: float = 1.0):
    """The engine's plug-in for ``phe, heu, prec [B, n, n]`` (``prec`` 0/1);
    every ant starts at node 0. The spec carries SOP's shape for the
    engine's one-launch route (K7r)."""
    from deepaco_tpu_torch.aco.engine import RolloutSpec
    from deepaco_tpu_torch.ops.rollout import RolloutShape

    b, n, _ = phe.shape
    score = score_matrix(phe, heu, alpha, beta)
    rows = row_gatherer(b, n, phe.device)
    # row k of prec^T: the nodes whose predecessor k is, subtracted on visiting k
    succ = prec.to(phe.dtype).transpose(-1, -2).contiguous()

    def start(_generator: torch.Generator) -> torch.Tensor:
        return torch.zeros((b, n_ants), dtype=torch.int64, device=phe.device)

    def init(start_nodes: torch.Tensor):
        a = start_nodes.shape[1]
        counts = prec.to(phe.dtype).sum(dim=-1)[:, None, :].expand(b, a, n)
        counts = counts - rows(succ, start_nodes)
        visit_mask = clear_onehot(torch.ones((b, a, n), dtype=phe.dtype, device=phe.device),
                                  start_nodes)
        return start_nodes, visit_mask, counts

    def step(state, actions):
        _, visit_mask, counts = state
        return actions, clear_onehot(visit_mask, actions), counts - rows(succ, actions)

    return RolloutSpec(horizon=n - 1, start=start, init=init,
                       prob_rows=lambda state: (rows(phe, state[0]), rows(heu, state[0])),
                       mask=lambda state: state[1] * (state[2] == 0).to(phe.dtype),
                       step=step, score_rows=lambda state: rows(score, state[0]),
                       fused=(score, RolloutShape("sop", prec=prec)))


def sop_cost(dist: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Directed path lengths ``[..., A]`` of ``paths [..., n, A]``, no
    wraparound (sop/aco.py:101-112)."""
    return route_cost(dist, paths)


def validate_sop(paths: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    """Feasibility per ant ``[..., A]`` of ``paths [..., n, A]``: a
    permutation of the nodes from node 0 in which every node comes after
    each of its predecessors (``prec [..., n, n]``)."""
    p = paths.transpose(-1, -2).long()                              # [..., A, n]
    n = p.shape[-1]
    ident = torch.arange(n, device=p.device)
    perm = (torch.sort(p, dim=-1).values == ident).all(dim=-1)
    pos = torch.zeros_like(p).scatter(-1, p.clamp(0, n - 1), ident.expand_as(p))
    # prec[j, k] = 1 needs pos[k] < pos[j]
    late = pos[..., None, :] >= pos[..., :, None]                   # [..., A, j, k]
    kept = ~((prec[..., None, :, :] > 0) & late).any(dim=-1).any(dim=-1)
    return (p[..., 0] == 0) & perm & kept


class SOPACO(ProblemACO):
    """Reference-style facade (sop/aco.py; ``deepaco_tpu/aco/problems/sop.py:68-95``)
    over one instance: ``distances [n, n]``, the precedence matrix
    ``prec_mat [n, n]`` and a ``heuristic`` (default ``1 / (distances +
    1e-10)``)."""

    def __init__(self, distances, prec_mat, n_ants: int = 20, decay: float = 0.9,
                 alpha: float = 1.0, beta: float = 1.0, elitist: bool = False,
                 min_max: bool = False, heuristic=None, seed: int = 0, *, device=None,
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        self.distances, self.prec = as_instance(distances, dev), as_instance(prec_mat, dev)
        n = self.distances.shape[-1]
        self.heuristic = (1.0 / (self.distances + 1e-10) if heuristic is None
                          else as_instance(heuristic, dev))
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                        elitist=elitist, min_max=min_max, cyclic=False, symmetric=False)
        super().__init__(cfg, n, n - 1, seed, device=dev, generator=generator)

    def spec(self, tau, heu):
        cfg = self.cfg
        return sop_spec(tau, heu, self.prec, cfg.n_ants, cfg.alpha, cfg.beta)

    def cost(self, paths):
        return sop_cost(self.distances, paths)
