"""Single-machine total weighted tardiness plug-in for the rollout engine, its
cost and the reference-style facade (counterpart of
``deepaco_tpu/aco/problems/smtwtp.py``), batched over instances.

Jobs 1..n follow a dummy start job 0, so pheromone and heuristic are
``[n+1, n+1]``; a plain visit mask over the jobs (the dummy masked from the
start), horizon exactly n steps. The cost is ``sum w * max(0, finish -
due)`` over the sequence (smtwtp/aco.py:99-109), the finish times one
``cumsum``. An update deposits ``1 / (cost + 1)`` on the consecutive directed
edges (``cost_offset = 1``, smtwtp/aco.py:86-95). The prior heuristic is
``1 / due`` broadcast over the rows (smtwtp/aco.py:50-52).

State: ``(cur [B, A], mask [B, A, n+1])``.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.problems.tsp import clear_onehot, row_gatherer, score_matrix
from deepaco_tpu_torch.aco.runner import ACOConfig, ProblemACO, as_instance
from deepaco_tpu_torch.device import resolve_device


def smtwtp_spec(phe: torch.Tensor, heu: torch.Tensor, n_ants: int, alpha: float = 1.0,
                beta: float = 1.0):
    """The engine's plug-in for ``phe, heu [B, n+1, n+1]``; every ant starts
    at the dummy job 0. Its walk is TSP's from a fixed start (the dummy
    closed at ``init``, a horizon of n steps), so the spec carries TSP's
    shape for the engine's one-launch route (K7r)."""
    from deepaco_tpu_torch.aco.engine import RolloutSpec
    from deepaco_tpu_torch.ops.rollout import TSP_SHAPE

    b, m, _ = phe.shape
    score = score_matrix(phe, heu, alpha, beta)
    rows = row_gatherer(b, m, phe.device)

    def start(_generator: torch.Generator) -> torch.Tensor:
        return torch.zeros((b, n_ants), dtype=torch.int64, device=phe.device)

    def init(start_jobs: torch.Tensor):
        mask = torch.ones((b, start_jobs.shape[1], m), dtype=phe.dtype, device=phe.device)
        mask[..., 0] = 0.0
        return start_jobs, mask

    def step(state, actions):
        return actions, clear_onehot(state[1], actions)

    return RolloutSpec(horizon=m - 1, start=start, init=init,
                       prob_rows=lambda state: (rows(phe, state[0]), rows(heu, state[0])),
                       mask=lambda state: state[1], step=step,
                       score_rows=lambda state: rows(score, state[0]),
                       fused=(score, TSP_SHAPE))


def smtwtp_cost(processing: torch.Tensor, due: torch.Tensor, weights: torch.Tensor,
                paths: torch.Tensor) -> torch.Tensor:
    """Total weighted tardiness ``[..., A]`` of ``paths [..., n+1, A]`` (row
    0 the dummy job); ``processing, due, weights [..., n]`` over the real
    jobs, 0-indexed (the reference shifts by the dummy, smtwtp/aco.py:102)."""
    jobs = paths.transpose(-1, -2)[..., 1:].long() - 1              # [..., A, n]
    lead, a = jobs.shape[:-2], jobs.shape[-2]
    take = lambda v: torch.gather(v, -1, jobs.reshape(*lead, -1)).reshape(jobs.shape)
    finish = torch.cumsum(take(processing), dim=-1)
    tardiness = torch.clamp(finish - take(due), min=0.0)
    return (take(weights) * tardiness).sum(dim=-1)


def validate_smtwtp(paths: torch.Tensor) -> torch.Tensor:
    """Feasibility per ant ``[..., A]`` of ``paths [..., n+1, A]``: the dummy
    job first, then a permutation of the jobs 1..n."""
    p = paths.transpose(-1, -2).long()                              # [..., A, n+1]
    jobs = torch.arange(1, p.shape[-1], device=p.device)
    return (p[..., 0] == 0) & (torch.sort(p[..., 1:], dim=-1).values == jobs).all(dim=-1)


def smtwtp_default_heuristic(due: torch.Tensor) -> torch.Tensor:
    """The classic prior ``1 / due`` of the destination job, 1 into the
    dummy, the same for every row (smtwtp/aco.py:50-52): ``[..., n+1, n+1]``."""
    prior = 1.0 / torch.cat([torch.ones_like(due[..., :1]), due], dim=-1)
    m = prior.shape[-1]
    return prior[..., None, :].expand(*prior.shape[:-1], m, m)


class SMTWTPACO(ProblemACO):
    """Reference-style facade (smtwtp/aco.py; ``deepaco_tpu/aco/problems/smtwtp.py:64-96``)
    over one instance: ``processing``, ``due`` and ``weights [n]`` and a
    ``heuristic [n+1, n+1]`` (default the classic prior)."""

    def __init__(self, processing, due, weights, n_ants: int = 20, decay: float = 0.9,
                 alpha: float = 1.0, beta: float = 1.0, elitist: bool = False,
                 min_max: bool = False, heuristic=None, seed: int = 0, *, device=None,
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        self.processing, self.due = as_instance(processing, dev), as_instance(due, dev)
        self.weights = as_instance(weights, dev)
        m = self.due.shape[-1] + 1
        self.heuristic = (smtwtp_default_heuristic(self.due) if heuristic is None
                          else as_instance(heuristic, dev))
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                        elitist=elitist, min_max=min_max, cyclic=False, symmetric=False,
                        cost_offset=1.0, mm_static_max=1.0 if min_max else None)
        super().__init__(cfg, m, m - 1, seed, device=dev, generator=generator)

    def spec(self, tau, heu):
        return smtwtp_spec(tau, heu, self.cfg.n_ants, self.cfg.alpha, self.cfg.beta)

    def cost(self, paths):
        return smtwtp_cost(self.processing, self.due, self.weights, paths)
