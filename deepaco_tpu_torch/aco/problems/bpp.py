"""Bin Packing plug-in: the CVRP construction at capacity 150, Falkenauer's
fitness, the validator and the reference-style facade (counterpart of
``deepaco_tpu/aco/problems/bpp.py``), batched over instances.

Node 0 is the bin separator (the CVRP "depot") and items 1..n carry their
sizes as demands; an ant builds its bins with the CVRP visit and capacity
masks (bpp/aco.py:44-211), so it constructs through ``cvrp_spec`` (K7 a
step) in training and through ``cvrp_paths`` (K7c) in inference. The
fitness, maximized, is ``sum((fill / C)^2) / n_bins`` (bpp/aco.py:12-40);
an update deposits ``fitness / A`` from every ant (``deposit_div_ants``),
floored at 1e-10 (bpp/aco.py:106-119). The prior heuristic is each item's
size, the same for every row, and 1e-5 into the separator (bpp/aco.py:74-75).
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.problems.cvrp import cvrp_paths, cvrp_spec, validate_routes
from deepaco_tpu_torch.aco.runner import ACOConfig, ProblemACO, as_instance
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.ops.cvrp_construct import cvrp_construct
from deepaco_tpu_torch.ops.pick import fused_pick


def bpp_fitness(demand: torch.Tensor, capacity: float, paths: torch.Tensor) -> torch.Tensor:
    """Falkenauer fitness per ant ``[..., A]`` of ``paths [..., L, A]``
    (``demand [..., N]``, 0 at the separator), vectorised from the JAX
    package's scan (bpp.py:22-48): each separator closes the bin before it
    with ``(fill / capacity)^2``, and the bin count is ``L - last_zeros -
    N + 1``, ``last_zeros`` the separators that park the path after its last
    item. A bin's fill is a difference of f64 prefix sums, exact for the
    integer sizes of the generators."""
    p = paths.transpose(-1, -2).long()                              # [..., A, L]
    n_nodes, length = demand.shape[-1], p.shape[-1]
    size = torch.gather(demand.double()[..., None, :].expand(*p.shape[:-1], n_nodes), -1, p)
    total = torch.cumsum(size, dim=-1)
    sep = p == 0
    at_sep = torch.where(sep, total, torch.zeros_like(total))
    # the prefix sum at the separator before each position
    before = torch.cat([torch.zeros_like(total[..., :1]),
                        torch.cummax(at_sep, dim=-1).values[..., :-1]], dim=-1)
    fill = (total - before).to(demand.dtype)
    closed = torch.where(sep, (fill / capacity) ** 2, torch.zeros_like(fill))
    idx = torch.arange(length, device=p.device)
    last_nonzero = torch.where(sep, -1, idx).amax(dim=-1)
    last_zeros = length - 1 - last_nonzero
    n_bins = length - last_zeros - n_nodes + 1
    return closed.sum(dim=-1) / n_bins


def validate_bpp(paths: torch.Tensor, demand: torch.Tensor, capacity: float) -> torch.Tensor:
    """Feasibility per ant ``[..., A]`` of ``paths [..., L, A]``: it starts at
    the separator, packs every item exactly once, and no bin holds more than
    ``capacity``."""
    return (paths[..., 0, :] == 0) & validate_routes(paths, demand, capacity)


def bpp_default_heuristic(demand: torch.Tensor) -> torch.Tensor:
    """The classic prior (bpp/aco.py:74-75): ``heu[i, j] = demand[j]`` and
    ``1e-5`` into the separator, ``[..., N, N]``."""
    n = demand.shape[-1]
    heu = demand[..., None, :].expand(*demand.shape[:-1], n, n).clone()
    heu[..., 0] = 1e-5
    return heu


class BPPACO(ProblemACO):
    """Reference-style facade (bpp/aco.py; ``deepaco_tpu/aco/problems/bpp.py:51-83``)
    over one instance: ``demand [N]`` (0 at the separator), ``capacity``
    and a ``heuristic`` (default the classic prior). ``sample`` steps
    through K7, ``run`` constructs through K7c and deposits through K8;
    ``best_fitness`` is the best so far, maximized."""

    def __init__(self, demand, capacity: float = 150.0, n_ants: int = 20,
                 decay: float = 0.9, alpha: float = 1.0, beta: float = 1.0,
                 elitist: bool = False, heuristic=None, seed: int = 0, *, device=None,
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        self.demand = as_instance(demand, dev)
        self.capacity = float(capacity)
        n = self.demand.shape[-1]
        self.heuristic = (bpp_default_heuristic(self.demand) if heuristic is None
                          else as_instance(heuristic, dev))
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                        elitist=elitist, maximize=True, cyclic=False, symmetric=False,
                        floor=1e-10, deposit_div_ants=True)
        super().__init__(cfg, n, 2 * (n - 1), seed, device=dev, generator=generator)

    def spec(self, tau, heu):
        cfg = self.cfg
        return cvrp_spec(tau, heu, self.demand, self.capacity, cfg.n_ants, cfg.alpha, cfg.beta)

    def construct(self, tau, heu, generator):
        cfg = self.cfg
        return cvrp_paths(tau, heu, self.demand, self.capacity, cfg.n_ants, generator,
                          construct=cvrp_construct, pick=fused_pick, alpha=cfg.alpha,
                          beta=cfg.beta)

    def cost(self, paths):
        return bpp_fitness(self.demand, self.capacity, paths)

    best_fitness = ProblemACO.best_cost
