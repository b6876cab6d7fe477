"""CVRP-NLS: the CVRP construction polished by the native SWAP* local search
(counterpart of ``deepaco_tpu/aco/problems/cvrp_nls.py``).

Reference semantics (cvrp_nls/aco.py:35-448): ``sample_nls`` refines every
ant (training; move budget ``max(n, 50)``), the ``run`` loop refines the 8
cheapest ants of each iteration (cvrp_nls/aco.py:143-146; budget 100000).
The neural variant perturbs on the learned metric ``1/(heu/rowmax + 1e-5)``
between two polishes on the true distances (cvrp_nls/aco.py:443-448).

Construction, costs and the pheromone update run on the device (K7c and K8
on the card); the local search runs in the native engine on host threads
(:mod:`deepaco_tpu_torch.ls.hgs`). Each iteration copies the paths from the
device's ``[1, L, A]`` to the engine's ``[L, A]`` and back: that copy is the
host boundary of the path, timed as the phase ``"host_copy"``.
"""
from __future__ import annotations

import numpy as np
import torch

from deepaco_tpu_torch.aco.engine import rollout
from deepaco_tpu_torch.aco.problems.cvrp import CVRPACO, cvrp_paths
from deepaco_tpu_torch.aco.runner import search_update
from deepaco_tpu_torch.ls import hgs
from deepaco_tpu_torch.train.drivers import KERNEL_OPS, FamilyOps
from deepaco_tpu_torch.utils.metrics import phase

INFERENCE_LS_COUNT = 100000


def perturbation_metric(heu: np.ndarray) -> np.ndarray:
    """``1 / (heu / rowmax + 1e-5)`` on the f32 heuristic ``[N, N]``, in f32
    as the JAX package computes it (cvrp_nls.py:58-62), so that the neural
    metric and the routes it leads to are the same bits."""
    heu = np.asarray(heu, np.float32)
    return np.float32(1.0) / (heu / heu.max(-1, keepdims=True) + np.float32(1e-5))


class CVRPNLSACO(CVRPACO):
    """Reference-style facade (cvrp_nls/aco.py ACO with ``swapstar=True``;
    ``deepaco_tpu/aco/problems/cvrp_nls.py:28-99``) over one instance with
    demands normalised to ``capacity`` 1. ``run`` constructs through
    ``ops.construct`` (K7c), refines the ``topk_refine`` cheapest ants and
    deposits through ``ops.deposit`` (K8); ``ops`` is
    ``train.drivers.FamilyOps`` (``drivers.PLAIN_OPS`` for the plain
    versions), and ``ops.timer`` wraps the phases ``"construction"``,
    ``"host_copy"``, ``"local_search"`` and ``"update"``. One native
    context a metric lives for the whole search."""

    def __init__(self, distances, demand, capacity: float = 1.0, n_ants: int = 20,
                 swap_star: bool = True, neural_perturb: bool = True,
                 topk_refine: int = 8, coords=None, *, ops: FamilyOps = KERNEL_OPS,
                 **kwargs):
        super().__init__(distances, demand, capacity, n_ants=n_ants, **kwargs)
        self.swap_star = swap_star
        self.neural_perturb = neural_perturb
        self.topk_refine = topk_refine
        self.ops = ops
        self._dist_np = self.distances[0].cpu().numpy().astype(np.float64)
        self._dem_np = self.demand[0].cpu().numpy().astype(np.float64)
        # coords enable the engine's polar-sector pruning of SWAP*'s route pairs
        self._coords_np = None if coords is None else np.asarray(coords, np.float64)
        self._ctx = hgs.LSContext(self._dem_np, self._dist_np, coords=self._coords_np)
        self._heu_dist = None
        self._heu_ctx = None

    @property
    def heuristic_dist(self) -> np.ndarray:
        """The perturbation metric (cvrp_nls/aco.py:128-132), from the
        heuristic, which does not change during the search."""
        if self._heu_dist is None:
            self._heu_dist = perturbation_metric(self.heuristic[0].detach().cpu().numpy())
        return self._heu_dist

    def construct(self, tau, heu, generator):
        cfg = self.cfg
        return cvrp_paths(tau, heu, self.demand, self.capacity, cfg.n_ants, generator,
                          construct=self.ops.construct, pick=self.ops.pick,
                          alpha=cfg.alpha, beta=cfg.beta)

    def _ls(self, paths: np.ndarray, indexes=None, inference: bool = False) -> np.ndarray:
        """Refine the ants ``indexes`` (all by default) of ``paths [L, A]`` in
        place (reference multiple_swap_star)."""
        count = INFERENCE_LS_COUNT if inference else max(self.n - 1, 50)
        hd = self.heuristic_dist if self.neural_perturb else None
        if hd is not None and self._heu_ctx is None:
            self._heu_ctx = hgs.LSContext(self._dem_np, hd, coords=self._coords_np)
        idx = list(range(paths.shape[1]) if indexes is None else indexes)
        paths[:, idx] = hgs.multiple_swap_star(
            self._dem_np, self._dist_np, paths[:, idx], count=count, heu_dist=hd,
            context=self._ctx, heu_context=self._heu_ctx)
        return paths

    def sample_nls(self):
        """``(ls_costs [A], log_probs [L-1, A], raw_costs [A])``: one
        construction through ``ops.pick``'s one-launch rollout (K7r) with its
        log-probabilities, every ant refined (cvrp_nls/aco.py:106-111)."""
        ro = rollout(self.spec(self.state.phe.tau, self.heuristic), self.generator,
                     require_prob=True, pick=self.ops.pick)
        raw_costs = self.cost(ro.paths)
        paths = self._ls(ro.paths[0].cpu().numpy().copy())
        costs = self.cost(torch.from_numpy(paths).to(ro.paths.device)[None])
        return costs[0], ro.log_probs[0], raw_costs[0]

    @torch.no_grad()
    def run(self, n_iterations: int) -> torch.Tensor:
        """Per iteration: construct, cost, refine the ``topk_refine`` ants of
        lowest cost (``np.argsort`` of the host costs, as the JAX package
        picks them), cost again, update (cvrp_nls/aco.py:135-165). Returns
        the best cost so far."""
        heu = self.heuristic.detach()
        timer = self.ops.timer
        for _ in range(n_iterations):
            with phase("construction", timer):
                paths = self.construct(self.state.phe.tau, heu, self.generator)
            costs = self.cost(paths)
            if self.swap_star:
                with phase("host_copy", timer):
                    host = paths[0].cpu().numpy().copy()
                    order = np.argsort(costs[0].cpu().numpy())
                with phase("local_search", timer):
                    host = self._ls(host, order[:min(self.topk_refine, len(order))],
                                    inference=True)
                with phase("host_copy", timer):
                    paths = torch.from_numpy(host).to(paths.device)[None]
                costs = self.cost(paths)
            with phase("update", timer):
                self.state = search_update(self.cfg, self.state, paths, costs,
                                           deposit=self.ops.deposit)
        return self.best_cost
