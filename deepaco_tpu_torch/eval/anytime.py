"""Anytime-quality evaluation protocol for TSP (counterpart of
``deepaco_tpu/eval/anytime.py``), the entry point of the slice.

Per instance: build the heuristic (neural, or the classic sparsified
``1/d``), then run ACO with a persistent pheromone state and report the mean
best-so-far cost at cumulative T. With ``ls="2opt"`` or ``"nls"`` it is the
TSP-NLS protocol (reference tsp_nls/test.py:17-56): every ant's tour goes
through local search, and the neural heuristic reads the one-hot start node.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.batched_tsp import (KERNEL_OPS, PathOps,
                                               run_anytime_batched)
from deepaco_tpu_torch.aco.engine import rollout
from deepaco_tpu_torch.aco.problems.tsp import tour_cost, tsp_spec
from deepaco_tpu_torch.aco.runner import ACOConfig, init_search, run_anytime
from deepaco_tpu_torch.core.builders import start_node_features
from deepaco_tpu_torch.core.graph import (knn_graph, scatter_to_dense,
                                          sparse_distance_matrix)
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops.fused_gnn import (dense_heuristic_supported,
                                             embnet_supported, net_forward_fast)
from deepaco_tpu_torch.ops.gnn_layer import fused_gnn_layer_plain
from deepaco_tpu_torch.utils.datasets import distance_matrix
from deepaco_tpu_torch.utils.metrics import phase


def tsp_instance_curve(heu: torch.Tensor, dist: torch.Tensor, cfg: ACOConfig,
                       generator: torch.Generator, t_max: int) -> torch.Tensor:
    """The best-so-far cost after each of ``t_max`` iterations ``[t_max]``
    of one instance (``heu, dist [N, N]``; anytime.py:24-32): ``tsp_spec``'s
    rollout from uniform starts (one K7r launch on the card) and the runner's
    update (K8)."""
    n = dist.shape[-1]
    heu, dist = heu[None], dist[None]
    state = init_search(n, n - 1, cfg, batch=(1,), device=dist.device)
    _, curve = run_anytime(
        lambda tau, gen: rollout(tsp_spec(tau, heu, cfg.n_ants, alpha=cfg.alpha,
                                          beta=cfg.beta), gen).paths,
        lambda paths: tour_cost(dist, paths), cfg, state, generator, t_max)
    return curve[0]


@torch.no_grad()
def dense_heuristic(net: Net, x: torch.Tensor, coords: torch.Tensor,
                    dist: torch.Tensor, k_sparse: int, *,
                    _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    """The neural heuristic ``[B, N, N]`` over node features ``x [B, N, F]``,
    routed by configuration as ``deepaco_tpu/eval/anytime.py:47-75`` routes
    it: K1 where :func:`dense_heuristic_supported` holds; else the k-NN
    graph through ``net_forward_fast`` (layer stack K9) where
    :func:`embnet_supported` holds, else through ``Net`` with the plain
    layer; each then ``scatter_to_dense`` plus 1e-10."""
    n = dist.shape[-1]
    if dense_heuristic_supported(net, n, k_sparse):
        return _ops.heuristic(net, x, dist, k_sparse)
    g = knn_graph(coords, dist, k_sparse, node_feats=x)
    if embnet_supported(net, n, k_sparse):
        vec = net_forward_fast(net, g.x, g.nbr, g.edge, layers=_ops.layers)
    else:
        out = net(g, layer=fused_gnn_layer_plain)
        vec = out[1] if isinstance(out, tuple) else out
    return scatter_to_dense(g, vec) + 1e-10


def batched_tsp_heuristic(net: Net, coords: torch.Tensor, k_sparse: int, *,
                          _ops: PathOps = KERNEL_OPS):
    """``coords [B, N, 2]`` → ``(heu [B, N, N], dist [B, N, N])``, the
    heuristic by :func:`dense_heuristic` on the coordinates."""
    with phase("heuristic.distance"):
        dist = distance_matrix(coords)
    return dense_heuristic(net, coords, coords, dist, k_sparse, _ops=_ops), dist


def _eval_neural(net: Net, cfg: ACOConfig, k_sparse: int, t_max: int,
                 coords: torch.Tensor, generator: torch.Generator, *,
                 stats: dict | None = None, _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    with phase("heuristic", _ops.timer):
        heu, dist = batched_tsp_heuristic(net, coords, k_sparse, _ops=_ops)
    return run_anytime_batched(heu, dist, cfg, generator, t_max, stats=stats, _ops=_ops)


def _eval_classic(cfg: ACOConfig, k_sparse: int, t_max: int,
                  coords: torch.Tensor, generator: torch.Generator, *,
                  stats: dict | None = None, _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    with phase("heuristic", _ops.timer):
        with phase("heuristic.distance"):
            dist = distance_matrix(coords)
        heu = 1.0 / sparse_distance_matrix(dist, k_sparse)
    return run_anytime_batched(heu, dist, cfg, generator, t_max, stats=stats, _ops=_ops)


def _eval_ls(net: Net | None, cfg: ACOConfig, k_sparse: int, t_max: int,
             ls: str, coords: torch.Tensor, generator: torch.Generator, *,
             stats: dict | None = None, _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    """The TSP-NLS anytime protocol, batched. The neural heuristic is
    :func:`dense_heuristic` on the one-hot start-node feature
    (tsp_nls/utils.py:37-45); the classic one is
    ``1/sparse_distance_matrix``. The JAX package runs this
    in host chunks of instances and single iterations to stay under a TPU
    watchdog; here the batch runs whole, which changes nothing in law, since
    instances are independent and each keeps its own search state."""
    with phase("heuristic", _ops.timer):
        with phase("heuristic.distance"):
            dist = distance_matrix(coords)
            x = None if net is None else start_node_features(coords)
        if net is None:
            heu = 1.0 / sparse_distance_matrix(dist, k_sparse)
        else:
            heu = dense_heuristic(net, x, coords, dist, k_sparse, _ops=_ops)
    return run_anytime_batched(heu, dist, cfg, generator, t_max,
                               coords=coords, ls=ls, stats=stats, _ops=_ops)


@torch.no_grad()
def evaluate_tsp(coords, *, net: Net | None = None, k_sparse: int,
                 cfg: ACOConfig | None = None,
                 t_values=(1, 10, 20, 30, 40, 50, 100), seed: int = 0,
                 ls: str | None = None, device=None, stats: dict | None = None,
                 _ops: PathOps = KERNEL_OPS):
    """Anytime sweep over ``coords [B, N, 2]``.

    Returns ``(mean best-so-far cost at each of t_values, curves [B, t_max])``.
    ``net=None`` runs the classic-ACO baseline (sparsified ``1/d``
    heuristic). ``ls`` in {``"2opt"``, ``"nls"``} runs the TSP-NLS protocol
    (local search on every ant, start-node feature when neural). The sweep
    runs on ``device`` (``cuda`` by default; ``cpu`` only when asked), and
    ``net`` is moved there. The private ``_ops``
    (:class:`~deepaco_tpu_torch.aco.batched_tsp.PathOps`) swaps in the plain
    versions of the kernels or a timer around each phase. ``stats``, when
    given, receives each instance's best tour (``best [B, N]``).

    Spans (``utils/metrics.phase``): ``request`` around the call;
    ``request.prologue`` (the inputs to the device, the generator, the net
    to the device), ``heuristic`` (``heuristic.distance`` and, for K1,
    ``heuristic.prepare`` and ``heuristic.k1``), each iteration's
    ``construction``, ``local_search`` and ``update``, and
    ``request.epilogue`` (the curve's gather and mean) inside it.
    """
    with phase("request"):
        with phase("request.prologue"):
            dev = resolve_device(device)
            cfg = cfg or ACOConfig()
            coords = torch.as_tensor(coords, dtype=torch.float32, device=dev)
            t_max = int(max(t_values))
            generator = torch.Generator(device=dev).manual_seed(seed)
            if net is not None:
                net = net.to(dev).eval()
        if ls is not None:
            curves = _eval_ls(net, cfg, k_sparse, t_max, ls, coords, generator,
                              stats=stats, _ops=_ops)
        elif net is None:
            curves = _eval_classic(cfg, k_sparse, t_max, coords, generator,
                                   stats=stats, _ops=_ops)
        else:
            curves = _eval_neural(net, cfg, k_sparse, t_max, coords, generator,
                                  stats=stats, _ops=_ops)
        with phase("request.epilogue"):
            idx = torch.tensor([t - 1 for t in t_values], device=dev)
            return curves[:, idx].mean(dim=0), curves
