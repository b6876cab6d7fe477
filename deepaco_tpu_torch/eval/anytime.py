"""Anytime-quality evaluation protocol for TSP (counterpart of
``deepaco_tpu/eval/anytime.py``), the entry point of the slice.

Per instance: build the heuristic (neural, or the classic sparsified
``1/d``), then run ACO with a persistent pheromone state and report the mean
best-so-far cost at cumulative T.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.batched_tsp import (KERNEL_OPS, PathOps,
                                               run_anytime_batched)
from deepaco_tpu_torch.aco.runner import ACOConfig
from deepaco_tpu_torch.core.graph import sparse_distance_matrix
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops.fused_gnn import tsp_dense_heuristic
from deepaco_tpu_torch.utils.datasets import distance_matrix


def batched_tsp_heuristic(net: Net, coords: torch.Tensor, k_sparse: int, *,
                          _heuristic=tsp_dense_heuristic):
    """``coords [B, N, 2]`` → ``(heu [B, N, N], dist [B, N, N])``; on CUDA
    the heuristic is one call of kernel K1."""
    dist = distance_matrix(coords)
    return _heuristic(net, coords, dist, k_sparse), dist


def _eval_neural(net: Net, cfg: ACOConfig, k_sparse: int, t_max: int,
                 coords: torch.Tensor, generator: torch.Generator, *,
                 _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    with _ops.timer("heuristic"):
        heu, dist = batched_tsp_heuristic(net, coords, k_sparse,
                                          _heuristic=_ops.heuristic)
    return run_anytime_batched(heu, dist, cfg, generator, t_max, _ops=_ops)


def _eval_classic(cfg: ACOConfig, k_sparse: int, t_max: int,
                  coords: torch.Tensor, generator: torch.Generator, *,
                  _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    with _ops.timer("heuristic"):
        dist = distance_matrix(coords)
        heu = 1.0 / sparse_distance_matrix(dist, k_sparse)
    return run_anytime_batched(heu, dist, cfg, generator, t_max, _ops=_ops)


@torch.no_grad()
def evaluate_tsp(coords, *, net: Net | None = None, k_sparse: int,
                 cfg: ACOConfig | None = None,
                 t_values=(1, 10, 20, 30, 40, 50, 100), seed: int = 0,
                 ls: str | None = None, device=None,
                 _ops: PathOps = KERNEL_OPS):
    """Anytime sweep over ``coords [B, N, 2]``.

    Returns ``(mean best-so-far cost at each of t_values, curves [B, t_max])``.
    ``net=None`` runs the classic-ACO baseline (sparsified ``1/d``
    heuristic). The sweep runs on ``device`` (``cuda`` by default; ``cpu``
    only when asked), and ``net`` is moved there. The private ``_ops``
    (:class:`~deepaco_tpu_torch.aco.batched_tsp.PathOps`) swaps in the plain
    versions of the kernels or a timer around each phase.
    """
    if ls is not None:
        raise NotImplementedError(
            "local search (TSP-NLS) is not ported to deepaco_tpu_torch yet; "
            "see ROADMAP.md")
    dev = resolve_device(device)
    cfg = cfg or ACOConfig()
    coords = torch.as_tensor(coords, dtype=torch.float32, device=dev)
    t_max = int(max(t_values))
    generator = torch.Generator(device=dev).manual_seed(seed)
    if net is None:
        curves = _eval_classic(cfg, k_sparse, t_max, coords, generator,
                               _ops=_ops)
    else:
        net = net.to(dev).eval()
        curves = _eval_neural(net, cfg, k_sparse, t_max, coords, generator,
                              _ops=_ops)
    idx = torch.tensor([t - 1 for t in t_values], device=dev)
    return curves[:, idx].mean(dim=0), curves
