"""GNN input graphs (counterpart of ``deepaco_tpu/core/builders.py``; the
other families wait for their slices).

  TSP       top-k kNN, node feats = coords            (tsp/utils.py:16-36):
            ``core.graph.knn_graph`` itself
  TSP-NLS   top-k kNN, node feats = one-hot start     (tsp_nls/utils.py:17-45)
  CVRP      dense incl. self-loops, feats = demand    (cvrp/utils.py:24-33)
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.core.graph import SparseGraph, knn_graph


def start_node_features(coords: torch.Tensor, start_node: int = 0) -> torch.Tensor:
    """The TSP-NLS node feature ``[..., N, 1]``: 1 at ``start_node``, else 0."""
    x = torch.zeros((*coords.shape[:-1], 1), dtype=torch.float32,
                    device=coords.device)
    x[..., start_node, 0] = 1.0
    return x


def tsp_nls_graph(coords: torch.Tensor, dist: torch.Tensor, k: int,
                  start_node: int = 0) -> SparseGraph:
    """Start-node one-hot feature variant (tsp_nls/utils.py:37-45)."""
    return knn_graph(coords, dist, k,
                     node_feats=start_node_features(coords, start_node))


def cvrp_graph(demand: torch.Tensor, dist: torch.Tensor) -> SparseGraph:
    """The dense CVRP graph with self-loops, k-regular with K = N:
    ``x = demand [..., N, 1]``, ``nbr[..., i, :] = arange(N)``, ``edge =
    dist [..., N, N, 1]``."""
    n = dist.shape[-1]
    nbr = torch.arange(n, device=dist.device).expand(*dist.shape[:-2], n, n)
    return SparseGraph(x=demand[..., None], nbr=nbr, edge=dist[..., None])
