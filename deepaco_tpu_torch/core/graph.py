"""Regular sparse instance graphs (counterpart of ``deepaco_tpu/core/graph.py``).

Every node has exactly ``k`` out-edges, so the graph is a neighbour table
``nbr [..., N, K]`` with edge features ``edge [..., N, K, E]``. All functions
take any number of leading batch dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SparseGraph(NamedTuple):
    """A k-regular directed graph: ``x [..., N, F]``, ``nbr [..., N, K]``
    (int64 destination ids) and ``edge [..., N, K, E]``."""

    x: torch.Tensor
    nbr: torch.Tensor
    edge: torch.Tensor


def topk_smallest(dist: torch.Tensor, k: int):
    """The ``k`` smallest values of each row and their column ids, ties going
    to the lowest index (``lax.top_k(-dist)``'s order). ``torch.topk`` promises
    no tie order, so this keeps the first ``k`` of a stable ascending sort."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn_graph(coords: torch.Tensor, dist: torch.Tensor, k: int,
              node_feats: torch.Tensor | None = None) -> SparseGraph:
    """Top-k nearest-neighbour sparsification; ``dist`` carries a large
    diagonal sentinel so self-loops never enter the top-k."""
    vals, idx = topk_smallest(dist, k)
    x = coords if node_feats is None else node_feats
    return SparseGraph(x=x, nbr=idx, edge=vals[..., None])


def scatter_to_dense(graph: SparseGraph, vec: torch.Tensor,
                     fill: float = 0.0) -> torch.Tensor:
    """Scatter a per-edge ``[..., N, K]`` vector into a dense ``[..., N, N]``
    matrix, ``fill`` off the support. k-NN rows hold no duplicate column, so
    the write order does not matter."""
    n = graph.nbr.shape[-2]
    dense = torch.full((*vec.shape[:-1], n), fill, dtype=vec.dtype,
                       device=vec.device)
    return dense.scatter(-1, graph.nbr, vec)


def sparse_distance_matrix(dist: torch.Tensor, k: int,
                           big: float = 1e10) -> torch.Tensor:
    """Classic-ACO support: each row keeps its ``k`` smallest distances and
    every other entry becomes ``big``; the classic heuristic is ``1 / this``."""
    vals, idx = topk_smallest(dist, k)
    return torch.full_like(dist, big).scatter(-1, idx, vals)
