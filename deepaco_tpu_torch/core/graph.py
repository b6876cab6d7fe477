"""Regular sparse instance graphs (counterpart of ``deepaco_tpu/core/graph.py``)
and the blocks of an irregular one (``deepaco_tpu/models/gnn.py:43-64``).

Every node has exactly ``k`` out-edges, so the graph is a neighbour table
``nbr [..., N, K]`` with edge features ``edge [..., N, K, E]`` and, for a
masked block (SOP's), an edge-validity ``mask [..., N, K]``. All functions
take any number of leading batch dimensions. An irregular graph (CVRP-NLS's
customer k-NN plus the depot star) is ``(x, blocks)``: a few
:class:`EdgeBlock` blocks, each regular over its own source rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SparseGraph(NamedTuple):
    """A k-regular directed graph: ``x [..., N, F]``, ``nbr [..., N, K]``
    (int64 destination ids), ``edge [..., N, K, E]`` and an optional
    ``mask [..., N, K]`` (float {0, 1}; None: every edge valid), the port's
    form of one masked ``EdgeBlock`` (deepaco_tpu/models/gnn.py:43-64)."""

    x: torch.Tensor
    nbr: torch.Tensor
    edge: torch.Tensor
    mask: torch.Tensor | None = None


class EdgeBlock(NamedTuple):
    """A regular block of out-edges over the source rows ``src [R]`` (int64,
    the same for every instance; None: ``arange(N)``, the k-regular case):
    ``nbr [..., R, Kb]`` destination ids, ``edge [..., R, Kb, E]`` and an
    optional ``mask [..., R, Kb]`` (float {0, 1}; None: every edge valid)."""

    src: torch.Tensor | None
    nbr: torch.Tensor
    edge: torch.Tensor
    mask: torch.Tensor | None = None


def as_blocks(g) -> tuple[tuple[EdgeBlock, ...], torch.Tensor]:
    """``(blocks, x)`` of a :class:`SparseGraph` (one block over every node)
    or of ``(x, blocks)``."""
    if isinstance(g, SparseGraph):
        return (EdgeBlock(None, g.nbr, g.edge, g.mask),), g.x
    x, blocks = g
    return tuple(blocks), x


def scatter_blocks(blocks, outs, n: int) -> torch.Tensor:
    """Each block's per-edge values ``outs[i] [..., R, Kb]`` written into a
    dense ``[..., N, N]`` matrix at ``(src, nbr)``, zeros elsewhere (the JAX
    trainer's ``heu.at[rows, b.nbr].set(h)``, special.py:160-169). The
    blocks' rows and each row's columns hold no duplicate, so the write
    order does not matter."""
    lead = outs[0].shape[:-2]
    dense = torch.zeros((*lead, n * n), dtype=outs[0].dtype, device=outs[0].device)
    for b, h in zip(blocks, outs):
        src = (torch.arange(n, device=h.device) if b.src is None else b.src)[:, None]
        flat = (src * n + b.nbr).expand(*lead, *b.nbr.shape[-2:]).reshape(*lead, -1)
        dense = dense.scatter(-1, flat, h.reshape(*lead, -1))
    return dense.reshape(*lead, n, n)


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


def gather_from_dense(graph: SparseGraph, mat: torch.Tensor) -> torch.Tensor:
    """Gather a dense ``[..., N, N]`` matrix onto the graph's support:
    ``[..., N, K]``, the inverse of :func:`scatter_to_dense` there."""
    return torch.gather(mat, -1, graph.nbr.expand(*mat.shape[:-2], *graph.nbr.shape[-2:]))


def sparse_distance_matrix(dist: torch.Tensor, k: int,
                           big: float = 1e10) -> torch.Tensor:
    """Classic-ACO support: each row keeps its ``k`` smallest distances and
    every other entry becomes ``big``; the classic heuristic is ``1 / this``."""
    vals, idx = topk_smallest(dist, k)
    return torch.full_like(dist, big).scatter(-1, idx, vals)
