"""GNN input graphs (counterpart of ``deepaco_tpu/core/builders.py``; the
other families wait for their slices). Every builder takes leading batch
dimensions.

  TSP       top-k kNN, node feats = coords            (tsp/utils.py:16-36):
            ``core.graph.knn_graph`` itself
  TSP-NLS   top-k kNN, node feats = one-hot start     (tsp_nls/utils.py:17-45)
  CVRP      dense incl. self-loops, feats = demand    (cvrp/utils.py:24-33)
  CVRP-NLS  customer kNN + depot star, two blocks     (cvrp_nls/utils.py:35-60)
  OP        top-k kNN, feats = (dist-to-depot, prize) (op/utils.py:26-48)
  PCTSP     dense, feats = (prize, penalty)           (pctsp/utils.py:31-40)
  SMTWTP    dense over n+1 jobs, attr = proc[dst]     (smtwtp/utils.py:5-22)
  MKP       dense, x = weight [n, m], attr = prize[src] (mkp/utils.py:27-36)
  SOP       masked dense, x = cost row 0, mask = adj  (sop/utils.py:52-58)
  BPP       ``cvrp_graph(demand, ones)``              (bpp/utils.py:14-23)
  RCPSP     masked dense, E = 2 edge types            (rcpsp_inst.py:202-222)
"""
from __future__ import annotations

import numpy as np
import torch

from deepaco_tpu_torch.core.graph import EdgeBlock, SparseGraph, knn_graph, topk_smallest


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


def _dense_nbr(lead: tuple, n: int, device) -> torch.Tensor:
    """``nbr[..., i, :] = arange(n)``: the dense graph, self-loops included."""
    return torch.arange(n, device=device).expand(*lead, n, n)


def cvrp_graph(demand: torch.Tensor, dist: torch.Tensor) -> SparseGraph:
    """The dense CVRP graph with self-loops, k-regular with K = N:
    ``x = demand [..., N, 1]``, ``nbr[..., i, :] = arange(N)``, ``edge =
    dist [..., N, N, 1]``."""
    return SparseGraph(x=demand[..., None], nbr=_dense_nbr(dist.shape[:-2], dist.shape[-1],
                                                           dist.device),
                       edge=dist[..., None])


def cvrp_nls_graph(demand: torch.Tensor, dist: torch.Tensor, k: int = 5) -> tuple:
    """The two-block graph ``(x, (block_a, block_b))`` (builders.py:55-77):
    block A holds each customer's k nearest customers and its depot edge
    (``src = 1..N-1``, k+1 out-edges), block B the depot row over every
    customer (``src = [0]``). Edge attributes are distances; both directions
    of a depot edge carry ``dist[cust, 0]``. The k nearest are taken on
    ``dist[1:, 1:]``, whose 1e-10 diagonal puts each customer itself among
    them, ties to the lowest index as ``lax.top_k`` breaks them. ``x =
    demand [..., N, 1]``."""
    lead, n = dist.shape[:-2], dist.shape[-1]
    cust = torch.arange(1, n, device=dist.device)
    vals, idx = topk_smallest(dist[..., 1:, 1:], k)
    nbr_a = torch.cat([idx + 1, idx.new_zeros((*lead, n - 1, 1))], dim=-1)
    depot_attr = dist[..., 1:, 0]
    edge_a = torch.cat([vals[..., None], depot_attr[..., None, None]], dim=-2)
    block_a = EdgeBlock(src=cust, nbr=nbr_a, edge=edge_a)
    block_b = EdgeBlock(src=cust.new_zeros(1), nbr=cust.expand(*lead, 1, n - 1),
                        edge=depot_attr[..., None, :, None])
    return demand[..., None].float(), (block_a, block_b)


def op_graph(coords: torch.Tensor, dist: torch.Tensor, prizes: torch.Tensor,
             k: int) -> SparseGraph:
    """The k-NN graph over the real nodes with ``x = (distance to the depot,
    prize) [..., n, 2]``."""
    to_depot = torch.linalg.vector_norm(coords - coords[..., :1, :], dim=-1)
    return knn_graph(coords, dist, k, node_feats=torch.stack([to_depot, prizes], dim=-1))


def pctsp_graph(prizes: torch.Tensor, penalties: torch.Tensor,
                dist: torch.Tensor) -> SparseGraph:
    """The dense graph with self-loops, ``x = (prize, penalty) [..., N, 2]``,
    ``edge = dist [..., N, N, 1]``."""
    return SparseGraph(x=torch.stack([prizes, penalties], dim=-1),
                       nbr=_dense_nbr(dist.shape[:-2], dist.shape[-1], dist.device),
                       edge=dist[..., None])


def smtwtp_graph(due_norm: torch.Tensor, weights: torch.Tensor,
                 processing: torch.Tensor) -> SparseGraph:
    """The dense graph over the dummy job 0 and the n jobs: ``x = [(0, 0),
    (due_norm, weight)...] [..., n+1, 2]``; the attribute of edge ``(i, j)``
    is the processing time of ``j`` (0 for the dummy)."""
    lead, n = due_norm.shape[:-1], due_norm.shape[-1]
    x = torch.cat([due_norm.new_zeros((*lead, 1, 2)),
                   torch.stack([due_norm, weights], dim=-1)], dim=-2)
    proc = torch.cat([processing.new_zeros((*lead, 1)), processing], dim=-1)
    edge = proc[..., None, :, None].expand(*lead, n + 1, n + 1, 1)
    return SparseGraph(x=x, nbr=_dense_nbr(lead, n + 1, due_norm.device), edge=edge)


def mkp_graph(prize: torch.Tensor, weight: torch.Tensor) -> SparseGraph:
    """The dense graph over the n items, self-loops included: ``x = weight
    [..., n, m]``; every out-edge of item ``i`` carries ``prize[i]``, the
    source's prize (builders.py:115-125)."""
    lead, n = prize.shape[:-1], prize.shape[-1]
    return SparseGraph(x=weight, nbr=_dense_nbr(lead, n, prize.device),
                       edge=prize[..., :, None, None].expand(*lead, n, n, 1))


def sop_graph(dist: torch.Tensor, adj: torch.Tensor) -> SparseGraph:
    """The masked dense block over the allowed successors (builders.py:129-136):
    ``x = dist[..., 0, :, None]``, ``edge = dist [..., n, n, 1]`` and
    ``mask = adj``, where ``adj[i, j] = 1`` iff ``j`` may follow ``i``."""
    return SparseGraph(x=dist[..., 0, :, None],
                       nbr=_dense_nbr(dist.shape[:-2], dist.shape[-1], dist.device),
                       edge=dist[..., None], mask=adj.to(torch.float32))


def _related(adj: np.ndarray) -> np.ndarray:
    """Whether each pair is ordered either way, or is one activity: the
    transitive closure of ``adj [n, n]`` by repeated squaring, with its
    transpose and the identity."""
    reach = adj.astype(bool)
    for _ in range(adj.shape[0]):
        new = reach | (reach.astype(np.int64) @ reach.astype(np.int64) > 0)
        if (new == reach).all():
            break
        reach = new
    return reach | reach.T | np.eye(adj.shape[0], dtype=bool)


def rcpsp_graph(data) -> SparseGraph:
    """The masked dense block of an RCPSP instance (builders.py:139-169),
    batched over ``data``'s leading dimensions (``core.rcpsp.RCPSPData``):
    ``x = [duration / max(max, 1), resources / capacity] [..., n, 1+m]``;
    ``edge [..., n, n, 2]`` is ``[1, 0]`` on a precedence edge and ``[0,
    1]`` between two activities that neither precedes (transitively), zero
    elsewhere; ``mask`` holds both kinds of edge and the sink's self-loop
    (the reference's extra edge with attribute ``[0, 0]``)."""
    adj = data.adj.cpu().numpy()
    n = adj.shape[-1]
    flat = adj.reshape(-1, n, n)
    no_rel = ~np.stack([_related(a) for a in flat]).reshape(adj.shape)
    dev = data.adj.device
    t = data.duration.float()
    t = t / torch.clamp(t.amax(dim=-1, keepdim=True), min=1.0)
    r = data.resources.float() / data.capacity.float()[..., None, :]
    x = torch.cat([t[..., None], r], dim=-1)
    prec = torch.as_tensor(adj, dtype=torch.float32, device=dev)
    norel = torch.as_tensor(no_rel, dtype=torch.float32, device=dev)
    mask = np.logical_or(adj > 0, no_rel)
    mask[..., n - 1, n - 1] = True
    return SparseGraph(x=x, nbr=_dense_nbr(adj.shape[:-2], n, dev),
                       edge=torch.stack([prec, norel], dim=-1),
                       mask=torch.as_tensor(mask, dtype=torch.float32, device=dev))
