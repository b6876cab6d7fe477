"""Row-sharded multi-device GNN forward (counterpart of
``deepaco_tpu/parallel/gnn_shard.py``).

The k-regular ``[N, K]`` graph is split by source rows: of ``D`` ranks on
the axis, rank ``r`` owns rows ``[r N/D, (r+1) N/D)`` of the node table and
of the edge arrays. Per layer:

* the node table is ``all_gather``-ed once (the gather ``x[nbr]`` needs
  every node), and ``v_lins2`` / ``v_lins4`` run on the whole table,
  ``v_lins1`` / ``v_lins3`` / ``e_lins0`` on the shard;
* the gather phase (the gated neighbour mean and the edge pre-activation)
  is one launch of kernel K6's forward on the shard's rows
  (``ops/gnn_layer.fused_gnn_layer_rows``) on the card;
* BatchNorm takes the running statistics in eval mode, or in train mode the
  global moments: the all-reduced sum over the total count for the mean,
  the all-reduced ``sum((v - mean)^2)`` over it for the (biased) variance.

The weights are replicated; the activations are sharded.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.nn import functional as F

from deepaco_tpu_torch.ops.gnn_layer import fused_gnn_layer_rows
from deepaco_tpu_torch.parallel._axes import mesh_dim, rank_device


def _bn_eval(bn, v: torch.Tensor) -> torch.Tensor:
    return (v - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps) * bn.weight + bn.bias


def _bn_train_global(bn, v: torch.Tensor, group, total: int) -> torch.Tensor:
    """Train-mode BatchNorm with moments over every rank's rows (gnn_shard.py:38-46):
    two passes, the biased variance; the running statistics stay as they are."""
    flat = v.reshape(-1, v.shape[-1])
    s = flat.sum(dim=0)
    dist.all_reduce(s, group=group)
    mean = s / total
    sq = ((flat - mean) ** 2).sum(dim=0)
    dist.all_reduce(sq, group=group)
    var = sq / total
    return (v - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias


def _all_gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


@torch.no_grad()
def sharded_embnet_forward(emb_net, x, nbr, edge, mesh, axis: str = "instance", *,
                           train: bool = False) -> torch.Tensor:
    """The forward of ``emb_net`` (a ``models.gnn.EmbNet``: its depth, node
    update and weights) on one instance ``x [N, F]``, ``nbr [N, K]``,
    ``edge [N, K, E]`` with the rows sharded over ``mesh[axis]``; each rank
    passes the whole arrays and keeps its own rows. ``train`` takes
    BatchNorm's global batch moments; the running statistics stay
    untouched either way. Refuses an ``N`` the axis size does not divide.
    Returns the edge embeddings ``[N, K, U]``, gathered on every rank. On
    the card each layer is one K6 forward launch on the shard."""
    dim = mesh_dim(mesh, axis)
    rank, d = mesh.get_local_rank(dim), mesh.size(dim)
    group = mesh.get_group(axis)
    dev = rank_device()
    n, k = nbr.shape
    if n % d:
        raise ValueError(f"N={n} must divide over the {axis} axis of {d} ranks")
    rows = slice(rank * (n // d), (rank + 1) * (n // d))
    x_s = torch.as_tensor(x, dtype=torch.float32, device=dev)[rows]
    nbr_s = torch.as_tensor(nbr, device=dev)[rows][None]
    edge_s = torch.as_tensor(edge, dtype=torch.float32, device=dev)[rows]
    net = emb_net
    xs = F.silu(net.v_lin0(x_s))
    w = F.silu(net.e_lin0(edge_s))[None]
    for i in range(net.depth):
        x_full = _all_gather_rows(xs, group, d)
        x1 = net.v_lins1[i](xs)
        x2 = net.v_lins2[i](x_full)
        x3 = net.v_lins3[i](xs)
        x4 = net.v_lins4[i](x_full)
        e_lin = net.e_lins0[i]
        agg, pre = fused_gnn_layer_rows(x2[None], x3[None], x4[None], nbr_s, w,
                                        e_lin.weight.T, e_lin.bias)
        if net.node_update:
            v_pre = x1 + agg[0]
            normed = (_bn_train_global(net.v_bns[i], v_pre, group, n) if train
                      else _bn_eval(net.v_bns[i], v_pre))
            xs = xs + F.silu(normed)
        e_normed = (_bn_train_global(net.e_bns[i], pre, group, n * k) if train
                    else _bn_eval(net.e_bns[i], pre))
        w = w + F.silu(e_normed)
    return _all_gather_rows(w[0], group, d)


def edges_per_second_bench(emb_net, x, nbr, edge, mesh, reps: int = 3) -> float:
    """Edges a second of the eval-mode sharded forward (gnn_shard.py:110-125):
    one warm-up call, then ``reps`` calls timed on the host clock, the card
    synchronised before and after; the edges of all ``depth`` layers."""
    def sync():
        if mesh.device_type == "cuda":
            torch.cuda.synchronize()

    sharded_embnet_forward(emb_net, x, nbr, edge, mesh)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        sharded_embnet_forward(emb_net, x, nbr, edge, mesh)
    sync()
    dt = (time.perf_counter() - t0) / reps
    n, k = nbr.shape
    return n * k * emb_net.depth / dt
