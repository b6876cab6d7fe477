"""Inference-folded EmbNet in one call (counterpart of
``deepaco_tpu/ops/fused_gnn.py``). Two kernels live here, each beside its
plain PyTorch version:

- K1, :func:`tsp_dense_heuristic` (``csrc/dense_heuristic.cu``): distance
  matrix → k-NN, EmbNet, ParNet head, dense scatter; plain version
  :func:`tsp_dense_heuristic_plain`;
- K9, :func:`embnet_layers` (``csrc/embnet_layers.cu``): ``e_lin0`` and the
  folded layer stack over a given ``[B, N, K]`` neighbour table and its edge
  features; plain version :func:`embnet_layers_plain`.
  :func:`net_forward_fast` wraps it into ``Net.forward(train=False)``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. :func:`dense_heuristic_supported` and :func:`embnet_supported` state
each kernel's limits, so that callers route by configuration. Both work in f32 with BatchNorm folded into per-layer affines
(:func:`fold_embnet_params`) and share the layer passes
(``csrc/embnet_passes.cuh``; :func:`_layer_stack_plain`), and both equal
``Net`` up to that re-association.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.nn import functional as F

from deepaco_tpu_torch.core.graph import topk_smallest
from deepaco_tpu_torch.models.gnn import EmbNet, Net, ParNet
from deepaco_tpu_torch.ops import _build
from deepaco_tpu_torch.ops.gnn_layer import gather_nodes


class FoldedEmbNet(NamedTuple):
    """Inference-folded EmbNet weights, stacked over layers in the Flax
    ``[in, out]`` orientation: ``wv [L*U, 4U]`` (v_lins1..4 side by side),
    ``bv [L, 4U]``, ``wel [L*U, U]``, ``bel [L, U]``, the BatchNorm affines
    ``vs/vb/es/eb [L, U]`` (``s = weight * rsqrt(var + eps)``,
    ``b = bias - mean * s``), ``w_in/b_in`` (v_lin0) and ``we_in/be_in``
    (e_lin0)."""

    w_in: torch.Tensor
    b_in: torch.Tensor
    we_in: torch.Tensor
    be_in: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wel: torch.Tensor
    bel: torch.Tensor
    vs: torch.Tensor
    vb: torch.Tensor
    es: torch.Tensor
    eb: torch.Tensor


@torch.no_grad()
def fold_embnet_params(emb: EmbNet) -> FoldedEmbNet:
    """Fold an :class:`EmbNet`'s weights and running statistics."""
    def affine(bn):
        s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        return s, bn.bias - bn.running_mean * s

    kern = lambda lin: lin.weight.T
    layers = range(emb.depth)
    v_aff = [affine(emb.v_bns[i]) for i in layers]
    e_aff = [affine(emb.e_bns[i]) for i in layers]
    folded = FoldedEmbNet(
        w_in=kern(emb.v_lin0), b_in=emb.v_lin0.bias,
        we_in=kern(emb.e_lin0), be_in=emb.e_lin0.bias,
        wv=torch.cat([torch.cat([kern(m[i]) for m in (
            emb.v_lins1, emb.v_lins2, emb.v_lins3, emb.v_lins4)], dim=1)
            for i in layers]),
        bv=torch.stack([torch.cat([m[i].bias for m in (
            emb.v_lins1, emb.v_lins2, emb.v_lins3, emb.v_lins4)])
            for i in layers]),
        wel=torch.cat([kern(emb.e_lins0[i]) for i in layers]),
        bel=torch.stack([emb.e_lins0[i].bias for i in layers]),
        vs=torch.stack([a[0] for a in v_aff]),
        vb=torch.stack([a[1] for a in v_aff]),
        es=torch.stack([a[0] for a in e_aff]),
        eb=torch.stack([a[1] for a in e_aff]))
    return FoldedEmbNet._make(t.detach() for t in folded)


def _head(net: Net, head: str) -> ParNet:
    return getattr(net, f"par_net_{head}")


def _node_embedding(f: FoldedEmbNet, x: torch.Tensor) -> torch.Tensor:
    """v_lin0 on the node features: a plain product outside the kernel."""
    return F.silu(x.float() @ f.w_in + f.b_in)


def _layer_stack_plain(f: FoldedEmbNet, xs: torch.Tensor, w: torch.Tensor,
                       nbr: torch.Tensor, k: int, node_update: bool) -> torch.Tensor:
    """The folded layers on node state ``xs [B, N, U]`` and edge state
    ``w [B, N, K, U]``; returns the final edge state."""
    u = xs.shape[-1]
    for i in range(f.bv.shape[0]):
        x1234 = xs @ f.wv[i * u:(i + 1) * u] + f.bv[i]
        x1, x2, x3, x4 = x1234.split(u, dim=-1)
        agg = torch.sum(torch.sigmoid(w) * gather_nodes(x2, nbr), dim=-2)
        pre = (w @ f.wel[i * u:(i + 1) * u] + (x3 + f.bel[i])[..., None, :]
               + gather_nodes(x4, nbr))
        w_new = w + F.silu(pre * f.es[i] + f.eb[i])
        if node_update:
            xs = xs + F.silu((x1 + agg * (1.0 / k)) * f.vs[i] + f.vb[i])
        w = w_new
    return w


@torch.no_grad()
def tsp_dense_heuristic_plain(net: Net, x: torch.Tensor, dist: torch.Tensor,
                              k: int, *, head: str = "heu",
                              fill: float = 1e-10) -> torch.Tensor:
    """The plain PyTorch version of K1, step for step."""
    emb = net.emb_net
    f = fold_embnet_params(emb)
    vals, nbr = topk_smallest(dist.float(), k)
    w = F.silu(vals[..., None] @ f.we_in + f.be_in)              # [B,N,K,U]
    w = _layer_stack_plain(f, _node_embedding(f, x), w, nbr, k, emb.node_update)
    o = _head(net, head)(w)                                      # [B,N,K]
    out = torch.full_like(dist, fill, dtype=torch.float32)
    return out.scatter(-1, nbr, o + fill)


def _pack_layers(f: FoldedEmbNet) -> list[torch.Tensor]:
    """The folded layer weights in the order ``csrc/embnet_passes.cuh``'s
    ``unpack_layers`` reads them."""
    return [f.we_in, f.be_in, f.wv, f.bv, f.wel, f.bel, f.vs, f.vb, f.es, f.eb]


def _flat(parts: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1) for p in parts])


def _pack_params(f: FoldedEmbNet, head: ParNet) -> torch.Tensor:
    """The folded weights in the order ``csrc/dense_heuristic.cu`` reads them."""
    lins = head.lins
    return _flat(_pack_layers(f) + [lins[0].weight.T, lins[0].bias,
                                    lins[1].weight.T, lins[1].bias,
                                    lins[2].weight, lins[2].bias])


K1_MAX_N = 48 * 1024 // 16    # K1 keeps 16 bytes a city of a row in 48 KB
# the C entries' argument types: deepaco_dense_heuristic (K1) and
# deepaco_embnet_layers (K9)
K1_ARGTYPES = [_build.P] * 7 + [_build.I] * 5 + [_build.F, _build.P]
K9_ARGTYPES = [_build.P] * 6 + [_build.I] * 6 + [_build.P]


def dense_heuristic_supported(net: Net, n: int, k: int, head: str = "heu") -> bool:
    """Whether K1 takes ``net`` at ``n`` cities and ``k`` neighbours: 32
    units, one edge feature, a 3-layer ParNet head and ``0 < k <= n <=
    3072``. Elsewhere :func:`tsp_dense_heuristic` raises on CUDA tensors."""
    emb = net.emb_net
    return (emb.units == 32 and emb.e_lin0.in_features == 1
            and 0 < k <= n <= K1_MAX_N and len(_head(net, head).lins) == 3)


def embnet_supported(net: Net, n: int, k: int) -> bool:
    """Whether K9 takes ``net``'s layer stack over ``k`` of ``n`` nodes: 32
    units, at most 4 edge features and ``0 < k <= n``."""
    emb = net.emb_net
    return emb.units == 32 and 1 <= emb.e_lin0.in_features <= 4 and 0 < k <= n


@torch.no_grad()
def tsp_dense_heuristic(net: Net, x: torch.Tensor, dist: torch.Tensor, k: int,
                        *, head: str = "heu", fill: float = 1e-10) -> torch.Tensor:
    """``x [B, N, F]`` node features and ``dist [B, N, N]`` (diagonal
    sentinel included) → ``heu [B, N, N]``: the head's sigmoid plus ``fill``
    on each row's ``k`` nearest columns, ``fill`` elsewhere."""
    if dist.device.type == "cpu":
        return tsp_dense_heuristic_plain(net, x, dist, k, head=head, fill=fill)
    _build.require_cuda("tsp_dense_heuristic", x, dist)
    n = dist.shape[-1]
    if not dense_heuristic_supported(net, n, k, head):
        raise ValueError("the K1 kernel takes units=32, one edge feature, a 3-layer "
                         f"ParNet head and 0 < k <= n <= {K1_MAX_N}, got k={k}, n={n}")
    heu = _launch(net, head, x, dist.float().contiguous(), k, fill)
    tsp_dense_heuristic.launches += 1
    return heu


def _launch(net: Net, head: str, x: torch.Tensor, dist: torch.Tensor, k: int,
            fill: float, entry=None) -> torch.Tensor:
    """Allocate the outputs and scratch and call the K1 entry point:
    ``entry``, a ctypes function with the signature of
    ``deepaco_dense_heuristic``, or by default the package's own."""
    emb = net.emb_net
    b, n, _ = dist.shape
    dev = dist.device
    f = fold_embnet_params(emb)
    params = _pack_params(f, _head(net, head))
    xs = _node_embedding(f, x).contiguous()
    x1234 = torch.empty((b, n, 4 * 32), dtype=torch.float32, device=dev)
    nbr = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    w = torch.empty((b, n, k, 32), dtype=torch.float32, device=dev)
    heu = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    fn = entry or _build.function("deepaco_dense_heuristic", K1_ARGTYPES)
    rc = fn(dist.data_ptr(), xs.data_ptr(), x1234.data_ptr(), nbr.data_ptr(),
            w.data_ptr(), params.data_ptr(), heu.data_ptr(), b, n, k,
            emb.depth, int(emb.node_update), ctypes.c_float(fill),
            _build.stream_ptr(dev))
    _build.check(rc, "deepaco_dense_heuristic")
    return heu


tsp_dense_heuristic.launches = 0


# ------------------------------------------------ K9: the graph-given stack ---
@torch.no_grad()
def embnet_layers_plain(folded: FoldedEmbNet, x_emb: torch.Tensor,
                        nbr: torch.Tensor, edge: torch.Tensor, *, k: int,
                        node_update: bool = True) -> torch.Tensor:
    """The plain PyTorch version of K9: ``e_lin0`` over the ``E`` edge
    features, then the folded layers, step for step as
    :func:`tsp_dense_heuristic_plain` takes them."""
    w = F.silu(edge.float() @ folded.we_in + folded.be_in)       # [B,N,K,U]
    return _layer_stack_plain(folded, x_emb.float(), w, nbr, k, node_update)


@torch.no_grad()
def embnet_layers(folded: FoldedEmbNet, x_emb: torch.Tensor, nbr: torch.Tensor,
                  edge: torch.Tensor, *, k: int, node_update: bool = True) -> torch.Tensor:
    """The folded EmbNet layer stack over a given graph: ``x_emb [B, N, U]``
    (``silu(v_lin0(x))``), neighbour ids ``nbr [B, N, K]`` within each
    instance and edge features ``edge [B, N, K, E]`` → the final edge state
    ``[B, N, K, U]`` f32, in JAX's public layout. ``k`` is the mean's
    divisor, the table's ``K``. One call of kernel K9 on CUDA: 32 units,
    ``E <= 4`` and ``K <= N`` only."""
    b, n, kk = nbr.shape
    if k != kk:
        raise ValueError(f"embnet_layers: k={k} but nbr holds K={kk} neighbours")
    if x_emb.device.type == "cpu":
        return embnet_layers_plain(folded, x_emb, nbr, edge, k=k,
                                   node_update=node_update)
    _build.require_cuda("embnet_layers", x_emb, nbr, edge)
    u, e = x_emb.shape[-1], edge.shape[-1]
    if u != 32:
        raise ValueError(f"the K9 kernel takes 32 units, got {u}")
    if not 1 <= e <= 4 or edge.shape != (b, n, k, e):
        raise ValueError(f"the K9 kernel takes edge [B, N, K, E <= 4], got {tuple(edge.shape)}")
    if x_emb.shape != (b, n, u) or not 0 < k <= n:
        raise ValueError(f"the K9 kernel takes x [B, N, 32] and 0 < K <= N, got "
                         f"x {tuple(x_emb.shape)} and nbr {tuple(nbr.shape)}")
    lo, hi = torch.aminmax(nbr)
    if lo.item() < 0 or hi.item() >= n:
        raise ValueError(f"embnet_layers: neighbour ids must lie in [0, {n})")
    w = _launch_layers(folded, x_emb, nbr, edge, node_update)
    embnet_layers.launches += 1
    return w


def _launch_layers(f: FoldedEmbNet, x_emb, nbr, edge, node_update,
                   entry=None) -> torch.Tensor:
    """Allocate the edge state and scratch and call the K9 entry point:
    ``entry``, a ctypes function with the signature of
    ``deepaco_embnet_layers``, or by default the package's own."""
    b, n, k = nbr.shape
    e = edge.shape[-1]
    dev = x_emb.device
    params = _flat(_pack_layers(f)).to(dev)
    x = x_emb.float().clone(memory_format=torch.contiguous_format)
    x1234 = torch.empty((b, n, 4 * 32), dtype=torch.float32, device=dev)
    ids = nbr.to(torch.int32).contiguous()
    feats = edge.float().contiguous()
    w = torch.empty((b, n, k, 32), dtype=torch.float32, device=dev)
    fn = entry or _build.function("deepaco_embnet_layers", K9_ARGTYPES)
    rc = fn(feats.data_ptr(), x.data_ptr(), x1234.data_ptr(), ids.data_ptr(),
            w.data_ptr(), params.data_ptr(), b, n, k, e, f.bv.shape[0],
            int(node_update), _build.stream_ptr(dev))
    _build.check(rc, "deepaco_embnet_layers")
    return w


embnet_layers.launches = 0


@torch.no_grad()
def net_forward_fast(net: Net, x: torch.Tensor, nbr: torch.Tensor,
                     edge: torch.Tensor, *, heads: tuple = ("heu",),
                     layers=embnet_layers):
    """``Net.forward(train=False)`` through the folded layer stack: ``x [B,
    N, F]``, ``nbr [B, N, K]``, ``edge [B, N, K, E]`` → per-edge head outputs
    ``[B, N, K]``, one tensor for one head, else a tuple in the order of
    ``heads`` (``("phe", "heu")`` is ``Net(dual_heads=True)``'s). ``v_lin0``
    and the ParNet heads are PyTorch products around ``layers`` (K9 by
    default; :func:`embnet_layers_plain` on any device), as the JAX package
    leaves them to XLA around its kernel."""
    emb = net.emb_net
    f = fold_embnet_params(emb)
    w = layers(f, _node_embedding(f, x), nbr, edge, k=nbr.shape[-1],
               node_update=emb.node_update)
    outs = tuple(_head(net, h)(w) for h in heads)
    return outs[0] if len(outs) == 1 else outs
