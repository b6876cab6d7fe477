"""Dense neural heuristic in one call: k-NN, EmbNet, ParNet head, scatter
(counterpart of ``deepaco_tpu/ops/fused_gnn.py``).

:func:`tsp_dense_heuristic` is the wrapper of kernel K1
(``csrc/dense_heuristic.cu``). A CPU tensor takes
:func:`tsp_dense_heuristic_plain`, the same arithmetic in PyTorch; a CUDA
tensor launches the kernel or raises. Both work in f32 with BatchNorm
folded into per-layer affines (:func:`fold_embnet_params`), and both equal
``knn_graph + Net + scatter_to_dense + fill`` up to that re-association.
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


@torch.no_grad()
def tsp_dense_heuristic_plain(net: Net, x: torch.Tensor, dist: torch.Tensor,
                              k: int, *, head: str = "heu",
                              fill: float = 1e-10) -> torch.Tensor:
    """The plain PyTorch version of K1, step for step."""
    emb = net.emb_net
    f = fold_embnet_params(emb)
    u = emb.units
    vals, nbr = topk_smallest(dist.float(), k)
    w = F.silu(vals[..., None] @ f.we_in + f.be_in)              # [B,N,K,U]
    xs = _node_embedding(f, x)                                   # [B,N,U]
    for i in range(emb.depth):
        x1234 = xs @ f.wv[i * u:(i + 1) * u] + f.bv[i]
        x1, x2, x3, x4 = x1234.split(u, dim=-1)
        agg = torch.sum(torch.sigmoid(w) * gather_nodes(x2, nbr), dim=-2)
        pre = (w @ f.wel[i * u:(i + 1) * u] + (x3 + f.bel[i])[..., None, :]
               + gather_nodes(x4, nbr))
        w_new = w + F.silu(pre * f.es[i] + f.eb[i])
        if emb.node_update:
            xs = xs + F.silu((x1 + agg * (1.0 / k)) * f.vs[i] + f.vb[i])
        w = w_new
    o = _head(net, head)(w)                                      # [B,N,K]
    out = torch.full_like(dist, fill, dtype=torch.float32)
    return out.scatter(-1, nbr, o + fill)


def _pack_params(f: FoldedEmbNet, head: ParNet) -> torch.Tensor:
    """The folded weights in the order ``csrc/dense_heuristic.cu`` reads them."""
    lins = head.lins
    parts = [f.we_in, f.be_in, f.wv, f.bv, f.wel, f.bel, f.vs, f.vb, f.es, f.eb,
             lins[0].weight.T, lins[0].bias, lins[1].weight.T, lins[1].bias,
             lins[2].weight, lins[2].bias]
    return torch.cat([p.detach().float().reshape(-1) for p in parts])


@torch.no_grad()
def tsp_dense_heuristic(net: Net, x: torch.Tensor, dist: torch.Tensor, k: int,
                        *, head: str = "heu", fill: float = 1e-10) -> torch.Tensor:
    """``x [B, N, F]`` node features and ``dist [B, N, N]`` (diagonal
    sentinel included) → ``heu [B, N, N]``: the head's sigmoid plus ``fill``
    on each row's ``k`` nearest columns, ``fill`` elsewhere."""
    if dist.device.type == "cpu":
        return tsp_dense_heuristic_plain(net, x, dist, k, head=head, fill=fill)
    _build.require_cuda("tsp_dense_heuristic", x, dist)
    emb = net.emb_net
    b, n, _ = dist.shape
    if emb.units != 32 or emb.e_lin0.in_features != 1:
        raise ValueError("the K1 kernel takes units=32 and one edge feature")
    if not 0 < k <= n or n * 4 * 4 > 48 * 1024:
        raise ValueError(f"the K1 kernel takes 0 < k <= n <= 3072, got k={k}, n={n}")
    if len(_head(net, head).lins) != 3:
        raise ValueError("the K1 kernel takes a 3-layer ParNet head")
    heu = _launch(net, head, x, dist.float().contiguous(), k, fill)
    tsp_dense_heuristic.launches += 1
    return heu


def _launch(net: Net, head: str, x: torch.Tensor, dist: torch.Tensor, k: int,
            fill: float) -> torch.Tensor:
    """Allocate the outputs and scratch and call the K1 entry point."""
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
    P, I, Fl = _build.P, _build.I, _build.F
    fn = _build.function("deepaco_dense_heuristic",
                         [P] * 7 + [I] * 5 + [Fl, P])
    rc = fn(dist.data_ptr(), xs.data_ptr(), x1234.data_ptr(), nbr.data_ptr(),
            w.data_ptr(), params.data_ptr(), heu.data_ptr(), b, n, k,
            emb.depth, int(emb.node_update), ctypes.c_float(fill),
            _build.stream_ptr(dev))
    _build.check(rc, "deepaco_dense_heuristic")
    return heu


tsp_dense_heuristic.launches = 0
