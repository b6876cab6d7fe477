"""The gather phase of one EmbNet layer, forward and backward (counterpart of
``deepaco_tpu/ops/pallas_kernels.py:93-309``: ``gated_mean_aggregate``,
``fused_gnn_layer`` and its custom VJP ``fused_gnn_layer_ad``).

Over leading batch axes ``[B, ...]``: node tables ``x2, x3, x4 [B, N, U]``,
neighbours ``nbr [B, N, K]``, edge state ``w [B, N, K, U]``, the edge
linear ``ew [U, U]`` (Flax ``[in, out]``) and ``eb [U]``:

    agg[b, i] = mean_k sigmoid(w[b, i, k]) * x2[b, nbr[b, i, k]]
    pre[b, i, k] = w[b, i, k] @ ew + eb + x3[b, i] + x4[b, nbr[b, i, k]]

Kernel K6 (``csrc/gnn_layer.cu``) computes the forward in one launch and the
backward of ``x2, x3, x4, w`` in two (an edge pass and a node pass), without
atomics. The node pass walks a reverse adjacency (:func:`reverse_adjacency`),
built once per graph and shared by every layer. ``d_ew = w^T d_pre`` and
``d_eb = sum d_pre`` stay two PyTorch reductions, as the JAX package leaves
them to XLA (pallas_kernels.py:303-304).

- :func:`fused_gnn_layer_plain`: the forward math in PyTorch (autograd
  differentiates it); :func:`fused_gnn_layer_backward_plain`: the backward
  of ``_fused_ad_bwd`` (290-306) written out, with ``index_add_``.
- :func:`fused_gnn_layer`: the wrapper, a :class:`FusedGnnLayer`. A CPU
  tensor takes the plain forward and the plain backward; a CUDA tensor
  launches K6 both ways or raises.
- :func:`gated_mean_aggregate`: ``agg`` alone (TPU kernel row 8); its CUDA
  route is K6's forward with the ``pre`` output compiled out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from deepaco_tpu_torch.ops import _build

UNITS = 32          # K6 works on 32-feature rows (tiles of 16 edge rows by 32)


class GraphIndex(NamedTuple):
    """The neighbour table and its reverse, built once per graph:
    ``nbr32 [B, N, K]`` int32; ``offsets [B, N + 1]`` int32 and ``edges
    [B, N*K]`` int32, so that the edges into node ``j`` of instance ``b``
    are ``edges[b, offsets[b, j]:offsets[b, j + 1]]`` (flat ids ``i*K + k``
    within the instance), in increasing order."""

    nbr32: torch.Tensor
    offsets: torch.Tensor
    edges: torch.Tensor


def reverse_adjacency(nbr: torch.Tensor) -> GraphIndex:
    """The CSR of incoming edges of ``nbr [B, N, K]``, by a stable sort.
    ``scatter_add_`` checks every id against ``[0, N)``, so an id out of
    range raises here (a device assert on CUDA) before any kernel reads it."""
    b, n, k = nbr.shape
    flat = nbr.reshape(b, n * k)
    edges = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros((b, n), dtype=torch.int64, device=nbr.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    offsets = torch.zeros((b, n + 1), dtype=torch.int64, device=nbr.device)
    torch.cumsum(counts, dim=1, out=offsets[:, 1:])
    return GraphIndex(nbr.to(torch.int32).contiguous(),
                      offsets.to(torch.int32).contiguous(),
                      edges.to(torch.int32).contiguous())


def gather_nodes(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``x [B, N, U]`` at ``nbr [B, R, K]`` → ``[B, R, K, U]``."""
    b, r, k = nbr.shape
    idx = nbr.reshape(b, r * k, 1).long().expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx).reshape(b, r, k, x.shape[-1])


# ----------------------------------------------------------------- plain ---
def gated_mean_aggregate_plain(x: torch.Tensor, nbr: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """``mean_k sigmoid(w) * x[nbr]``: ``x [B, N, U]``, ``nbr [B, R, K]``,
    ``w [B, R, K, U]`` → ``[B, R, U]`` (gated_mean_aggregate_xla)."""
    return torch.mean(torch.sigmoid(w) * gather_nodes(x, nbr), dim=-2)


def fused_gnn_layer_plain(x2, x3, x4, nbr, w, ew, eb, index=None):
    """``(agg, pre)`` in PyTorch, the math of ``fused_gnn_layer_xla``
    (pallas_kernels.py:256-260); ``index`` is unused."""
    agg = gated_mean_aggregate_plain(x2, nbr, w)
    pre = w @ ew + eb + x3[..., None, :] + gather_nodes(x4, nbr)
    return agg, pre


def node_sum_plain(nbr: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[b, j] = sum of values[b, e] over the edges e into j``:
    ``values [B, N, K, U]`` → ``[B, N, U]``, by ``index_add_`` (the JAX
    ``.at[nbr].add``)."""
    b, n, k, u = values.shape
    flat = (nbr.long() + n * torch.arange(b, device=nbr.device)[:, None, None])
    out = torch.zeros((b * n, u), dtype=values.dtype, device=values.device)
    return out.index_add_(0, flat.reshape(-1), values.reshape(-1, u)).reshape(b, n, u)


def fused_gnn_layer_backward_plain(x2, nbr, w, ew, d_agg, d_pre):
    """The VJP of the layer, ``_fused_ad_bwd`` written out:
    ``(d_x2, d_x3, d_x4, d_w, d_ew, d_eb)``."""
    k = nbr.shape[-1]
    sig = torch.sigmoid(w)
    d_gated = d_agg[..., None, :] / k
    d_x2 = node_sum_plain(nbr, sig * d_gated)
    d_w = d_gated * gather_nodes(x2, nbr) * sig * (1.0 - sig)
    d_w = d_w + d_pre @ ew.T
    d_x3 = torch.sum(d_pre, dim=-2)
    d_x4 = node_sum_plain(nbr, d_pre)
    d_ew, d_eb = _param_grads(w, d_pre)
    return d_x2, d_x3, d_x4, d_w, d_ew, d_eb


def _param_grads(w, d_pre):
    """``d_ew = w^T d_pre`` and ``d_eb = sum d_pre`` over every edge."""
    u = w.shape[-1]
    return (w.reshape(-1, u).T @ d_pre.reshape(-1, u),
            d_pre.reshape(-1, u).sum(dim=0))


# ---------------------------------------------------------------- kernel ---
def _check_layer(name, x2, x3, x4, nbr, w, ew, eb):
    b, n, k = nbr.shape
    u = x2.shape[-1]
    if u != UNITS:
        raise ValueError(f"{name}: K6 takes {UNITS} units, got {u}")
    for t, shape in ((x2, (b, n, u)), (x3, (b, n, u)), (x4, (b, n, u)),
                     (w, (b, n, k, u)), (ew, (u, u)), (eb, (u,))):
        if t.shape != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: K6 takes f32 tensors, got {t.dtype}")


def _launch_forward(x2, x3, x4, nbr32, w, ew, eb, write_pre: bool):
    """Allocate ``agg`` (and ``pre``) and call K6's forward entry point.
    ``x2 [B, N, U]``, ``nbr32 [B, R, K]``, ``w [B, R, K, U]``."""
    b, r, k = nbr32.shape
    n, u = x2.shape[1], x2.shape[2]
    dev = x2.device
    agg = torch.empty((b, r, u), dtype=torch.float32, device=dev)
    pre = torch.empty((b, r, k, u) if write_pre else (0,), dtype=torch.float32,
                      device=dev)
    if agg.numel() == 0:
        return agg, pre
    P, I = _build.P, _build.I
    fn = _build.function("deepaco_gnn_layer_fwd", [P] * 9 + [I] * 5 + [P])
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(x2.data_ptr(), ptr(x3), ptr(x4), nbr32.data_ptr(), w.data_ptr(),
            ptr(ew), ptr(eb), agg.data_ptr(), pre.data_ptr() if write_pre else None,
            b, r, n, k, int(write_pre), _build.stream_ptr(dev))
    _build.check(rc, "deepaco_gnn_layer_fwd")
    return agg, pre


def fused_gnn_layer_backward(x2, index: GraphIndex, w, ew, d_agg, d_pre):
    """The layer's VJP. A CPU tensor takes
    :func:`fused_gnn_layer_backward_plain`; a CUDA tensor launches K6's
    edge and node passes (one call of the C entry) for ``d_x2, d_x3, d_x4,
    d_w``, then the two PyTorch reductions for ``d_ew, d_eb``."""
    if x2.device.type == "cpu":
        return fused_gnn_layer_backward_plain(x2, index.nbr32, w, ew, d_agg, d_pre)
    _build.require_cuda("fused_gnn_layer_backward", x2, w, ew, d_agg, d_pre,
                        *index)
    b, n, k = index.nbr32.shape
    x2, w, ew = x2.contiguous(), w.contiguous(), ew.contiguous()
    d_agg, d_pre = d_agg.float().contiguous(), d_pre.float().contiguous()
    if d_agg.shape != x2.shape or d_pre.shape != w.shape:
        raise ValueError("fused_gnn_layer_backward: cotangents do not match "
                         "agg [B, N, U] and pre [B, N, K, U]")
    d_w = torch.empty_like(w)
    d_x2, d_x3, d_x4 = (torch.empty_like(x2) for _ in range(3))
    P, I = _build.P, _build.I
    fn = _build.function("deepaco_gnn_layer_bwd", [P] * 12 + [I] * 3 + [P])
    rc = fn(x2.data_ptr(), index.nbr32.data_ptr(), index.offsets.data_ptr(),
            index.edges.data_ptr(), w.data_ptr(), ew.data_ptr(),
            d_agg.data_ptr(), d_pre.data_ptr(), d_w.data_ptr(), d_x3.data_ptr(),
            d_x2.data_ptr(), d_x4.data_ptr(), b, n, k, _build.stream_ptr(x2.device))
    _build.check(rc, "deepaco_gnn_layer_bwd")
    fused_gnn_layer_backward.launches += 1
    d_ew, d_eb = _param_grads(w, d_pre)
    return d_x2, d_x3, d_x4, d_w, d_ew, d_eb


class FusedGnnLayer(torch.autograd.Function):
    """The layer with K6 as its forward and backward on CUDA tensors, and
    the plain forward and backward on CPU tensors. ``index`` takes no
    gradient."""

    @staticmethod
    def forward(ctx, x2, x3, x4, w, ew, eb, index):
        ctx.save_for_backward(x2, w, ew, *index)
        if x2.device.type == "cpu":
            return fused_gnn_layer_plain(x2, x3, x4, index.nbr32, w, ew, eb)
        _build.require_cuda("fused_gnn_layer", x2, x3, x4, w, ew, eb, *index)
        _check_layer("fused_gnn_layer", x2, x3, x4, index.nbr32, w, ew, eb)
        out = _launch_forward(x2.contiguous(), x3.contiguous(), x4.contiguous(),
                              index.nbr32, w.contiguous(), ew.contiguous(),
                              eb.contiguous(), write_pre=True)
        fused_gnn_layer.launches += 1
        return out

    @staticmethod
    def backward(ctx, d_agg, d_pre):
        x2, w, ew, *index = ctx.saved_tensors
        d_x2, d_x3, d_x4, d_w, d_ew, d_eb = fused_gnn_layer_backward(
            x2, GraphIndex(*index), w, ew, d_agg, d_pre)
        return d_x2, d_x3, d_x4, d_w, d_ew, d_eb, None


def fused_gnn_layer(x2, x3, x4, nbr, w, ew, eb, index: GraphIndex | None = None):
    """``(agg [B, N, U], pre [B, N, K, U])`` of one EmbNet layer, with its
    exact gradient; on CUDA one K6 launch forward and one backward.
    ``index`` is ``reverse_adjacency(nbr)``, built here when not given."""
    if index is None:
        index = reverse_adjacency(nbr)
    return FusedGnnLayer.apply(x2, x3, x4, w, ew, eb, index)


@torch.no_grad()
def gated_mean_aggregate(x: torch.Tensor, nbr: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """``mean_k sigmoid(w) * x[nbr]`` over ``x [B, N, U]``, ``nbr [B, R, K]``,
    ``w [B, R, K, U]``; on CUDA one launch of K6's forward without ``pre``."""
    if x.device.type == "cpu":
        return gated_mean_aggregate_plain(x, nbr, w)
    _build.require_cuda("gated_mean_aggregate", x, nbr, w)
    b, r, k = nbr.shape
    if x.shape[-1] != UNITS or x.dim() != 3 or w.shape != (b, r, k, UNITS):
        raise ValueError(f"gated_mean_aggregate: expected x [B, N, {UNITS}] "
                         f"and w [B, R, K, {UNITS}] for nbr {tuple(nbr.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("gated_mean_aggregate: K6 takes f32 tensors")
    if nbr.numel():
        # K6 reads x[nbr] unchecked; here no reverse_adjacency checks the ids
        lo, hi = (int(v) for v in torch.aminmax(nbr))
        if lo < 0 or hi >= x.shape[1]:
            raise IndexError(f"gated_mean_aggregate: neighbour ids span "
                             f"[{lo}, {hi}], outside [0, {x.shape[1]})")
    agg, _ = _launch_forward(x.contiguous(), None, None,
                             nbr.to(torch.int32).contiguous(), w.contiguous(),
                             None, None, write_pre=False)
    gated_mean_aggregate.launches += 1
    return agg


fused_gnn_layer.launches = 0
fused_gnn_layer_backward.launches = 0
gated_mean_aggregate.launches = 0
