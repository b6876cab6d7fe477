"""Edge-gated GNN heuristic network (counterpart of ``deepaco_tpu/models/gnn.py``).

The regular block: every node has ``K`` out-edges held in a
:class:`~deepaco_tpu_torch.core.graph.SparseGraph`. Tensors carry leading
batch dimensions (``x [B, N, F]``, ``nbr [B, N, K]``, ``edge [B, N, K, E]``).
This module is the plain oracle for the heuristic kernel in
:mod:`deepaco_tpu_torch.ops.fused_gnn`.

An irregular graph ``(x, blocks)`` of
:class:`~deepaco_tpu_torch.core.graph.EdgeBlock` blocks (CVRP-NLS's) runs the
plain layer of gnn.py:213-256 on every device: each block's gated mean is
merged into its source rows, and one edge BatchNorm covers the edges of all
blocks. Neither K6 nor K9 takes a map of source rows, and the JAX package
keeps such a graph off its fused layer too (gnn.py:177-180). So does a
masked graph with the node update (RCPSP's): its neighbour mean runs over
the valid edges only (gnn.py:216-228), which no kernel computes, and it
runs the plain layer on every device too.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepaco_tpu_torch.core.graph import SparseGraph, as_blocks
from deepaco_tpu_torch.ops.gnn_layer import fused_gnn_layer, gather_nodes, reverse_adjacency


class TorchBatchNorm(nn.Module):
    """BatchNorm with torch / PyG numerics: the biased variance to normalise,
    the unbiased variance for the running update, momentum 0.1 and eps 1e-5.

    In train mode the statistics are taken per instance, over every axis but
    the leading batch axis and the feature axis, as the JAX trainer takes
    them inside its ``vmap`` over instances (reinforce.py:166-169); each
    instance moves the running statistics by its own batch statistics and
    the results are averaged over instances. A ``mask`` (``x``'s shape
    without the feature axis, float {0, 1}) weights the train-mode
    statistics (gnn.py:95-104): per instance ``count = max(sum(mask), 1)``,
    the mean and the biased variance over the valid elements, the running
    variance ``var * count / max(count - 1, 1)``. Eval mode uses the
    running statistics and ignores the mask, as the JAX package does."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.training:
            if x.dim() < 3:
                raise ValueError("train-mode BatchNorm takes [B, ..., F] with "
                                 f"a leading instance axis, got {tuple(x.shape)}")
            axes = tuple(range(1, x.dim() - 1))
            if mask is None:
                count = math.prod(x.shape[1:-1])
                mean = x.mean(dim=axes, keepdim=True)
                var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
                denom = max(count - 1, 1)
            else:
                w = mask[..., None].to(x.dtype)
                count = torch.clamp(w.sum(dim=axes, keepdim=True), min=1.0)
                mean = (x * w).sum(dim=axes, keepdim=True) / count
                var = (w * (x - mean) ** 2).sum(dim=axes, keepdim=True) / count
                denom = torch.clamp(count - 1.0, min=1.0).reshape(x.shape[0], 1)
                count = count.reshape(x.shape[0], 1)
            with torch.no_grad():
                stat = lambda t: t.reshape(x.shape[0], x.shape[-1])
                unbiased = stat(var) * count / denom
                keep = 1 - self.momentum
                self.running_mean.copy_(torch.mean(
                    keep * self.running_mean + self.momentum * stat(mean), dim=0))
                self.running_var.copy_(torch.mean(
                    keep * self.running_var + self.momentum * unbiased, dim=0))
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class EmbNet(nn.Module):
    """Gated residual layers → per-edge embeddings ``[B, N, K, U]``.

    Node update ``x ← x + silu(BN(W1 x + mean_k(σ(w) ⊙ W2 x[nbr])))``, edge
    update ``w ← w + silu(BN(W5 w + W3 x + W4 x[nbr]))``, both from the
    layer's input state (reference tsp/net.py:34-44).
    """

    def __init__(self, feats: int = 2, edge_feats: int = 1, depth: int = 12,
                 units: int = 32, node_update: bool = True):
        super().__init__()
        self.depth, self.units, self.node_update = depth, units, node_update
        self.v_lin0 = nn.Linear(feats, units)
        self.e_lin0 = nn.Linear(edge_feats, units)
        lins = lambda: nn.ModuleList(nn.Linear(units, units)
                                     for _ in range(depth))
        self.v_lins1, self.v_lins2 = lins(), lins()
        self.v_lins3, self.v_lins4 = lins(), lins()
        self.e_lins0 = lins()
        self.v_bns = nn.ModuleList(TorchBatchNorm(units) for _ in range(depth))
        self.e_bns = nn.ModuleList(TorchBatchNorm(units) for _ in range(depth))

    def forward(self, g, layer: Callable = fused_gnn_layer):
        """``layer`` computes each layer's ``(agg, pre)``: by default the
        wrapper of kernel K6 (the plain version on CPU tensors); the plain
        version on any device when ``fused_gnn_layer_plain`` is passed. A
        masked graph (``g.mask``) weights the edge BatchNorms' train-mode
        statistics; with the node update it takes the masked neighbour
        mean, ``sum(sigmoid(w) x2[nbr] m) / max(sum m, 1)`` (gnn.py:216-228),
        and the plain layer on every device, whatever ``layer`` is. An
        irregular graph ``(x, blocks)`` takes :meth:`forward_blocks` and
        returns its list."""
        if not isinstance(g, SparseGraph):
            return self.forward_blocks(g)
        masked_mean = g.mask is not None and self.node_update
        if masked_mean:
            m = g.mask[..., None].float()
            count = torch.clamp(m.sum(dim=-2), min=1.0)
        x = F.silu(self.v_lin0(g.x.float()))
        w = F.silu(self.e_lin0(g.edge.float()))
        index = None if masked_mean else reverse_adjacency(g.nbr)   # once, all layers
        for i in range(self.depth):
            x0, w0 = x, w
            x1 = self.v_lins1[i](x0)
            x2 = self.v_lins2[i](x0)
            x3 = self.v_lins3[i](x0)
            x4 = self.v_lins4[i](x0)
            e_lin = self.e_lins0[i]
            if masked_mean:
                gated = torch.sigmoid(w0) * gather_nodes(x2, g.nbr)
                agg = torch.sum(gated * m, dim=-2) / count
                pre = w0 @ e_lin.weight.T + e_lin.bias + x3[..., None, :] \
                    + gather_nodes(x4, g.nbr)
            else:
                agg, pre = layer(x2, x3, x4, g.nbr, w0, e_lin.weight.T, e_lin.bias,
                                 index)
            if self.node_update:
                x = x0 + F.silu(self.v_bns[i](x1 + agg))
            w = w0 + F.silu(self.e_bns[i](pre, g.mask))
        return w

    def forward_blocks(self, g) -> list[torch.Tensor]:
        """The plain layers over ``(x, blocks)`` (gnn.py:213-256): per block
        ``[B, R, Kb, U]``. Each layer's node update adds every block's gated
        mean into the block's source rows (``index_add`` by ``src``; a
        block holds each source once, so no two adds meet); the edge update
        is ``e_lin(w) + x3[src] + x4[nbr]`` per block, and one BatchNorm
        takes its statistics over the concatenated edges of all blocks. A
        masked block's mean runs over its valid edges, ``sum(gated m) /
        max(sum m, 1)``, and its mask weights the edge BatchNorm's train-mode
        statistics (the other blocks' edges with weight 1)."""
        blocks, x_in = as_blocks(g)
        n = x_in.shape[-2]
        lead = x_in.shape[:-2]
        masks = None
        if any(b.mask is not None for b in blocks):
            masks = torch.cat([(torch.ones(b.nbr.shape, device=x_in.device) if b.mask is None
                                else b.mask.float()).expand(*lead, *b.nbr.shape[-2:])
                               .flatten(-2) for b in blocks], dim=-1)
        x = F.silu(self.v_lin0(x_in.float()))
        ws = [F.silu(self.e_lin0(b.edge.float())) for b in blocks]
        srcs = [torch.arange(n, device=x.device) if b.src is None else b.src for b in blocks]
        for i in range(self.depth):
            x0, ws0 = x, ws
            x1 = self.v_lins1[i](x0)
            x2 = self.v_lins2[i](x0)
            x3 = self.v_lins3[i](x0)
            x4 = self.v_lins4[i](x0)
            if self.node_update:
                agg = torch.zeros_like(x0)
                for b, src, w0 in zip(blocks, srcs, ws0):
                    gated = torch.sigmoid(w0) * gather_nodes(x2, b.nbr.expand(
                        *x0.shape[:-2], *b.nbr.shape[-2:]))
                    if b.mask is None:
                        mean = gated.mean(dim=-2)
                    else:
                        m = b.mask[..., None].float()
                        mean = torch.sum(gated * m, dim=-2) / torch.clamp(m.sum(dim=-2),
                                                                          min=1.0)
                    agg = agg.index_add(-2, src, mean)
                x = x0 + F.silu(self.v_bns[i](x1 + agg))
            e_lin = self.e_lins0[i]
            pre = [e_lin(w0) + x3[..., src, None, :]
                   + gather_nodes(x4, b.nbr.expand(*x0.shape[:-2], *b.nbr.shape[-2:]))
                   for b, src, w0 in zip(blocks, srcs, ws0)]
            flat = self.e_bns[i](torch.cat([p.flatten(-3, -2) for p in pre], dim=-2), masks)
            ws, off = [], 0
            for p, w0 in zip(pre, ws0):
                size = p.shape[-3] * p.shape[-2]
                ws.append(w0 + F.silu(flat[..., off:off + size, :].reshape(p.shape)))
                off += size
        return ws


class ParNet(nn.Module):
    """Edge head: ``depth``-layer MLP, silu hidden, sigmoid out, squeezed."""

    def __init__(self, depth: int = 3, units: int = 32):
        super().__init__()
        self.lins = nn.ModuleList(
            nn.Linear(units, units if i < depth - 1 else 1) for i in range(depth))

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        for lin in self.lins[:-1]:
            w = F.silu(lin(w))
        return torch.sigmoid(self.lins[-1](w)).squeeze(-1)


class Net(nn.Module):
    """EmbNet + heuristic head, plus a pheromone head when ``dual_heads``;
    returns ``heu [B, N, K]`` or ``(phe, heu)``. With ``pad_feats`` node
    features narrower than that are padded with zeros to it (RCPSP's five,
    gnn.py:293-307); ``feats`` is then ``pad_feats``."""

    def __init__(self, feats: int = 2, edge_feats: int = 1, depth: int = 12,
                 units: int = 32, node_update: bool = True,
                 dual_heads: bool = False, pad_feats: int = 0):
        super().__init__()
        feats = pad_feats or feats
        self.depth, self.units, self.node_update = depth, units, node_update
        self.dual_heads, self.pad_feats = dual_heads, pad_feats
        self.emb_net = EmbNet(feats, edge_feats, depth, units, node_update)
        self.par_net_heu = ParNet(units=units)
        if dual_heads:
            self.par_net_phe = ParNet(units=units)

    def forward(self, g, layer: Callable = fused_gnn_layer):
        """A :class:`SparseGraph`'s ``[B, N, K]`` heads, or a list a block
        for an irregular graph ``(x, blocks)``."""
        g = self.pad(g)
        emb = self.emb_net(g, layer)
        if isinstance(emb, list):
            heads = lambda head: [head(e) for e in emb]
        else:
            heads = lambda head: head(emb)
        heu = heads(self.par_net_heu)
        if self.dual_heads:
            return heads(self.par_net_phe), heu
        return heu

    def pad(self, g):
        """``g`` with its node features zero-padded to ``pad_feats``."""
        x = g.x if isinstance(g, SparseGraph) else g[0]
        if not self.pad_feats or x.shape[-1] >= self.pad_feats:
            return g
        x = F.pad(x, (0, self.pad_feats - x.shape[-1]))
        return g._replace(x=x) if isinstance(g, SparseGraph) else (x, g[1])

    @classmethod
    def from_jax_variables(cls, variables: dict, node_update: bool | None = None,
                           pad_feats: int = 0, dual_heads: bool | None = None) -> "Net":
        """A ``Net`` sized from a Flax ``{"params", "batch_stats"}`` tree,
        loaded with its weights, in eval mode. ``node_update`` defaults to
        whether the tree holds the node BatchNorms, which a Flax net without
        the node update (SMTWTP's) never creates, and ``dual_heads`` to
        whether it holds the pheromone head; ``pad_feats`` is the ``Net``'s.
        Given, they build the net a command builds, which ignores what else
        the tree holds (:func:`load_jax_variables`)."""
        p = variables["params"]
        emb = p["emb_net"]
        depth = sum(1 for key in emb if key.startswith("v_lins1_"))
        net = cls(feats=emb["v_lin0"]["kernel"].shape[0],
                  edge_feats=emb["e_lin0"]["kernel"].shape[0],
                  depth=depth, units=emb["v_lin0"]["kernel"].shape[1],
                  node_update="v_bns_0" in emb if node_update is None else node_update,
                  dual_heads="par_net_phe" in p if dual_heads is None else dual_heads,
                  pad_feats=pad_feats)
        load_jax_variables(net, variables)
        return net.eval()


def _unused(net: nn.Module) -> tuple[str, ...]:
    """The ``state_dict`` entries that a net without the node update never
    reads, the node BatchNorms (kept as modules so that every net has one
    layout); none for a model without an ``emb_net``."""
    emb = getattr(net, "emb_net", None)
    return () if emb is None or emb.node_update else ("emb_net.v_bns.",)


def load_jax_variables(net: nn.Module, variables: dict) -> None:
    """Load a Flax ``{"params", "batch_stats"}`` tree into ``net``. A
    pheromone head that a single-head net does not read is ignored, as
    Flax's ``apply`` ignores it; any other entry ``net`` has no place for
    raises. Every entry ``net`` reads must be there, except the node
    BatchNorms of a net without the node update, which then keep their
    values."""
    missing, unexpected = net.load_state_dict(from_jax_variables(variables), strict=False)
    missing = [k for k in missing if not k.startswith(_unused(net))]
    if not getattr(net, "dual_heads", True):
        unexpected = [k for k in unexpected if not k.startswith("par_net_phe.")]
    if missing or unexpected:
        raise RuntimeError(f"the Flax tree does not fit the Net: missing {missing}, "
                           f"unexpected {unexpected}")


def from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """Map a Flax ``{"params", "batch_stats"}`` tree (numpy leaves) to the
    port's ``state_dict``. A Flax Dense ``kernel [in, out]`` becomes a torch
    ``weight [out, in]``; ``v_lins1_3`` becomes ``v_lins1.3``; BatchNorm
    ``scale/bias`` and ``mean/var`` become ``weight/bias`` and
    ``running_mean/running_var``."""
    tensor = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd: dict[str, torch.Tensor] = {}
    params, stats = variables["params"], variables["batch_stats"]
    for name, leaf in params["emb_net"].items():
        base, _, idx = name.rpartition("_")
        mod = f"emb_net.{base}.{idx}" if base in (
            "v_lins1", "v_lins2", "v_lins3", "v_lins4", "e_lins0",
            "v_bns", "e_bns") else f"emb_net.{name}"
        if "kernel" in leaf:
            sd[f"{mod}.weight"] = tensor(leaf["kernel"]).T.contiguous()
            sd[f"{mod}.bias"] = tensor(leaf["bias"])
        else:
            st = stats["emb_net"][name]
            sd[f"{mod}.weight"] = tensor(leaf["scale"])
            sd[f"{mod}.bias"] = tensor(leaf["bias"])
            sd[f"{mod}.running_mean"] = tensor(st["mean"])
            sd[f"{mod}.running_var"] = tensor(st["var"])
    for head in ("par_net_heu", "par_net_phe"):
        for name, leaf in params.get(head, {}).items():
            i = int(name.rpartition("_")[2])
            sd[f"{head}.lins.{i}.weight"] = tensor(leaf["kernel"]).T.contiguous()
            sd[f"{head}.lins.{i}.bias"] = tensor(leaf["bias"])
    return sd


# Flax lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated law keeps the variance 1 / fan_in (the constant is
# the standard deviation of a unit normal truncated to [-2, 2])
_TRUNCATED_STD = 0.87962566103423978
_LAYER_LISTS = ("v_lins1", "v_lins2", "v_lins3", "v_lins4", "e_lins0",
                "v_bns", "e_bns")
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


@torch.no_grad()
def init_like_flax(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``net`` in place by the law of the JAX package's ``init``:
    every Linear weight from Flax's ``lecun_normal`` (normal, std
    ``sqrt(1/fan_in) / 0.8796``, truncated at 2 std), biases 0, BatchNorm
    scale 1, bias 0, running mean 0 and variance 1. Draws come from
    ``generator``, on the parameters' device."""
    for mod in net.modules():
        if isinstance(mod, nn.Linear):
            std = math.sqrt(1.0 / mod.in_features) / _TRUNCATED_STD
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, TorchBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return net


def jax_path(name: str) -> tuple[str, tuple[str, ...], bool]:
    """Where a ``state_dict`` entry of the port lives in the Flax variables:
    ``(collection, keys, transposed)``; the inverse of
    :func:`from_jax_variables`' naming."""
    parts = name.split(".")
    top = parts[0]
    if top == "emb_net" and parts[1] in _LAYER_LISTS:
        module, leaf = f"{parts[1]}_{parts[2]}", parts[3]
    elif top == "emb_net":
        module, leaf = parts[1], parts[2]
    else:                                          # par_net_*.lins.i.*
        module, leaf = f"lin_{parts[2]}", parts[3]
    if module.startswith(("v_bns", "e_bns")):
        coll, flax_leaf = _BN_LEAVES[leaf]
        return coll, (top, module, flax_leaf), False
    return "params", (top, module, "kernel" if leaf == "weight" else "bias"), \
        leaf == "weight"


def to_jax_tree(tensors: dict[str, torch.Tensor], path: Callable = jax_path) -> dict:
    """Tensors named as in the port's ``state_dict`` (weights, gradients or
    optimizer moments) → a Flax-shaped ``{"params", "batch_stats"}`` tree of
    f32 numpy arrays (copies, which later updates of the tensors leave
    alone), each Linear weight transposed to a ``kernel``; ``path`` is the
    model's naming (:func:`jax_path`, the GNN's, by default)."""
    tree: dict = {}
    for name, t in tensors.items():
        coll, keys, transposed = path(name)
        a = t.detach().float().cpu()
        node = tree.setdefault(coll, {})
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = (a.T if transposed else a).contiguous().numpy().copy()
    return tree


def to_jax_variables(net: nn.Module) -> dict:
    """The inverse of :func:`from_jax_variables`: ``net``'s weights and
    running statistics as Flax ``{"params", "batch_stats"}``."""
    return to_jax_tree(net.state_dict())


def jax_layout(named: dict, net: nn.Module) -> dict:
    """``named`` (``state_dict`` or parameter names) without the entries
    that the Flax net of ``net``'s configuration does not hold: a net
    without the node update has no node BatchNorms there."""
    return {k: v for k, v in named.items() if not k.startswith(_unused(net))}
