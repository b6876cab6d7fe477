"""Edge-gated GNN heuristic network (counterpart of ``deepaco_tpu/models/gnn.py``).

The single regular block: every node has ``K`` out-edges held in a
:class:`~deepaco_tpu_torch.core.graph.SparseGraph`. Tensors carry leading
batch dimensions (``x [B, N, F]``, ``nbr [B, N, K]``, ``edge [B, N, K, E]``).
This module is the plain oracle for the heuristic kernel in
:mod:`deepaco_tpu_torch.ops.fused_gnn`.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepaco_tpu_torch.core.graph import SparseGraph
from deepaco_tpu_torch.ops.gnn_layer import fused_gnn_layer, reverse_adjacency


class TorchBatchNorm(nn.Module):
    """BatchNorm with torch / PyG numerics: the biased variance to normalise,
    the unbiased variance for the running update, momentum 0.1 and eps 1e-5.

    In train mode the statistics are taken per instance, over every axis but
    the leading batch axis and the feature axis, as the JAX trainer takes
    them inside its ``vmap`` over instances (reinforce.py:166-169); each
    instance moves the running statistics by its own batch statistics and
    the results are averaged over instances. Eval mode uses the running
    statistics."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if x.dim() < 3:
                raise ValueError("train-mode BatchNorm takes [B, ..., F] with "
                                 f"a leading instance axis, got {tuple(x.shape)}")
            axes = tuple(range(1, x.dim() - 1))
            count = math.prod(x.shape[1:-1])
            mean = x.mean(dim=axes, keepdim=True)
            var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
            with torch.no_grad():
                stat = lambda t: t.reshape(x.shape[0], x.shape[-1])
                unbiased = stat(var) * count / max(count - 1, 1)
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

    def forward(self, g: SparseGraph, layer: Callable = fused_gnn_layer) -> torch.Tensor:
        """``layer`` computes each layer's ``(agg, pre)``: by default the
        wrapper of kernel K6 (the plain version on CPU tensors); the plain
        version on any device when ``fused_gnn_layer_plain`` is passed."""
        x = F.silu(self.v_lin0(g.x.float()))
        w = F.silu(self.e_lin0(g.edge.float()))
        index = reverse_adjacency(g.nbr)          # once per graph, all layers
        for i in range(self.depth):
            x0, w0 = x, w
            x1 = self.v_lins1[i](x0)
            x2 = self.v_lins2[i](x0)
            x3 = self.v_lins3[i](x0)
            x4 = self.v_lins4[i](x0)
            e_lin = self.e_lins0[i]
            agg, pre = layer(x2, x3, x4, g.nbr, w0, e_lin.weight.T, e_lin.bias,
                             index)
            if self.node_update:
                x = x0 + F.silu(self.v_bns[i](x1 + agg))
            w = w0 + F.silu(self.e_bns[i](pre))
        return w


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
    returns ``heu [B, N, K]`` or ``(phe, heu)``."""

    def __init__(self, feats: int = 2, edge_feats: int = 1, depth: int = 12,
                 units: int = 32, node_update: bool = True,
                 dual_heads: bool = False):
        super().__init__()
        self.depth, self.units, self.node_update = depth, units, node_update
        self.dual_heads = dual_heads
        self.emb_net = EmbNet(feats, edge_feats, depth, units, node_update)
        self.par_net_heu = ParNet(units=units)
        if dual_heads:
            self.par_net_phe = ParNet(units=units)

    def forward(self, g: SparseGraph, layer: Callable = fused_gnn_layer):
        emb = self.emb_net(g, layer)
        heu = self.par_net_heu(emb)
        if self.dual_heads:
            return self.par_net_phe(emb), heu
        return heu

    @classmethod
    def from_jax_variables(cls, variables: dict) -> "Net":
        """A ``Net`` sized from a Flax ``{"params", "batch_stats"}`` tree,
        loaded with its weights, in eval mode."""
        p = variables["params"]
        emb = p["emb_net"]
        depth = sum(1 for key in emb if key.startswith("v_lins1_"))
        net = cls(feats=emb["v_lin0"]["kernel"].shape[0],
                  edge_feats=emb["e_lin0"]["kernel"].shape[0],
                  depth=depth, units=emb["v_lin0"]["kernel"].shape[1],
                  dual_heads="par_net_phe" in p)
        net.load_state_dict(from_jax_variables(variables))
        return net.eval()


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


def to_jax_tree(tensors: dict[str, torch.Tensor]) -> dict:
    """Tensors named as in the port's ``state_dict`` (weights, gradients or
    optimizer moments) → a Flax-shaped ``{"params", "batch_stats"}`` tree of
    f32 numpy arrays, each Linear weight transposed to a ``kernel``."""
    tree: dict = {}
    for name, t in tensors.items():
        coll, keys, transposed = jax_path(name)
        a = t.detach().float().cpu()
        node = tree.setdefault(coll, {})
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.ascontiguousarray((a.T if transposed else a).numpy())
    return tree


def to_jax_variables(net: nn.Module) -> dict:
    """The inverse of :func:`from_jax_variables`: ``net``'s weights and
    running statistics as Flax ``{"params", "batch_stats"}``."""
    return to_jax_tree(net.state_dict())
