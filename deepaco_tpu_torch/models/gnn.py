"""Edge-gated GNN heuristic network (counterpart of ``deepaco_tpu/models/gnn.py``).

The single regular block: every node has ``K`` out-edges held in a
:class:`~deepaco_tpu_torch.core.graph.SparseGraph`. Tensors carry leading
batch dimensions (``x [B, N, F]``, ``nbr [B, N, K]``, ``edge [B, N, K, E]``).
This module is the plain oracle for the heuristic kernel in
:mod:`deepaco_tpu_torch.ops.fused_gnn`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepaco_tpu_torch.core.graph import SparseGraph


def gather_nodes(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``x [B, N, U]`` at ``nbr [B, N, K]`` → ``[B, N, K, U]``."""
    b, n, k = nbr.shape
    idx = nbr.reshape(b, n * k, 1).expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx).reshape(b, n, k, x.shape[-1])


class TorchBatchNorm(nn.Module):
    """BatchNorm with torch / PyG numerics: statistics over every leading
    axis, the biased variance to normalise, the unbiased variance for the
    running update, momentum 0.1 and eps 1e-5."""

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
            flat = x.reshape(-1, x.shape[-1])
            count = flat.shape[0]
            mean = flat.mean(dim=0)
            var = ((flat - mean) ** 2).mean(dim=0)
            with torch.no_grad():
                unbiased = var * count / max(count - 1, 1)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
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

    def forward(self, g: SparseGraph) -> torch.Tensor:
        x = F.silu(self.v_lin0(g.x.float()))
        w = F.silu(self.e_lin0(g.edge.float()))
        for i in range(self.depth):
            x0, w0 = x, w
            x1 = self.v_lins1[i](x0)
            x2 = self.v_lins2[i](x0)
            x3 = self.v_lins3[i](x0)
            x4 = self.v_lins4[i](x0)
            if self.node_update:
                agg = torch.mean(torch.sigmoid(w0) * gather_nodes(x2, g.nbr),
                                 dim=-2)
                x = x0 + F.silu(self.v_bns[i](x1 + agg))
            pre = self.e_lins0[i](w0) + x3[..., None, :] + gather_nodes(x4, g.nbr)
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

    def forward(self, g: SparseGraph):
        emb = self.emb_net(g)
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
