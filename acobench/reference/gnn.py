"""The plain reference of the neural heuristic: DeepACO's EmbNet (Ye et al.,
NeurIPS 2023, tsp/net.py) in eval mode, read straight from the Flax
checkpoint's tree, in plain PyTorch.

``heuristic(tree, x, coords, k)`` gives the dense heuristic ``[B, N, N]``:
the k nearest neighbours by Euclidean distance (ties to the lower index),
each edge's distance as its feature, the gated residual layers

    x <- x + silu(BN(W1 x + mean_k(sigmoid(w) * W2 x[nbr])))
    w <- w + silu(BN(W5 w + W3 x + W4 x[nbr]))

(both from the layer's input state; BatchNorm on its running statistics,
eps 1e-5), the heuristic head (two silu layers and a sigmoid), written on
the support and 1e-10 added everywhere. ``dtype`` is the precision of the
whole forward: float32 is what the configuration states, bfloat16 is the
control's.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

BN_EPS = 1e-5
FILL = 1e-10


def distance_matrix(coords: torch.Tensor, diag: float = 1e9) -> torch.Tensor:
    """Euclidean distances ``[..., N, N]`` in f32, the root taken in f64 and
    rounded once; ``diag`` on the diagonal (the instance law's sentinel)."""
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    sq = torch.sum(diff * diff, dim=-1) + 1e-20
    d = torch.sqrt(sq.double()).to(torch.float32)
    eye = torch.eye(coords.shape[-2], dtype=torch.bool, device=coords.device)
    return torch.where(eye, torch.full_like(d, diag), d)


def knn(dist: torch.Tensor, k: int):
    """The ``k`` smallest distances of each row and their columns, ties to
    the lower column (a stable ascending sort)."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


class Weights:
    """The tree's leaves as tensors on ``device`` in ``dtype``."""

    def __init__(self, tree: dict, device, dtype=torch.float32):
        t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device, dtype)
        p, s = tree["params"], tree["batch_stats"]
        emb = p["emb_net"]
        self.depth = sum(1 for key in emb if key.startswith("v_lins1_"))
        self.lin = {name: (t(leaf["kernel"]), t(leaf["bias"]))
                    for name, leaf in emb.items() if "kernel" in leaf}
        self.bn = {name: (t(leaf["scale"]), t(leaf["bias"]),
                          t(s["emb_net"][name]["mean"]), t(s["emb_net"][name]["var"]))
                   for name, leaf in emb.items() if "scale" in leaf}
        head = p["par_net_heu"]
        self.head = [(t(head[f"lin_{i}"]["kernel"]), t(head[f"lin_{i}"]["bias"]))
                     for i in range(len(head))]
        self.dtype = dtype

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.lin[name]
        return x @ w + b

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        scale, bias, mean, var = self.bn[name]
        return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias


def _gather_nodes(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``x [B, N, U]`` at ``nbr [B, N, K]`` → ``[B, N, K, U]``."""
    b, n, k = nbr.shape
    flat = torch.gather(x, 1, nbr.reshape(b, n * k, 1).expand(b, n * k, x.shape[-1]))
    return flat.reshape(b, n, k, x.shape[-1])


@torch.no_grad()
def heuristic_block(wt: Weights, x: torch.Tensor, dist: torch.Tensor, k: int) -> torch.Tensor:
    """The dense heuristic ``[B, N, N]`` (f32) of one block of instances."""
    vals, nbr = knn(dist, k)
    dt = wt.dtype
    v = F.silu(wt.dense("v_lin0", x.to(dt)))
    w = F.silu(wt.dense("e_lin0", vals[..., None].to(dt)))
    for i in range(wt.depth):
        x1 = wt.dense(f"v_lins1_{i}", v)
        x2 = wt.dense(f"v_lins2_{i}", v)
        x3 = wt.dense(f"v_lins3_{i}", v)
        x4 = wt.dense(f"v_lins4_{i}", v)
        agg = torch.mean(torch.sigmoid(w) * _gather_nodes(x2, nbr), dim=-2)
        pre = wt.dense(f"e_lins0_{i}", w) + x3[..., None, :] + _gather_nodes(x4, nbr)
        v = v + F.silu(wt.norm(f"v_bns_{i}", x1 + agg))
        w = w + F.silu(wt.norm(f"e_bns_{i}", pre))
    h = w
    for lin_w, lin_b in wt.head[:-1]:
        h = F.silu(h @ lin_w + lin_b)
    lin_w, lin_b = wt.head[-1]
    o = torch.sigmoid(h @ lin_w + lin_b)[..., 0].float()
    out = torch.full(dist.shape, FILL, dtype=torch.float32, device=dist.device)
    return out.scatter(-1, nbr, o + FILL)


def node_features(coords: torch.Tensor, kind: str) -> torch.Tensor:
    """The net's node features: the coordinates, or (``start_onehot``, the
    TSP-NLS net) 1 at node 0 and 0 elsewhere."""
    if kind == "coords":
        return coords
    if kind == "start_onehot":
        x = torch.zeros((*coords.shape[:-1], 1), dtype=torch.float32, device=coords.device)
        x[..., 0, 0] = 1.0
        return x
    raise ValueError(f"unknown node features {kind!r}")


def heuristic(wt: Weights, coords: torch.Tensor, k: int, features: str, *,
              block: int = 8) -> torch.Tensor:
    """The dense heuristic ``[B, N, N]`` of ``coords [B, N, 2]``, ``block``
    instances at a time so that the edge states fit."""
    outs = []
    for i in range(0, coords.shape[0], block):
        c = coords[i:i + block]
        outs.append(heuristic_block(wt, node_features(c, features), distance_matrix(c), k))
    return torch.cat(outs)
