"""The MKP-items heuristic network (counterpart of
``deepaco_tpu/models/transformer.py:21-81``; reference
mkp_transformer/net.py:9-45): ``Linear(6 → 32) · √32``, 3 post-LN encoder
layers (d 32, 2 heads, feed-forward 32, relu, LayerNorm eps 1e-5 with Flax's
numerics, no dropout), then a relu head of three Linears, a sigmoid and ``h / max(h)``
over each instance's items.

The attention is written out in the JAX package's order (``in_proj``, a
split into q, k, v, a per-head ``einsum``, softmax, ``out_proj``), not
through ``nn.TransformerEncoderLayer`` or ``scaled_dot_product_attention``,
whose fused paths round otherwise. The JAX package has no Pallas kernel
here, and neither has the port. Tensors carry a leading batch axis: ``src
[B, n, 6]`` → ``[B, n]``.

:func:`torch_transformer_to_flax` and :func:`load_transformer_checkpoint`
read the reference's state dict (``pretrained/mkp_transformer/*.pt``) into
the Flax ``{"params"}`` tree that :meth:`TransformerModel.from_jax_variables`
takes (transformer.py:81-144).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepaco_tpu_torch.models.gnn import init_like_flax
from deepaco_tpu_torch.models.torch_compat import _numpy, _set


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Flax's ``LayerNorm`` numerics with ``norm``'s scale and bias: the
    variance as ``max(mean(x^2) - mean(x)^2, 0)``, then ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias


class EncoderLayer(nn.Module):
    """Post-LN torch-style encoder layer (transformer.py:21-51)."""

    def __init__(self, d_model: int = 32, nhead: int = 2, d_hid: int = 32):
        super().__init__()
        self.nhead = nhead
        self.in_proj_w = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_b = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_hid)
        self.linear2 = nn.Linear(d_hid, d_model)
        nn.init.xavier_uniform_(self.in_proj_w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, n, d = x.shape
        h = self.nhead
        qkv = x @ self.in_proj_w.T + self.in_proj_b                    # [..., n, 3d]
        q, k, v = (t.reshape(*lead, n, h, d // h).transpose(-3, -2)
                   for t in qkv.split(d, dim=-1))                       # [..., h, n, hd]
        scores = torch.einsum("...hid,...hjd->...hij", q, k) / math.sqrt(d // h)
        out = torch.einsum("...hij,...hjd->...hid", torch.softmax(scores, dim=-1), v)
        out = self.out_proj(out.transpose(-3, -2).reshape(*lead, n, d))
        x = layer_norm(x + out, self.norm1)
        return layer_norm(x + self.linear2(F.relu(self.linear1(x))), self.norm2)


class TransformerModel(nn.Module):
    """``src [B, n, ntoken_input]`` (an item's price and its weights) → the
    item heuristic ``[B, n]`` in (0, 1], its largest entry 1."""

    def __init__(self, ntoken_input: int = 6, d_model: int = 32, nhead: int = 2,
                 d_hid: int = 32, nlayers: int = 3):
        super().__init__()
        self.d_model = d_model
        self.encoder = nn.Linear(ntoken_input, d_model)
        self.layers = nn.ModuleList(EncoderLayer(d_model, nhead, d_hid)
                                    for _ in range(nlayers))
        self.head = nn.ModuleList([nn.Linear(d_model, 32), nn.Linear(32, 32),
                                   nn.Linear(32, 1)])

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        x = self.encoder(src.to(self.encoder.weight.dtype)) * math.sqrt(self.d_model)
        for layer in self.layers:
            x = layer(x)
        h = F.relu(self.head[0](x))
        h = F.relu(self.head[1](h))
        h = torch.sigmoid(self.head[2](h))[..., 0]
        return h / h.amax(dim=-1, keepdim=True)

    @staticmethod
    def jax_path(name: str) -> tuple[str, tuple[str, ...], bool]:
        """Where a ``state_dict`` entry lives in the Flax variables:
        ``(collection, keys, transposed)``: ``encoder``, ``layer_i/{in_proj_w,
        in_proj_b, out_proj, norm1, norm2, linear1, linear2}`` and
        ``head_lin_{0,1,2}``; a Linear's ``weight`` is the transposed
        ``kernel``, a LayerNorm's ``weight`` its ``scale``."""
        parts = name.split(".")
        if parts[0] == "layers":
            keys = [f"layer_{parts[1]}", *parts[2:]]
        elif parts[0] == "head":
            keys = [f"head_lin_{parts[1]}", parts[2]]
        else:
            keys = parts
        leaf = keys[-1]
        if leaf == "weight":
            norm = keys[-2].startswith("norm")
            keys[-1] = "scale" if norm else "kernel"
            return "params", tuple(keys), not norm
        return "params", tuple(keys), False

    @classmethod
    def from_jax_variables(cls, variables: dict) -> "TransformerModel":
        """A model sized from a Flax ``{"params"}`` tree (the JAX
        ``TransformerModel``'s), loaded with its weights, in eval mode."""
        p = variables["params"]
        kernel = p["encoder"]["kernel"]
        net = cls(ntoken_input=kernel.shape[0], d_model=kernel.shape[1],
                  nlayers=sum(1 for key in p if key.startswith("layer_")))
        net.load_jax_variables(variables)
        return net.eval()

    def load_jax_variables(self, variables: dict) -> None:
        """Load the Flax ``params`` into this model; every entry must match."""
        sd = {}
        for name in self.state_dict():
            _, keys, transposed = self.jax_path(name)
            leaf = variables["params"]
            for key in keys:
                leaf = leaf[key]
            t = torch.from_numpy(np.array(leaf, dtype=np.float32))
            sd[name] = t.T.contiguous() if transposed else t
        self.load_state_dict(sd)


@torch.no_grad()
def init_transformer_like_flax(net: TransformerModel,
                               generator: torch.Generator) -> TransformerModel:
    """Initialise ``net`` in place by the JAX package's law: every Linear
    from Flax's ``lecun_normal`` (``models.gnn.init_like_flax``), each
    ``in_proj_w`` from ``xavier_uniform`` and ``in_proj_b`` 0, LayerNorms at
    scale 1 and bias 0. Draws come from ``generator``."""
    init_like_flax(net, generator)
    for layer in net.layers:
        nn.init.xavier_uniform_(layer.in_proj_w, generator=generator)
        layer.in_proj_b.zero_()
        for norm in (layer.norm1, layer.norm2):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
    return net


_LAYER_LEAVES = {
    "self_attn.in_proj_weight": ("in_proj_w",), "self_attn.in_proj_bias": ("in_proj_b",),
    "self_attn.out_proj.weight": ("out_proj", "kernel"),
    "self_attn.out_proj.bias": ("out_proj", "bias"),
    "linear1.weight": ("linear1", "kernel"), "linear1.bias": ("linear1", "bias"),
    "linear2.weight": ("linear2", "kernel"), "linear2.bias": ("linear2", "bias"),
    "norm1.weight": ("norm1", "scale"), "norm1.bias": ("norm1", "bias"),
    "norm2.weight": ("norm2", "scale"), "norm2.bias": ("norm2", "bias")}


def torch_transformer_to_flax(state_dict) -> dict:
    """The reference ``TransformerModel`` state dict (mkp_transformer/net.py:
    ``encoder``, ``transformer_encoder.layers.<i>.*``, ``decoder_heu.lins.<i>``)
    → the JAX model's ``{"params"}`` of numpy arrays. A Linear's ``weight`` is
    the transposed ``kernel``; ``in_proj_weight`` keeps torch's ``[3d, d]``;
    ``_dummy`` entries are dropped and any other name raises ``ValueError``."""
    params: dict = {}
    for key, val in state_dict.items():
        arr = _numpy(val)
        if key.endswith("_dummy"):
            continue
        if key in ("encoder.weight", "encoder.bias"):
            _set(params, ("encoder", "kernel") if key.endswith("weight") else ("encoder", "bias"),
                arr.T if key.endswith("weight") else arr)
            continue
        m = re.fullmatch(r"transformer_encoder\.layers\.(\d+)\.(.+)", key)
        if m:
            i, rest = m.groups()
            if rest not in _LAYER_LEAVES:
                raise ValueError(f"unrecognized layer key: {key}")
            leaf = _LAYER_LEAVES[rest]
            _set(params, (f"layer_{i}", *leaf), arr.T if leaf[-1] == "kernel" else arr)
            continue
        m = re.fullmatch(r"decoder_heu\.lins\.(\d+)\.(weight|bias)", key)
        if m:
            i, wb = m.groups()
            _set(params, (f"head_lin_{i}", "kernel" if wb == "weight" else "bias"),
                arr.T if wb == "weight" else arr)
            continue
        raise ValueError(f"unrecognized checkpoint key: {key}")
    return {"params": params}


def load_transformer_checkpoint(path: str) -> dict:
    """A reference MKP-items ``.pt`` file (``torch.load`` on the CPU, tensors
    only) as the Flax ``{"params"}`` tree."""
    return torch_transformer_to_flax(torch.load(path, map_location="cpu", weights_only=True))
