"""Read the reference's PyTorch checkpoints (``pretrained/<problem>/*.pt``)
into the Flax-layout variables the port's models load (the port's own copy
of ``deepaco_tpu/models/torch_compat.py:35-117``).

The reference saves ``net.state_dict()``. :func:`torch_state_dict_to_flax`
maps its names onto the ``{"params", "batch_stats"}`` tree of numpy arrays
that ``models.gnn.Net.from_jax_variables`` takes:

  ``emb_net.v_lin0.weight``                 → params/emb_net/v_lin0/kernel (transposed)
  ``emb_net.v_lins1.<i>.weight``            → params/emb_net/v_lins1_<i>/kernel
  ``emb_net.v_bns.<i>.module.weight``       → params/emb_net/v_bns_<i>/scale
  ``emb_net.v_bns.<i>.module.running_mean`` → batch_stats/emb_net/v_bns_<i>/mean
  ``par_net_heu.lins.<i>.weight``           → params/par_net_heu/lin_<i>/kernel

``num_batches_tracked`` and ``_dummy`` entries are dropped; any other name
raises ``ValueError``. A torch ``Linear`` stores ``weight [out, in]``, a
Flax ``Dense`` ``kernel [in, out]``: hence the transpose. A state dict with
``transformer_encoder.*`` names is the MKP-items transformer's, which
``models.transformer.torch_transformer_to_flax`` maps.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _numpy(val) -> np.ndarray:
    return np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach") else val)


def torch_state_dict_to_flax(state_dict: Mapping[str, Any]) -> dict:
    """A reference ``Net`` state dict → ``{"params", "batch_stats"}``, the
    layout of the JAX ``Net``'s variables. Single-head and dual-head nets
    both map; every head the state dict holds is kept (the net a command
    builds reads the ones it has)."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        arr = _numpy(val)
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("num_batches_tracked", "_dummy"):
            continue
        m = (re.fullmatch(r"emb_net\.([ve]_lin0)\.(weight|bias)", key)
             or re.fullmatch(r"emb_net\.([ve]_lins\d)\.(\d+)\.(weight|bias)", key))
        if m:
            *name, wb = m.groups()
            module = "_".join(name)
            _set(tree["params"], ("emb_net", module, "kernel" if wb == "weight" else "bias"),
                 arr.T if wb == "weight" else arr)
            continue
        m = re.fullmatch(r"emb_net\.([ve]_bns)\.(\d+)\.module\."
                         r"(weight|bias|running_mean|running_var)", key)
        if m:
            fam, i, what = m.groups()
            coll, flax_leaf = _BN_LEAVES[what]
            _set(tree[coll], ("emb_net", f"{fam}_{i}", flax_leaf), arr)
            continue
        if key.startswith("emb_net."):
            raise ValueError(f"unrecognized emb_net key: {key}")
        m = re.fullmatch(r"(par_net_\w+)\.lins\.(\d+)\.(weight|bias)", key)
        if m:
            head, i, wb = m.groups()
            _set(tree["params"], (head, f"lin_{i}", "kernel" if wb == "weight" else "bias"),
                 arr.T if wb == "weight" else arr)
            continue
        raise ValueError(f"unrecognized checkpoint key: {key}")
    return tree


def load_reference_checkpoint(path: str) -> dict:
    """A reference ``.pt`` file (``torch.load`` on the CPU, tensors only)
    as Flax variables: the transformer's ``{"params"}`` for an MKP-items
    state dict (``transformer_encoder.*`` names), else the GNN's
    ``{"params", "batch_stats"}``."""
    from deepaco_tpu_torch.models.transformer import torch_transformer_to_flax

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if any(k.startswith("transformer_encoder") for k in sd):
        return torch_transformer_to_flax(sd)
    return torch_state_dict_to_flax(sd)
