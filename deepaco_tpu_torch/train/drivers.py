"""Evaluation over the family registry (counterpart of
``deepaco_tpu/train/drivers.py``): the anytime evaluation of any ported
family. Training through the registry waits for its slice (ROADMAP.md).

:func:`evaluate_family` runs the whole batch at once, every instance with
its own search state: graph → GNN → dense heuristic (or the classic one),
then ``aco.runner.run_anytime``. On the card the eval-mode GNN runs the
folded layer stack K9 in one launch where ``embnet_supported`` takes the net
(else one K6 launch a layer), every deposit K8, and each iteration's
construction one launch of K7c (CVRP) or one K7 a step (TSP, and CVRP past
K7c's N). The JAX version's host
chunking of instances (``b_chunk``, a TPU watchdog workaround) and its
``mesh`` (multi-device) are not ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.aco.runner import _no_timer, init_search, run_anytime
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.families import Family, get_family
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops.cvrp_construct import cvrp_construct, cvrp_construct_plain
from deepaco_tpu_torch.ops.fused_gnn import (embnet_layers, embnet_layers_plain,
                                             embnet_supported, net_forward_fast)
from deepaco_tpu_torch.ops.gnn_layer import fused_gnn_layer, fused_gnn_layer_plain
from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain


class FamilyOps(NamedTuple):
    """What the evaluation calls for the GNN layer (``layer``, the per-layer
    route) or the folded layer stack (``layers``, the eval-mode route of
    :func:`_forward_heu`), each construction step (``pick``: the TSP
    family, and CVRP past K7c's N), each deposit, the CVRP family's whole
    construction (``construct``), and ``timer(name)``, a context manager
    around each phase (``"heuristic"``, ``"construction"``, ``"update"``).
    The default is kernels K6, K7, K8, K9, K7c and no timer."""

    layer: Callable = fused_gnn_layer
    pick: Callable = fused_pick
    deposit: Callable = ph.deposit
    timer: Callable = _no_timer
    layers: Callable = embnet_layers
    construct: Callable = cvrp_construct


KERNEL_OPS = FamilyOps()
PLAIN_OPS = FamilyOps(fused_gnn_layer_plain, fused_pick_plain, ph.deposit_plain,
                      layers=embnet_layers_plain, construct=cvrp_construct_plain)


def family_model(family: Family, variables: dict | None = None) -> Net:
    """The family's ``Net``: sized from and loaded with a Flax
    ``{"params", "batch_stats"}`` tree when given (``Net.from_jax_variables``),
    else fresh with the family's arguments."""
    if variables is not None:
        return Net.from_jax_variables(variables)
    return Net(**dict(family.model_kwargs))


def gen_batch(family: Family, rng: np.random.Generator, n: int,
              batch_size: int) -> dict:
    """Host-side instance batch: a dict of stacked numpy arrays ``[B, ...]``."""
    insts = [family.gen(rng, n) for _ in range(batch_size)]
    return {k: np.stack([np.asarray(i[k]) for i in insts]) for k in insts[0]}


def _forward_heu(family: Family, net: Net, inst: dict, k_sparse: int,
                 ops: FamilyOps = KERNEL_OPS) -> torch.Tensor:
    """graph → GNN → the dense heuristic ``[B, N, N]``, routed by
    configuration as ``eval.anytime.dense_heuristic`` routes TSP: an
    eval-mode net that :func:`embnet_supported` takes runs the folded layer
    stack (``ops.layers``, K9) under ``net_forward_fast``; a net in train
    mode, or one K9 does not take, runs ``net(g, ops.layer)``, a layer at a
    time (K6)."""
    g = family.graph(inst, k_sparse)
    n, k = g.nbr.shape[-2:]
    if not net.training and embnet_supported(net, n, k):
        out = net_forward_fast(net, g.x, g.nbr, g.edge, layers=ops.layers)
    else:
        out = net(g, ops.layer)
        out = out[1] if isinstance(out, tuple) else out
    return family.heu_matrix(g, out, inst)


@torch.no_grad()
def evaluate_family(name: str, batch: dict, *, n_nodes: int, net: Net | None = None,
                    k_sparse: int | None = None, n_ants: int = 20,
                    t_values=(1, 10, 20, 30, 40, 50, 100), seed: int = 0,
                    device=None, return_state: bool = False,
                    _ops: FamilyOps = KERNEL_OPS):
    """The anytime protocol over an instance batch (``batch``: a dict of
    arrays ``[B, ...]`` in the family's layout, e.g. ``utils.golden.cvrp_test``).

    Returns ``(mean best-so-far at each of t_values, curves [B, t_max])``, and
    with ``return_state`` also the final
    :class:`~deepaco_tpu_torch.aco.runner.SearchState` (its ``best_path
    [B, horizon+1]`` holds each instance's best solution). ``net=None`` runs
    the classic arm. It runs on ``device`` (``cuda`` by default; ``cpu``
    only when asked), and ``net`` is moved there. The private ``_ops``
    (:class:`FamilyOps`) swaps in the plain versions of the kernels or a
    timer around each phase.
    """
    dev = resolve_device(device)
    family = get_family(name)
    cfg = family.aco._replace(n_ants=n_ants)
    k_sparse = family.k_sparse(n_nodes) if k_sparse is None else k_sparse
    inst = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
            for k, v in batch.items()}
    b = next(iter(inst.values())).shape[0]
    t_max = int(max(t_values))
    generator = torch.Generator(device=dev).manual_seed(seed)
    with _ops.timer("heuristic"):
        if net is None:
            heu = family.classic_heu(inst, k_sparse)
        else:
            heu = _forward_heu(family, net.to(dev).eval(), inst, k_sparse, _ops)
    n_states, horizon = family.horizon_states(n_nodes)
    state = init_search(n_states, horizon, cfg, batch=(b,), device=dev)
    state, curves = run_anytime(
        lambda tau, gen: family.construct(tau, heu, inst, n_ants, gen, _ops),
        lambda paths: family.cost(paths, inst), cfg, state, generator, t_max,
        deposit=_ops.deposit, timer=_ops.timer)
    idx = torch.tensor([t - 1 for t in t_values], device=dev)
    means = curves[:, idx].mean(dim=0)
    return (means, curves, state) if return_state else (means, curves)
