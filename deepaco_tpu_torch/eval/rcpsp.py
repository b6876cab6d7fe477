"""The RCPSP anytime protocol over a PSPLIB subset (counterpart of
``deepaco_tpu/eval/rcpsp.py``; the reference's rcpsp/test.ipynb cells
0-5): for each instance, the elitist MAX-MIN search with 20 ants, neural
(the single-head ``Net(pad_feats=5)`` on the masked graph) or classic
(``default_rcpsp_heuristic``), and the mean best makespan at cumulative T
in {1, 10, 20, 30, 40, 50, 100}.

The whole subset runs as one batch, each instance with its own search
state, on the decoder's common horizon: the largest ``t_max`` of the
subset, with each instance's ``latest_finish`` left as it was (the JAX
evaluation ``_replace``-s ``t_max`` only). The JAX package's ``b_chunk``
(a TPU watchdog workaround) is not ported: instances are independent, so
the results agree in law.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.problems.rcpsp import (RCPSPConfig, init_rcpsp_search,
                                                  rcpsp_iteration)
from deepaco_tpu_torch.core.builders import rcpsp_graph
from deepaco_tpu_torch.core.rcpsp import RCPSPData, default_rcpsp_heuristic, stack_rcpsp
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.train.drivers import KERNEL_OPS, FamilyOps
from deepaco_tpu_torch.utils.metrics import phase

RCPSP_FEATS = 5           # the node features the RCPSP net pads to (eval/rcpsp.py:79)
EPS = 1e-10               # the heuristic's offset (rcpsp/test.ipynb cell 1)


def rcpsp_net(variables: dict | None = None, pad_feats: int = RCPSP_FEATS) -> Net:
    """The single-head RCPSP ``Net`` (the reference's phe head is commented
    out, rcpsp/net.py:86-102), two edge features, node features padded to
    ``pad_feats``: loaded from a Flax tree in eval mode when given, else
    fresh."""
    if variables is not None:
        return Net.from_jax_variables(variables, pad_feats=pad_feats, dual_heads=False)
    return Net(edge_feats=2, pad_feats=pad_feats)


def rcpsp_heuristics(data: RCPSPData, net: Net) -> torch.Tensor:
    """``[B, n, n]``: ``net`` (in the mode it is in) on each instance's
    masked graph (``core.builders.rcpsp_graph``), ``heu * mask + 1e-10``.
    The masked block is the dense layout, so the reference's reshape is the
    mask's product."""
    g = rcpsp_graph(data)
    out = net(g)
    heu = out[1] if isinstance(out, tuple) else out
    return heu * g.mask + EPS


@torch.no_grad()
def evaluate_rcpsp(instances: list[RCPSPData], net: Net | None = None, *,
                   n_ants: int = 20, t_values=(1, 10, 20, 30, 40, 50, 100), seed: int = 0,
                   elitist: bool = True, min_max: bool = True, backfill: bool = False,
                   device=None, return_state: bool = False, _ops: FamilyOps = KERNEL_OPS):
    """The anytime protocol over ``instances`` (one size). Returns ``(mean
    best makespan at each of t_values, curves [B, max(t_values)])`` and,
    with ``return_state``, also the batched instances and the final
    ``RCPSPSearchState`` (``best_path [B, n]``). ``net=None`` is the
    classic arm; ``net`` is moved to ``device`` (``cuda`` by default, ``cpu``
    only when asked) and run in eval mode, and left in the mode it came in.
    ``backfill`` picks the decoder (``aco.problems.rcpsp.ssgs_schedule``).
    Every construction is one ``rollout`` with ``_ops.pick`` (the direct
    evaluation's one-launch route: K7r's untraced forward on the card) and
    every update one ``_ops.deposit`` (K8); ``_ops.timer`` wraps the phases
    ``"heuristic"``, ``"construction"``, ``"decode"`` and ``"update"``."""
    dev = resolve_device(device)
    data = stack_rcpsp(instances, device=dev)
    with phase("heuristic", _ops.timer):
        if net is None:
            heu = default_rcpsp_heuristic(data)
        else:
            training = net.training
            heu = rcpsp_heuristics(data, net.to(dev).eval())
            net.train(training)
    cfg = RCPSPConfig(n_ants=n_ants, elitist=elitist, min_max=min_max, backfill=backfill)
    state = init_rcpsp_search(heu.shape[0], data.n, cfg, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    curve = []
    for _ in range(int(max(t_values))):
        state = rcpsp_iteration(data, heu, cfg, state, generator, pick=_ops.pick,
                                deposit=_ops.deposit, timer=_ops.timer)
        curve.append(state.best_cost)
    curves = torch.stack(curve, dim=1)
    means = curves[:, [t - 1 for t in t_values]].mean(dim=0)
    return (means, curves, data, state) if return_state else (means, curves)
