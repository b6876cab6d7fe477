"""Training and evaluation over the family registry (counterpart of
``deepaco_tpu/train/drivers.py``): one REINFORCE trainer and one anytime
evaluator for every ported family.

:func:`train_family` trains a family's ``Net`` from a seed (drivers.py:134-199):
each step (:func:`make_family_train_step`) runs the train-mode GNN with
BatchNorm statistics per instance, averaged over the instance batch as the
JAX step's ``vmap`` takes them, samples with ``rollout(require_prob=True)``
through the family's ``spec``, and updates with the loss ``sum(sign *
(cost - mean) * sum_t log p) / A``. On the card every GNN layer is one
launch of kernel K6 forward and one backward, and the rollout one launch of
K7r each way (TSP, SMTWTP, CVRP, BPP, SOP, MKP, MKP-items, OP and PCTSP,
whose plug-ins carry their score matrix) or, past K7r's caps, one launch of
K7 a step.
Products stay in full f32 (TF32 is never switched on), as
the JAX step runs under ``default_matmul_precision("highest")``.

:func:`evaluate_family` runs the whole batch at once, every instance with
its own search state: graph → GNN → dense heuristic (or the classic one),
then ``aco.runner.run_anytime``. On the card the eval-mode GNN runs the
folded layer stack K9 in one launch where ``embnet_supported`` takes the net
(else one K6 launch a layer), every deposit K8, and each iteration's
construction one launch of K7c (CVRP, BPP), one launch of K7r's untraced
forward (TSP, SMTWTP, SOP, MKP, MKP-items, OP, PCTSP) or, past the caps of
K7c and K7r, one K7 a step. Each
instance batch first goes through ``Family.prepare`` (OP's and MKP's
extended arrays), and ``Family.extras`` (OP's and MKP's per-instance ``q``)
reaches the search. A family with a ``forward`` hook (MKP-items'
transformer) computes its heuristic there, in PyTorch on every device, and
a ``vector_pheromone`` family deposits on items, not edges (no K8). The JAX version's host
chunking of instances (``b_chunk``, a TPU watchdog workaround) is not
ported.

With a ``mesh`` (``parallel.make_mesh``), :func:`evaluate_family` shards the
batch over the mesh's ``instance`` axis: the rank at instance coordinate
``i`` runs the routine above on its contiguous block, with a generator
seeded ``parallel._axes.block_seed(seed, i)`` (``seed`` itself for block
0), and the curves are gathered over ``instance``, so every rank returns the
whole batch's. Ranks that share an instance coordinate along ``ant``
compute the same block, as JAX's ``P("instance")`` replicates it. JAX draws
a key an instance; the port draws one stream a batch, so a sharded run
equals each block run alone with its block seed, concatenated (a one-rank
mesh gives the unsharded run to the digit).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.aco.engine import path_log_probs, rollout
from deepaco_tpu_torch.aco.runner import _no_timer, init_search, run_anytime
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.families import Family, get_family
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops.cvrp_construct import cvrp_construct, cvrp_construct_plain
from deepaco_tpu_torch.ops.fused_gnn import (embnet_layers, embnet_layers_plain,
                                             embnet_supported, net_forward_fast)
from deepaco_tpu_torch.ops.gnn_layer import fused_gnn_layer, fused_gnn_layer_plain
from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain
from deepaco_tpu_torch.parallel._axes import block_seed, instance_block, rank_device
from deepaco_tpu_torch.train.config import ProblemConfig
from deepaco_tpu_torch.train.reinforce import (LossOut, StepInfo, TrainState,
                                               init_train_state, optimizer_update,
                                               reinforce_loss, total_steps)
from deepaco_tpu_torch.utils.checkpoint import save_checkpoint


class FamilyOps(NamedTuple):
    """What training and evaluation call for the GNN layer (``layer``, the
    per-layer route: training) or the folded layer stack (``layers``, the
    eval-mode route of :func:`_forward_heu`), each construction step
    (``pick``: where ``fused_pick`` stands for K7r and ``fused_pick_plain``
    for its plain version on the plug-ins that carry ``fused``, in
    training and evaluation; the per-step families' rollouts, and CVRP's
    and BPP's past K7c's N), each deposit, the CVRP and BPP families' whole
    construction in evaluation (``construct``), and ``timer(name)``, a context manager around each
    phase (evaluation: ``"heuristic"``, ``"construction"``, ``"update"``;
    a training step: ``"heuristic"``, ``"rollout"``, ``"backward"``,
    ``"optimizer"``). The default is kernels K6, K7, K8, K9, K7c and no
    timer."""

    layer: Callable = fused_gnn_layer
    pick: Callable = fused_pick
    deposit: Callable = ph.deposit
    timer: Callable = _no_timer
    layers: Callable = embnet_layers
    construct: Callable = cvrp_construct


KERNEL_OPS = FamilyOps()
PLAIN_OPS = FamilyOps(fused_gnn_layer_plain, fused_pick_plain, ph.deposit_plain,
                      layers=embnet_layers_plain, construct=cvrp_construct_plain)


def family_model(family: Family, variables: dict | None = None, **sizes) -> torch.nn.Module:
    """The family's ``Net``: sized from and loaded with a Flax
    ``{"params", "batch_stats"}`` tree when given (``Net.from_jax_variables``,
    with the family's ``node_update`` and ``dual_heads``, ignoring what else
    the tree holds, as the JAX family's ``Net`` does), else fresh with the
    family's arguments and ``sizes`` (``feats``, ``edge_feats``). A family
    with a ``model_ctor`` gets that model instead (MKP-items' transformer)."""
    kwargs = dict(family.model_kwargs)
    if family.model_ctor is not None:
        if variables is not None:
            return family.model_ctor.from_jax_variables(variables)
        return family.model_ctor(**kwargs)
    if variables is not None:
        return Net.from_jax_variables(variables, node_update=kwargs.get("node_update", True),
                                      dual_heads=kwargs.get("dual_heads", False))
    return Net(**{**kwargs, **sizes})


def gen_batch(family: Family, rng: np.random.Generator, n: int,
              batch_size: int) -> dict:
    """Host-side instance batch: a dict of stacked numpy arrays ``[B, ...]``."""
    insts = [family.gen(rng, n) for _ in range(batch_size)]
    return {k: np.stack([np.asarray(i[k]) for i in insts]) for k in insts[0]}


def instance_tensors(batch: dict, device) -> dict:
    """A batch of instances (numpy arrays or tensors ``[B, ...]``) as f32
    tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in batch.items()}


def _forward_heu(family: Family, net: Net, inst: dict, k_sparse: int,
                 ops: FamilyOps = KERNEL_OPS) -> torch.Tensor:
    """graph → GNN → the dense heuristic ``[B, N, N]``, routed by
    configuration as ``eval.anytime.dense_heuristic`` routes TSP: an
    eval-mode net that :func:`embnet_supported` takes runs the folded layer
    stack (``ops.layers``, K9) under ``net_forward_fast``; a net in train
    mode, or one K9 does not take, runs ``net(g, ops.layer)``, a layer at a
    time (K6). A masked graph (SOP's) takes K9 only without the node
    update: then each edge's state depends on itself alone and eval mode
    ignores the mask, so the mask changes nothing before ``heu_matrix``
    applies it; with the node update (RCPSP's) ``net`` takes the masked
    neighbour mean in its plain layer, whatever ``ops.layer`` is. A
    family's ``forward`` hook replaces all of this."""
    if family.forward is not None:
        return family.forward(net, inst, k_sparse)
    g = family.graph(inst, k_sparse)
    n, k = g.nbr.shape[-2:]
    if (not net.training and embnet_supported(net, n, k)
            and (g.mask is None or not net.node_update)):
        out = net_forward_fast(net, g.x, g.nbr, g.edge, layers=ops.layers)
    else:
        out = net(g, ops.layer)
        out = out[1] if isinstance(out, tuple) else out
    return family.heu_matrix(g, out, inst)


@torch.no_grad()
def evaluate_family(name: str, batch: dict, *, n_nodes: int, net: Net | None = None,
                    k_sparse: int | None = None, n_ants: int = 20,
                    t_values=(1, 10, 20, 30, 40, 50, 100), seed: int = 0,
                    device=None, return_state: bool = False, mesh=None,
                    _ops: FamilyOps = KERNEL_OPS):
    """The anytime protocol over an instance batch (``batch``: a dict of
    arrays ``[B, ...]`` in the family's layout, e.g. ``utils.golden.cvrp_test``).

    Returns ``(mean best-so-far at each of t_values, curves [B, t_max])`` (the
    objective, larger is better, for a family that maximizes: OP, BPP, MKP), and
    with ``return_state`` also the final
    :class:`~deepaco_tpu_torch.aco.runner.SearchState` (its ``best_path
    [B, horizon+1]`` holds each instance's best solution). ``net=None`` runs
    the classic arm. It runs on ``device`` (``cuda`` by default; ``cpu``
    only when asked); ``net`` is moved there, runs in eval mode (its
    running statistics untouched) and is left in the mode it came in, so
    that a trainer can validate its net between steps. The private ``_ops``
    (:class:`FamilyOps`) swaps in the plain versions of the kernels or a
    timer around each phase.

    ``mesh``: shard the batch over the mesh's ``instance`` axis (the module's
    notes); refuses a ``B`` the axis does not divide, a ``device`` of
    another type than the mesh's, and ``return_state``.
    """
    dev = resolve_device(device)
    if mesh is not None:
        return _evaluate_sharded(name, batch, mesh, dev, n_nodes=n_nodes, net=net,
                                 k_sparse=k_sparse, n_ants=n_ants, t_values=t_values,
                                 seed=seed, return_state=return_state, _ops=_ops)
    family = get_family(name)
    cfg = family.aco._replace(n_ants=n_ants)
    k_sparse = family.k_sparse(n_nodes) if k_sparse is None else k_sparse
    inst = family.prepare(instance_tensors(batch, dev))
    b = next(iter(inst.values())).shape[0]
    t_max = int(max(t_values))
    generator = torch.Generator(device=dev).manual_seed(seed)
    with _ops.timer("heuristic"):
        if net is None:
            heu = family.classic_heu(inst, k_sparse)
        else:
            training = net.training
            heu = _forward_heu(family, net.to(dev).eval(), inst, k_sparse, _ops)
            net.train(training)
    n_states, horizon = family.horizon_states(n_nodes)
    state = init_search(n_states, horizon, cfg, batch=(b,), device=dev)
    state, curves = run_anytime(
        lambda tau, gen: family.construct(tau, heu, inst, n_ants, gen, _ops),
        lambda paths: family.cost(paths, inst), cfg, state, generator, t_max,
        deposit=_ops.deposit, timer=_ops.timer, **family.extras(inst))
    idx = torch.tensor([t - 1 for t in t_values], device=dev)
    means = curves[:, idx].mean(dim=0)
    return (means, curves, state) if return_state else (means, curves)


def _evaluate_sharded(name: str, batch: dict, mesh, dev, *, seed: int,
                      return_state: bool, **kwargs):
    """:func:`evaluate_family` over ``mesh``'s ``instance`` axis: this rank's
    block with its block seed, then the curves gathered over the axis."""
    if return_state:
        raise ValueError("evaluate_family: return_state is not gathered over a mesh")
    if mesh.device_type != dev.type:
        raise ValueError(f"evaluate_family: a {mesh.device_type} mesh cannot run on {dev}")
    block = instance_block(mesh)
    b = len(next(iter(batch.values())))
    rows = block.rows(b)
    _, curves = evaluate_family(name, {k: v[rows] for k, v in batch.items()},
                                seed=block_seed(seed, block.index),
                                device=rank_device(), **kwargs)
    parts = [torch.empty_like(curves) for _ in range(block.count)]
    dist.all_gather(parts, curves.contiguous(), group=mesh.get_group("instance"))
    curves = torch.cat(parts, dim=0)
    idx = torch.tensor([t - 1 for t in kwargs["t_values"]], device=curves.device)
    return curves[:, idx].mean(dim=0), curves


# --------------------------------------------------------------- training --
def family_loss(family: Family, net: Net, inst: dict, cfg: ProblemConfig,
                generator: torch.Generator, *, paths: torch.Tensor | None = None,
                _ops: FamilyOps = KERNEL_OPS) -> LossOut:
    """The loss of one training step (drivers.py:62-100) on ``inst``, a dict
    of tensors ``[B, ...]``, differentiable in ``net``, which it puts in
    train mode: the heuristic through ``_forward_heu``'s per-layer route
    (BatchNorm on batch statistics does not fold into K9), then the
    family's ``spec`` on a pheromone of ones, after ``Family.prepare``.
    Without ``paths`` the
    ``cfg.aco.n_ants`` ants sample (``rollout(require_prob=True)``: the
    pick's one-launch rollout, K7r, for the plug-ins that carry ``fused``,
    else a pick a step); with ``paths [B, horizon+1, A]`` their log-probabilities are
    replayed (``path_log_probs``). The loss is the batch mean of
    ``sum(sign * (cost - mean cost) * sum_t log p) / A``, the advantage
    detached, ``sign = -1`` for a family that maximizes."""
    a = cfg.aco.n_ants
    alpha, beta = family.aco.alpha, family.aco.beta
    inst = family.prepare(inst)
    net.train(True)
    with _ops.timer("heuristic"):
        heu = _forward_heu(family, net, inst, cfg.k_sparse, _ops)
    with _ops.timer("rollout"):
        spec = family.spec(torch.ones_like(heu), heu, inst, a)
        if paths is None:
            ro = rollout(spec, generator, alpha=alpha, beta=beta, require_prob=True,
                         pick=_ops.pick)
            paths, log_probs = ro.paths, ro.log_probs
        else:
            log_probs = path_log_probs(spec, paths, alpha=alpha, beta=beta)
        costs = family.cost(paths, inst)
    sign = -1.0 if family.aco.maximize else 1.0
    loss = reinforce_loss(sign * costs, log_probs, a).mean()
    return LossOut(loss, costs.mean(), paths, log_probs, costs, None)


def make_family_train_step(family: Family, cfg: ProblemConfig, *,
                           _ops: FamilyOps = KERNEL_OPS):
    """The family's train step: ``(state, batch, generator) -> (state,
    StepInfo)``, ``batch`` a host batch of ``gen_batch`` (or tensors),
    moved to the net's device. The ants draw from ``generator``; the
    optimizer is ``train.reinforce``'s (clip, AdamW as optax runs them).
    Nothing waits for the card: ``StepInfo`` holds 0-d tensors."""

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        inst = instance_tensors(batch, next(state.net.parameters()).device)
        out = family_loss(family, state.net, inst, cfg, generator, _ops=_ops)
        with _ops.timer("backward"):
            out.loss.backward()
        with _ops.timer("optimizer"):
            state, norm = optimizer_update(state, cfg)
        return state, StepInfo(out.loss.detach(), out.mean_cost.detach(), norm)

    return step


def init_family_state(family: Family, cfg: ProblemConfig, rng_np: np.random.Generator,
                      generator: torch.Generator) -> TrainState:
    """A fresh ``Net`` of the family on ``generator``'s device, initialised by
    the JAX package's law (``init_like_flax``; the draws differ from JAX's),
    and its optimizer at step 0. Like JAX's ``init_family_state``
    (drivers.py:116-131) it draws one instance from ``rng_np``, prepares it
    and builds its graph on the CPU, and sizes the net's node and edge
    features from that template, as Flax's ``init`` does; the batches that
    follow are the JAX trainer's. A family with a ``model_ctor`` gets its
    model, initialised by its ``model_init``."""
    template = {k: np.asarray(v)[None] for k, v in family.gen(rng_np, cfg.n_nodes).items()}
    if family.model_ctor is not None:
        return init_train_state(family_model(family).to(generator.device), cfg, generator,
                                family.model_init)
    g = family.graph(family.prepare(instance_tensors(template, "cpu")), cfg.k_sparse)
    net = family_model(family, feats=g.x.shape[-1], edge_feats=g.edge.shape[-1])
    return init_train_state(net.to(generator.device), cfg, generator)


def train_family(name: str, cfg: ProblemConfig, progress: Callable | None = None,
                 val_instances: int = 0, val_t: int = 10, ckpt_path: str | None = None,
                 logger=None, max_steps: int | None = None, device=None,
                 _ops: FamilyOps = KERNEL_OPS) -> TrainState:
    """The whole training run of family ``name`` (drivers.py:134-199) on
    ``device`` (``cuda`` by default; ``cpu`` only when asked): instances
    from ``numpy.random.default_rng(cfg.train.seed)``, ``batch_size`` a
    step, ``epochs * steps_per_epoch`` steps, or the first ``max_steps`` of
    them (the epoch they end in is the last; the learning rate keeps the
    whole run's schedule). The weights and the ants draw from one
    ``torch.Generator`` seeded with ``cfg.train.seed``.

    After each epoch: ``logger`` (a ``utils.metrics.MetricsLogger``) gets a
    ``train_epoch`` event; with ``val_instances > 0`` the net is evaluated
    (:func:`evaluate_family`, T = ``val_t``, seed ``cfg.train.seed``) on a
    held-out batch drawn from ``default_rng(seed + 777_777)``, ``logger``
    gets a ``val`` event, and with ``ckpt_path`` the state is written to
    ``<stem>-last.msgpack`` and, when the validation cost is the best so
    far, ``<stem>-best.msgpack``. ``progress(epoch, mean cost[, val])`` is
    called once an epoch, the mean cost that of the epoch's last step."""
    dev = resolve_device(device)
    family = get_family(name)
    rng_np = np.random.default_rng(cfg.train.seed)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    state = init_family_state(family, cfg, rng_np, generator)
    step_fn = make_family_train_step(family, cfg, _ops=_ops)
    val_batch = None
    if val_instances > 0:
        val_batch = gen_batch(family, np.random.default_rng(cfg.train.seed + 777_777),
                              cfg.n_nodes, val_instances)
    stem = None if ckpt_path is None else ckpt_path.removesuffix(".msgpack")
    sign = -1.0 if family.aco.maximize else 1.0
    best_val = math.inf
    n_steps = total_steps(cfg) if max_steps is None else min(max_steps, total_steps(cfg))
    per_epoch = cfg.train.steps_per_epoch
    for epoch in range(-(-n_steps // per_epoch)):
        for _ in range(min(per_epoch, n_steps - epoch * per_epoch)):
            batch = gen_batch(family, rng_np, cfg.n_nodes, cfg.train.batch_size)
            state, info = step_fn(state, batch, generator)
        cost = info.mean_cost.item()
        if logger is not None:
            logger.log("train_epoch", epoch=epoch, mean_cost=cost)
        if val_batch is None:
            if progress is not None:
                progress(epoch, cost)
            continue
        means, _ = evaluate_family(name, val_batch, n_nodes=cfg.n_nodes, net=state.net,
                                   k_sparse=cfg.k_sparse, n_ants=cfg.aco.n_ants,
                                   t_values=(val_t,), seed=cfg.train.seed, device=dev,
                                   _ops=_ops._replace(timer=_no_timer))
        val = means[0].item()
        if logger is not None:
            logger.log("val", epoch=epoch, t=val_t, mean_best=val)
        if stem is not None:
            save_checkpoint(f"{stem}-last.msgpack", state)
            if sign * val < best_val:
                best_val = sign * val
                save_checkpoint(f"{stem}-best.msgpack", state)
        if progress is not None:
            progress(epoch, cost, val)
    return state
