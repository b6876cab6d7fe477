"""REINFORCE training for neural-heuristic ACO, TSP family (counterpart of
``deepaco_tpu/train/reinforce.py:37-194``).

The reference loss (tsp/train.ipynb cell 1; tsp_nls/train.py:15-44):
``loss = sum((costs - mean(costs)).detach() * sum_t log_probs) / n_ants``,
averaged over the instance batch; AdamW after a global-norm clip at 3.0,
with a cosine schedule for the NLS envelope. With a local-search hook the
advantage is NLS-shaped: ``W*(ls - mean ls) + (1-W)*(raw - mean raw)``,
W=0.95 (tsp_nls/train.py:33-35).

One step: instances from the trainer's generator, the train-mode GNN
(BatchNorm statistics per instance, as the JAX step's ``vmap`` takes them),
the dense heuristic, a sampled rollout with log-probabilities, optionally
NLS on every ant, the loss, its gradient and the update. On the card the
GNN layers run kernel K6 (forward and backward), the rollout kernel K7r
(one launch forward, one backward) and the local search kernel K5.

The optimizer follows optax's ``chain(clip_by_global_norm, adamw)`` where
torch's defaults differ: the clip scales by ``max_norm / norm`` only when
``norm >= max_norm``; weight decay reaches every parameter, also one that
got no gradient (its gradient is set to zero); the learning rate is the
closed form of ``optax.cosine_decay_schedule`` at the update count, from 0.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from deepaco_tpu_torch.aco.engine import path_log_probs, rollout
from deepaco_tpu_torch.aco.problems.tsp import tour_cost, tsp_spec
from deepaco_tpu_torch.core.builders import tsp_nls_graph
from deepaco_tpu_torch.core.graph import knn_graph, scatter_to_dense
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.models.gnn import (init_like_flax, jax_layout, jax_path,
                                          load_jax_variables, to_jax_tree)
from deepaco_tpu_torch.ops.gnn_layer import (fused_gnn_layer,
                                             fused_gnn_layer_plain)
from deepaco_tpu_torch.ops.two_opt import batched_nls_euclid, heuristic_dist
from deepaco_tpu_torch.train.config import ProblemConfig
from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords
from deepaco_tpu_torch.utils.metrics import phase

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8       # optax.adamw's defaults


class TrainOps(NamedTuple):
    """What a train step calls for the GNN layer, and ``timer(name)``, a
    context manager around each phase (``"heuristic"``, ``"rollout"``,
    ``"local_search"``, ``"backward"``, ``"optimizer"``). The default is
    kernel K6 and no timer."""

    layer: Callable = fused_gnn_layer
    timer: Callable | None = None


KERNEL_OPS = TrainOps()
PLAIN_OPS = TrainOps(fused_gnn_layer_plain)


class TrainState(NamedTuple):
    """The network (weights and running statistics), its optimizer, the
    number of updates taken, and whether the learning rate follows the
    cosine schedule (which adds a count to optax's state)."""

    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    cosine: bool

    def tree(self) -> dict:
        """The layout of the JAX ``TrainState`` under
        ``flax.serialization.to_state_dict``: ``params``, ``batch_stats``,
        ``opt_state`` (``(clip, (adam, decay, schedule))`` as ``{"0": {},
        "1": {"0": {count, mu, nu}, "1": {}, "2": {count} or {}}}``) and
        ``step``, with numpy leaves. A net without the node update leaves
        out the node BatchNorms, as the Flax net has none."""
        path = _jax_path(self.net)
        variables = to_jax_tree(jax_layout(self.net.state_dict(), self.net), path)
        named = jax_layout(dict(self.net.named_parameters()), self.net)

        def moment(key):
            return to_jax_tree({
                name: self.optimizer.state[p][key] if p in self.optimizer.state
                else torch.zeros_like(p) for name, p in named.items()}, path)["params"]

        count = np.array(self.step, dtype=np.int32)
        adam = {"count": count, "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
        schedule = {"count": count} if self.cosine else {}
        return {"params": variables["params"],
                "batch_stats": variables.get("batch_stats", {}),
                "opt_state": {"0": {}, "1": {"0": adam, "1": {}, "2": schedule}},
                "step": count}


class StepInfo(NamedTuple):
    """What a step reports: the loss, the mean cost (the mean LS cost with
    local search) and the gradient's global norm before clipping, as 0-d
    tensors on the step's device."""

    loss: torch.Tensor
    mean_cost: torch.Tensor
    grad_norm: torch.Tensor


class LossOut(NamedTuple):
    """:func:`tsp_loss`'s result: the scalar loss, the monitored mean cost,
    the paths ``[B, N, A]``, their log-probabilities ``[B, N-1, A]``, costs
    ``[B, A]`` and LS costs."""

    loss: torch.Tensor
    mean_cost: torch.Tensor
    paths: torch.Tensor
    log_probs: torch.Tensor
    costs: torch.Tensor
    ls_costs: torch.Tensor | None


def total_steps(cfg: ProblemConfig) -> int:
    return cfg.train.epochs * cfg.train.steps_per_epoch


def learning_rate(cfg: ProblemConfig, count: int) -> float:
    """The rate of update ``count`` (from 0): ``lr``, or with the cosine
    schedule ``lr * 0.5 * (1 + cos(pi * min(count, T) / T))`` over
    ``T = epochs * steps_per_epoch`` (``optax.cosine_decay_schedule``)."""
    lr = cfg.train.lr
    if not cfg.train.cosine_schedule:
        return lr
    t = total_steps(cfg)
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count, t) / t))


def make_optimizer(net: torch.nn.Module, cfg: ProblemConfig) -> torch.optim.AdamW:
    """AdamW with optax's settings written out: betas (0.9, 0.999), eps
    1e-8, ``cfg.train.weight_decay``, the rate of update 0."""
    return torch.optim.AdamW(net.parameters(), lr=learning_rate(cfg, 0),
                             betas=ADAM_BETAS, eps=ADAM_EPS,
                             weight_decay=cfg.train.weight_decay,
                             amsgrad=False, maximize=False)


def _jax_path(net: torch.nn.Module) -> Callable:
    """The net's naming in the Flax variables: its own ``jax_path`` (the
    transformer's) or the GNN's."""
    return getattr(net, "jax_path", jax_path)


def init_train_state(net: torch.nn.Module, cfg: ProblemConfig,
                     generator: torch.Generator, init: Callable = init_like_flax) -> TrainState:
    """``net`` initialised in place by the JAX package's law (``init``,
    :func:`init_like_flax` by default, drawn from ``generator``), with a
    fresh optimizer at step 0."""
    init(net, generator)
    return TrainState(net, make_optimizer(net, cfg), 0, cfg.train.cosine_schedule)


def restore_train_state(tree: dict, net: torch.nn.Module,
                        cfg: ProblemConfig) -> TrainState:
    """The inverse of :meth:`TrainState.tree`: ``net`` (on its device) loaded
    with the tree's weights and statistics, and an optimizer holding its
    Adam moments and update count."""
    dev = next(net.parameters()).device
    if hasattr(net, "load_jax_variables"):
        net.load_jax_variables(tree)
    else:
        load_jax_variables(net, tree)
    opt = make_optimizer(net, cfg)
    adam = tree["opt_state"]["1"]["0"]
    count = int(adam["count"])
    path = _jax_path(net)
    if count:
        def leaf(root, name):
            _, keys, transposed = path(name)
            for key in keys:
                root = root[key]
            t = torch.from_numpy(np.array(root, dtype=np.float32))
            return (t.T if transposed else t).contiguous().to(dev)

        for name, p in jax_layout(dict(net.named_parameters()), net).items():
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": leaf(adam["mu"], name),
                            "exp_avg_sq": leaf(adam["nu"], name)}
    return TrainState(net, opt, int(tree["step"]), cfg.train.cosine_schedule)


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: ``g / norm * max_norm`` when
    ``norm >= max_norm``, else ``g``. Returns the norm before clipping; no
    host synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def optimizer_update(state: TrainState, cfg: ProblemConfig):
    """One update from the gradients in ``state.net``: a zero gradient for
    every parameter without one, the clip, the rate of this update, AdamW.
    Returns ``(state, grad norm)``; the gradients are cleared."""
    params = list(state.net.parameters())
    with phase("optimizer.clip"):
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in params], cfg.train.grad_clip)
    with phase("optimizer.adamw"):
        for group in state.optimizer.param_groups:
            group["lr"] = learning_rate(cfg, state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
    return state._replace(step=state.step + 1), norm


def tsp_heuristic(net: torch.nn.Module, coords: torch.Tensor, *, k_sparse: int,
                  eps: float, train: bool, nls_graph: bool = False,
                  layer: Callable = fused_gnn_layer):
    """``coords [B, N, 2]`` → ``(heu [B, N, N], dist [B, N, N])``: the k-NN
    graph (or the NLS one-hot start graph), ``net`` in train or eval mode,
    the heuristic head scattered to dense, plus ``eps``; spans
    ``heuristic.graph``, ``heuristic.net`` and ``heuristic.scatter``."""
    with phase("heuristic.graph"):
        dist = distance_matrix(coords)
        if nls_graph:
            g = tsp_nls_graph(coords, dist, k_sparse, start_node=0)
        else:
            g = knn_graph(coords, dist, k_sparse)
    with phase("heuristic.net"):
        net.train(train)
        out = net(g, layer)
        heu_vec = out[1] if isinstance(out, tuple) else out
    with phase("heuristic.scatter"):
        return scatter_to_dense(g, heu_vec) + eps, dist


def reinforce_loss(costs: torch.Tensor, log_probs: torch.Tensor, n_ants: int, *,
                   ls_costs: torch.Tensor | None = None,
                   w: float = 0.95) -> torch.Tensor:
    """Per-instance loss ``[B]`` from ``costs [B, A]`` and ``log_probs
    [B, T, A]``: the mean-baseline REINFORCE, or the NLS-shaped advantage."""
    adv = costs - costs.mean(dim=-1, keepdim=True)
    if ls_costs is not None:
        adv = w * (ls_costs - ls_costs.mean(dim=-1, keepdim=True)) + (1.0 - w) * adv
    return torch.sum(adv.detach() * log_probs.sum(dim=-2), dim=-1) / n_ants


def nls_local_search(t_nls: int = 10, t_p: int = 20):
    """Training-time NLS hook (tsp_nls/aco.py:226-258): every ant's tour
    through NLS with budget ``n // 4``, perturbing on ``heuristic_dist(heu)``;
    ``t_nls=0`` is plain 2-opt. ``fn(dist, heu, paths, coords)`` returns the
    improved costs ``[B, A]``, through K5 on the card. Reward shaping only:
    no gradient flows through it."""

    @torch.no_grad()
    def fn(dist, heu, paths, coords):
        budget = max(dist.shape[-1] // 4, 1)
        tours = batched_nls_euclid(coords, heuristic_dist(heu.detach()), paths.transpose(1, 2),
                    budget, t_nls, t_p)
        return tour_cost(dist, tours.transpose(1, 2))

    return fn


def tsp_loss(net: torch.nn.Module, coords: torch.Tensor, cfg: ProblemConfig,
             generator: torch.Generator, *, local_search: Callable | None = None,
             nls_w: float = 0.95, paths: torch.Tensor | None = None,
             _ops: TrainOps = KERNEL_OPS) -> LossOut:
    """The step's loss on ``coords [B, N, 2]``, differentiable in ``net``.
    Without ``paths`` the ants sample (``rollout(require_prob=True)``);
    with ``paths [B, N, A]`` their log-probabilities are replayed
    (``path_log_probs``). With ``local_search`` every ant starts at city 0,
    the graph carries the one-hot start feature and the advantage is
    NLS-shaped."""
    a = cfg.aco
    with phase("heuristic", _ops.timer):
        heu, dist = tsp_heuristic(net, coords, k_sparse=cfg.k_sparse,
                                  eps=cfg.train.eps, train=True,
                                  nls_graph=local_search is not None,
                                  layer=_ops.layer)
    with phase("rollout", _ops.timer):
        fixed_start = 0 if local_search is not None else None
        spec = tsp_spec(torch.ones_like(heu), heu, a.n_ants, fixed_start)
        if paths is None:
            ro = rollout(spec, generator, alpha=a.alpha, beta=a.beta,
                         require_prob=True)
            paths, log_probs = ro.paths, ro.log_probs
        else:
            log_probs = path_log_probs(spec, paths, alpha=a.alpha, beta=a.beta)
        costs = tour_cost(dist, paths)
    ls_costs = None
    if local_search is not None:
        with phase("local_search", _ops.timer):
            ls_costs = local_search(dist, heu.detach(), paths, coords)
    with phase("loss"):
        loss = reinforce_loss(costs, log_probs, a.n_ants, ls_costs=ls_costs,
                              w=nls_w).mean()
        mean_cost = (costs if ls_costs is None else ls_costs).mean()
    return LossOut(loss, mean_cost, paths, log_probs, costs, ls_costs)


def make_tsp_train_step(cfg: ProblemConfig, local_search: Callable | None = None,
                        nls_w: float = 0.95, *, _ops: TrainOps = KERNEL_OPS):
    """The TSP train step: ``(state, generator) -> (state, StepInfo)``. Each
    step draws ``batch_size`` instances of ``n_nodes`` uniform cities from
    ``generator`` on the network's device. Spans (``utils/metrics.phase``):
    ``step`` around it; ``step.data``, ``heuristic``, ``rollout``,
    ``local_search``, ``loss``, ``backward`` and ``optimizer`` inside."""

    def step(state: TrainState, generator: torch.Generator):
        with phase("step"):
            dev = next(state.net.parameters()).device
            with phase("step.data"):
                coords = uniform_coords(cfg.n_nodes, generator,
                                        batch=cfg.train.batch_size, device=dev)
            out = tsp_loss(state.net, coords, cfg, generator,
                           local_search=local_search, nls_w=nls_w, _ops=_ops)
            with phase("backward", _ops.timer):
                out.loss.backward()
            with phase("optimizer", _ops.timer):
                state, norm = optimizer_update(state, cfg)
            return state, StepInfo(out.loss.detach(), out.mean_cost.detach(), norm)

    return step


def train_tsp(net: torch.nn.Module, cfg: ProblemConfig, *,
              local_search: Callable | None = None,
              progress: Callable | None = None, max_steps: int | None = None,
              device=None, _ops: TrainOps = KERNEL_OPS) -> TrainState:
    """The whole training loop (reference tsp/train.ipynb cell 3 envelope):
    ``net`` moved to ``device`` (``cuda`` by default; ``cpu`` only when
    asked), initialised from ``cfg.train.seed``, then ``epochs *
    steps_per_epoch`` steps, or the first ``max_steps`` of them (the
    schedule still spans the whole run). ``progress(step, StepInfo)`` is
    called after every step; the JAX ``train_tsp`` calls it once an epoch."""
    dev = resolve_device(device)
    net = net.to(dev)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    state = init_train_state(net, cfg, generator)
    step_fn = make_tsp_train_step(cfg, local_search=local_search, _ops=_ops)
    n = total_steps(cfg) if max_steps is None else min(max_steps, total_steps(cfg))
    for i in range(n):
        state, info = step_fn(state, generator)
        if progress is not None:
            progress(i, info)
    return state
