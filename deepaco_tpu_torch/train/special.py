"""The trainers outside the family trainer (counterpart of
``deepaco_tpu/train/special.py``): RCPSP's, whose loss is scaled by 1/n
with the clip 1.0 and whose graph needs the host's precedence analysis
(rcpsp/train.ipynb cell 1), CVRP-NLS's, whose advantage comes from the
costs of the native SWAP* engine on the host (cvrp_nls/train.py:14-55),
and the MKP-items transformer's single-instance step
(:func:`make_mkp_items_train_step`, mkp_transformer/train.py:14-30).

One RCPSP step (:func:`make_rcpsp_train_step`, special.py:35-70): the
train-mode ``Net(pad_feats=5)`` on one instance's masked graph (its
BatchNorms on the batch's statistics, the edge ones weighted by the mask;
the masked layer in plain PyTorch on every device), tau of ones, the ants
sampled on the one-launch route (K7r forward and backward on the card: SOP's
kind on the direct evaluation, the ``"blend"`` kind on the blend of ``gamma
>= 0.05`` and ``c < 1``; ``probs_fn`` and K7 a step only at ``alpha <= 0``
off the direct evaluation) and decoded by the
reference's SSGS, the loss ``sum(adv * sum_t log p) / A / n``, and
``optax.chain(clip_by_global_norm(1.0), adamw(lr))`` with optax's default
weight decay 1e-4.

One CVRP-NLS step (:func:`cvrp_nls_train_step`): the heuristic of the two-block graph
with the net in **eval mode**, as the JAX trainer applies it (``train=False``,
special.py:160), so the BatchNorms normalise with their running statistics
and never update them; one construction without log-probabilities (K7c on
the card); every ant refined on the host (``ls.hgs.multiple_swap_star``,
move budget ``max(n - 1, 50)``, the neural perturbation metric); the
advantage ``ls_costs - mean``; then the gradient of ``sum(adv * sum_t
log p) / A``, the recorded paths replayed through ``path_log_probs``, and
``optax.chain(clip_by_global_norm(3.0), adamw(lr))`` with optax's default
weight decay 1e-4.

One MKP-items step (special.py:117-145): the transformer on one instance's
``[price, weights]`` tokens plus 1e-10, ``extend_mkp``'s dummy item, a
pheromone of ones, ``mkp_items_spec``'s rollout with its log-probabilities
(K7r's ``"items"`` kind, one launch each way on the card), ``mkp_objective``, and the maximising loss
``sum((mean - objective) * sum_t log p) / A``; the optimizer is the
configuration's (clip, AdamW). The CLI trains MKP-items through the family
trainer, as the JAX CLI does.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from deepaco_tpu_torch.aco.engine import path_log_probs, rollout
from deepaco_tpu_torch.aco.problems.cvrp import cvrp_paths, cvrp_spec, route_cost
from deepaco_tpu_torch.aco.problems.cvrp_nls import perturbation_metric
from deepaco_tpu_torch.aco.problems.rcpsp import RCPSPConfig, makespans, rcpsp_spec
from deepaco_tpu_torch.core.builders import cvrp_nls_graph
from deepaco_tpu_torch.core.rcpsp import RCPSPData, stack_rcpsp
from deepaco_tpu_torch.core.graph import scatter_blocks
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.ls import hgs
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.eval.rcpsp import RCPSP_FEATS, rcpsp_heuristics, rcpsp_net
from deepaco_tpu_torch.families import get_family
from deepaco_tpu_torch.train.config import ACOSettings, ModelConfig, ProblemConfig, TrainConfig
from deepaco_tpu_torch.train.drivers import KERNEL_OPS, FamilyOps, make_family_train_step
from deepaco_tpu_torch.train.reinforce import (LossOut, StepInfo, TrainState, init_train_state,
                                               optimizer_update)
from deepaco_tpu_torch.utils.golden import cvrp_nls_capacity
from deepaco_tpu_torch.utils.metrics import phase

ADAMW_WEIGHT_DECAY = 1e-4        # optax.adamw's default
TRAIN_EPS = 1e-5                 # the training heuristic's offset (special.py:147)


# ------------------------------------------------------------------ RCPSP --
def rcpsp_config(n_nodes: int, *, epochs: int = 5, steps_per_epoch: int = 20,
                 n_ants: int = 10, lr: float = 3e-4, grad_clip: float = 1.0,
                 seed: int = 0) -> ProblemConfig:
    """The RCPSP trainer's configuration (special.py:73-88): ``lr``, AdamW
    decay 1e-4, the clip ``grad_clip``, one instance a step, node features
    padded to 5 (``model.pad_feats``)."""
    return ProblemConfig(name="rcpsp", n_nodes=n_nodes, k_sparse=n_nodes,
                         model=ModelConfig(pad_feats=RCPSP_FEATS),
                         aco=ACOSettings(n_ants=n_ants),
                         train=TrainConfig(lr=lr, weight_decay=ADAMW_WEIGHT_DECAY,
                                           grad_clip=grad_clip, epochs=epochs,
                                           steps_per_epoch=steps_per_epoch, batch_size=1,
                                           seed=seed))


def rcpsp_loss(net: Net, data: RCPSPData, aco_cfg: RCPSPConfig, generator: torch.Generator,
               *, paths: torch.Tensor | None = None, _ops: FamilyOps = KERNEL_OPS) -> LossOut:
    """The loss of one step on the batched instances ``data`` (one in the
    trainer), differentiable in ``net``, which it puts in train mode: the
    heuristic ``heu * mask + 1e-10`` on tau of ones, then ``aco_cfg.n_ants``
    ants sampled (``rollout(require_prob=True)``, ``_ops.pick`` a step) or,
    with ``paths [B, n, A]``, replayed (``path_log_probs``); the makespans
    by the reference's decoder; the batch mean of ``sum(adv * sum_t log p)
    / A / n``, ``adv = cost - mean`` detached."""
    net.train(True)
    with phase("heuristic", _ops.timer):
        heu = rcpsp_heuristics(data, net)
    with phase("rollout", _ops.timer):
        spec = rcpsp_spec(torch.ones_like(heu), heu, data, aco_cfg)
        if paths is None:
            ro = rollout(spec, generator, require_prob=True, pick=_ops.pick)
            paths, log_probs = ro.paths, ro.log_probs
        else:
            log_probs = path_log_probs(spec, paths)
    with phase("decode", _ops.timer):
        costs = makespans(data, paths)
    adv = (costs - costs.mean(dim=-1, keepdim=True)).detach()
    loss = (adv * log_probs.sum(dim=-2)).sum(dim=-1) / aco_cfg.n_ants / heu.shape[-1]
    return LossOut(loss.mean(), costs.mean(), paths, log_probs, costs, None)


def make_rcpsp_train_step(cfg: ProblemConfig, aco_cfg: RCPSPConfig | None = None, *,
                          _ops: FamilyOps = KERNEL_OPS):
    """``(state, data, generator) -> (state, StepInfo)``: :func:`rcpsp_loss`
    on ``data`` (batched instances on the net's device), its gradient and
    one optimizer update (the clip, then AdamW as optax runs them)."""
    aco_cfg = aco_cfg or RCPSPConfig(n_ants=cfg.aco.n_ants)

    def step(state: TrainState, data: RCPSPData, generator: torch.Generator):
        out = rcpsp_loss(state.net, data, aco_cfg, generator, _ops=_ops)
        with phase("backward", _ops.timer):
            out.loss.backward()
        with phase("optimizer", _ops.timer):
            state, norm = optimizer_update(state, cfg)
        return state, StepInfo(out.loss.detach(), out.mean_cost.detach(), norm)

    return step


def train_rcpsp(instances: list[RCPSPData], *, epochs: int = 5, steps_per_epoch: int = 20,
                n_ants: int = 10, lr: float = 3e-4, grad_clip: float = 1.0, seed: int = 0,
                progress: Callable | None = None, max_steps: int | None = None,
                device=None, _ops: FamilyOps = KERNEL_OPS) -> tuple[Net, TrainState]:
    """The RCPSP training loop (special.py:73-101) over ``instances`` (one
    size; the decoder's horizon is the largest ``t_max``) on ``device``
    (``cuda`` by default; ``cpu`` only when asked): a fresh net initialised
    from ``seed`` by the JAX package's law, the ants drawn from a generator
    seeded ``seed + 1``, and each of ``epochs * steps_per_epoch`` steps (or
    the first ``max_steps``) on the instance that
    ``numpy.random.default_rng(seed).integers`` picks. ``progress(epoch,
    mean makespan of the epoch's last step)`` after each epoch. Returns
    ``(net, state)``; ``state.tree()`` is the JAX ``TrainState``."""
    dev = resolve_device(device)
    cfg = rcpsp_config(instances[0].n, epochs=epochs, steps_per_epoch=steps_per_epoch,
                       n_ants=n_ants, lr=lr, grad_clip=grad_clip, seed=seed)
    t_max = max(d.t_max for d in instances)
    batches = [stack_rcpsp([d], t_max, device=dev) for d in instances]
    state = init_train_state(rcpsp_net(pad_feats=cfg.model.pad_feats).to(dev), cfg,
                             torch.Generator(device=dev).manual_seed(seed))
    step_fn = make_rcpsp_train_step(cfg, _ops=_ops)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    rs = np.random.default_rng(seed)
    n_steps = epochs * steps_per_epoch if max_steps is None else min(
        max_steps, epochs * steps_per_epoch)
    for epoch in range(-(-n_steps // steps_per_epoch)):
        for _ in range(min(steps_per_epoch, n_steps - epoch * steps_per_epoch)):
            state, info = step_fn(state, batches[int(rs.integers(len(instances)))], generator)
        if progress is not None:
            progress(epoch, info.mean_cost.item())
    return state.net, state


# -------------------------------------------------------------- MKP-items --
def make_mkp_items_train_step(cfg: ProblemConfig, *, _ops: FamilyOps = KERNEL_OPS):
    """``(state, prize [n], weight [n, m], generator) -> (state, mean
    objective)``: the ``mkp_items`` family's train step
    (``drivers.make_family_train_step``, which runs the module note's
    step) on a batch of this one instance (numpy arrays or tensors, moved
    to the net's device), ``cfg.aco.n_ants`` ants. The mean objective is a
    0-d tensor; nothing waits for the card."""
    family_step = make_family_train_step(get_family("mkp_items"), cfg, _ops=_ops)

    def step(state: TrainState, prize, weight, generator: torch.Generator):
        batch = {"prize": torch.as_tensor(prize)[None], "weight": torch.as_tensor(weight)[None]}
        state, info = family_step(state, batch, generator)
        return state, info.mean_cost

    return step


# --------------------------------------------------------------- CVRP-NLS --


def cvrp_nls_config(n_nodes: int, *, epochs: int = 5, steps_per_epoch: int = 20,
                    lr: float = 1e-4, n_ants: int = 20, k_sparse: int = 5,
                    seed: int = 0) -> ProblemConfig:
    """The trainer's configuration: ``lr``, AdamW decay 1e-4, the clip 3.0,
    one instance a step, no schedule."""
    return ProblemConfig(name="cvrp_nls", n_nodes=n_nodes, k_sparse=k_sparse,
                         aco=ACOSettings(n_ants=n_ants),
                         train=TrainConfig(lr=lr, weight_decay=ADAMW_WEIGHT_DECAY,
                                           epochs=epochs, steps_per_epoch=steps_per_epoch,
                                           batch_size=1, seed=seed))


def cvrp_nls_heuristic(net: Net, demand: torch.Tensor, dist: torch.Tensor,
                       k_sparse: int = 5, eps: float = TRAIN_EPS) -> torch.Tensor:
    """``demand [B, N]``, ``dist [B, N, N]`` → the dense heuristic ``[B, N,
    N]``: ``net`` (in the mode it is in) on ``cvrp_nls_graph``, each block's
    output written at its ``(src, nbr)`` (row = source, no transpose),
    zeros elsewhere, plus ``eps``."""
    g = cvrp_nls_graph(demand, dist, k_sparse)
    out = net(g)
    outs = out[1] if isinstance(out, tuple) else out
    return scatter_blocks(g[1], outs, dist.shape[-1]) + eps


def cvrp_nls_loss(net: Net, demand: torch.Tensor, dist: torch.Tensor, paths: torch.Tensor,
                  adv: torch.Tensor, *, k_sparse: int = 5, n_ants: int = 20) -> torch.Tensor:
    """The loss of the recorded ``paths [B, L, A]`` under the advantage
    ``adv [B, A]``: ``sum(adv * sum_t log p) / A``, averaged over instances,
    with ``net`` put in eval mode (its BatchNorms on running statistics)."""
    net.eval()
    heu = cvrp_nls_heuristic(net, demand, dist, k_sparse)
    spec = cvrp_spec(torch.ones_like(heu), heu, demand, 1.0, n_ants)
    logp = path_log_probs(spec, paths)
    return (adv * logp.sum(dim=-2)).sum(dim=-1).mean() / n_ants


def make_cvrp_nls_train_fns(cfg: ProblemConfig, *, ops: FamilyOps = KERNEL_OPS):
    """``(sample_fn, grad_fn)`` of the host-LS training loop
    (special.py:147-191):

    - ``sample_fn(net, demand, dist, generator) -> (heu, paths, raw_costs)``:
      the eval-mode heuristic and one construction of ``cfg.aco.n_ants``
      ants at capacity 1 through ``ops.construct`` (K7c; past its N a pick
      a step), no gradient;
    - ``grad_fn(state, demand, dist, paths, adv) -> (state, loss, grad
      norm)``: :func:`cvrp_nls_loss`, its gradient and one optimizer
      update."""
    a, k = cfg.aco.n_ants, cfg.k_sparse

    @torch.no_grad()
    def sample_fn(net, demand, dist, generator):
        net.eval()
        heu = cvrp_nls_heuristic(net, demand, dist, k)
        paths = cvrp_paths(torch.ones_like(heu), heu, demand, 1.0, a, generator,
                           construct=ops.construct, pick=ops.pick)
        return heu, paths, route_cost(dist, paths)

    def grad_fn(state: TrainState, demand, dist, paths, adv):
        loss = cvrp_nls_loss(state.net, demand, dist, paths, adv, k_sparse=k, n_ants=a)
        loss.backward()
        state, norm = optimizer_update(state, cfg)
        return state, loss.detach(), norm

    return sample_fn, grad_fn


def cvrp_nls_train_step(state: TrainState, fns, demand: torch.Tensor, dist: torch.Tensor,
                        generator: torch.Generator, *, ls_count: int | None = None):
    """One step on one instance (``demand [1, N]``, ``dist [1, N, N]`` on
    the net's device): sample on the device, copy the paths to the host
    and refine every ant there, then the gradient (special.py:194-212).
    Returns ``(state, mean LS cost, mean raw cost)``, the costs as 0-d
    tensors."""
    sample_fn, grad_fn = fns
    heu, paths, raw_costs = sample_fn(state.net, demand, dist, generator)
    n = dist.shape[-1]
    improved = hgs.multiple_swap_star(
        demand[0].cpu().numpy().astype(np.float64), dist[0].cpu().numpy().astype(np.float64),
        paths[0].cpu().numpy(), count=ls_count or max(n - 1, 50),
        heu_dist=perturbation_metric(heu[0].cpu().numpy()))
    ls_costs = route_cost(dist, torch.from_numpy(improved).to(dist.device)[None])
    adv = ls_costs - ls_costs.mean(dim=-1, keepdim=True)
    state, _, _ = grad_fn(state, demand, dist, paths, adv)
    return state, ls_costs.mean(), raw_costs.mean()


def cvrp_nls_instances(n_nodes: int, seed: int):
    """The trainer's instance stream (special.py:240-248):
    ``numpy.random.default_rng(seed)``, each draw ``n + 1`` f32 locations
    and demands 1..9 over the scale's capacity, the distance diagonal
    1e-10. Returns ``gen_instance() -> (demand [n+1], dist [n+1, n+1])``."""
    cap = cvrp_nls_capacity(n_nodes)
    rng_np = np.random.default_rng(seed)

    def gen_instance():
        coords = rng_np.random((n_nodes + 1, 2)).astype(np.float32)
        dist = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
        np.fill_diagonal(dist, 1e-10)
        demand = np.concatenate(
            [[0.0], rng_np.integers(1, 10, n_nodes)]).astype(np.float32) / cap
        return demand, dist.astype(np.float32)

    return gen_instance


def train_cvrp_nls(n_nodes: int, *, epochs: int = 5, steps_per_epoch: int = 20,
                   lr: float = 1e-4, n_ants: int = 20, k_sparse: int = 5, seed: int = 0,
                   ls_count: int | None = None, progress: Callable | None = None,
                   max_steps: int | None = None, device=None) -> tuple[Net, TrainState]:
    """The whole CVRP-NLS training run (reference cvrp_nls/train.py:67-151
    envelope; special.py:219-267) on ``device`` (``cuda`` by default;
    ``cpu`` only when asked): a fresh 12-layer ``Net`` on the seed's
    ``torch.Generator`` (the JAX package's init law), one template instance
    drawn and dropped as the JAX trainer draws it, then ``epochs *
    steps_per_epoch`` steps (or the first ``max_steps``) of one new
    instance each. ``progress(epoch, mean LS cost)`` after each epoch.
    Returns ``(net, state)``; ``state.tree()`` is the JAX ``TrainState``."""
    dev = resolve_device(device)
    cfg = cvrp_nls_config(n_nodes, epochs=epochs, steps_per_epoch=steps_per_epoch, lr=lr,
                          n_ants=n_ants, k_sparse=k_sparse, seed=seed)
    gen_instance = cvrp_nls_instances(n_nodes, seed)
    gen_instance()           # the template that sizes the JAX net
    generator = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(Net(feats=1).to(dev), cfg, generator)
    fns = make_cvrp_nls_train_fns(cfg)
    n_steps = epochs * steps_per_epoch if max_steps is None else min(
        max_steps, epochs * steps_per_epoch)
    for epoch in range(-(-n_steps // steps_per_epoch)):
        for _ in range(min(steps_per_epoch, n_steps - epoch * steps_per_epoch)):
            demand, dist = (torch.from_numpy(a)[None].to(dev) for a in gen_instance())
            state, ls_cost, _ = cvrp_nls_train_step(state, fns, demand, dist, generator,
                                                    ls_count=ls_count)
        if progress is not None:
            progress(epoch, ls_cost.item())
    return state.net, state
