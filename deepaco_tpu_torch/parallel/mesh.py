"""Mesh parallelism: instance × ant sharding for training and search
(counterpart of ``deepaco_tpu/parallel/mesh.py``).

The mesh is a ``torch.distributed`` ``DeviceMesh`` over the world, with the
axes ``("instance", "ant")``, instance-major: rank ``i * n_ant + a`` sits
at ``(i, a)``. JAX gets its parallelism from shardings; here each rank runs
its share and the collectives are written out:

* the train step: instance block ``i`` on every rank of row ``i``, ant block
  ``a`` sampled on rank ``(i, a)``; the baseline an ``all_reduce`` over
  ``ant``, the gradients one over the world, the BatchNorm statistics a mean
  over ``instance``;
* the island search: one colony a rank along an axis, an ``all_gather`` of
  the colonies' bests every ``sync_every`` iterations.

Seeds: JAX folds a device's index into its key; the port seeds block or
colony ``c``'s generator with :func:`block_seed` / :func:`colony_seed`, so
that each can be replayed alone.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.aco.engine import rollout
from deepaco_tpu_torch.aco.problems.tsp import tour_cost, tsp_spec
from deepaco_tpu_torch.aco.runner import ACOConfig, init_search, run_anytime
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.parallel._axes import block_seed, instance_block, mesh_dim, rank_device
from deepaco_tpu_torch.train.config import ProblemConfig
from deepaco_tpu_torch.train.reinforce import (KERNEL_OPS, StepInfo, TrainOps,
                                               TrainState, optimizer_update, tsp_loss)


def make_mesh(n_instance: int | None = None, n_ant: int = 1,
              axis_names=("instance", "ant")):
    """The ``(instance, ant)`` ``DeviceMesh`` over the world's ranks,
    instance-major (``n_instance`` defaults to ``world // n_ant``), on
    ``cuda`` under NCCL and ``cpu`` under gloo. Raises without a process
    group (:func:`~deepaco_tpu_torch.parallel.multihost.init_distributed`
    makes one); it never builds one of its own."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.multihost.init_distributed first")
    world = dist.get_world_size()
    if n_instance is None:
        n_instance = world // n_ant
    if n_instance * n_ant != world:
        raise ValueError(f"make_mesh: {n_instance} x {n_ant} ranks for a world of {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_instance, n_ant),
                            mesh_dim_names=tuple(axis_names))


def colony_seed(seed: int, colony: int) -> int:
    """The seed of colony ``colony``'s generator in
    :func:`multi_colony_tsp_search`: :func:`block_seed`'s mix."""
    return block_seed(seed, colony)


def shard_colony_search(mesh) -> dict:
    """The torch counterparts of JAX's two shardings for an instance-sharded
    search: ``"instances"``, this rank's ``_axes.InstanceBlock`` on the
    ``instance`` axis (``.rows(b)`` its rows), and ``"replicated"``, the
    group of every rank."""
    return {"instances": instance_block(mesh), "replicated": dist.group.WORLD}


def _unflatten(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    """Copy ``flat`` back into ``tensors``, in order."""
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def _flatten(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def make_sharded_tsp_train_step(net: torch.nn.Module, cfg: ProblemConfig, mesh, *,
                                _ops: TrainOps = KERNEL_OPS):
    """The TSP train step over ``mesh`` (mesh.py:51-99): ``step(state,
    coords, generator, *, paths=None) -> (state, StepInfo)``.

    Rank ``(i, a)`` passes instance block ``i``'s coordinates ``[B/I, N,
    2]`` (:func:`~deepaco_tpu_torch.parallel.multihost.host_local_batch`)
    and its own generator. Every rank of the block runs the same train-mode
    GNN on it (K6 a layer forward and backward on the card) and samples ant
    block ``a``, ``A / n_ant`` ants an instance (one K7r launch each way), or with
    ``paths [B/I, N, A / n_ant]`` replays those tours: ``tsp_loss`` at
    ``A / n_ant`` ants, whose own baseline it replaces. Each instance's
    baseline is its mean cost over all ``A`` ants (an ``all_reduce`` of cost
    sums over ``ant``, detached), and the rank's loss is its share of the
    unsharded one, ``sum (cost - baseline) sum_t log p / (A B)``. After
    ``backward`` the gradients are summed over the world (one
    ``all_reduce``), so every rank holds the gradient of the unsharded step
    on the union of instances and ants; the BatchNorm running statistics are
    averaged over ``instance`` (as the JAX step averages them over its
    instances) and then taken from the first rank of each ``ant`` group.
    Clipping and AdamW (``optimizer_update``) then see the same gradients
    everywhere, so weights that start equal on every rank stay bit-equal.
    ``StepInfo`` holds the whole batch's loss and mean cost (summed over the
    world) and the gradient norm. ``net`` is the network the steps train,
    on the mesh's device; ``_ops`` is ``train.reinforce``'s."""
    inst_dim, ant_dim = mesh_dim(mesh, "instance"), mesh_dim(mesh, "ant")
    n_inst, n_ant = mesh.size(inst_dim), mesh.size(ant_dim)
    inst_group, ant_group = mesh.get_group("instance"), mesh.get_group("ant")
    ant_root = dist.get_global_rank(ant_group, 0)
    a_total = cfg.aco.n_ants
    if a_total % n_ant:
        raise ValueError(f"{a_total} ants do not split over {n_ant} ant ranks")
    a_local = a_total // n_ant
    local_cfg = dataclasses.replace(cfg, aco=dataclasses.replace(cfg.aco, n_ants=a_local))
    if next(net.parameters()).device.type != mesh.device_type:
        raise ValueError(f"the net is on {next(net.parameters()).device}, the mesh on "
                         f"{mesh.device_type}")

    def step(state: TrainState, coords, generator: torch.Generator, *,
             paths: torch.Tensor | None = None):
        dev = next(state.net.parameters()).device
        coords = torch.as_tensor(coords, dtype=torch.float32, device=dev)
        scale = a_total * coords.shape[0] * n_inst
        out = tsp_loss(state.net, coords, local_cfg, generator,
                       paths=None if paths is None else paths.to(dev), _ops=_ops)
        costs = out.costs.detach()
        sums = costs.sum(dim=-1)
        dist.all_reduce(sums, group=ant_group)
        adv = costs - (sums / a_total)[:, None]
        loss = torch.sum(adv * out.log_probs.sum(dim=-2)) / scale
        with _ops.timer("backward"):
            loss.backward()
            params = list(state.net.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = _flatten([p.grad for p in params])
            dist.all_reduce(grads)
            _unflatten(grads, [p.grad for p in params])
        stats = list(state.net.buffers())
        if stats:
            flat = _flatten(stats)
            dist.all_reduce(flat, group=inst_group)
            flat /= n_inst
            dist.broadcast(flat, src=ant_root, group=ant_group)
            _unflatten(flat, stats)
        with _ops.timer("optimizer"):
            state, norm = optimizer_update(state, cfg)
        report = torch.stack([loss.detach(), costs.sum() / scale])
        dist.all_reduce(report)
        return state, StepInfo(report[0], report[1], norm)

    return step


def migrate(phe: ph.PheromoneState, costs: torch.Tensor, paths: torch.Tensor,
            cfg: ACOConfig, migrate_weight: float, blend: float, mean):
    """One synchronisation of the island search (mesh.py:150-168) over the
    colonies' pheromones ``phe.tau [C, n, n]`` (``C = 1``: this rank's), all
    colonies' best costs ``costs [D]`` and tours ``paths [D, n]``. The
    global best is the first cheapest (ties to the lowest colony); with
    ``migrate_weight > 0`` every colony deposits it with weight
    ``migrate_weight / cost`` (``pheromone.deposit``, K8 with one ant on
    the card); with ``blend > 0``, ``tau <- (1 - blend) tau + blend
    mean(tau)``, where ``mean`` averages ``tau`` over the colonies (the
    search passes an ``all_reduce`` mean over the ranks); under
    ``cfg.min_max`` the clamp follows. Returns ``(phe, best cost, best
    tour)``."""
    gi = torch.argmin(costs)
    gcost, gpath = costs[gi], paths[gi]
    tau = phe.tau
    c = tau.shape[0]
    if migrate_weight > 0.0:
        amounts = (migrate_weight / gcost).reshape(1, 1).expand(c, 1)
        tau = ph.deposit(tau, gpath.reshape(1, -1, 1).expand(c, -1, 1), amounts)
    if blend > 0.0:
        tau = (1.0 - blend) * tau + blend * mean(tau)
    phe = phe._replace(tau=tau)
    if cfg.min_max:
        phe = ph.min_max_clamp(phe, cfg.tau_min)
    return phe, gcost, gpath


@torch.no_grad()
def multi_colony_tsp_search(mesh, heuristic, distances, cfg: ACOConfig, seed: int, *,
                            n_rounds: int, sync_every: int, axis: str = "instance",
                            migrate_weight: float = 1.0, blend: float = 0.0,
                            device=None) -> torch.Tensor:
    """The island model over ``mesh`` (mesh.py:112-181): one colony a rank
    along ``axis`` (ranks that share that coordinate run the same colony),
    on ``heuristic`` and ``distances [n, n]``. A round is ``sync_every``
    iterations of ``aco.runner.run_anytime`` (``tsp_spec``'s rollout, one
    K7r launch; the Ant System update, K8), drawn from a generator seeded with
    :func:`colony_seed` ``(seed, colony)``; then an ``all_gather`` over
    ``axis`` of every colony's best cost and tour, and :func:`migrate`
    (the blend's mean an ``all_reduce``), after which every colony holds the
    global best as its own. ``migrate_weight=0, blend=0`` leaves the
    colonies independent restarts. Runs on ``device`` (``cuda`` by default;
    ``cpu`` only when asked, on a gloo mesh). Returns the global best after
    each round, ``[n_rounds]``, the same on every rank."""
    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run the search on {dev}")
    dim = mesh_dim(mesh, axis)
    colony, colonies = mesh.get_local_rank(dim), mesh.size(dim)
    group = mesh.get_group(axis)
    dev = rank_device()
    heu = torch.as_tensor(heuristic, dtype=torch.float32, device=dev)[None]
    dist_m = torch.as_tensor(distances, dtype=torch.float32, device=dev)[None]
    n = dist_m.shape[-1]
    generator = torch.Generator(device=dev).manual_seed(colony_seed(seed, colony))
    state = init_search(n, n - 1, cfg, batch=(1,), device=dev)

    def construct(tau, gen):
        return rollout(tsp_spec(tau, heu, cfg.n_ants, None, cfg.alpha, cfg.beta), gen).paths

    def ranks_mean(tau):
        total = tau.clone()
        dist.all_reduce(total, group=group)
        return total / colonies

    curve = []
    for _ in range(n_rounds):
        state, _ = run_anytime(construct, lambda p: tour_cost(dist_m, p), cfg, state,
                               generator, sync_every)
        costs = [torch.empty_like(state.best_cost) for _ in range(colonies)]
        paths = [torch.empty_like(state.best_path) for _ in range(colonies)]
        dist.all_gather(costs, state.best_cost, group=group)
        dist.all_gather(paths, state.best_path, group=group)
        phe, gcost, gpath = migrate(state.phe, torch.cat(costs), torch.cat(paths), cfg,
                                    migrate_weight, blend, ranks_mean)
        state = state._replace(phe=phe, best_cost=gcost.reshape(1),
                               best_path=gpath.reshape(1, -1))
        curve.append(gcost)
    return torch.stack(curve)
