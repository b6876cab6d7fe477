"""Large-N TSP with the whole search state on the k-NN support (counterpart
of ``deepaco_tpu/aco/large_tsp.py``), batched over instances.

Every piece of per-instance state lives on the ``[N, K]`` support:
``coords [B, N, 2]``, ``nbr [B, N, K]``, ``heu [B, N, K]``, ``tau [B, N, K]``
and the ants' visited sets; no ``[N, N]`` matrix exists anywhere.

- **Support.** :func:`knn_support` takes each row's K nearest cities in row
  tiles, ties to the lower index.
- **Heuristic.** Neural: ``Net`` over :func:`sparse_tsp_graph` (coordinates
  and neighbour distances) through :func:`~deepaco_tpu_torch.ops.fused_gnn.
  net_forward_fast`, whose layer stack is kernel K9; classic:
  :func:`classic_knn_heuristic`, ``1/d``.
- **Sampling.** :func:`sweep_construct_knn`: bf16 Gumbel-max over the K
  unvisited support slots of the current city; an ant whose K neighbours are
  all visited samples over its unvisited cities instead (logits 0, the same
  bf16 Gumbel law, first maximum), as the JAX package does.
- **Costs** from coordinates; **deposits** folded onto the support slot of
  each tour edge, off-support edges dropped (:func:`deposit_knn`).
- **Local search.** ``ls="2opt"`` runs kernel K4 on every tour, from
  coordinates.

:func:`run_anytime_knn` runs the anytime loop. Its private ``_ops`` swaps in
the plain versions (``PLAIN_OPS``) or a phase timer (phases ``heuristic``,
taken by the caller, ``construction``, ``local_search`` and ``update``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from deepaco_tpu_torch.aco.batched_tsp import NEG_INF, _gumbel_table
from deepaco_tpu_torch.aco.runner import ACOConfig
from deepaco_tpu_torch.core.graph import SparseGraph, topk_smallest
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops.fused_gnn import (embnet_layers, embnet_layers_plain,
                                             net_forward_fast)
from deepaco_tpu_torch.ops.gnn_layer import gather_nodes
from deepaco_tpu_torch.ops.two_opt import (batched_two_opt_euclid,
                                           batched_two_opt_euclid_plain)
from deepaco_tpu_torch.utils.metrics import phase

_TILE_DISTANCES = 4_000_000     # distances per row tile of knn_support
LS_BUDGET = 10000               # 2-opt moves per descent (large_tsp.py:219)


def _norm(diff: torch.Tensor) -> torch.Tensor:
    """Length of 2-vectors ``diff [..., 2]`` f32, the value the JAX package's
    ``jnp.linalg.norm`` takes on the CPU: XLA rounds ``dx*dx`` and adds
    ``dy*dy`` by one fused multiply-add, then takes a correctly rounded root.
    Both steps run in f64 and round once to f32 (exact but for a double
    rounding about once in 2^29 values), which also keeps torch's vectorised
    CPU ``sqrt``, not correctly rounded, out of it."""
    x2 = (diff[..., 0] * diff[..., 0]).double()
    dy = diff[..., 1].double()
    sq = (dy * dy + x2).to(diff.dtype)
    return torch.sqrt(sq.double()).to(diff.dtype)


def knn_support(coords: torch.Tensor, k: int) -> torch.Tensor:
    """``coords [B, N, 2]`` → the ``[B, N, K]`` nearest-neighbour ids by
    Euclidean distance, self excluded, ties to the lower index
    (``lax.top_k(-d)``'s order). Row tiles hold at most 4M distances across
    the batch, as the JAX package's hold 4M for one instance, so no
    ``[N, N]`` matrix is built; the tail tile is simply shorter."""
    b, n, _ = coords.shape
    tile = max(1, min(n, _TILE_DISTANCES // max(n * b, 1)))
    cols = torch.arange(n, device=coords.device)
    out = []
    for start in range(0, n, tile):
        block = coords[:, start:start + tile]
        d = _norm(block[:, :, None] - coords[:, None])               # [B, t, N]
        rows = torch.arange(start, start + block.shape[1], device=coords.device)
        d = d.masked_fill(cols[None, None, :] == rows[None, :, None], float("inf"))
        out.append(topk_smallest(d, k)[1])
    return torch.cat(out, dim=1)


def _neighbour_distances(coords: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    return _norm(coords[:, :, None] - gather_nodes(coords, nbr))   # [B, N, K]


def sparse_tsp_graph(coords: torch.Tensor, nbr: torch.Tensor) -> SparseGraph:
    """The GNN input over a given support: ``x = coords``, ``edge`` the
    neighbour distances ``[B, N, K, 1]``, with no ``[N, N]`` matrix."""
    return SparseGraph(x=coords, nbr=nbr,
                       edge=_neighbour_distances(coords, nbr)[..., None])


def classic_knn_heuristic(coords: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``1 / max(d, 1e-12)`` on the support (the reference's sparsified
    prior, tsp/aco.py:51-67, in ``[B, N, K]`` layout)."""
    return 1.0 / torch.clamp(_neighbour_distances(coords, nbr), min=1e-12)


def neural_knn_heuristic(net: Net, coords: torch.Tensor, nbr: torch.Tensor, *,
                         layers: Callable = embnet_layers) -> torch.Tensor:
    """The heuristic head of ``net`` over :func:`sparse_tsp_graph` plus
    1e-10 (cli.py:309-313): ``[B, N, K]``; the layer stack is K9 on CUDA."""
    g = sparse_tsp_graph(coords, nbr)
    return net_forward_fast(net, g.x, g.nbr, g.edge, layers=layers) + 1e-10


def _bf16_gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """bf16 Gumbel noise by the law of ``jax.random.gumbel(dtype=bf16)``
    (``ops/philox.gumbel_bf16_from_bits``): one of its 128 values, each
    with probability 1/128, as f32."""
    idx = torch.randint(0, 128, shape, generator=generator, device=generator.device)
    return _gumbel_table(torch.device(device))[idx.to(device)]


def sweep_construct_knn(score: torch.Tensor, nbr: torch.Tensor, start: torch.Tensor,
                        generator: torch.Generator, with_stats: bool = False):
    """One construction sweep over the support: ``score [B, N, K]`` bf16,
    ``nbr [B, N, K]``, ``start [B, A]`` → paths ``[B, N, A]`` int64, row 0
    the start.

    Each step masks the current city's visited support slots, adds bf16
    Gumbel noise, rounds the sum to bf16 and takes the first maximum. An ant
    whose K neighbours are all visited takes the fallback draw instead: the
    same law over all cities with logits 0 on its unvisited ones. The JAX
    package gates that draw with ``lax.cond(any(exhausted))``; here it is
    drawn every step and selected with ``torch.where``, which gives the same
    law without a device-to-host sync per step. The visited set is a bool
    ``[B, A, N]`` mask in place of JAX's packed words (a TPU layout choice).
    ``with_stats=True`` also returns the fallback ant-steps per instance
    ``[B]``.
    """
    if score.dtype != torch.bfloat16:
        raise ValueError(f"sweep_construct_knn samples bf16 scores, got {score.dtype}")
    b, n, k = nbr.shape
    a = start.shape[1]
    dev = score.device
    cur = start.long()
    visited = torch.zeros((b, a, n), dtype=torch.bool, device=dev)
    visited.scatter_(2, cur[..., None], True)
    neg = torch.tensor(NEG_INF, dtype=torch.bfloat16, device=dev)
    zero = torch.zeros((), dtype=torch.bfloat16, device=dev)
    fallbacks = torch.zeros((b,), dtype=torch.int64, device=dev)
    steps = [cur]
    for _ in range(n - 1):
        at = cur[..., None].expand(b, a, k)
        ids = torch.gather(nbr, 1, at)                                 # [B, A, K]
        open_ = ~torch.gather(visited, 2, ids)
        logits = torch.where(open_, torch.gather(score, 1, at), neg)
        noise = _bf16_gumbel(generator, (b, a, k + n), dev)
        slot = torch.argmax((logits.float() + noise[..., :k]).to(torch.bfloat16), dim=-1)
        action = torch.gather(ids, 2, slot[..., None])[..., 0]
        exhausted = ~open_.any(dim=-1)
        free = torch.where(visited, neg, zero).float()
        uniform = torch.argmax((free + noise[..., k:]).to(torch.bfloat16), dim=-1)
        cur = torch.where(exhausted, uniform, action)
        visited.scatter_(2, cur[..., None], True)
        fallbacks += exhausted.sum(dim=-1)
        steps.append(cur)
    paths = torch.stack(steps, dim=1)
    return (paths, fallbacks) if with_stats else paths


def tour_cost_coords(coords: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Cyclic tour lengths from coordinates: ``paths [B, N, A]`` → ``[B, A]``."""
    b, n, a = paths.shape
    pts = gather_nodes(coords, paths)                                  # [B, N, A, 2]
    return _norm(pts - torch.roll(pts, -1, dims=1)).sum(dim=1)


def _support_slots(nbr: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """For directed edges ``u → v`` ``[B, N, A]``: the slot of v in u's
    neighbour list (``argmax(nbr[u] == v)``) and whether v is there."""
    hits = gather_nodes(nbr, u) == v[..., None]                        # [B, N, A, K]
    return torch.argmax(hits.to(torch.uint8), dim=-1), hits.any(dim=-1)


def deposit_knn(tau: torch.Tensor, nbr: torch.Tensor, paths: torch.Tensor,
                amounts: torch.Tensor, symmetric: bool = True) -> torch.Tensor:
    """Fold each tour edge's deposit ``amounts [B, A]`` onto the support:
    edge ``(u, v)`` adds to ``tau[u, slot of v]``, and with ``symmetric``
    edge ``(v, u)`` to ``tau[v, slot of u]``; an edge whose head is not in
    the tail's list is dropped. One ``scatter_add`` into ``[B, N*K]``; its
    duplicate adds sum in another order than XLA's."""
    b, n, k = tau.shape
    nxt = torch.roll(paths, -1, dims=1)
    pairs = [(paths, nxt), (nxt, paths)] if symmetric else [(paths, nxt)]
    index, values = [], []
    for u, v in pairs:
        slot, on = _support_slots(nbr, u, v)
        index.append((u * k + slot).reshape(b, -1))
        values.append(torch.where(on, amounts[:, None, :], 0.0).reshape(b, -1))
    return tau.reshape(b, n * k).scatter_add(
        1, torch.cat(index, dim=1), torch.cat(values, dim=1)).reshape(b, n, k)


class LargeOps(NamedTuple):
    """What the sparse path calls: the neural ``heuristic(net, coords, nbr)``,
    the ``two_opt`` of ``ls="2opt"`` and ``timer(name)``, a context manager
    around each phase. The default is the kernels (K9, K4) and no timer."""

    heuristic: Callable = neural_knn_heuristic
    two_opt: Callable = batched_two_opt_euclid
    timer: Callable | None = None


KERNEL_OPS = LargeOps()
PLAIN_OPS = LargeOps(functools.partial(neural_knn_heuristic, layers=embnet_layers_plain),
                     batched_two_opt_euclid_plain)


@torch.no_grad()
def run_anytime_knn(coords: torch.Tensor, nbr: torch.Tensor, heu: torch.Tensor,
                    cfg: ACOConfig, n_iterations: int, ls: str | None,
                    generator: torch.Generator, *, device=None,
                    stats: dict | None = None, _ops: LargeOps = KERNEL_OPS):
    """The anytime sweep with ``[B, N, K]`` state: ``coords [B, N, 2]``,
    ``nbr``, ``heu [B, N, K]`` → ``(curve [B, n_iterations], best [B, N])``,
    the best-so-far costs and each instance's best tour.

    Per iteration: the bf16 score ``alpha*log(tau) + beta*log(heu)``, start
    cities drawn afresh, :func:`sweep_construct_knn`, 2-opt of every tour
    when ``ls == "2opt"`` (the JAX package ignores any other ``ls``; here it
    raises), costs from coordinates, the strict best-so-far update and
    :func:`deposit_knn` on the decayed pheromone. It runs on ``device``
    (``cuda`` by default; ``cpu`` only when asked), where the inputs are
    moved; ``generator`` draws on its own device. ``stats``, when given,
    receives the run's fallback ant-steps and off-support tour edges beside
    their totals (one extra support lookup per iteration).
    """
    if ls not in (None, "2opt"):
        raise ValueError(f"the sparse path takes ls=None or '2opt', got {ls!r}")
    dev = resolve_device(device)
    coords = torch.as_tensor(coords, dtype=torch.float32, device=dev)
    nbr = torch.as_tensor(nbr, device=dev).long()
    heu = torch.as_tensor(heu, device=dev)
    b, n, k = nbr.shape
    a = cfg.n_ants
    log_heu = cfg.beta * torch.log(torch.clamp(heu.float(), min=1e-30))
    tau = torch.ones((b, n, k), dtype=torch.float32, device=dev)
    best_cost = torch.full((b,), float("inf"), device=dev)
    best_path = torch.zeros((b, n), dtype=torch.int64, device=dev)
    fallbacks = torch.zeros((), dtype=torch.int64, device=dev)
    off_support = torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    curve = []
    for _ in range(n_iterations):
        with phase("construction", _ops.timer):
            score = (cfg.alpha * torch.log(torch.clamp(tau, min=1e-30))
                     + log_heu).to(torch.bfloat16)
            start = torch.randint(0, n, (b, a), generator=generator,
                                  device=generator.device).to(dev)
            paths, fb = sweep_construct_knn(score, nbr, start, generator, with_stats=True)
        if ls is not None:
            with phase("local_search", _ops.timer):
                paths = _ops.two_opt(coords, paths.transpose(1, 2).contiguous(),
                                     LS_BUDGET).transpose(1, 2)
        with phase("update", _ops.timer):
            costs = tour_cost_coords(coords, paths)                    # [B, A]
            it_best = torch.argmin(costs, dim=1)
            it_cost = costs[rows, it_best]
            improved = it_cost < best_cost
            best_cost = torch.where(improved, it_cost, best_cost)
            best_path = torch.where(improved[:, None], paths[rows, :, it_best], best_path)
            tau = deposit_knn(tau * cfg.decay, nbr, paths, cfg.q / costs, cfg.symmetric)
        if stats is not None:
            fallbacks += fb.sum()
            off_support += (~_support_slots(nbr, paths, torch.roll(paths, -1, dims=1))[1]).sum()
        curve.append(best_cost)
    if stats is not None:
        stats.update(fallback_steps=int(fallbacks), ant_steps=b * a * (n - 1) * n_iterations,
                     off_support_edges=int(off_support), tour_edges=b * a * n * n_iterations)
    return torch.stack(curve, dim=1), best_path
