"""Batched dense anytime TSP runner (counterpart of
``deepaco_tpu/aco/batched_tsp.py``), the inference path of the slice.

State is batched ``[B, ...]`` over instances. Each iteration builds the
score ``alpha*log(tau) + beta*log(heu)`` in f32 (the heuristic log is
hoisted out of the loop) and casts it to ``sample_dtype`` (bf16 by
default), constructs every ant's tour, then applies the Ant System update.

Two kernels live here, each beside its plain PyTorch version:

- K2, :func:`dense_sweep_fused` (``csrc/sweep.cu``): the whole construction
  sweep; its plain version is :func:`dense_sweep`;
- K3, :func:`fused_tsp_update` (``csrc/as_update.cu``): ``decay*tau + D +
  D^T`` and the tour costs; its plain version is
  :func:`fused_tsp_update_plain` (``tour_cost`` plus the scatter deposit).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The runner's private ``_ops=PLAIN_OPS`` calls the plain versions on
any device, the oracle that ``chip_smoke.py`` holds the kernel path against.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple

import torch

from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.aco.problems.tsp import tour_cost
from deepaco_tpu_torch.aco.runner import (ACOConfig, SearchState, init_search,
                                          search_update, track_best)
from deepaco_tpu_torch.ops import _build
from deepaco_tpu_torch.ops.fused_gnn import (tsp_dense_heuristic,
                                             tsp_dense_heuristic_plain)

NEG_INF = -1e30
_TINY = 1.1754944e-38      # smallest normal f32 = finfo(bfloat16).tiny


def gumbel_bf16_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The bf16 Gumbel law of the JAX sweep (``jax.random.gumbel(dtype=bf16)``
    and pallas_kernels.py:489-495), from 32 random bits per draw: a 7-bit
    uniform ``u = max(((bits >> 13) & 0x7F) * 2^-7, tiny)``, then
    ``g = bf16(-log(f32(bf16(-log u))))``. It takes 128 values and truncates
    the right tail near +4.85."""
    k = (bits >> 13) & 0x7F
    u = torch.clamp(k.float() * (2.0 ** -7), min=_TINY)
    inner = (-torch.log(u)).to(torch.bfloat16)
    return (-torch.log(inner.float())).to(torch.bfloat16)


def gumbel_f32_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Full-width f32 Gumbel noise: ``u = ((bits >> 9) + 0.5) * 2^-23`` in
    (0, 1), ``g = -log(-log u)``."""
    u = ((bits >> 9) & 0x7FFFFF).float().add(0.5).mul(2.0 ** -23)
    return -torch.log(-torch.log(u))


@functools.cache
def _gumbel_table(device: torch.device) -> torch.Tensor:
    """The 128 values of :func:`gumbel_bf16_from_bits` for K2, as f32."""
    k = torch.arange(128, dtype=torch.int64, device=device)
    return gumbel_bf16_from_bits(k << 13).float()


def _start_cities(generator: torch.Generator, b: int, a: int, n: int,
                  fixed_start: int | None, device) -> torch.Tensor:
    if fixed_start is None:
        return torch.randint(0, n, (b, a), generator=generator,
                             device=generator.device).to(device)
    return torch.full((b, a), fixed_start, dtype=torch.int64, device=device)


def _batched_init(b: int, n: int, cfg: ACOConfig, device) -> SearchState:
    return init_search(n, n - 1, cfg, batch=(b,), device=device)


# --------------------------------------------------------- construction ---
def dense_sweep(score: torch.Tensor, start: torch.Tensor,
                generator: torch.Generator, *,
                stochastic: bool = True) -> torch.Tensor:
    """Plain construction for the ``[B, A]`` ants over dense score rows.

    ``score [B, N, N]`` in the sampling dtype; each step gathers the current
    rows, masks visited columns, adds Gumbel noise drawn from ``generator``
    (the bf16 law for bf16 scores, full-width f32 otherwise) and takes the
    first maximum. Returns paths ``[B, N, A]`` int64, row 0 the start.
    """
    b, n, _ = score.shape
    a = start.shape[1]
    cur = start.long()
    visited = torch.zeros((b, a, n), dtype=torch.bool, device=score.device)
    visited.scatter_(-1, cur[..., None], True)
    neg = torch.tensor(NEG_INF, dtype=score.dtype, device=score.device)
    steps = [cur]
    for _ in range(n - 1):
        rows = torch.gather(score, 1, cur[..., None].expand(b, a, n))
        logits = torch.where(visited, neg, rows)
        if stochastic:
            bits = torch.randint(0, 2 ** 32, (b, a, n), generator=generator,
                                 device=generator.device).to(score.device)
            if score.dtype == torch.bfloat16:
                logits = (logits.float()
                          + gumbel_bf16_from_bits(bits).float()).to(torch.bfloat16)
            else:
                logits = logits + gumbel_f32_from_bits(bits)
        cur = torch.argmax(logits, dim=-1)
        visited.scatter_(-1, cur[..., None], True)
        steps.append(cur)
    return torch.stack(steps, dim=1)


def dense_sweep_fused(score: torch.Tensor, start: torch.Tensor,
                      generator: torch.Generator, *,
                      stochastic: bool = True) -> torch.Tensor:
    """:func:`dense_sweep` as one launch of kernel K2 (one warp per ant for
    all N-1 steps; Philox noise keyed by a seed drawn from ``generator``)."""
    if score.device.type == "cpu":
        return dense_sweep(score, start, generator, stochastic=stochastic)
    _build.require_cuda("dense_sweep_fused", score, start)
    b, n, _ = score.shape
    a = start.shape[1]
    if score.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dense_sweep_fused takes bf16 or f32 scores, got {score.dtype}")
    if score.shape != (b, n, n) or start.shape != (b, a):
        raise ValueError("expected score [B, N, N] and start [B, A]")
    paths = _launch_sweep(score.contiguous(), start.long().contiguous(),
                          generator, stochastic)
    dense_sweep_fused.launches += 1
    return paths


def _launch_sweep(score, start, generator, stochastic):
    """Allocate the paths, draw the seed and call the K2 entry point."""
    b, n, _ = score.shape
    a = start.shape[1]
    dev = score.device
    paths = torch.empty((b, n, a), dtype=torch.int64, device=dev)
    seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device).to(dev)
    table = _gumbel_table(dev)
    P, I = _build.P, _build.I
    fn = _build.function("deepaco_sweep", [P] * 5 + [I] * 5 + [P])
    rc = fn(score.data_ptr(), start.data_ptr(), paths.data_ptr(),
            seed.data_ptr(), table.data_ptr(), b, n, a,
            int(score.dtype == torch.bfloat16), int(stochastic),
            _build.stream_ptr(dev))
    _build.check(rc, "deepaco_sweep")
    return paths


dense_sweep_fused.launches = 0


# --------------------------------------------------------------- update ---
def fused_tsp_update_plain(tau: torch.Tensor, paths: torch.Tensor,
                           dist: torch.Tensor, *, decay: float, q: float,
                           symmetric: bool = True):
    """Plain version of K3: ``tour_cost`` and the scatter deposit."""
    costs = tour_cost(dist, paths)
    tau = ph.deposit(tau * decay, paths, q / costs, cyclic=True,
                     symmetric=symmetric)
    return tau, costs


def fused_tsp_update(tau: torch.Tensor, paths: torch.Tensor,
                     dist: torch.Tensor, *, decay: float, q: float,
                     symmetric: bool = True):
    """``(decay*tau + D [+ D^T], costs)`` for permutation tours
    ``paths [B, N, A]`` over ``dist [B, N, N]``; one launch of kernel K3.
    On CUDA a tour that is not a permutation stops the kernel with a
    device-side assert; the plain version takes any tours."""
    if tau.device.type == "cpu":
        return fused_tsp_update_plain(tau, paths, dist, decay=decay, q=q,
                                      symmetric=symmetric)
    _build.require_cuda("fused_tsp_update", tau, paths, dist)
    b, n, a = paths.shape
    if tau.shape != (b, n, n) or dist.shape != (b, n, n):
        raise ValueError("expected tau, dist [B, N, N] and paths [B, N, A]")
    if tau.dtype != torch.float32 or dist.dtype != torch.float32:
        raise ValueError("fused_tsp_update takes f32 tau and dist")
    out = _launch_update(tau.contiguous(), paths.long().contiguous(),
                         dist.contiguous(), decay, q, symmetric)
    fused_tsp_update.launches += 1
    return out


def _launch_update(tau, paths, dist, decay, q, symmetric):
    """Allocate tau', the costs and the scratch and call the K3 entry point."""
    b, n, a = paths.shape
    dev = tau.device
    tau_out = torch.empty_like(tau)
    costs = torch.empty((b, a), dtype=torch.float32, device=dev)
    pos = torch.empty((b, a, n), dtype=torch.int32, device=dev)
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("deepaco_as_update", [P] * 6 + [I] * 3 + [F, F, I, P])
    rc = fn(tau.data_ptr(), paths.data_ptr(), dist.data_ptr(),
            tau_out.data_ptr(), costs.data_ptr(), pos.data_ptr(), b, n, a,
            decay, q, int(symmetric), _build.stream_ptr(dev))
    _build.check(rc, "deepaco_as_update")
    return tau_out, costs


fused_tsp_update.launches = 0


def _fused_update_ok(cfg: ACOConfig) -> bool:
    """K3 covers exactly the plain Ant System TSP update; every other
    configuration takes :func:`search_update`."""
    return (not cfg.elitist and not cfg.min_max and not cfg.maximize
            and not cfg.vector_pheromone and not cfg.deposit_div_ants
            and cfg.cost_offset == 0.0 and cfg.cyclic)


def _batched_update(cfg: ACOConfig, state: SearchState, paths: torch.Tensor,
                    dist: torch.Tensor, *,
                    update: Callable = fused_tsp_update) -> SearchState:
    if _fused_update_ok(cfg):
        tau, costs = update(state.phe.tau, paths, dist, decay=cfg.decay,
                            q=cfg.q, symmetric=cfg.symmetric)
        if cfg.floor > 0.0:
            tau = torch.clamp(tau, min=cfg.floor)
        state = track_best(state, paths, costs)
        return state._replace(phe=state.phe._replace(tau=tau))
    return search_update(cfg, state, paths, tour_cost(dist, paths))


def _no_timer(_name: str):
    return contextlib.nullcontext()


class PathOps(NamedTuple):
    """What the main path calls in each phase, and ``timer(name)``, a context
    manager around each phase (``"heuristic"``, ``"construction"``,
    ``"update"``). The default is the kernels and no timer."""

    heuristic: Callable = tsp_dense_heuristic
    sweep: Callable = dense_sweep_fused
    update: Callable = fused_tsp_update
    timer: Callable = _no_timer


KERNEL_OPS = PathOps()
PLAIN_OPS = PathOps(tsp_dense_heuristic_plain, dense_sweep, fused_tsp_update_plain)


@torch.no_grad()
def run_anytime_batched(heu: torch.Tensor, dist: torch.Tensor, cfg: ACOConfig,
                        generator: torch.Generator, n_iterations: int,
                        fixed_start: int | None = None,
                        sample_dtype: torch.dtype = torch.bfloat16,
                        ls: str | None = None, *,
                        _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    """Batched dense anytime sweep: ``heu, dist [B, N, N]`` → the curve
    ``[B, n_iterations]`` of best-so-far costs."""
    if ls is not None:
        raise NotImplementedError(
            "local search (TSP-NLS) is not ported to deepaco_tpu_torch yet; "
            "see ROADMAP.md")
    b, n, _ = heu.shape
    a = cfg.n_ants
    log_heu = cfg.beta * torch.log(torch.clamp(heu.float(), min=1e-30))
    state = _batched_init(b, n, cfg, heu.device)
    curve = []
    for _ in range(n_iterations):
        with _ops.timer("construction"):
            score = (cfg.alpha * torch.log(torch.clamp(state.phe.tau, min=1e-30))
                     + log_heu).to(sample_dtype)
            start = _start_cities(generator, b, a, n, fixed_start, heu.device)
            paths = _ops.sweep(score, start, generator)
        with _ops.timer("update"):
            state = _batched_update(cfg, state, paths, dist, update=_ops.update)
        curve.append(state.best_cost)
    return torch.stack(curve, dim=1)
