"""Batched dense anytime TSP runner (counterpart of
``deepaco_tpu/aco/batched_tsp.py``), the inference path of the slice.

State is batched ``[B, ...]`` over instances. Each iteration constructs
every ant's tour from the score ``alpha*log(tau) + beta*log(heu)`` in
``sample_dtype`` (bf16 by default; the heuristic log is hoisted out of the
loop), then applies the Ant System update, which also tracks the best tour
and writes the next iteration's score (the first one is computed before
the loop).

Two kernels live here, each beside its plain PyTorch version:

- K2, :func:`dense_sweep_fused` (``csrc/sweep.cu``): the whole construction
  sweep; its plain version is :func:`dense_sweep`. :func:`tsp_sweep_construct`
  (one instance, f32 scores) is K2 at B=1;
- K3, :func:`fused_tsp_update` (``csrc/as_update.cu``): the tour costs,
  ``decay*tau + D + D^T`` with the floor, the best-so-far state and the
  next score in one pass; its plain version is :func:`fused_tsp_update_plain`
  (``tour_cost``, the scatter deposit, ``clamp``, ``track_best`` and
  :func:`next_score`).

With ``ls="2opt"`` or ``"nls"`` every ant's tour goes through local search
between construction and update: K4 or K5 of :mod:`deepaco_tpu_torch.ops.two_opt`
from coordinates, or its dense descents on ``dist`` when none are given.

:func:`run_anytime_sparse` (with :func:`sweep_construct`) samples over the
``[N, K]`` k-NN support only, with an exact dense step whenever an ant has
no unvisited neighbour left; its update is K3, its sweep plain PyTorch on
every device (plain XLA in the JAX package too).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The runner's private ``_ops=PLAIN_OPS`` calls the plain versions on
any device, the oracle that ``chip_smoke.py`` holds the kernel path against.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple

import torch

from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.aco.engine import gumbel
from deepaco_tpu_torch.aco.problems.tsp import tour_cost
from deepaco_tpu_torch.aco.runner import (ACOConfig, SearchState, init_search,
                                          search_update, track_best)
from deepaco_tpu_torch.ops import _build
from deepaco_tpu_torch.ops.philox import (draw_seed, gumbel_bf16_from_bits,
                                          gumbel_f32_from_bits)
from deepaco_tpu_torch.ops.fused_gnn import (embnet_layers, embnet_layers_plain,
                                             tsp_dense_heuristic,
                                             tsp_dense_heuristic_plain)
from deepaco_tpu_torch.ops.two_opt import (batched_nls, batched_nls_euclid,
                                           batched_nls_euclid_plain,
                                           batched_two_opt,
                                           batched_two_opt_euclid,
                                           batched_two_opt_euclid_plain,
                                           heuristic_dist)
from deepaco_tpu_torch.utils.metrics import phase

NEG_INF = -1e30


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
    """:func:`dense_sweep` as one launch of kernel K2 (one to four warps walk
    each ant through all N-1 steps, more when fewer ants would leave the card
    idle; Philox noise keyed by a seed drawn from ``generator``)."""
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
    seed = draw_seed(generator, dev)
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


def tsp_sweep_construct(score: torch.Tensor, start: torch.Tensor,
                        generator: torch.Generator, *,
                        stochastic: bool = True) -> torch.Tensor:
    """Whole construction of one instance: ``score [N, N]`` f32 and ``start
    [A]`` → paths ``[N, A]``, row 0 the start (the function of the JAX
    package's ``tsp_sweep_construct_pallas``). On CUDA one launch of K2 at
    B=1, on the CPU :func:`dense_sweep`. Both the TPU kernel's 23-bit
    uniform ``(bits & 0x7FFFFF) 2^-23 + 2^-24`` and
    :func:`gumbel_f32_from_bits`' are uniform on the 2^23 midpoints of
    (0, 1), and greedy ties go to the first column in both."""
    if score.dtype != torch.float32 or score.dim() != 2 or start.dim() != 1:
        raise ValueError("tsp_sweep_construct takes f32 score [N, N] and start [A]")
    if score.device.type == "cpu":
        return dense_sweep(score[None], start[None], generator, stochastic=stochastic)[0]
    paths = dense_sweep_fused(score[None], start[None], generator, stochastic=stochastic)[0]
    tsp_sweep_construct.launches += 1
    return paths


tsp_sweep_construct.launches = 0


# --------------------------------------------------------------- update ---
def next_score(tau: torch.Tensor, log_heu: torch.Tensor, alpha: float,
               dtype: torch.dtype) -> torch.Tensor:
    """The construction score ``alpha*log(max(tau, 1e-30)) + log_heu`` in
    ``dtype``; ``log_heu`` is ``beta*log(heu)``, hoisted out of the loop."""
    return (alpha * torch.log(torch.clamp(tau, min=1e-30)) + log_heu).to(dtype)


def fused_tsp_update_plain(state: SearchState, paths: torch.Tensor,
                           dist: torch.Tensor, *, decay: float, q: float,
                           symmetric: bool = True, floor: float = 0.0,
                           log_heu: torch.Tensor | None = None, alpha: float = 1.0,
                           score_dtype: torch.dtype = torch.bfloat16):
    """Plain version of K3, the steps it fuses one after the other:
    ``tour_cost``, the scatter deposit onto ``decay*tau``, the ``floor``
    clamp (when > 0), :func:`track_best` and, when ``log_heu`` is given,
    :func:`next_score` of the new tau. Returns ``(state, costs, score)``,
    ``score`` None without ``log_heu``."""
    costs = tour_cost(dist, paths)
    tau = ph.deposit_plain(state.phe.tau * decay, paths, q / costs, cyclic=True,
                           symmetric=symmetric)
    if floor > 0.0:
        tau = torch.clamp(tau, min=floor)
    state = track_best(state, paths, costs)
    state = state._replace(phe=state.phe._replace(tau=tau))
    score = None if log_heu is None else next_score(tau, log_heu, alpha, score_dtype)
    return state, costs, score


K3_STAGED_MAX_N = 19000   # the staged cost pass holds 3 N words of an ant in shared memory


def k3_staged(n: int) -> bool:
    """Whether K3 takes its staged variant at ``n`` cities (an ant's tour
    and a warp's row of deposits in shared memory); past it K3 takes the
    unstaged variant, which computes the same bits from device memory."""
    return n <= K3_STAGED_MAX_N


def fused_tsp_update(state: SearchState, paths: torch.Tensor,
                     dist: torch.Tensor, *, decay: float, q: float,
                     symmetric: bool = True, floor: float = 0.0,
                     log_heu: torch.Tensor | None = None, alpha: float = 1.0,
                     score_dtype: torch.dtype = torch.bfloat16,
                     staged: bool | None = None):
    """:func:`fused_tsp_update_plain` for permutation tours ``paths [B, N,
    A]`` over ``dist [B, N, N]`` and the state's ``tau [B, N, N]``, best
    cost ``[B]`` and best path ``[B, N]``; on CUDA one launch of kernel K3
    (two kernels on the stream) at any N: the staged variant where
    :func:`k3_staged` holds, else the unstaged one (``staged=False`` asks
    for it at any N; ``staged=True`` past the staged limit raises). Both
    variants give the same bits. Its tau' and costs agree with the plain
    version's to rtol 1e-6 (``tour_cost`` sums in f32, ``scatter_add_`` in
    any order), and its best state and score are what the plain steps make
    of its own costs and tau', bit for bit. A tour that is not a permutation
    stops the kernel with a device-side assert; the plain version takes any
    tours."""
    tau = state.phe.tau
    if tau.device.type == "cpu":
        return fused_tsp_update_plain(state, paths, dist, decay=decay, q=q,
                                      symmetric=symmetric, floor=floor,
                                      log_heu=log_heu, alpha=alpha,
                                      score_dtype=score_dtype)
    _build.require_cuda("fused_tsp_update", tau, paths, dist, state.best_cost,
                        state.best_path, *(() if log_heu is None else (log_heu,)))
    b, n, a = paths.shape
    if (tau.shape != (b, n, n) or dist.shape != (b, n, n)
            or state.best_cost.shape != (b,) or state.best_path.shape != (b, n)
            or (log_heu is not None and log_heu.shape != (b, n, n))):
        raise ValueError("expected tau, dist, log_heu [B, N, N], paths [B, N, A], "
                         "best_cost [B] and best_path [B, N]")
    if any(t.dtype != torch.float32 for t in (tau, dist, state.best_cost,
                                              *(() if log_heu is None else (log_heu,)))):
        raise ValueError("fused_tsp_update takes f32 tau, dist, log_heu and best_cost")
    if score_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_tsp_update writes a bf16 or f32 score, not {score_dtype}")
    if staged is None:
        staged = k3_staged(n)
    elif staged and not k3_staged(n):
        raise ValueError(f"fused_tsp_update: the staged variant takes N <= "
                         f"{K3_STAGED_MAX_N} (shared memory), got {n}")
    out = _launch_update(state, paths.long().contiguous(), dist.contiguous(), decay, q,
                         symmetric, floor, log_heu, alpha, score_dtype, staged)
    fused_tsp_update.launches += 1
    return out


def _launch_update(state, paths, dist, decay, q, symmetric, floor, log_heu, alpha,
                   score_dtype, staged):
    """Allocate the outputs and the scratch and call the K3 entry point."""
    b, n, a = paths.shape
    tau = state.phe.tau.contiguous()
    dev = tau.device
    tau_out = torch.empty_like(tau)
    costs = torch.empty((b, a), dtype=torch.float32, device=dev)
    best_cost = torch.empty_like(state.best_cost)
    best_path = torch.empty((b, n), dtype=torch.int64, device=dev)
    nbr = torch.empty((b, n, a, 2), dtype=torch.int32, device=dev)
    best_cost_in = state.best_cost.contiguous()
    best_path_in = state.best_path.contiguous()
    score, score_kind, heu_ptr = None, 0, None
    if log_heu is not None:
        log_heu = log_heu.contiguous()
        score = torch.empty((b, n, n), dtype=score_dtype, device=dev)
        score_kind, heu_ptr = (1 if score_dtype == torch.bfloat16 else 2), log_heu.data_ptr()
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("deepaco_as_update", [P] * 12 + [I] * 3 + [F, F, I, I, F, F, I, I, P])
    rc = fn(tau.data_ptr(), paths.data_ptr(), dist.data_ptr(), heu_ptr,
            best_cost_in.data_ptr(), best_path_in.data_ptr(),
            tau_out.data_ptr(), costs.data_ptr(),
            None if score is None else score.data_ptr(), best_cost.data_ptr(),
            best_path.data_ptr(), nbr.data_ptr(), b, n, a, decay, q,
            int(symmetric), int(floor > 0.0), floor, alpha, score_kind, int(staged),
            _build.stream_ptr(dev))
    _build.check(rc, "deepaco_as_update")
    state = state._replace(phe=state.phe._replace(tau=tau_out), best_cost=best_cost,
                           best_path=best_path)
    return state, costs, score


fused_tsp_update.launches = 0


def _fused_update_ok(cfg: ACOConfig) -> bool:
    """K3 covers exactly the plain Ant System TSP update; every other
    configuration takes :func:`search_update`."""
    return (not cfg.elitist and not cfg.min_max and not cfg.maximize
            and not cfg.vector_pheromone and not cfg.deposit_div_ants
            and cfg.cost_offset == 0.0 and cfg.cyclic)


def _batched_update(cfg: ACOConfig, state: SearchState, paths: torch.Tensor,
                    dist: torch.Tensor, *, update: Callable = fused_tsp_update,
                    log_heu: torch.Tensor | None = None,
                    sample_dtype: torch.dtype = torch.bfloat16):
    """One iteration's update, ``(state, next score)``: ``update`` (K3 or its
    plain version) where it covers ``cfg``, else :func:`search_update`; the
    score in ``sample_dtype`` only when ``log_heu`` is given."""
    if _fused_update_ok(cfg):
        state, _, score = update(state, paths, dist, decay=cfg.decay, q=cfg.q,
                                 symmetric=cfg.symmetric, floor=cfg.floor,
                                 log_heu=log_heu, alpha=cfg.alpha,
                                 score_dtype=sample_dtype)
        return state, score
    state = search_update(cfg, state, paths, tour_cost(dist, paths))
    if log_heu is None:
        return state, None
    return state, next_score(state.phe.tau, log_heu, cfg.alpha, sample_dtype)


class PathOps(NamedTuple):
    """What the main path calls in each phase, and ``timer(name)``, a context
    manager that each phase's span enters (``"heuristic"``,
    ``"construction"``, ``"local_search"``, ``"update"``). ``heuristic`` is
    K1, ``layers`` the layer stack of the heuristic's route past K1's limits
    (K9). The default is the kernels and no timer."""

    heuristic: Callable = tsp_dense_heuristic
    sweep: Callable = dense_sweep_fused
    update: Callable = fused_tsp_update
    two_opt: Callable = batched_two_opt_euclid
    nls: Callable = batched_nls_euclid
    layers: Callable = embnet_layers
    timer: Callable | None = None


KERNEL_OPS = PathOps()
PLAIN_OPS = PathOps(tsp_dense_heuristic_plain, dense_sweep, fused_tsp_update_plain,
                    batched_two_opt_euclid_plain, batched_nls_euclid_plain,
                    embnet_layers_plain)


def _batched_ls_fn(ls: str | None, coords: torch.Tensor | None, dist: torch.Tensor,
                   heu: torch.Tensor, ls_budget: int, ops: PathOps):
    """Whole-batch local search, ``paths [B, N, A]`` → improved paths
    (reference semantics, tsp_nls/aco.py:226-258): 2-opt, or NLS with the
    perturbation metric ``heuristic_dist(heu)``. With ``coords`` it runs K4
    or K5 (the metric rounded to bf16); without, the dense descents on
    ``dist`` (the metric as it is), as the JAX package does."""
    if ls is None:
        return None
    if ls not in ("2opt", "nls"):
        raise ValueError(f"ls must be None, '2opt' or 'nls', got {ls!r}")
    hd = heuristic_dist(heu) if ls == "nls" else None
    if coords is None:
        if ls == "nls":
            run = lambda tours: batched_nls(dist, hd, tours, ls_budget)
        else:
            run = lambda tours: batched_two_opt(dist, tours, ls_budget)
    elif ls == "nls":
        run = lambda tours: ops.nls(coords, hd, tours, ls_budget)
    else:
        run = lambda tours: ops.two_opt(coords, tours, ls_budget)
    return lambda paths: run(paths.transpose(1, 2)).transpose(1, 2)


@torch.no_grad()
def run_anytime_batched(heu: torch.Tensor, dist: torch.Tensor, cfg: ACOConfig,
                        generator: torch.Generator, n_iterations: int,
                        fixed_start: int | None = None,
                        sample_dtype: torch.dtype = torch.bfloat16,
                        coords: torch.Tensor | None = None,
                        ls: str | None = None, ls_budget: int = 10000, *,
                        stats: dict | None = None,
                        _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    """Batched dense anytime sweep: ``heu, dist [B, N, N]`` → the curve
    ``[B, n_iterations]`` of best-so-far costs. ``ls`` (``"2opt"`` or
    ``"nls"``; K4 or K5 with ``coords [B, N, 2]``, the dense descents on
    ``dist`` without) improves every ant's tour with at most ``ls_budget``
    moves per descent before the update, and starts every ant at city 0
    unless ``fixed_start`` says otherwise. ``stats``, when given, receives
    each instance's best tour (``best [B, N]``)."""
    b, n, _ = heu.shape
    a = cfg.n_ants
    log_heu = cfg.beta * torch.log(torch.clamp(heu.float(), min=1e-30))
    if ls is not None and fixed_start is None:
        fixed_start = 0     # the NLS protocol constructs from node 0
    ls_fn = _batched_ls_fn(ls, coords, dist, heu, ls_budget, _ops)
    state = _batched_init(b, n, cfg, heu.device)
    curve = []
    with phase("construction", _ops.timer):
        score = next_score(state.phe.tau, log_heu, cfg.alpha, sample_dtype)
    for t in range(n_iterations):
        with phase("construction", _ops.timer):
            start = _start_cities(generator, b, a, n, fixed_start, heu.device)
            paths = _ops.sweep(score, start, generator)
        if ls_fn is not None:
            with phase("local_search", _ops.timer):
                paths = ls_fn(paths)
        with phase("update", _ops.timer):   # the last iteration writes no score
            state, score = _batched_update(
                cfg, state, paths, dist, update=_ops.update, sample_dtype=sample_dtype,
                log_heu=log_heu if t + 1 < n_iterations else None)
        curve.append(state.best_cost)
    if stats is not None:
        stats["best"] = state.best_path
    return torch.stack(curve, dim=1)


# ----------------------------------------------------------- sparse path ---
def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [B, N, X]`` gathered at ``idx [B, A]`` → ``[B, A, X]``."""
    return torch.gather(table, 1, idx[..., None].expand(*idx.shape, table.shape[-1]))


def sweep_construct(score_dense: torch.Tensor, score_sparse: torch.Tensor,
                    nbr: torch.Tensor, start: torch.Tensor, generator: torch.Generator, *,
                    stochastic: bool = True, count_dense: bool = False,
                    stats: dict | None = None):
    """Every ant's tour over the k-NN support (batched_tsp.py:343-405):
    ``score_dense [B, N, N]`` (the exact fallback rows), ``score_sparse [B,
    N, K]`` the same scores on the support ``nbr [B, N, K]``, ``start [B,
    A]``. A step picks among each ant's unvisited neighbours (Gumbel noise
    over ``[B, A, K]`` from ``generator``, or the first maximum when not
    ``stochastic``) unless some ant of the batch has none left; then every
    ant takes the dense step (noise over ``[B, A, N]``). The JAX package
    branches on the device (``lax.cond``); here the predicate reaches the
    host, one synchronisation a step, and only the branch taken runs. The
    visited set is a bool ``[B, A, N]`` mask in place of JAX's packed words
    (a TPU layout choice), as in ``large_tsp.sweep_construct_knn``.
    ``stats``, when given, adds the synchronisations (``syncs``) and the
    host's seconds blocked in them (``sync_s``).

    Returns paths ``[B, N, A]`` (row 0 the start), and with ``count_dense``
    also the number of dense steps."""
    b, n, _ = score_sparse.shape
    dev = score_sparse.device
    cur = start.long()
    visited = torch.zeros((*cur.shape, n), dtype=torch.bool, device=dev)
    visited.scatter_(-1, cur[..., None], True)
    steps, dense = [cur], 0
    for _ in range(n - 1):
        nbr_rows = _gather_rows(nbr, cur)                            # [B, A, K]
        open_nbr = ~visited.gather(-1, nbr_rows)
        t0 = time.perf_counter()
        sparse_ok = bool(open_nbr.any(dim=-1).all())
        if stats is not None:
            stats["sync_s"] = stats.get("sync_s", 0.0) + time.perf_counter() - t0
            stats["syncs"] = stats.get("syncs", 0) + 1
        if sparse_ok:
            logits = torch.where(open_nbr, _gather_rows(score_sparse, cur), NEG_INF)
        else:
            dense += 1
            logits = torch.where(visited, NEG_INF, _gather_rows(score_dense, cur))
        if stochastic:
            logits = logits + gumbel(logits.shape, generator, dev)
        pick = torch.argmax(logits, dim=-1)
        cur = nbr_rows.gather(-1, pick[..., None])[..., 0] if sparse_ok else pick
        visited.scatter_(-1, cur[..., None], True)
        steps.append(cur)
    paths = torch.stack(steps, dim=1)
    return (paths, dense) if count_dense else paths


@torch.no_grad()
def run_anytime_sparse(heu: torch.Tensor, dist: torch.Tensor, nbr: torch.Tensor,
                       cfg: ACOConfig, generator: torch.Generator, n_iterations: int,
                       fixed_start: int | None = None, *, stats: dict | None = None,
                       _ops: PathOps = KERNEL_OPS) -> torch.Tensor:
    """Batched anytime TSP over the sparse support (batched_tsp.py:408-436):
    ``heu [B, N, N]`` (floored off the support, as ``scatter_to_dense(...) +
    1e-10`` and K1 make it), ``dist [B, N, N]``, the support ``nbr [B, N,
    K]`` the heuristic lives on → the curve ``[B, n_iterations]`` of
    best-so-far costs. Each iteration samples with :func:`sweep_construct`
    on the f32 score ``alpha*log(tau) + beta*log(heu)``, from uniform starts
    unless ``fixed_start``, then updates through ``_batched_update`` (K3,
    which also writes the next score; ``_ops.update`` takes its plain
    version). ``stats``, when given, receives ``fallback_steps``, ``steps``
    (sweep steps in all), ``syncs``, ``sync_s`` and each instance's best
    tour (``best [B, N]``); the spans ``"construction"`` and ``"update"``
    enter ``_ops.timer``."""
    b, n, _ = heu.shape
    a = cfg.n_ants
    log_heu = cfg.beta * torch.log(torch.clamp(heu.float(), min=1e-30))
    state = _batched_init(b, n, cfg, heu.device)
    counts = {} if stats is None else stats
    counts.update(fallback_steps=0, steps=0, syncs=0, sync_s=0.0)
    score = next_score(state.phe.tau, log_heu, cfg.alpha, torch.float32)
    curve = []
    for t in range(n_iterations):
        with phase("construction", _ops.timer):
            start = _start_cities(generator, b, a, n, fixed_start, heu.device)
            paths, dense = sweep_construct(score, torch.gather(score, -1, nbr), nbr, start,
                                           generator, count_dense=True, stats=counts)
        counts["fallback_steps"] += dense
        counts["steps"] += n - 1
        with phase("update", _ops.timer):   # the last iteration writes no score
            state, score = _batched_update(
                cfg, state, paths, dist, update=_ops.update, sample_dtype=torch.float32,
                log_heu=log_heu if t + 1 < n_iterations else None)
        curve.append(state.best_cost)
    counts["best"] = state.best_path
    return torch.stack(curve, dim=1)
