"""ctypes binding for the native CVRP local-search engine, SWAP* and RI moves
(counterpart of ``deepaco_tpu/ls/hgs.py``, whole).

The engine is host code: ``native/cvrp_ls.cpp``, the port's own byte-identical
copy of ``deepaco_tpu/ls/native/cvrp_ls.cpp``. :func:`get_library` compiles it
at first use with the JAX package's ``Makefile`` flags (``g++ -O3 -std=c++17
-fPIC -Wall -shared``), so that both packages' engines compute the same
floats, into ``build/native/libcvrpls.so`` at the repository root; it
rebuilds only when the source is newer than the library. Several processes
may ask at once (``pytest -n``): a file lock serialises them, and the
library is written to a temporary name and moved into place. A build or load
that fails raises; nothing runs without the engine.

The API is the JAX package's: ``swapstar`` (reference cvrp_nls/swapstar.py:
324-346), ``neural_swapstar`` (cvrp_nls/aco.py:443-448), ``multiple_swap_star``
(cvrp_nls/aco.py:113-126), ``solve_cvrp`` and a reusable :class:`LSContext`
holding one instance's matrices and its granular neighbour lists. Every
round trip re-validates the returned routes (coverage and capacity) and
raises :class:`NativeLSError` when they are invalid. Unlike the JAX
package, whose ``swapstar`` hands back the input routes when the ctypes call
itself raises (hgs.py:266-269), the port lets that error through.

The engine has no random state in its local search, so equal routes,
matrices and move budgets give equal routes (the 30 s deadline is a cap
only).
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "cvrp_ls.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_PATH = BUILD_DIR / "libcvrpls.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]   # the JAX Makefile's

_lock = threading.Lock()
_lib = None

_PD = ctypes.POINTER(ctypes.c_double)
_PI = ctypes.POINTER(ctypes.c_int)

# Default wall-clock cap per native call: generous for any real instance but
# bounds a pathological one (the reference's only bound is the move count).
DEFAULT_TIME_LIMIT_S = 30.0


class NativeLSError(RuntimeError):
    """The native engine returned an invalid solution: customers lost or
    duplicated, or a route over the capacity."""


def build_library(path: Path = LIB_PATH) -> Path:
    """Compile ``SOURCE`` into ``path`` unless ``path`` is newer than the
    source. Safe across processes: a lock file beside ``path`` serialises
    the builders, and the compiler writes a temporary file that replaces
    ``path`` in one step. Raises with the compiler's output on failure."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / f".{path.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists() and path.stat().st_mtime >= SOURCE.stat().st_mtime:
            return path
        tmp = path.parent / f".{path.name}.{os.getpid()}.tmp"
        out = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SOURCE} (rc {out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    return path


def get_library() -> ctypes.CDLL:
    """The loaded engine, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.cvrp_ls_context_new.restype = ctypes.c_void_p
            lib.cvrp_ls_context_new.argtypes = [
                ctypes.c_int, _PD, _PD, ctypes.c_double, _PD, ctypes.c_int]
            lib.cvrp_ls_context_free.restype = None
            lib.cvrp_ls_context_free.argtypes = [ctypes.c_void_p]
            lib.cvrp_ls_improve.restype = ctypes.c_int
            lib.cvrp_ls_improve.argtypes = [
                ctypes.c_void_p, _PI, _PI, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_double]
            # n, dist, demands, capacity, coords (nullable), routes_flat,
            # route_lens, n_routes, count_limit, k_granular, use_swap_star,
            # time_limit_s
            lib.cvrp_local_search.restype = ctypes.c_int
            lib.cvrp_local_search.argtypes = [
                ctypes.c_int, _PD, _PD, ctypes.c_double, _PD, _PI, _PI,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double]
            # n, dist, demands, capacity, max_iters, no_improve_limit,
            # time_limit_s, seed, ls_count, k_granular, routes_flat out,
            # route_lens out, n_routes out
            lib.cvrp_solve.restype = ctypes.c_double
            lib.cvrp_solve.argtypes = [
                ctypes.c_int, _PD, _PD, ctypes.c_double, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_uint, ctypes.c_int,
                ctypes.c_int, _PI, _PI, _PI]
            lib.cvrp_solution_cost.restype = ctypes.c_double
            lib.cvrp_solution_cost.argtypes = [
                ctypes.c_int, _PD, _PI, _PI, ctypes.c_int]
            _lib = lib
    return _lib


def path_to_routes(path) -> list[np.ndarray]:
    """Split a depot-delimited ant path (0 c.. 0 c.. 0 ...) into its customer
    routes (get_subroutes, cvrp_nls/aco.py:12-23)."""
    path = np.asarray(path)
    zeros = np.nonzero(path == 0)[0]
    routes = []
    for a, b in zip(zeros, zeros[1:]):
        if b - a > 1:
            routes.append(path[a + 1:b].astype(np.int32))
    tail = path[zeros[-1] + 1:] if len(zeros) else path
    if len(tail):
        routes.append(tail.astype(np.int32))
    return routes


def routes_to_path(routes, length: int | None = None) -> np.ndarray:
    """Merge routes back into a depot-delimited path (merge_subroutes,
    cvrp_nls/aco.py:25-33), padded with depot zeros to ``length``."""
    parts = [np.zeros(1, np.int64)]
    for r in routes:
        if len(r):
            parts.append(np.asarray(r, np.int64))
            parts.append(np.zeros(1, np.int64))
    path = np.concatenate(parts)
    if length is not None:
        if len(path) > length:
            raise ValueError(f"merged path of {len(path)} nodes exceeds the horizon {length}")
        path = np.concatenate([path, np.zeros(length - len(path), np.int64)])
    return path


def _validate_output(demands, capacity, routes_in, routes_out):
    """Raise NativeLSError unless ``routes_out`` covers exactly the customers
    of ``routes_in`` and no route's demand (summed in f64) exceeds
    ``capacity`` by more than 1e-6."""
    want = np.sort(np.concatenate([np.asarray(r) for r in routes_in]))
    have = (np.sort(np.concatenate([np.asarray(r) for r in routes_out]))
            if routes_out else np.empty(0, np.int64))
    if want.shape != have.shape or not np.array_equal(want, have):
        raise NativeLSError("native LS lost or duplicated customers")
    dem = np.asarray(demands, np.float64)
    for r in routes_out:
        if dem[np.asarray(r)].sum() > capacity + 1e-6:
            raise NativeLSError("native LS violated capacity")


def _encode(routes):
    routes = [np.asarray(r, np.int32) for r in routes if len(r)]
    total = sum(len(r) for r in routes)
    flat = np.zeros(max(total, 1), np.int32)
    lens = np.zeros(max(len(routes), 1), np.int32)
    off = 0
    for i, r in enumerate(routes):
        flat[off:off + len(r)] = r
        lens[i] = len(r)
        off += len(r)
    return routes, flat, lens


def _decode(flat, lens, out_r):
    out, off = [], 0
    for i in range(out_r):
        out.append(flat[off:off + lens[i]].copy())
        off += lens[i]
    return out


class LSContext:
    """A reusable native context for one ``(dist, demands)`` pair: it keeps
    the arrays alive (the engine holds raw pointers into them) with their
    k-nearest granular neighbour lists. Concurrent :meth:`improve` calls from
    several threads are safe."""

    def __init__(self, demands, dist, capacity: float = 1.0 + 1e-9,
                 coords=None, k_granular: int = 20):
        self._lib = get_library()
        self.dist = np.ascontiguousarray(dist, np.float64)
        self.demands = np.ascontiguousarray(demands, np.float64)
        self.coords = None if coords is None else np.ascontiguousarray(coords, np.float64)
        self.capacity = float(capacity)
        self.n = self.dist.shape[0]
        self._handle = self._lib.cvrp_ls_context_new(
            self.n, self.dist.ctypes.data_as(_PD), self.demands.ctypes.data_as(_PD),
            ctypes.c_double(self.capacity),
            None if self.coords is None else self.coords.ctypes.data_as(_PD),
            k_granular)

    def improve(self, routes, count: int = 1000, use_swap_star: bool = True,
                time_limit_s: float = 0.0, validate: bool = True):
        """Polish ``routes`` (a list of customer arrays); returns new routes."""
        routes, flat, lens = _encode(routes)
        if not routes:
            return routes
        out_r = self._lib.cvrp_ls_improve(
            self._handle, flat.ctypes.data_as(_PI), lens.ctypes.data_as(_PI),
            len(routes), count, int(use_swap_star), ctypes.c_double(time_limit_s))
        out = _decode(flat, lens, out_r)
        if validate:
            _validate_output(self.demands, self.capacity, routes, out)
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.cvrp_ls_context_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def swapstar(demands, dist, routes, count: int = 1000, k_granular: int = 20,
             use_swap_star: bool = True, coords=None,
             time_limit_s: float = DEFAULT_TIME_LIMIT_S,
             context: LSContext | None = None) -> list[np.ndarray]:
    """Improve ``routes`` (a list of customer arrays) under ``dist`` with at
    most ``count`` applied moves; demands are normalised to the capacity 1.
    ``coords [n, 2]`` enable the polar-sector pruning of SWAP*'s route
    pairs; ``context`` reuses an :class:`LSContext`. An invalid result raises
    :class:`NativeLSError`, and so does any failure of the call itself."""
    routes = [np.asarray(r, np.int32) for r in routes if len(r)]
    if not routes:
        return routes
    if context is not None:
        return context.improve(routes, count=count, use_swap_star=use_swap_star,
                               time_limit_s=time_limit_s)
    lib = get_library()
    dist = np.ascontiguousarray(dist, np.float64)
    demands = np.ascontiguousarray(demands, np.float64)
    coords_arr = None if coords is None else np.ascontiguousarray(coords, np.float64)
    routes, flat, lens = _encode(routes)
    out_r = lib.cvrp_local_search(
        dist.shape[0], dist.ctypes.data_as(_PD), demands.ctypes.data_as(_PD),
        ctypes.c_double(1.0 + 1e-9),
        None if coords_arr is None else coords_arr.ctypes.data_as(_PD),
        flat.ctypes.data_as(_PI), lens.ctypes.data_as(_PI), len(routes), count,
        k_granular, int(use_swap_star), ctypes.c_double(time_limit_s))
    out = _decode(flat, lens, out_r)
    _validate_output(demands, 1.0 + 1e-9, routes, out)
    return out


def solve_cvrp(demands, dist, capacity: float = 1.0, max_iters: int = 2000,
               no_improve_limit: int = 500, time_limit_s: float = 0.0,
               seed: int = 0, ls_count: int = 100000, k_granular: int = 20):
    """The engine's hybrid genetic search on one instance (giant-tour
    chromosomes, Split decoding, OX crossover, local-search education,
    biased-fitness population; the reference's ``solve_cvrp*`` entries,
    cvrp_nls/HGS-CVRP-main/Program/C_Interface.cpp:50-127). Returns
    ``(routes, cost)``."""
    lib = get_library()
    dist = np.ascontiguousarray(dist, np.float64)
    demands = np.ascontiguousarray(demands, np.float64)
    n = dist.shape[0]
    flat = np.zeros(max(n - 1, 1), np.int32)
    lens = np.zeros(max(n, 1), np.int32)
    n_routes = ctypes.c_int(0)
    cost = lib.cvrp_solve(
        n, dist.ctypes.data_as(_PD), demands.ctypes.data_as(_PD), ctypes.c_double(capacity),
        max_iters, no_improve_limit, ctypes.c_double(time_limit_s), ctypes.c_uint(seed),
        ls_count, k_granular, flat.ctypes.data_as(_PI), lens.ctypes.data_as(_PI),
        ctypes.byref(n_routes))
    return _decode(flat, lens, n_routes.value), float(cost)


def neural_swapstar(demands, dist, heu_dist, routes, count: int = 1000,
                    perturb_moves: int = 10, coords=None,
                    context: LSContext | None = None,
                    heu_context: LSContext | None = None):
    """LS on ``dist``, a perturbation of ``perturb_moves`` moves on the
    learned metric ``heu_dist``, LS on ``dist`` again (reference
    neural_swapstar, cvrp_nls/aco.py:443-448)."""
    routes = swapstar(demands, dist, routes, count, coords=coords, context=context)
    routes = swapstar(demands, heu_dist, routes, perturb_moves, coords=coords,
                      context=heu_context)
    return swapstar(demands, dist, routes, count, coords=coords, context=context)


def multiple_swap_star(demands, dist, paths, count: int = 1000, heu_dist=None,
                       coords=None, max_workers: int | None = None,
                       context: LSContext | None = None,
                       heu_context: LSContext | None = None):
    """Every ant of ``paths [L, A]`` (depot-delimited) refined on a pool of
    host threads (reference cvrp_nls/aco.py:113-126): ``swapstar``, or
    ``neural_swapstar`` given the metric ``heu_dist``. Returns ``[L, A]``.
    One context a metric serves the whole batch; pass ``context`` and
    ``heu_context`` to keep them across calls."""
    paths = np.asarray(paths)
    length, ants = paths.shape
    own_ctx = context is None
    ctx = context or LSContext(demands, dist, coords=coords)
    own_heu = heu_context is None and heu_dist is not None
    heu_ctx = heu_context if heu_context is not None else (
        None if heu_dist is None else LSContext(demands, heu_dist, coords=coords))

    def one(a):
        routes = path_to_routes(paths[:, a])
        if heu_ctx is None:
            routes = swapstar(demands, dist, routes, count, context=ctx)
        else:
            routes = neural_swapstar(demands, dist, heu_dist, routes, count,
                                     context=ctx, heu_context=heu_ctx)
        return routes_to_path(routes, length)

    try:
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            out = list(ex.map(one, range(ants)))
    finally:
        if own_ctx:
            ctx.close()
        if own_heu:
            heu_ctx.close()
    return np.stack(out, axis=1)
