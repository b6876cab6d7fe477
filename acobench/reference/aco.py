"""The plain reference of the ant colony search that a solve request runs:
the Ant System of DeepACO (tsp/aco.py) as the configuration states it, in
plain PyTorch.

- Score: ``alpha*log(max(tau, 1e-30)) + beta*log(max(heu, 1e-30))`` in the
  sampling precision (bfloat16 as stated).
- Construction: each ant from its start city; a step takes the first
  maximum of the score row plus Gumbel noise over the unvisited columns, in
  the sampling precision. The stated bf16 law draws a 7-bit uniform ``u =
  max(k 2^-7, tiny)`` and ``g = bf16(-log(f32(bf16(-log u))))``, as JAX's
  ``jax.random.gumbel(dtype=bfloat16)`` does.
- Update: ``tau <- decay*tau`` plus ``q/cost`` on both directions of every
  edge of every ant's cyclic tour; the best-so-far keeps the iteration's
  first cheapest tour when it is strictly cheaper.
- Local search (``nls``): :mod:`acobench.reference.nls`.

:func:`run_search` runs the whole search; with ``precision="lower"`` it is
the control of the check: the heuristic in bfloat16, the sampling in
float8 (e4m3), tau, the costs and the local search's distances in bfloat16,
its perturbation metric in float8.
"""
from __future__ import annotations

import torch

from acobench.reference import gnn, nls

NEG = -1e30
TINY = float(torch.finfo(torch.float32).tiny)

PRECISIONS = {
    # name -> (heuristic, sampling, tau and costs, NLS distances, NLS metric)
    "stated": (torch.float32, torch.bfloat16, torch.float32, torch.float32, torch.bfloat16),
    "lower": (torch.bfloat16, torch.float8_e4m3fn, torch.bfloat16, torch.bfloat16,
              torch.float8_e4m3fn),
}


FLOAT8_MAX = 448.0     # e4m3's largest finite value


def rnd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to f32 (f32 arithmetic on the
    rounded values; float8 has no arithmetic of its own, and saturates at
    its largest finite value here rather than turning to NaN)."""
    if dtype == torch.float8_e4m3fn:
        x = torch.clamp(x, -FLOAT8_MAX, FLOAT8_MAX)
    return x.to(dtype).float()


def score(tau: torch.Tensor, heu: torch.Tensor, alpha: float, beta: float,
          dtype: torch.dtype) -> torch.Tensor:
    """The construction score ``[B, N, N]``, rounded to ``dtype`` (as f32)."""
    s = alpha * torch.log(torch.clamp(tau, min=1e-30)) \
        + beta * torch.log(torch.clamp(heu.float(), min=1e-30))
    return rnd(s, dtype)


def gumbel(shape, generator: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """The stated law's Gumbel noise (a 7-bit uniform), rounded to ``dtype``."""
    k = torch.randint(0, 128, shape, generator=generator, device=generator.device)
    u = torch.clamp(k.float() * (2.0 ** -7), min=TINY)
    inner = rnd(-torch.log(u), dtype)
    return rnd(-torch.log(inner), dtype)


def sample(sc: torch.Tensor, start: torch.Tensor, generator: torch.Generator,
           dtype: torch.dtype) -> torch.Tensor:
    """Every ant's tour from ``start [B, A]`` over the score ``sc [B, N, N]``:
    paths ``[B, N, A]``, row 0 the start."""
    b, n, _ = sc.shape
    a = start.shape[1]
    cur = start.long()
    visited = torch.zeros((b, a, n), dtype=torch.bool, device=sc.device)
    visited.scatter_(-1, cur[..., None], True)
    steps = [cur]
    for _ in range(n - 1):
        rows = torch.gather(sc, 1, cur[..., None].expand(b, a, n))
        logits = torch.where(visited, NEG, rows)
        z = rnd(logits + gumbel((b, a, n), generator, dtype), dtype)
        cur = torch.argmax(z, dim=-1)
        visited.scatter_(-1, cur[..., None], True)
        steps.append(cur)
    return torch.stack(steps, dim=1)


def mean_log_likelihood(sc: torch.Tensor, paths: torch.Tensor) -> float:
    """The mean over every step of every ant of the log-probability of the
    city it took, under the softmax of the score over its unvisited
    columns: how likely the stated law finds these tours. A path that takes
    a visited city, or leaves the cities, reads -inf."""
    b, n, a = paths.shape
    paths = paths.long()
    if paths.min() < 0 or paths.max() >= n:
        return float("-inf")
    cur = paths[:, 0]
    visited = torch.zeros((b, a, n), dtype=torch.bool, device=sc.device)
    visited.scatter_(-1, cur[..., None], True)
    total = torch.zeros((), dtype=torch.float64, device=sc.device)
    for t in range(1, n):
        rows = torch.gather(sc, 1, cur[..., None].expand(b, a, n))
        lp = torch.log_softmax(torch.where(visited, float("-inf"), rows), dim=-1)
        nxt = paths[:, t]
        total = total + lp.gather(-1, nxt[..., None]).double().sum()
        visited.scatter_(-1, nxt[..., None], True)
        cur = nxt
    return float(total) / (b * a * (n - 1))


def tour_costs(dist: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Cyclic lengths ``[B, A]`` of ``paths [B, N, A]`` in f64."""
    nxt = torch.roll(paths, -1, dims=1)
    b = dist.shape[0]
    idx = torch.arange(b, device=dist.device)[:, None, None]
    return dist.double()[idx, paths.long(), nxt.long()].sum(dim=1)


def deposit(tau: torch.Tensor, paths: torch.Tensor, costs: torch.Tensor,
            decay: float, q: float, dtype: torch.dtype) -> torch.Tensor:
    """The Ant System update of ``tau [B, N, N]`` by ``paths [B, N, A]`` with
    ``costs [B, A]``, symmetric and cyclic, rounded to ``dtype``."""
    b, n, _ = tau.shape
    nxt = torch.roll(paths, -1, dims=1).long()
    cur = paths.long()
    amount = (q / costs.float())[:, None, :].expand(b, n, cur.shape[-1])
    flat = rnd(tau * decay, dtype).reshape(b, n * n).clone()
    flat.scatter_add_(1, (cur * n + nxt).reshape(b, -1), amount.reshape(b, -1))
    flat.scatter_add_(1, (nxt * n + cur).reshape(b, -1), amount.reshape(b, -1))
    return rnd(flat.reshape(b, n, n), dtype)


def run_search(tree: dict, coords: torch.Tensor, cfg: dict, t_max: int,
               seed: int, precision: str = "stated") -> dict:
    """The whole search of one request with the weights ``tree``, in the
    form the harness captures the
    program's: ``heu``, each iteration's constructed ``sweeps`` and (with
    local search) its improved ``ls`` tours ``[B, N, A]``, the ``curve [B,
    T]`` of best-so-far costs and the ``best`` tours ``[B, N]``."""
    heu_dt, samp_dt, tau_dt, ls_dist_dt, ls_metric_dt = PRECISIONS[precision]
    aco, dev = cfg["aco"], coords.device
    b, n, _ = coords.shape
    a = aco["n_ants"]
    heu = gnn.heuristic(gnn.Weights(tree, dev, heu_dt), coords, cfg["k_sparse"],
                        cfg["node_features"])
    dist = gnn.distance_matrix(coords)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tau = torch.ones((b, n, n), dtype=torch.float32, device=dev)
    best = torch.full((b,), float("inf"), dtype=torch.float64, device=dev)
    best_path = torch.zeros((b, n), dtype=torch.int64, device=dev)
    ls = cfg.get("local_search")
    out = {"heu": heu, "sweeps": [], "ls": [], "curve": []}
    for _ in range(t_max):
        sc = score(tau, heu, aco["alpha"], aco["beta"], samp_dt)
        if ls is None:
            start = torch.randint(0, n, (b, a), generator=gen, device=dev)
        else:
            start = torch.zeros((b, a), dtype=torch.int64, device=dev)
        paths = sample(sc, start, gen, samp_dt)
        out["sweeps"].append(paths)
        if ls is not None:
            paths = nls.nls_paths(coords, heu, paths, ls, ls_dist_dt, ls_metric_dt)
            out["ls"].append(paths)
        costs = tour_costs(rnd(dist, tau_dt), paths)
        costs = rnd(costs.float(), tau_dt).double()
        it = torch.argmin(costs, dim=-1)
        it_cost = costs.gather(-1, it[:, None])[:, 0]
        better = it_cost < best
        best = torch.where(better, it_cost, best)
        best_path = torch.where(better[:, None],
                                paths.gather(2, it[:, None, None].expand(b, n, 1))[..., 0],
                                best_path)
        tau = deposit(tau, paths, costs, aco["decay"], aco["q"], tau_dt)
        out["curve"].append(best.float())
    out["curve"] = torch.stack(out["curve"], dim=1)
    out["best"] = best_path
    return out
