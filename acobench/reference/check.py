"""The comparison that decides ``correct`` for a solve request.

It judges what one request of the timed path produced (``capture``: the
heuristic, every iteration's constructed tours and, with local search,
improved tours, the best-so-far curve and the best tours) against the plain
reference, which works everything out again from the request's instances
and the configuration's weights. The numbers, each compared with a limit of
its own (the cell's file holds them):

- ``heu_log_gap``: the largest ``|log heu - log heu_ref|`` over every entry
  (the heuristic, K1).
- ``law_gap``: the construction (K2) and the update's pheromone (K3). At
  each of up to ``LAW_ITERATIONS`` iterations spread over the request
  (the first and the last among them), the mean log-likelihood per step of
  the request's tours under the reference's law (the softmax of its score
  over the unvisited cities) less that of tours the reference samples
  itself from the same score; the gap is the absolute value of the mean of
  these differences over the iterations. The reference's score at an
  iteration comes from tau that it rebuilds from the request's own tours of
  every earlier iteration. A sampler that departs from the law moves every
  difference the same way; sound sampling leaves noise that the mean over
  iterations shrinks.
- ``best_gap``: every iteration's best-so-far against ``min(previous best,
  cheapest tour of the iteration)``, the costs the reference's (f64),
  relative (the update's best state, K3).
- ``invalid_tours``: tours handed to the update that are no permutation of
  the cities (limit 0).
- ``ls_gap`` (with local search): the mean relative gap between the length
  of each first-iteration tour as the request improved it and as the
  reference's NLS improves the same constructed tour (K5).
"""
from __future__ import annotations

import math

import torch

from acobench.reference import aco, gnn, nls

SENTINEL = 1e30     # a reading that is not finite is reported as this
LAW_ITERATIONS = 10


def finite(x: float) -> float:
    return float(x) if math.isfinite(x) else SENTINEL


def _is_perm(paths: torch.Tensor) -> torch.Tensor:
    """Per tour ``[B, A]``: whether ``paths [B, N, A]`` holds each city once."""
    n = paths.shape[1]
    ident = torch.arange(n, device=paths.device)[None, :, None]
    return (torch.sort(paths.long(), dim=1).values == ident).all(dim=1)


def _law_difference(sc: torch.Tensor, paths: torch.Tensor, generator: torch.Generator,
                    fixed_start: bool) -> float:
    """The mean log-likelihood of ``paths`` under ``sc`` less that of tours
    the reference samples from ``sc`` itself."""
    b, n, a = paths.shape
    if fixed_start:
        start = torch.zeros((b, a), dtype=torch.int64, device=sc.device)
    else:
        start = torch.randint(0, n, (b, a), generator=generator, device=sc.device)
    own = aco.sample(sc, start, generator, torch.bfloat16)
    return aco.mean_log_likelihood(sc, paths) - aco.mean_log_likelihood(sc, own)


def law_iterations(t_max: int) -> set:
    """The iterations whose construction the check judges: up to
    ``LAW_ITERATIONS`` spread evenly, the first and the last among them."""
    k = min(LAW_ITERATIONS, t_max)
    return {round(i * (t_max - 1) / max(k - 1, 1)) for i in range(k)}


@torch.no_grad()
def judge(capture: dict, coords: torch.Tensor, tree: dict, cfg: dict, seed: int) -> dict:
    """The numbers of one request (``coords [B, N, 2]`` on the device the
    reference runs on; ``capture`` as :func:`acobench.reference.aco.run_search`
    returns it)."""
    dev = coords.device
    b, n, _ = coords.shape
    a_cfg = cfg["aco"]
    ls = cfg.get("local_search")
    out = {}
    heu_ref = gnn.heuristic(gnn.Weights(tree, dev), coords, cfg["k_sparse"], cfg["node_features"])
    heu = capture["heu"].to(dev).float()
    if heu.shape != heu_ref.shape:
        out["heu_log_gap"] = SENTINEL
    else:
        gap = (torch.log(torch.clamp(heu, min=1e-30)) - torch.log(heu_ref)).abs().max()
        out["heu_log_gap"] = finite(float(gap))
    sweeps = [p.to(dev).long() for p in capture["sweeps"]]
    updated = [p.to(dev).long() for p in capture["ls"]] if ls is not None else sweeps
    t_max = len(sweeps)
    dist = gnn.distance_matrix(coords)
    curve = capture["curve"].to(dev).double()
    if curve.shape != (b, t_max) or any(p.shape != (b, n, a_cfg["n_ants"]) for p in updated):
        return {**out, "law_gap": SENTINEL, "best_gap": SENTINEL, "invalid_tours": SENTINEL,
                **({"ls_gap": SENTINEL} if ls is not None else {})}
    handed = sweeps if ls is None else sweeps + updated
    out["invalid_tours"] = float(sum(int((~_is_perm(p)).sum()) for p in handed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    alpha, beta = a_cfg["alpha"], a_cfg["beta"]
    tau = torch.ones((b, n, n), dtype=torch.float32, device=dev)
    judged, diffs = law_iterations(t_max), []
    worst = 0.0
    prev = torch.full((b,), float("inf"), dtype=torch.float64, device=dev)
    for t in range(t_max):
        if t in judged:
            diffs.append(_law_difference(aco.score(tau, heu_ref, alpha, beta, torch.bfloat16),
                                         sweeps[t], gen, ls is not None))
        costs = aco.tour_costs(dist, updated[t])
        want = torch.minimum(prev, costs.min(dim=-1).values)
        worst = max(worst, float(((curve[:, t] - want).abs() / want).max()))
        prev = curve[:, t]
        if t + 1 < t_max:
            tau = aco.deposit(tau, updated[t], costs, a_cfg["decay"], a_cfg["q"], torch.float32)
    out["best_gap"] = finite(worst)
    out["law_gap"] = finite(abs(sum(diffs) / len(diffs)))
    if ls is not None:
        ref = nls.nls_paths(coords, heu_ref, sweeps[0], ls)
        got = aco.tour_costs(dist, updated[0])
        want = aco.tour_costs(dist, ref)
        out["ls_gap"] = finite(float(((got - want).abs() / want).mean()))
    return out


def validate(coords, tours, reported) -> tuple[int, float]:
    """Every instance of one request, on the host (numpy): whether each best
    tour ``tours [B, N]`` is a permutation, and the largest relative gap
    between each reported best cost ``reported [B]`` and the f64 length of
    its tour. Returns ``(instances wrong, largest gap)``: a tour that is no
    permutation, a missing instance or a cost that is not finite is wrong."""
    import numpy as np

    b, n, _ = coords.shape
    tours = np.asarray(tours)
    reported = np.asarray(reported, dtype=np.float64)
    if tours.shape != (b, n) or reported.shape != (b,):
        return b, SENTINEL
    perm = (np.sort(tours, axis=1) == np.arange(n)[None]).all(axis=1)
    safe = np.where(perm[:, None], tours, np.arange(n)[None]).astype(np.int64)
    c = np.take_along_axis(coords.astype(np.float64), safe[..., None], axis=1)
    d = np.sqrt(((c - np.roll(c, -1, axis=1)) ** 2).sum(-1)).sum(-1)
    gap = np.abs(reported - d) / d
    wrong = ~perm | ~np.isfinite(reported)
    gap = np.where(wrong, 0.0, gap)
    return int(wrong.sum()), float(gap.max()) if b else 0.0
