"""RCPSP instances (counterpart of ``deepaco_tpu/core/rcpsp.py``): the
PSPLIB ``.RCP`` parser and archive loader, precedence analysis (earliest
starts and latest finishes, a topological order, successor closures), the
schedule validator and the classic column priors (rcpsp/aco.py:65-92,
152-155).

An instance is an :class:`RCPSPData` of int32 tensors and the plain-int
schedule horizon ``t_max`` (the sum of the durations, or a larger bound
shared by a batch). :func:`stack_rcpsp` stacks instances of one size into
the batched form the search and the decoder take, ``[B, ...]``. The host
analysis runs in numpy, as in the JAX package.
"""
from __future__ import annotations

import tarfile
from typing import NamedTuple

import numpy as np
import torch


class RCPSPData(NamedTuple):
    """``n`` activities (two dummies, the source 0 and the sink ``n-1``)
    and ``m`` renewable resources, each tensor with optional leading batch
    dimensions: ``duration [n]``, ``resources [n, m]``, ``capacity [m]``,
    ``adj [n, n]`` (``adj[i, j] = 1`` iff ``i`` precedes ``j``),
    ``earliest_start [n]``, ``latest_finish [n]``, all int32, and
    ``t_max``, the horizon of the decoder's resource timeline."""

    duration: torch.Tensor
    resources: torch.Tensor
    capacity: torch.Tensor
    adj: torch.Tensor
    earliest_start: torch.Tensor
    latest_finish: torch.Tensor
    t_max: int

    @property
    def n(self) -> int:
        return self.duration.shape[-1]

    @property
    def m(self) -> int:
        return self.capacity.shape[-1]


def _topo_order(adj: np.ndarray) -> np.ndarray:
    """A topological order of the precedence graph (a stack, the JAX
    package's order)."""
    n = adj.shape[0]
    indeg = adj.sum(axis=0).copy()
    order, stack = [], [i for i in range(n) if indeg[i] == 0]
    while stack:
        i = stack.pop()
        order.append(i)
        for j in np.nonzero(adj[i])[0]:
            indeg[j] -= 1
            if indeg[j] == 0:
                stack.append(int(j))
    if len(order) != n:
        raise ValueError("precedence graph contains a cycle")
    return np.array(order)


def _es_lf(duration: np.ndarray, adj: np.ndarray, max_total_time: int):
    """Earliest starts and latest finishes by the forward and backward
    critical-path passes (rcpsp_inst.py:112-135)."""
    n = len(duration)
    es = np.zeros(n, np.int64)
    order = _topo_order(adj)
    for j in order:
        preds = np.nonzero(adj[:, j])[0]
        if len(preds):
            es[j] = max(es[p] + duration[p] for p in preds)
    lf = np.full(n, max_total_time, np.int64)
    for j in order[::-1]:
        succs = np.nonzero(adj[j])[0]
        if len(succs):
            lf[j] = min(lf[s] - duration[s] for s in succs)
    return es, lf


def make_rcpsp(duration, resources, capacity, adj, max_total_time: int | None = None,
               *, device=None) -> RCPSPData:
    """One instance from its arrays; ``t_max`` defaults to the sum of the
    durations, the serial schedule's length."""
    duration = np.asarray(duration, np.int64)
    resources = np.asarray(resources, np.int64)
    capacity = np.asarray(capacity, np.int64)
    adj = np.asarray(adj, np.int64)
    if max_total_time is None:
        max_total_time = int(duration.sum())
    es, lf = _es_lf(duration, adj, max_total_time)
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return RCPSPData(t(duration), t(resources), t(capacity), t(adj), t(es), t(lf),
                     int(max_total_time))


def stack_rcpsp(datas: list[RCPSPData], t_max: int | None = None, *,
                device=None) -> RCPSPData:
    """Instances of one size stacked to ``[B, ...]`` on ``device``, with the
    horizon ``t_max`` (the largest of theirs by default). Only ``t_max``
    changes: each ``latest_finish`` keeps its instance's own horizon, as the
    JAX evaluation's ``_replace(t_max=...)`` keeps it."""
    t_max = max(d.t_max for d in datas) if t_max is None else t_max
    return RCPSPData(*(torch.stack([d[i] for d in datas]).to(device) for i in range(6)),
                     t_max=int(t_max))


def parse_rcp(text: str, *, device=None) -> RCPSPData:
    """A PSPLIB ``.RCP`` file (read_RCPfile, rcpsp_inst.py:239-261; the
    successor ids are 1-based in the file)."""
    it = iter(text.split())
    n_jobs, n_res = int(next(it)), int(next(it))
    capacity = [int(next(it)) for _ in range(n_res)]
    duration = np.zeros(n_jobs, np.int64)
    resources = np.zeros((n_jobs, n_res), np.int64)
    adj = np.zeros((n_jobs, n_jobs), np.int64)
    for i in range(n_jobs):
        duration[i] = int(next(it))
        for r in range(n_res):
            resources[i, r] = int(next(it))
        for _ in range(int(next(it))):
            adj[i, int(next(it)) - 1] = 1
    if next(it, None) is not None:
        raise ValueError("trailing tokens in RCP file")
    if adj[:, 0].sum() or adj[-1].sum():
        raise ValueError("the first job must have no predecessor and the last no successor")
    return make_rcpsp(duration, resources, capacity, adj, device=device)


def load_psplib(archive: str, subset: str = "j30rcp", limit: int | None = None,
                test_size: int = 100, split: str = "test", *, device=None) -> list[RCPSPData]:
    """The instances of ``subset`` in a PSPLIB ``.tar.gz`` (load_dataset,
    rcpsp_inst.py:263-280): the members named ``<subset>*.RCP`` in sorted
    order, the first ``test_size`` the test split and the rest the train
    split, then the first ``limit`` of the split."""
    out = []
    with tarfile.open(archive) as tf:
        names = sorted(n for n in tf.getnames() if n.startswith(subset) and n.endswith(".RCP"))
        names = names[:test_size] if split == "test" else names[test_size:]
        if limit:
            names = names[:limit]
        for name in names:
            out.append(parse_rcp(tf.extractfile(name).read().decode(), device=device))
    return out


def check_schedule(data: RCPSPData, start_time) -> bool:
    """Whether the start times of one instance keep every precedence and,
    at every time step, every resource's capacity (rcpsp_inst.py:168-191)."""
    start = np.asarray(torch.as_tensor(start_time).cpu(), np.int64)
    dur = data.duration.cpu().numpy().astype(np.int64)
    res = data.resources.cpu().numpy().astype(np.int64)
    cap = data.capacity.cpu().numpy().astype(np.int64)
    adj = data.adj.cpu().numpy()
    for i in range(len(start)):
        for j in np.nonzero(adj[i])[0]:
            if start[i] + dur[i] > start[j]:
                return False
    usage = np.zeros((int((start + dur).max()) + 1, len(cap)), np.int64)
    for j in range(len(start)):
        usage[start[j]:start[j] + dur[j]] += res[j]
    return bool((usage <= cap[None, :]).all())


# ------------------------------------------------------------ the priors ---
def _succ_closure_sizes(adj: np.ndarray) -> np.ndarray:
    """Each activity's count of transitive successors (rcpsp_inst.py:32-38)."""
    reach = adj.astype(bool).copy()
    for j in _topo_order(adj)[::-1]:
        for s in np.nonzero(adj[j])[0]:
            reach[j] |= reach[s]
    return reach.sum(axis=1)


def _columns(col: torch.Tensor) -> torch.Tensor:
    """A column prior ``[..., n]`` broadcast over the rows, ``[..., n, n]``."""
    return col[..., None, :].expand(*col.shape, col.shape[-1])


def nlft_heuristic(data: RCPSPData) -> torch.Tensor:
    """The normalized latest-finish-time prior (rcpsp/aco.py:66-72)."""
    lf = data.latest_finish.float()
    return _columns(lf.amax(dim=-1, keepdim=True) - lf + 1.0)


def ngrpwa_heuristic(data: RCPSPData) -> torch.Tensor:
    """The normalized greatest-rank-positional-weight prior
    (rcpsp/aco.py:74-79): each activity's successor count, shifted to a
    least value of 1."""
    adj = data.adj.cpu().numpy().reshape(-1, data.n, data.n)
    sizes = np.stack([_succ_closure_sizes(a) for a in adj]).reshape(data.adj.shape[:-1])
    col = torch.as_tensor(sizes, dtype=torch.float32, device=data.adj.device)
    return _columns(col - col.amin(dim=-1, keepdim=True) + 1.0)


def nwrup_heuristic(data: RCPSPData, omega: float = 0.5) -> torch.Tensor:
    """The normalized weighted resource-utilization and precedence prior
    (rcpsp/aco.py:82-92)."""
    outdeg = data.adj.sum(dim=-1).float()
    util = torch.sum(data.resources.float() / data.capacity.float()[..., None, :], dim=-1)
    col = omega * outdeg + (1.0 - omega) * util
    return _columns(col - col.amin(dim=-1, keepdim=True) + 1.0)


def default_rcpsp_heuristic(data: RCPSPData) -> torch.Tensor:
    """The reference's default, ``nWRUP(0.3) / max * nGRPWA``
    (rcpsp/aco.py:152-155)."""
    h = nwrup_heuristic(data, omega=0.3)
    return h / h.amax(dim=(-2, -1), keepdim=True) * ngrpwa_heuristic(data)


# ------------------------------------------------------- seeded instances ---
def progen_rcp(rng: np.random.Generator, jobs: int = 30, resources: int = 4, *,
               max_duration: int = 10, succ: tuple[int, int] = (1, 3),
               factor: float = 0.5, strength: float = 0.3, max_request: int = 10) -> str:
    """A seeded instance in PSPLIB ``.RCP`` form, with ProGen's parameters
    (Kolisch, Sprecher and Drexl 1995, Management Science 41(10)), which
    PSPLIB's j30-j120 sets use: ``jobs`` real jobs between the two dummies,
    durations uniform on 1..``max_duration``, each job 1-3 successors among
    the later jobs, each job requesting each resource with probability
    ``factor`` (the resource factor; at least one), amounts uniform on
    1..``max_request``, and each capacity at resource strength ``strength``:
    ``k_min + round(strength (k_max - k_min))``, ``k_min`` the largest single
    request and ``k_max`` the peak of the earliest-start schedule's usage."""
    n = jobs + 2
    adj = np.zeros((n, n), np.int64)
    for i in range(1, jobs + 1):
        later = np.arange(i + 1, jobs + 1)
        if len(later):
            k = min(int(rng.integers(succ[0], succ[1] + 1)), len(later))
            adj[i, rng.choice(later, size=k, replace=False)] = 1
    for j in range(1, jobs + 1):
        if not adj[:, j].any():
            adj[0, j] = 1
        if not adj[j].any():
            adj[j, n - 1] = 1
    duration = np.zeros(n, np.int64)
    duration[1:-1] = rng.integers(1, max_duration + 1, jobs)
    uses = rng.random((jobs, resources)) < factor
    uses[~uses.any(axis=1), rng.integers(0, resources)] = True
    req = np.zeros((n, resources), np.int64)
    req[1:-1] = np.where(uses, rng.integers(1, max_request + 1, (jobs, resources)), 0)
    es, _ = _es_lf(duration, adj, int(duration.sum()))
    profile = np.zeros((int((es + duration).max()) + 1, resources), np.int64)
    for j in range(n):
        profile[es[j]:es[j] + duration[j]] += req[j]
    k_min, k_max = req.max(axis=0), profile.max(axis=0)
    capacity = k_min + np.round(strength * (k_max - k_min)).astype(np.int64)
    lines = [f"{n} {resources}", " ".join(map(str, capacity))]
    for j in range(n):
        succs = (np.nonzero(adj[j])[0] + 1).tolist()
        lines.append(" ".join(map(str, [duration[j], *req[j], len(succs), *succs])))
    return "\n".join(lines) + "\n"


def write_psplib(archive: str, texts: list[str], subset: str = "j30rcp") -> None:
    """A ``.tar.gz`` of ``.RCP`` texts named ``<subset>/<subset[:-3]>_<i>.RCP``
    in :func:`load_psplib`'s sorted order."""
    import io

    with tarfile.open(archive, "w:gz") as tf:
        for i, text in enumerate(texts):
            data = text.encode()
            info = tarfile.TarInfo(f"{subset}/{subset[:-3]}_{i + 1:04d}.RCP")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
