"""Golden fixed-seed evaluation sets (counterpart of
``deepaco_tpu/utils/golden.py``). TSP's are the reference's committed files,
read from ``$DEEPACO_REFERENCE_DATA`` (``utils.datasets.load_tsp_dataset``).

The reference commits no CVRP, CVRP-NLS, OP, PCTSP, SMTWTP, SOP, BPP, MKP
or MKP-items test files: each writer (cvrp/utils.py:42-53,
cvrp_nls/utils.py:89-100, op/utils.py:73-83, pctsp/utils.py:50-59,
smtwtp/utils.py:32-44, sop/utils.py:68-81, bpp/utils.py:29-39,
mkp/utils.py:51-72, mkp_transformer/utils.py:46-67) seeds torch's CPU
generator once and draws its instances, scale after scale where it makes
several. This module repeats the same draws in the same order from a
``torch.Generator`` of its own, seeded as ``torch.manual_seed`` seeds the
global one, so its instances are the reference's, made with no file and
without touching torch's global generator. The MKP writers draw their
knapsack constraints from numpy's global stream, which the reference never
seeded; the JAX package seeds it with ``np_seed``, and this module draws the
same numbers from a ``numpy.random.RandomState(np_seed)`` of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from deepaco_tpu_torch.families import OP_MAX_LEN, PCTSP_KN, sop_masks
from deepaco_tpu_torch.utils.datasets import load_tsp_dataset

CVRP_SCALES = (20, 100, 500)
OP_SCALES = (100, 200, 300)
PCTSP_SCALES = (20, 100, 500)
SMTWTP_SCALES = (50, 100, 500)
SOP_SCALES = (20, 50, 100)
MKP_ITEMS_SCALES = (300, 500)
# the writers that make only these scales; BPP's and MKP's take any n,
# CVRP-NLS's any n >= 1
SCALES = {"cvrp": CVRP_SCALES, "op": OP_SCALES, "pctsp": PCTSP_SCALES,
          "smtwtp": SMTWTP_SCALES, "sop": SOP_SCALES, "mkp_items": MKP_ITEMS_SCALES}
# the CVRP-NLS vehicle capacity by scale (cvrp_nls/utils.py:5-10): the
# entry of the largest key at most n
CVRP_NLS_CAPACITY = {1: 10, 20: 30, 50: 40, 100: 50, 400: 150, 1000: 200, 2000: 300}


def _check(name: str, n: int) -> None:
    if n not in SCALES[name]:
        raise ValueError(f"unknown {name.upper()} scale {n}; the writer makes {SCALES[name]}")


def tsp_test(n: int, split: str = "test") -> dict:
    """The reference's TSP set of scale ``n`` (tsp/utils.py:47-54): ``coords
    [B, n, 2]`` and ``dist [B, n, n]`` (diagonal 1e9), f32, the distances by
    the JAX package's numpy expression (golden.py:30-39)."""
    coords = load_tsp_dataset(n, split)
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1)
    idx = np.arange(coords.shape[1])
    dist[:, idx, idx] = 1e9
    return {"coords": coords.astype(np.float32), "dist": dist.astype(np.float32)}


def cvrp_test(n: int, count: int = 100, seed: int = 123456) -> dict:
    """The CVRP test set of scale ``n`` as stacked numpy arrays: ``coords
    [count, n+1, 2]`` (depot (0.5, 0.5) first), ``dist [count, n+1, n+1]``
    (diagonal 1e-10) and ``demand [count, n+1]`` (integers 1..9, depot 0),
    all f32. The draws of the smaller scales are consumed first."""
    _check("cvrp", n)
    gen = torch.Generator().manual_seed(seed)
    for scale in CVRP_SCALES:
        coords_l, dem_l = [], []
        for _ in range(count):
            locations = torch.rand(size=(scale, 2), generator=gen)
            demands = torch.randint(1, 10, size=(scale,), generator=gen)
            coords_l.append(np.concatenate([[[0.5, 0.5]], locations.numpy()]))
            dem_l.append(np.concatenate([[0.0], demands.numpy()]))
        if scale == n:
            break
    coords = np.stack(coords_l).astype(np.float32)
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1)
    idx = np.arange(n + 1)
    dist[:, idx, idx] = 1e-10
    return {"coords": coords, "dist": dist.astype(np.float32),
            "demand": np.stack(dem_l).astype(np.float32)}


def cvrp_nls_capacity(n: int) -> int:
    """The vehicle capacity of CVRP-NLS instances with ``n`` customers."""
    if n < 1:
        raise ValueError(f"CVRP-NLS scale {n}: the capacity table starts at 1 customer")
    return [v for k, v in sorted(CVRP_NLS_CAPACITY.items()) if k <= n][-1]


def cvrp_nls_test(n: int, count: int = 100, seed: int = 123456) -> dict:
    """The CVRP-NLS test set of ``n`` customers: the generator seeded once
    for the call, then per instance ``n + 1`` f64 locations (node 0 the
    depot) and ``n`` integer demands 1..9 in f64, divided by the scale's
    capacity. ``coords [count, n+1, 2]``, ``dist`` (diagonal 1e-10) and
    ``demand [count, n+1]`` (0 at the depot) in f32, and ``capacity`` 1."""
    cap = cvrp_nls_capacity(n)
    gen = torch.Generator().manual_seed(seed)
    coords_l, dem_l = [], []
    for _ in range(count):
        locations = torch.rand(size=(n + 1, 2), dtype=torch.double, generator=gen)
        demands = torch.randint(1, 10, size=(n,), dtype=torch.double, generator=gen)
        coords_l.append(locations.numpy())
        dem_l.append(np.concatenate([[0.0], demands.numpy() / cap]))
    coords = np.stack(coords_l)
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1)
    idx = np.arange(n + 1)
    dist[:, idx, idx] = 1e-10
    return {"coords": coords.astype(np.float32), "dist": dist.astype(np.float32),
            "demand": np.stack(dem_l).astype(np.float32), "capacity": np.float32(1.0)}


def op_test(n: int, split: str = "test") -> dict:
    """The OP set of scale ``n`` (``split`` "test": seed 123456, 100
    instances; "val": seed 12345, 30): ``coords [count, n, 2]`` (node 0 the
    depot), ``dist`` (diagonal 1e9), ``prizes`` (by distance to the depot)
    and ``max_len [count]``, all f32."""
    _check("op", n)
    seed, count = (123456, 100) if split == "test" else (12345, 30)
    gen = torch.Generator().manual_seed(seed)
    for scale in OP_SCALES:
        coords = torch.rand(size=(count, scale, 2), generator=gen).numpy()
        if scale == n:
            break
    coords = coords.astype(np.float32)
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1)
    idx = np.arange(n)
    dist[:, idx, idx] = 1e9
    d0 = np.linalg.norm(coords - coords[:, :1], axis=-1)
    prizes = 1.0 + np.floor(99.0 * d0 / d0.max(axis=1, keepdims=True))
    prizes = prizes / prizes.max(axis=1, keepdims=True)
    return {"coords": coords, "dist": dist.astype(np.float32),
            "prizes": prizes.astype(np.float32),
            "max_len": np.full(count, OP_MAX_LEN[n], np.float32)}


def pctsp_test(n: int, count: int = 100, seed: int = 123456) -> dict:
    """The PCTSP set of ``n`` nodes and the depot: ``coords [count, n+1,
    2]``, ``dist`` (diagonal 0), ``prizes`` and ``penalties [count, n+1]``
    (0 at the depot), all f32."""
    _check("pctsp", n)
    gen = torch.Generator().manual_seed(seed)
    for scale in PCTSP_SCALES:
        coords_l, prize_l, pen_l = [], [], []
        k = PCTSP_KN[scale]
        for _ in range(count):
            coords_l.append(torch.rand((scale + 1, 2), generator=gen).numpy())
            prize_l.append(np.concatenate(
                [[0.0], torch.rand(size=(scale,), generator=gen).numpy()]))
            penalty = torch.rand(size=(scale,), generator=gen) * 3 * k / scale
            pen_l.append(np.concatenate([[0.0], penalty.numpy()]))
        if scale == n:
            break
    coords = np.stack(coords_l).astype(np.float32)
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1)
    return {"coords": coords, "dist": dist.astype(np.float32),
            "prizes": np.stack(prize_l).astype(np.float32),
            "penalties": np.stack(pen_l).astype(np.float32)}


def smtwtp_test(n: int, count: int = 100, seed: int = 123456) -> dict:
    """The SMTWTP set of ``n`` jobs: ``due_norm``, ``due = due_norm * n``,
    ``weights`` and ``processing [count, n]``, all f32; each instance draws
    due, weights and processing in that order."""
    _check("smtwtp", n)
    gen = torch.Generator().manual_seed(seed)
    for scale in SMTWTP_SCALES:
        rows = [[torch.rand(size=(scale,), generator=gen).numpy() for _ in range(3)]
                for _ in range(count)]
        if scale == n:
            break
    due_norm, weights, processing = (np.stack([r[i] for r in rows]).astype(np.float32)
                                     for i in range(3))
    return {"due_norm": due_norm, "due": (due_norm * n).astype(np.float32),
            "weights": weights, "processing": processing}


def sop_test(n: int, count: int = 100, seed: int = 123456) -> dict:
    """The SOP set of ``n`` nodes (node 0 the start): ``dist``, ``adj`` and
    ``prec [count, n, n]``, all f32. Each instance draws its cost matrix,
    then one uniform per candidate ordering pair (sop/utils.py:46-51)."""
    _check("sop", n)
    gen = torch.Generator().manual_seed(seed)
    for scale in SOP_SCALES:
        insts = [_sop_instance(gen, scale) for _ in range(count)]
        if scale == n:
            break
    return {k: np.stack([i[k] for i in insts]) for k in ("dist", "adj", "prec")}


def _sop_instance(gen: torch.Generator, n: int) -> dict:
    dist = torch.rand(size=(n, n), generator=gen)
    dist[1:, :] += dist[0, :].clone()
    pairs = [(0, i) for i in range(1, n)]
    a = list(range(1, n))
    precede = [set() for _ in range(n - 1)]
    for i in range(n - 3, -1, -1):
        for j in range(i + 1, n - 1):
            if torch.rand(size=(1,), generator=gen) > 0.2:
                continue
            precede[i].add(j)
            precede[i].update(precede[j])
        pairs.extend((a[i], a[j]) for j in precede[i])
    return {"dist": dist.numpy().astype(np.float32), **sop_masks(n, pairs)}


def bpp_test(n: int = 120, count: int = 100, seed: int = 123456) -> dict:
    """The BPP set of ``n`` items: ``demand [count, n+1]`` (sizes 20..100,
    the separator 0 first), f32."""
    gen = torch.Generator().manual_seed(seed)
    dems = [np.concatenate([[0.0], torch.randint(20, 101, size=(n,), generator=gen).numpy()])
            for _ in range(count)]
    return {"demand": np.stack(dems).astype(np.float32)}


def mkp_test(n: int = 50, count: int = 100, seed: int = 123456, np_seed: int = 0) -> dict:
    """The MKP set of ``n`` items in 5 dimensions: ``prize [count, n]`` and
    ``weight [count, n, 5]``, f32, each dimension scaled to the capacity
    ``n // 2`` by a constraint drawn uniformly between its largest weight and
    its sum (numpy's stream seeded with ``np_seed``)."""
    gen = torch.Generator().manual_seed(seed)
    nprng = np.random.RandomState(np_seed)
    m = 5
    prizes, weights = [], []
    for _ in range(count):
        prize = torch.rand(size=(n,), generator=gen)
        w = torch.rand(size=(n, m), generator=gen)
        constraints = np.array([nprng.uniform(float(w[:, j].max()), float(w[:, j].sum()))
                                for j in range(m)])
        weights.append(w.numpy() * (n // 2) / constraints[None, :])
        prizes.append(prize.numpy())
    return {"prize": np.stack(prizes).astype(np.float32),
            "weight": np.stack(weights).astype(np.float32)}


def mkp_items_test(n: int, count: int = 100, seed: int = 123456, np_seed: int = 0) -> dict:
    """The MKP-items set of ``n`` items in 5 dimensions (scales 300 and 500,
    drawn in that order): ``prize [count, n]`` and ``weight [count, n, 5]``,
    f32. Each instance draws its weights as ``[5, n]`` and divides each
    dimension by a constraint drawn uniformly between its largest weight
    and its sum (numpy's stream seeded with ``np_seed``), so that every
    capacity is 1."""
    _check("mkp_items", n)
    gen = torch.Generator().manual_seed(seed)
    nprng = np.random.RandomState(np_seed)
    m = 5
    for scale in MKP_ITEMS_SCALES:
        prices, weights = [], []
        for _ in range(count):
            price = torch.rand(size=(scale,), generator=gen)
            w = torch.rand(size=(m, scale), generator=gen)
            constraints = np.array([nprng.uniform(float(w[j].max()), float(w[j].sum()))
                                    for j in range(m)])
            weights.append((w.numpy() / constraints[:, None]).T)
            prices.append(price.numpy())
        if scale == n:
            break
    return {"prize": np.stack(prices).astype(np.float32),
            "weight": np.stack(weights).astype(np.float32)}


GOLDEN = {"tsp": tsp_test, "cvrp": cvrp_test, "op": op_test, "pctsp": pctsp_test, "smtwtp": smtwtp_test,
          "sop": sop_test, "bpp": bpp_test, "mkp": mkp_test, "cvrp_nls": cvrp_nls_test,
          "mkp_items": mkp_items_test}
