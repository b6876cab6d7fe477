"""Golden fixed-seed evaluation sets (counterpart of
``deepaco_tpu/utils/golden.py``; the other families wait for their slices).

The reference commits no CVRP test files: its writer (cvrp/utils.py:42-53)
seeds torch's CPU generator once and draws 100 instances per scale in the
order 20, 100, 500. This module repeats the same draws in the same order, so
its instances are the reference's own, made with no file.
"""
from __future__ import annotations

import numpy as np
import torch

CVRP_SCALES = (20, 100, 500)


def cvrp_test(n: int, count: int = 100, seed: int = 123456) -> dict:
    """The CVRP test set of scale ``n`` as stacked numpy arrays: ``coords
    [count, n+1, 2]`` (depot (0.5, 0.5) first), ``dist [count, n+1, n+1]``
    (diagonal 1e-10) and ``demand [count, n+1]`` (integers 1..9, depot 0),
    all f32. The draws of the smaller scales are consumed first."""
    if n not in CVRP_SCALES:
        raise ValueError(f"unknown CVRP scale {n}; the writer makes {CVRP_SCALES}")
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
