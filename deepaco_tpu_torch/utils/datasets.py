"""Instance generators and the reference's golden TSP files (counterpart of
``deepaco_tpu/utils/datasets.py``).

The golden TSP sets are read from ``$DEEPACO_REFERENCE_DATA/tsp/``, where
the JAX package's variable points (datasets.py:18-38), and only when it is
set: this repository holds none of the reference's data.
"""
from __future__ import annotations

import os

import numpy as np
import torch

REFERENCE_DATA_VAR = "DEEPACO_REFERENCE_DATA"


def reference_path(var: str, *parts: str) -> str:
    """``$var/<parts>``, a file of the reference's data; ``FileNotFoundError``
    naming the variable when it is unset, or the file when it is missing."""
    root = os.environ.get(var)
    if not root:
        raise FileNotFoundError(f"set {var} to read {'/'.join(parts)} (the reference's "
                                "data); this repository does not hold it")
    path = os.path.join(root, *parts)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} does not exist (from {var})")
    return path


def load_pt_tensor(path: str) -> np.ndarray:
    """A ``torch.save``-d tensor, or list of tensors (stacked), as numpy;
    ``torch.load`` with ``weights_only=True``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, (list, tuple)):
        return np.stack([t.numpy() for t in obj])
    return obj.numpy()


def load_tsp_dataset(n_node: int, split: str = "test") -> np.ndarray:
    """The reference's golden TSP set ``tsp/{split}Dataset-{n}.pt`` under
    ``$DEEPACO_REFERENCE_DATA`` as ``[instances, n, 2]`` coordinates
    (tsp/utils.py:38-54)."""
    name = {"test": "testDataset", "val": "valDataset"}[split]
    return load_pt_tensor(reference_path(REFERENCE_DATA_VAR, "tsp", f"{name}-{n_node}.pt"))


def uniform_coords(n: int, generator: torch.Generator, *, batch: int | None = None,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """U(0,1)^2 coordinates ``[N, 2]`` (or ``[batch, N, 2]``), drawn from
    ``generator`` on the generator's own device and then moved to ``device``."""
    shape = (n, 2) if batch is None else (batch, n, 2)
    coords = torch.rand(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
    return coords if device is None else coords.to(device)


def distance_matrix(coords: torch.Tensor, diag: float = 1e9) -> torch.Tensor:
    """Euclidean distances ``[..., N, N]`` with a large diagonal sentinel
    (1e9 for TSP); ``+1e-20`` under the sqrt as in the reference.

    Every step is one correctly rounded f32 operation, so the values equal
    the JAX package's bit for bit. torch's vectorised CPU ``sqrt`` is not
    correctly rounded (one ulp off in about 0.7% of entries), so the root
    is taken in f64 and rounded once to f32, which is exact on any device
    (f64 carries more than twice f32's 24 bits)."""
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    sq = torch.sum(diff * diff, dim=-1) + 1e-20
    d = torch.sqrt(sq.double()).to(sq.dtype)
    n = coords.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=coords.device)
    return torch.where(eye, torch.full_like(d, diag), d)
