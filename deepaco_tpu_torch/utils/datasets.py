"""Instance generators (counterpart of ``deepaco_tpu/utils/datasets.py``)."""
from __future__ import annotations

import torch


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
