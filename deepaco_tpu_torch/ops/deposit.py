"""The all-ant deposit matrix of one Ant System update (counterpart of
``deepaco_tpu/ops/pallas_kernels.py:313-366``, ``tour_deposit_pallas``).

Over paths ``[..., L, A]`` and amounts ``[..., A]``:

    D[..., u, v] = sum_a amounts[..., a] * #{l : (u, v) is edge l of ant a}

one direction only. Cyclic paths have the ``L`` edges ``(path[i],
path[i-1])``, open paths the ``L-1`` edges ``(path[i], path[i+1])``; a
repeated edge (a CVRP ant parked on the depot) deposits once per occurrence.

- :func:`tour_deposit_plain`: ``scatter_add_`` in PyTorch;
- :func:`tour_deposit`: the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches kernel K8 (``csrc/tour_deposit.cu``: a bucketing pass
  that groups the edges by (row, ant), then one warp a row) or raises. K8
  adds the ants in order and is deterministic; it equals ``scatter_add_`` on
  the CPU (ant-major, one add at a time) bit for bit.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.ops import _build


def tour_edges(paths: torch.Tensor, cyclic: bool = True):
    """Edge endpoints ``(u, v)``, each ``[..., A, L']``: the ``L`` cyclic
    edges ``(path[i], path[i-1])`` or the ``L-1`` directed consecutive ones."""
    u = paths.transpose(-1, -2).long()
    if cyclic:
        return u, torch.roll(u, shifts=1, dims=-1)
    return u[..., :-1], u[..., 1:]


def tour_deposit_plain(paths: torch.Tensor, amounts: torch.Tensor, n: int, *,
                       cyclic: bool = True) -> torch.Tensor:
    """``D [..., n, n]`` f32 by one ``scatter_add_`` over every ant's edges."""
    u, v = tour_edges(paths, cyclic)
    lead = paths.shape[:-2]
    w = amounts[..., None].expand(u.shape).float()
    d = torch.zeros((*lead, n * n), dtype=torch.float32, device=paths.device)
    d.scatter_add_(-1, (u * n + v).flatten(-2), w.flatten(-2))
    return d.reshape(*lead, n, n)


def tour_deposit(paths: torch.Tensor, amounts: torch.Tensor, n: int, *,
                 cyclic: bool = True) -> torch.Tensor:
    """``D [..., n, n]`` f32 over ``paths [..., L, A]`` (ids in ``[0, n)``)
    and ``amounts [..., A]``; on CUDA one launch of kernel K8, where an id
    out of range stops the kernel with a device-side assert."""
    if paths.device.type == "cpu":
        return tour_deposit_plain(paths, amounts, n, cyclic=cyclic)
    _build.require_cuda("tour_deposit", paths, amounts)
    lead, (l, a) = paths.shape[:-2], paths.shape[-2:]
    if amounts.shape != (*lead, a):
        raise ValueError(f"tour_deposit: amounts {tuple(amounts.shape)} do not "
                         f"match paths {tuple(paths.shape)}")
    paths = paths.long().reshape(-1, l, a).contiguous()
    amounts = amounts.float().reshape(-1, a).contiguous()
    b = paths.shape[0]
    if b * a == 0 or l < (1 if cyclic else 2):         # no edges
        return torch.zeros((*lead, n, n), dtype=torch.float32, device=paths.device)
    dev = paths.device
    out = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    records = torch.empty((b, l * a, 2), dtype=torch.int32, device=dev)
    ends = torch.empty((b, n * a + a), dtype=torch.int32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("deepaco_tour_deposit", [P] * 5 + [I] * 5 + [P])
    rc = fn(paths.data_ptr(), amounts.data_ptr(), out.data_ptr(), records.data_ptr(),
            ends.data_ptr(), b, l, a, n, int(cyclic), _build.stream_ptr(dev))
    _build.check(rc, "deepaco_tour_deposit")
    tour_deposit.launches += 1
    return out.reshape(*lead, n, n)


tour_deposit.launches = 0
