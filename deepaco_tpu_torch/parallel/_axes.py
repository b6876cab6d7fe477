"""What a rank knows of its place on a mesh: its device, an axis's index,
its instance block and the block's seed. Shared by ``parallel/`` and
``train.drivers.evaluate_family(mesh=)``; imports nothing of ``train/``."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

_MIX = 0x9E3779B97F4A7C15     # an odd 64-bit constant: neighbouring indices land far apart


def rank_device() -> torch.device:
    """The device of this rank's tensors and collectives: its current card
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_dim(mesh, axis: str) -> int:
    """The index of the dimension named ``axis``."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}: {names}")
    return names.index(axis)


class InstanceBlock(NamedTuple):
    """This rank's coordinate ``index`` on an axis of ``count`` ranks."""

    index: int
    count: int

    def rows(self, b: int) -> slice:
        """The contiguous rows of a batch of ``b`` this rank holds (the
        layout of JAX's ``P("instance")``); refuses a ``b`` the axis does not
        divide."""
        if b % self.count:
            raise ValueError(f"a batch of {b} does not split over {self.count} ranks")
        size = b // self.count
        return slice(self.index * size, (self.index + 1) * size)


def instance_block(mesh, axis: str = "instance") -> InstanceBlock:
    """This rank's place on ``mesh``'s ``axis``."""
    dim = mesh_dim(mesh, axis)
    return InstanceBlock(mesh.get_local_rank(dim), mesh.size(dim))


def block_seed(seed: int, index: int) -> int:
    """The seed of instance block ``index``'s generator: ``seed`` itself for
    block 0 (so a one-rank mesh gives the unsharded run), ``index`` times an
    odd 64-bit constant added for the others."""
    return (seed + index * _MIX) % 2**63
