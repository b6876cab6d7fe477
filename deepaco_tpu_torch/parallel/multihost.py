"""Multi-process runtime: process groups, host-aware meshes, data feeding
(counterpart of ``deepaco_tpu/parallel/multihost.py``).

One process drives one card (the ``cuda`` device ``torch.cuda.set_device``
makes current) and ``torch.distributed`` joins them: NCCL between cards,
gloo between CPU processes.

* :func:`init_distributed`: one call a process, from its arguments or the
  ``DEEPACO_*`` variables, or from a launcher's (``torchrun``'s ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``LOCAL_RANK``).
* :func:`hybrid_mesh`: the ``(instance, ant)`` mesh with ``ant`` inside a
  host (consecutive local ranks) and ``instance`` across hosts.
* :func:`host_local_batch`: each rank hands over only its block of the
  instance axis.
* :func:`all_processes_mean`: the mean of a per-process scalar.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.parallel._axes import mesh_dim, rank_device
from deepaco_tpu_torch.parallel.mesh import make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device=None) -> torch.device | None:
    """Join this process to the group of ``num_processes`` ranks; returns the
    rank's device, or ``None`` when it stays a single process without a
    group.

    The arguments default to ``DEEPACO_COORDINATOR`` (``host:port``, or an
    ``init_method`` URL such as ``tcp://host:port`` or ``file:///path``),
    ``DEEPACO_NUM_PROCESSES`` and ``DEEPACO_PROCESS_ID``; failing those, to
    a launcher's ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` (``init_method="env://"``). With none of them set it stays a
    single process, as the JAX version does off a TPU pod. A one-rank group
    takes an explicit ``num_processes=1`` and no address: it meets on an
    in-process store, so it needs no port.

    ``device`` is ``cuda`` by default (NCCL; the rank's card,
    ``LOCAL_RANK`` or else ``process_id`` modulo the cards on the host, is
    made current first), ``cpu`` only when asked (gloo). A failed NCCL
    initialisation raises; it never falls back to gloo or the CPU. A second
    call, while the group lives, does nothing."""
    if dist.is_initialized():
        return rank_device()
    coordinator_address = coordinator_address or os.environ.get("DEEPACO_COORDINATOR")
    if num_processes is None and "DEEPACO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DEEPACO_NUM_PROCESSES"])
    if process_id is None and "DEEPACO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DEEPACO_PROCESS_ID"])
    launcher = coordinator_address is None and num_processes is None
    if launcher:
        if not all(v in os.environ for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return None
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if num_processes is None:
        raise ValueError("init_distributed: a coordinator address needs num_processes")
    process_id = 0 if process_id is None and num_processes == 1 else process_id
    if process_id is None:
        raise ValueError("init_distributed: process_id is required past one process")
    dev = resolve_device(device)
    kwargs = {"rank": process_id, "world_size": num_processes}
    if launcher:
        kwargs["init_method"] = "env://"
    elif coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    elif num_processes == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError("init_distributed: more than one process needs a coordinator address")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        # device_id binds the communicator to the card and creates it now, so
        # that a failed NCCL initialisation raises here
        dist.init_process_group("nccl", device_id=dev, **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)
    return dev


def hybrid_mesh(ant_parallelism: int | None = None, axis_names=("instance", "ant")):
    """The ``(instance, ant)`` mesh over every rank: ``ant`` spans
    ``ant_parallelism`` consecutive ranks of one host (all of the host's by
    default), so that its collectives stay on the host's links; ``instance``
    spans the hosts. A host's ranks are the launcher's ``LOCAL_WORLD_SIZE``,
    else 1 (a process a host, as the ``DEEPACO_*`` variables start them).
    With one process it is
    :func:`~deepaco_tpu_torch.parallel.mesh.make_mesh`'s."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if ant_parallelism is None:
        ant_parallelism = local
    if dist.is_initialized() and dist.get_world_size() > 1 and local % ant_parallelism:
        raise ValueError(f"hybrid_mesh: {ant_parallelism} ant ranks do not divide "
                         f"the {local} ranks of a host")
    return make_mesh(n_ant=ant_parallelism, axis_names=axis_names)


def host_local_batch(mesh, local_data: dict, axis: str = "instance") -> dict:
    """This rank's block of a batch sharded over ``axis``: every rank passes
    only its own rows (``global batch / axis size`` of them, the same count on
    every rank, which this checks) and gets them back as tensors on its
    device. No rank holds the whole batch."""
    dev = rank_device()
    sizes = {len(np.asarray(v)) for v in local_data.values()}
    if len(sizes) != 1:
        raise ValueError(f"host_local_batch: arrays of different leading sizes {sizes}")
    size = torch.tensor([sizes.pop()], device=dev)
    every = [torch.zeros_like(size) for _ in range(mesh.size(mesh_dim(mesh, axis)))]
    dist.all_gather(every, size, group=mesh.get_group(axis))
    if len({int(s) for s in every}) != 1:
        raise ValueError(f"host_local_batch: the ranks' blocks differ in size: "
                         f"{[int(s) for s in every]}")
    return {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in local_data.items()}


def all_processes_mean(x) -> float:
    """The mean over every rank of a per-rank scalar: each rank's value in
    float32, gathered, averaged in numpy."""
    dev = rank_device()
    mine = torch.tensor([float(x)], dtype=torch.float32, device=dev)
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return float(np.mean(torch.cat(every).cpu().numpy()))

