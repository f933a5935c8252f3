"""Multi-process bootstrap and meshes (port of
``sift_pyocl_tpu/parallel/multihost.py``).

The entry point for the distributed BA (``sfm/distributed.py``) across
processes and hosts: ``initialize_multihost`` starts the
``torch.distributed`` process group where the JAX package calls
``jax.distributed.initialize``, and the BA's camera sums are all-reduced
over that group (NCCL over NVLink within a host and the network across
hosts) where the JAX package ``psum``s them over ICI and DCN.  A lost
process fails the job; the controller restarts it and the state reloads
from ``sfm/checkpoint.py``'s snapshots.
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops import resolve_device

logger = logging.getLogger(__name__)

# launcher environments that name the world's size and this process's rank
_ENV_WORLDS = (("WORLD_SIZE", "RANK"), ("SLURM_NTASKS", "SLURM_PROCID"),
               ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"))


def _init_method(address: Optional[str]) -> str:
    """A ``host:port`` coordinator as a TCP rendezvous; a URL
    (``tcp://``, ``file://``, ``env://``) as it is; None as ``env://``
    (``MASTER_ADDR`` / ``MASTER_PORT``)."""
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """``torch.distributed.init_process_group`` with the launcher's
    environment as defaults; a no-op in a job that is provably one process.
    Returns (rank, world size).

    Explicit arguments win (a coordinator address needs a process count).
    Otherwise the environment counts only where it names more than one
    worker (torchrun's ``WORLD_SIZE`` / ``RANK`` with
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``SLURM_NTASKS`` / ``SLURM_PROCID``,
    ``OMPI_COMM_WORLD_SIZE`` / ``OMPI_COMM_WORLD_RANK``).  A group that is
    already initialised is taken as it is.  `backend` is the caller's;
    without one, NCCL where there is a CUDA card and gloo where there is
    none (no backend is swapped for another on failure)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = rank = None
    if num_processes is not None:
        if num_processes > 1:
            world, rank = num_processes, process_id
    else:
        for size_key, rank_key in _ENV_WORLDS:
            size = os.environ.get(size_key, "")
            if size.isdigit() and int(size) > 1:
                world, rank = int(size), int(os.environ[rank_key])
                break
    if world is None:
        if coordinator_address is not None:
            raise ValueError("a coordinator address needs num_processes (or a launcher's "
                             "WORLD_SIZE, SLURM_NTASKS or OMPI_COMM_WORLD_SIZE)")
        return 0, 1
    if rank is None:
        raise ValueError("a multi-process job needs process_id")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    logger.info("init_process_group: %s, rank %d of %d, %s", backend, rank, world,
                _init_method(coordinator_address))
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def local_rank() -> int:
    """This process's index on its host: the launcher's (torchrun, SLURM,
    Open MPI), else its global rank, else 0."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if os.environ.get(key, "").isdigit():
            return int(os.environ[key])
    return dist.get_rank() if dist.is_initialized() else 0


class BAMesh(NamedTuple):
    """The sharded BA's 1-D mesh as one rank sees it: the process group
    whose ranks hold the shards (None: one process, no collective) and this
    rank's device."""

    group: Optional[dist.ProcessGroup]
    device: torch.device
    axis_names: Tuple[str, ...] = ("ba",)

    @property
    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)


def global_ba_mesh(axis: str = "ba",
                   device: Optional[Union[str, torch.device]] = None) -> BAMesh:
    """The sharded BA's mesh over every rank of the job (the world group;
    none in one process).  The rank's device is `device`, else
    ``cuda:{local_rank % device_count}`` (ranks may share a card; raises
    without one)."""
    group = dist.group.WORLD if dist.is_initialized() else None
    if device is None:
        resolve_device(None)            # raises without a CUDA card
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return BAMesh(group, resolve_device(device), (axis,))


class DeviceMesh(NamedTuple):
    """An n-D grid of devices (devices may repeat) and its axis names."""

    devices: np.ndarray              # object array of torch.device
    axis_names: Tuple[str, ...]


def frames_x_ba_mesh(n_frames_axis: int, axes=("frames", "ba"),
                     devices: Optional[Sequence[Union[str, torch.device]]] = None
                     ) -> DeviceMesh:
    """2-D mesh: the frame-parallel frontend on one axis, the sharded BA on
    the other, over `devices` (every visible CUDA device where none are
    given; raises without one)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = np.empty(len(devices), dtype=object)
    devs[:] = [resolve_device(d) for d in devices]
    n = devs.size
    if n % n_frames_axis:
        raise ValueError(f"{n} devices not divisible by {n_frames_axis}")
    return DeviceMesh(devs.reshape(n_frames_axis, n // n_frames_axis), tuple(axes))
