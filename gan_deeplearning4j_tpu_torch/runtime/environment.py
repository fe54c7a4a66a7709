"""The process group and the data mesh — counterpart of
``gan_deeplearning4j_tpu/runtime/environment.py`` (``backend_info``,
``initialize_distributed``, ``TpuEnvironment.make_mesh``).

The JAX package runs SPMD in one process over a ``jax.sharding.Mesh`` and
XLA inserts the collectives. The port runs one process per rank over
``torch.distributed``; a :class:`DataMesh` holds what the JAX mesh held
for the trainers: the process group, this process's ``rank`` in it, the
``size`` of the ``data`` axis, the ``device`` this rank computes on, and
the ``backend``. This module is the only place that makes one.

Device and backend rules:

- on the card the default is NCCL, one rank per card on
  ``cuda:LOCAL_RANK``. NCCL asked for with more ranks on a host than it
  has cards raises; it never falls back to gloo;
- gloo runs on the CPU (``use_accelerator=False``, as the tests ask), and
  on the card only where the caller names it: four gloo ranks may share
  one card (the reference's ``local[4]``, four workers on one host), each
  on ``cuda:LOCAL_RANK % cards``. gloo's collectives on CUDA tensors go
  through host buffers (``parallel/collectives.py``).

Where the group comes from, first match wins:

- a coordinator (the JAX package's keywords ``coordinator_address``,
  ``num_processes``, ``process_id``): N processes, on one host or many,
  meet at a ``torch.distributed.TCPStore`` whose master, process 0, listens
  at ``host:port``. The caller's ``timeout`` bounds the master's wait for
  every process and each client's wait for the master. torchrun's
  variables are ignored, so a process started from a torchrun rank does
  not join that rank's group; under NCCL process ``i`` takes card
  ``i % cards`` (processes that share a host need a card each);
- ``rank``, ``world_size`` and ``init_file`` (a ``FileStore``) from the
  caller, as ``parallel/launch.py`` passes them;
- torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``
  (an ``env://`` rendezvous);
- with none of these, a world of one on a ``FileStore`` in a fresh
  temporary directory: a real process group whose collectives are made,
  so a run with ``distributed != "none"`` never takes a path that skips
  them.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")


def backend_info() -> dict:
    """The execution backend and the process group, for logging (the JAX
    package's ``backend_info``)."""
    cuda = torch.cuda.is_available()
    info = {
        "platform": "gpu" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else [],
        "distributed": dist.is_available() and dist.is_initialized(),
    }
    if info["distributed"]:
        info.update(backend=dist.get_backend(), process_index=dist.get_rank(),
                    process_count=dist.get_world_size())
    else:
        info.update(backend=None, process_index=0, process_count=1)
    return info


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def _check_nccl(local_world: int) -> None:
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_world > cards:
        raise RuntimeError(
            f"NCCL needs one card per rank: {local_world} ranks on this host, "
            f"{cards} cards; name backend='gloo' to share a card")


def backend_for(world_size: int, use_accelerator: bool = True) -> str:
    """The backend of a ``world_size``-rank mesh on this host: NCCL where
    the host has a card per rank, gloo otherwise (ranks sharing a card, or
    the CPU under ``use_accelerator=False``)."""
    if use_accelerator and torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def _coordinator_store(address: str, num_processes: int, process_id: int,
                       timeout: Optional[float]):
    """The ``TCPStore`` of a coordinator rendezvous: process 0 listens at
    ``host:port`` and waits for the others; every other process connects
    to it."""
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be host:port, not {address!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside {num_processes} processes")
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    return dist.TCPStore(host.strip("[]"), int(port), num_processes, is_master=process_id == 0,
                         wait_for_workers=True, **kwargs)


def initialize_distributed(rank: Optional[int] = None, world_size: Optional[int] = None,
                           init_file: Optional[str] = None, backend: Optional[str] = None,
                           use_accelerator: bool = True, *,
                           coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout: Optional[float] = None) -> dict:
    """Join (or make) the default process group; a no-op when one exists.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` this process meets the others at process 0's
    ``TCPStore``, ``timeout`` seconds at most (None: torch's default), and
    ``rank`` / ``world_size`` / ``init_file`` and torchrun's variables are
    not read. Otherwise arguments left None come from torchrun's variables;
    where those are absent too, this process is rank 0 of a world of one.
    ``init_file`` names a ``FileStore`` path (no TCP port); without it
    torchrun's ``MASTER_ADDR`` is used, or, for a world of one, a file in a
    fresh temporary directory. ``backend`` defaults to NCCL on the card and
    gloo on the CPU. Returns :func:`backend_info`, which is logged."""
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    if not dist.is_initialized():
        coordinated = coordinator_address is not None
        if coordinated:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator needs num_processes and process_id")
            rank, world_size, local_rank, local_world = process_id, num_processes, process_id, 1
        else:
            rank = _env_int("RANK") if rank is None else rank
            world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
            rank = 0 if rank is None else rank
            world_size = 1 if world_size is None else world_size
            local_rank = _env_int("LOCAL_RANK")
            local_rank = rank if local_rank is None else local_rank
            local_world = _env_int("LOCAL_WORLD_SIZE")
            local_world = world_size if local_world is None else local_world
        backend = backend or ("nccl" if use_accelerator else "gloo")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
        if backend == "nccl":
            if not use_accelerator:
                raise ValueError("NCCL runs on the card only; the CPU takes backend='gloo'")
            _check_nccl(local_world)
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
        if coordinated:
            store = _coordinator_store(coordinator_address, world_size, rank, timeout)
            kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
            dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                    **kwargs)
        elif init_file is not None:
            store = dist.FileStore(init_file, world_size)
            dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        elif os.environ.get("MASTER_ADDR"):
            dist.init_process_group(backend, init_method="env://", rank=rank,
                                    world_size=world_size)
        elif world_size == 1:
            path = os.path.join(tempfile.mkdtemp(prefix="gdt_pg_"), "store")
            dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0, world_size=1)
        else:
            raise ValueError(
                f"rank {rank} of {world_size}: give init_file (a FileStore path), a "
                f"coordinator_address, or torchrun's MASTER_ADDR / MASTER_PORT")
    info = backend_info()
    logger.info("Distributed runtime: %s", info)
    return info


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the ``data`` axis: the process group (None means
    the default group), this rank, the axis size, the device this rank
    computes on, and the backend (``"nccl"`` or ``"gloo"``)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = "data"

    @property
    def staged(self) -> bool:
        """True where the collectives go through host buffers: gloo on
        CUDA tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def capturable(self) -> bool:
        """Whether the collectives can run inside a CUDA graph: NCCL's can,
        gloo's cannot (a host-side library)."""
        return self.backend == "nccl"

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of ``n`` global rows (the
        ``PartitionSpec("data")`` split); ``n`` must divide evenly."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(use_accelerator: bool = True, backend: Optional[str] = None,
              init_file: Optional[str] = None, *, coordinator_address: Optional[str] = None,
              num_processes: Optional[int] = None, process_id: Optional[int] = None,
              timeout: Optional[float] = None) -> DataMesh:
    """The data mesh over every rank of the default process group,
    initialising the group first when there is none (see
    :func:`initialize_distributed`, which takes the keywords). The device
    is ``cuda:LOCAL_RANK`` under NCCL, ``cuda:LOCAL_RANK % cards`` under gloo
    on the card (the rank stands for ``LOCAL_RANK`` under a coordinator),
    and the CPU under ``use_accelerator=False`` (gloo only)."""
    initialize_distributed(init_file=init_file, backend=backend, use_accelerator=use_accelerator,
                           coordinator_address=coordinator_address, num_processes=num_processes,
                           process_id=process_id, timeout=timeout)
    name = dist.get_backend()
    rank, size = dist.get_rank(), dist.get_world_size()
    local = None if coordinator_address is not None else _env_int("LOCAL_RANK")
    local = rank if local is None else local
    if not use_accelerator:
        if name != "gloo":
            raise ValueError(f"the CPU runs the gloo backend, not {name!r}")
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass use_accelerator=False "
                               "to run the mesh on the CPU explicitly")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = DataMesh(group=None, rank=rank, size=size, device=device, backend=name)
    logger.info("Mesh: %s=%d on %s over %s", mesh.axis, size, device, backend_info())
    return mesh
