"""Bringing up the process group of a multi-process run (torch).

Counterpart of ``biograph_tpu/parallel/distributed.py``: one coordinator,
N processes, every bulk datum moving through ``torch.distributed``
collectives.  The JAX package reads its coordinator, world size and rank from
``BGT_COORDINATOR``, ``BGT_NUM_PROCESSES`` and ``BGT_PROCESS_ID``; here they
are arguments (the CLI's ``--coordinator``, ``--num-processes`` and
``--process-id``).  A run of one process brings up nothing, so the same
pipeline code runs unchanged on one card.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

from biograph_tpu_torch import resolve_device

DEFAULT_COORDINATOR = "localhost:12421"


@dataclass
class DistContext:
    num_processes: int
    process_id: int
    initialized: bool  # whether this call brought the process group up
    device: torch.device  # where this process's tensors live


def initialize(
    coordinator: str = DEFAULT_COORDINATOR,
    num_processes: int = 1,
    process_id: int = 0,
    backend: str | None = None,
    device="cuda",
    timeout_s: float = 600.0,
) -> DistContext:
    """Bring up ``torch.distributed`` when more than one process runs; a
    no-op otherwise.  Call once, on every process, before any collective.

    coordinator: ``host:port`` of process 0 (a TCP rendezvous), or an
    ``init_method`` URL (``tcp://...``, ``file://...``).  backend: ``nccl``
    for a CUDA device, ``gloo`` for the CPU, unless given.  A CUDA device
    without an index becomes card ``process_id % device_count`` (one process
    a card on one host)."""
    dev = resolve_device(device)
    if num_processes <= 1:
        return DistContext(num_processes=1, process_id=0, initialized=False, device=dev)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a world of {num_processes}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None,
    )
    return DistContext(
        num_processes=dist.get_world_size(), process_id=dist.get_rank(),
        initialized=True, device=dev,
    )


def shutdown(ctx: DistContext) -> None:
    """Tear down the process group ``initialize`` brought up, if it did."""
    if ctx.initialized and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Processes in the run: the process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_shapes: dict[str, int] | None = None, shards_per_rank: int = 1, device="cuda"):
    """The global mesh over every process's shards (``mesh.Mesh``).

    axis_shapes like {'data': -1, 'model': 4}: one axis may be -1 (inferred
    from the world size times ``shards_per_rank``).  Defaults to
    {'data': -1}."""
    from biograph_tpu_torch.parallel.mesh import Mesh

    return Mesh.build(axis_shapes or {"data": -1}, process_count(), process_index(), shards_per_rank, device)
