"""The slab mesh of the sharded mode and its multi-process runtime
(counterpart of masa_tpu/parallel/mesh.py).

A mesh is a row of column slabs: slab d runs on a torch device and is
owned by one process.  Within a process the slabs' boundary columns pass
as tensors (``.to(device)``); between processes they go over
``torch.distributed`` (``parallel/sharded``).  The process group runs on
``gloo``: what crosses a process boundary is small (a strip's boundary
column, 8 bytes a row, and a scalar best every round), it is staged
through pinned host memory either way, and NCCL refuses two ranks on one
card, which is how the sharded mode runs on a single GPU.

Unlike a JAX mesh, whose devices are distinct, several slabs may share a
device: a card runs their launches one after another.  On the CPU the
slabs are virtual, all on the host."""

from __future__ import annotations

import dataclasses
import datetime

import torch

from masa_tpu_torch.utils.devices import resolve_device

# seconds a process waits for its peers (rendezvous, a border, a reduce)
# before it fails
DIST_TIMEOUT = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[d]`` runs slab d, which process ``owners[d]`` owns;
    ``axis`` names the slab axis."""

    axis: str
    devices: tuple
    owners: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def owned(self, process: int) -> range:
        """The slabs of ``process``: a contiguous run, left to right."""
        own = [d for d, p in enumerate(self.owners) if p == process]
        return range(own[0], own[-1] + 1) if own else range(0)


def world() -> tuple[int, int]:
    """(this process's rank, the number of processes): (0, 1) without a
    process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def gather_objects(obj) -> list:
    """Every process's ``obj`` (picklable), in rank order: ``[obj]``
    without a process group."""
    _, procs = world()
    if procs == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * procs
    dist.all_gather_object(out, obj)
    return out


def make_mesh(n_devices: int | None = None, axis: str = "x",
              device="cuda") -> Mesh:
    """``n_devices`` slabs over the processes of the group, in contiguous
    runs (process p owns slabs ``p*n//P`` to ``(p+1)*n//P - 1``).  On
    CUDA slab d runs on ``cuda:{d % count}`` of its process, as
    ``parallel/fork.run_fork`` places workers (a device with an index puts
    every slab there); by default one slab a card.  On the CPU every slab
    is on the host; by default one a process."""
    dev = resolve_device(device)
    _, procs = world()
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = n_devices or procs * count
    if n < procs:
        raise ValueError(f"{n} slabs for {procs} processes: each process "
                         f"needs a slab")
    if dev.type == "cpu" or dev.index is not None:
        devs = (dev,) * n
    else:
        devs = tuple(torch.device("cuda", d % count) for d in range(n))
    return Mesh(axis, devs, tuple(d * procs // n for d in range(n)))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           timeout: float = DIST_TIMEOUT) -> None:
    """Join the process group of a multi-process run: ``gloo`` over TCP,
    process 0 listening at ``coordinator`` (host:port).  A no-op with one
    process.  A peer that does not answer within ``timeout`` seconds makes
    the call (or a later exchange) fail rather than hang."""
    if not num_processes or num_processes <= 1:
        return
    import torch.distributed as dist

    if not coordinator:
        raise ValueError("a multi-process run needs --coordinator host:port")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
