"""Multi-process bootstrap and global-array plumbing (counterpart of
``mlamg_tpu/parallel/distributed.py``).

Every process runs the same program.  :func:`initialize` joins the
processes into one ``torch.distributed`` group, after which
:func:`mlamg_torch.parallel.make_mesh` spans every process's shards;
:func:`make_global` splits a host array that every process holds alike
into this process's shards, :func:`gather_global` returns the full array
on every process, and :func:`broadcast_from_coordinator` hands process
0's value to all.  With one process everything is local.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from mlamg_torch.device import resolve_device
from mlamg_torch.parallel import _comm
from mlamg_torch.parallel.mesh import Mesh, Sharding

# this process's shard device and count, set by initialize (the process
# group itself is process-wide state of torch.distributed)
_LOCAL: dict = {}


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_count: int | None = None,
               device=None) -> None:
    """Join the process group (idempotent).

    The arguments default to torch's own variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (together the coordinator's ``host:port``),
    ``WORLD_SIZE`` and ``RANK``.  Without a coordinator address this is a
    no-op.  Each process holds ``local_device_count`` shards (default 1) on
    one device: on CUDA (the default ``device``) card ``rank % count``,
    over NCCL; with ``device="cpu"`` the CPU, over gloo.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if coordinator_address is None:
        return
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _LOCAL.update(device=dev, count=local_device_count or 1)


def shutdown() -> None:
    """Leave the process group that :func:`initialize` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL.clear()


def local_devices(device=None):
    """This process's shard devices: in a process group the ones
    ``initialize`` set up; else the distinct cards of ``device`` (default
    CUDA), or None on the CPU (as many as a mesh needs)."""
    if _LOCAL:
        return [_LOCAL["device"]] * _LOCAL["count"]
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def make_global(x, mesh: Mesh, spec):
    """``x`` (a host array every process holds alike) on ``mesh``: split
    over ``spec``'s axis (a :class:`Sharding`, or ``"row"``/``"pop"``;
    each process keeps only its shards), or with ``spec`` None a tensor on
    this process's first shard device."""
    axis = spec.axis if isinstance(spec, Sharding) else spec
    if axis is None:
        first = next(d for d in mesh.devices.reshape(-1) if d is not None)
        return _comm.as_tensor(x).to(first)
    return _comm.split(np.asarray(x), _comm.layout(mesh, axis))


def gather_global(x, mesh: Mesh | None = None) -> np.ndarray:
    """Full host copy (on every process) of a sharded array; the inverse
    of :func:`make_global`."""
    return _comm.to_numpy(x)


def broadcast_from_coordinator(tree: Any) -> Any:
    """Process 0's value (any picklable tree) on every process."""
    if process_count() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def multihost_population_eval(fitness_vmapped: Callable, mesh: Mesh) -> Callable:
    """Population-sharded fitness across processes: each process
    evaluates its pop shards of the (identical) host population, and the
    (P,) fitness comes back as a host array on every process."""
    from mlamg_torch.parallel.pop_parallel import shard_population_eval

    sharded = shard_population_eval(fitness_vmapped, mesh)

    def evaluate(population) -> np.ndarray:
        return sharded(population).cpu().numpy()

    return evaluate
