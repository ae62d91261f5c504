"""Device mesh (counterpart of ``mlamg_tpu/parallel/mesh.py``).

A :class:`Mesh` names two axes of parallelism over a ``(pop, row)`` array
of shards:

- ``pop``: population parallelism (the GA's fitness evaluations);
- ``row``: matrix-row partitioning (the halo-exchange axis).

Each shard is a ``torch.device`` owned by one process.  Several shards may
name the same card: these are virtual shards, the counterpart of the JAX
package's ``--xla_force_host_platform_device_count`` CPU devices, and the
consecutive shards of one device are held as one stacked tensor
(:mod:`mlamg_torch.parallel._comm`).  In a multi-process group (see
:func:`mlamg_torch.parallel.distributed.initialize`) process r owns the
shards ``r*L .. (r+1)*L - 1`` in row-major mesh order, L being its local
shard count, and holds no device of the others.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices`` (pop, row): each shard's ``torch.device`` (None where
    another process owns it); ``ranks`` (pop, row): the owning process;
    ``rank``: this process."""

    devices: np.ndarray
    ranks: np.ndarray
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {"pop": int(self.devices.shape[0]), "row": int(self.devices.shape[1])}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a mesh splits an array's first dimension: over ``axis`` (``"pop"``
    or ``"row"``), or not at all (None: replicated)."""

    mesh: Mesh
    axis: str | None


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: a CUDA device was named and CUDA is not available")
        index = torch.cuda.current_device() if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"make_mesh: {d} does not exist "
                             f"({torch.cuda.device_count()} CUDA devices)")
        d = torch.device("cuda", index)
    return d


def make_mesh(pop: int | None = None, row: int = 1, devices=None, device=None) -> Mesh:
    """Mesh over this process's devices with ('pop', 'row') axes.

    ``devices`` lists this process's shards, repeats allowed (virtual
    shards).  By default they are the distinct cards of ``device`` (default
    CUDA: every visible card), or on the CPU the CPU repeated as often as
    the mesh needs, as the JAX tests' 8 virtual CPU devices are.  In a
    multi-process group they are the local shards that ``initialize`` set
    up, and the mesh spans every process's shards.  ``pop=None`` puts all
    remaining shards on the population axis.  Raises ValueError where
    ``pop * row`` exceeds the shards.
    """
    from mlamg_torch.parallel import distributed

    world, rank = distributed.process_count(), distributed.process_index()
    if devices is None:
        devices = distributed.local_devices(device)
        if devices is None:  # the CPU: as many as the mesh needs
            devices = [torch.device("cpu")] * ((1 if pop is None else pop) * row)
    local = [_as_device(d) for d in devices]
    n = world * len(local)
    if pop is None:
        if n % row:
            raise ValueError(f"make_mesh: {n} shards do not split into rows of {row}")
        pop = n // row
    if pop * row > n:
        raise ValueError(f"make_mesh: pop {pop} x row {row} exceeds the {n} shards")
    if world > 1 and pop * row != n:
        raise ValueError(f"make_mesh: a {world}-process mesh must use all {n} shards "
                         f"(pop {pop} x row {row})")
    owner = np.repeat(np.arange(world), len(local))[: pop * row]
    devs = np.empty(pop * row, dtype=object)
    for s in range(pop * row):
        devs[s] = local[s % len(local)] if owner[s] == rank else None
    return Mesh(devs.reshape(pop, row), owner.reshape(pop, row), rank)


def population_sharding(mesh: Mesh) -> Sharding:
    """Sharding for a (P, W) population: rows split over the pop axis."""
    return Sharding(mesh, "pop")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)
