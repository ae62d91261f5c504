"""The collectives that XLA supplies to the JAX package's ``shard_map``.

Every other module of ``mlamg_torch/parallel`` has a JAX file behind it;
this one stands in for the SPMD runtime.  An array split over a mesh axis
is a :class:`Sharded`: this process's *blocks*, each the consecutive
shards that one device holds, stacked along dim 0, so that 8 virtual
shards on one card are one ``(8, n_loc, ...)`` tensor and each operation
on them is one launch.

- Between shards of one block, an exchange is a slice of the stacked
  tensor; between blocks of one process, a ``.to(device)`` copy; between
  processes, ``torch.distributed`` (NCCL for CUDA tensors, gloo for CPU
  ones): ``all_gather_single`` for gathers and reductions,
  ``batch_isend_irecv`` for the ring neighbours' boundary rows.
- ``psum``/``pmax``/``pmin`` gather every shard's partial and reduce over
  the shards in shard order, so a result has the same bits whatever the
  split into blocks and processes.
- Within one process every exchange is a differentiable torch operation.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Block:
    """Shards ``start .. stop - 1`` of an axis, on ``device`` of process
    ``rank`` (``device`` is None in the other processes)."""

    start: int
    stop: int
    device: torch.device | None
    rank: int


@dataclasses.dataclass(frozen=True)
class Layout:
    """The shards of one mesh axis grouped into blocks."""

    num_shards: int
    blocks: tuple
    rank: int

    @property
    def local(self) -> tuple:
        return tuple(b for b in self.blocks if b.rank == self.rank)


def layout(mesh, axis: str) -> Layout:
    """The blocks of ``mesh``'s ``axis`` ("row" or "pop"); the other axis
    must have size 1."""
    other = "pop" if axis == "row" else "row"
    if mesh.shape[other] != 1:
        raise ValueError(f"an array split over {axis!r} needs a mesh with {other} 1, "
                         f"got {mesh.shape}")
    devs, ranks = mesh.devices.reshape(-1), mesh.ranks.reshape(-1)
    blocks, start = [], 0
    for s in range(1, len(devs) + 1):
        if s == len(devs) or devs[s] != devs[start] or ranks[s] != ranks[start]:
            blocks.append(Block(start, s, devs[start], int(ranks[start])))
            start = s
    return Layout(len(devs), tuple(blocks), mesh.rank)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """An array whose dim 0 is split into ``layout.num_shards`` equal
    chunks: ``parts[i]`` holds the chunks of ``layout.local[i]`` on its
    device."""

    parts: tuple
    layout: Layout

    def map(self, fn) -> "Sharded":
        return Sharded(tuple(fn(p) for p in self.parts), self.layout)


def zip_map(fn, *xs: Sharded) -> Sharded:
    """``fn`` over the aligned blocks of Sharded arrays of one layout."""
    return Sharded(tuple(fn(*ps) for ps in zip(*(x.parts for x in xs))), xs[0].layout)


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; a host array as a tensor (copied where numpy
    holds it read-only)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.require(np.asarray(x), requirements="W"))


def split(x, lay: Layout, dtype=None) -> Sharded:
    """This process's blocks of ``x`` (a host array, or a tensor on any
    device; every process holds the same ``x``)."""
    x = as_tensor(x)
    S = lay.num_shards
    if x.shape[0] % S:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into {S} shards")
    c = x.shape[0] // S
    return Sharded(tuple(x[b.start * c:b.stop * c].to(device=b.device, dtype=dtype)
                         for b in lay.local), lay)


def _gather_single(out: torch.Tensor, inp: torch.Tensor) -> None:
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, inp)


def all_gather(x: Sharded) -> list:
    """Every shard's chunk, in shard order: one full tensor per local
    block, on that block's device."""
    parts, lay = x.parts, x.layout
    dev0 = parts[0].device
    mine = parts[0] if len(parts) == 1 else torch.cat([p.to(dev0) for p in parts])
    if dist.is_available() and dist.is_initialized():
        wire = mine.to(torch.uint8) if mine.dtype == torch.bool else mine.contiguous()
        out = wire.new_empty((wire.shape[0] * dist.get_world_size(),) + tuple(wire.shape[1:]))
        _gather_single(out, wire)
        full = out.to(torch.bool) if mine.dtype == torch.bool else out
    else:
        full = mine
    return [full if p.device == dev0 else full.to(p.device) for p in parts]


def _reduce(x: Sharded, op) -> list:
    return [op(full) for full in all_gather(x)]


def psum(x: Sharded) -> list:
    """Sum over the shards of their (s_d, ...) partials: one replicated
    result per local block."""
    return _reduce(x, lambda t: t.sum(0))


def pmax(x: Sharded) -> list:
    return _reduce(x, lambda t: t.amax(0))


def pmin(x: Sharded) -> list:
    return _reduce(x, lambda t: t.amin(0))


def ring_halo(x: Sharded, h: int, fill) -> Sharded:
    """Extend each shard's (n_loc, ...) chunk by h rows from each ring
    neighbour: the left neighbour's last h rows in front, the right
    neighbour's first h behind; ``fill`` beyond the chain's ends."""
    lay, parts = x.layout, x.parts
    n_loc = parts[0].shape[1]
    if not 0 < h <= n_loc:
        raise ValueError(f"halo {h} must lie in 1..{n_loc} (the rows of a shard)")
    local = lay.local
    pos = {b.start: i for i, b in enumerate(lay.blocks)}
    left_in, right_in, ops = [None] * len(parts), [None] * len(parts), []
    for i, (b, p) in enumerate(zip(local, parts)):
        j = pos[b.start]
        for side, nb in (("left", j - 1), ("right", j + 1)):
            if not 0 <= nb < len(lay.blocks):
                edge = p.new_full((1, h) + tuple(p.shape[2:]), fill)
            elif lay.blocks[nb].rank == lay.rank:
                q = parts[local.index(lay.blocks[nb])]
                edge = (q[-1:, -h:] if side == "left" else q[:1, :h]).to(p.device)
            else:  # the neighbour lives in another process
                peer = lay.blocks[nb].rank
                send = (p[:1, :h] if side == "left" else p[-1:, -h:]).contiguous()
                edge = torch.empty_like(send)
                ops += [dist.P2POp(dist.isend, send, peer), dist.P2POp(dist.irecv, edge, peer)]
            (left_in if side == "left" else right_in)[i] = edge
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = []
    for p, lft, rgt in zip(parts, left_in, right_in):
        lcol = torch.cat([lft, p[:-1, -h:]], 0)
        rcol = torch.cat([p[1:, :h], rgt], 0)
        out.append(torch.cat([lcol, p, rcol], 1))
    return Sharded(tuple(out), lay)


def to_device(tree, device: torch.device):
    """``tree`` (tensors, modules, dataclasses, tuples, lists, dicts) with
    every tensor on ``device``; what is there already is returned as is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, torch.nn.Module):
        p = next(tree.parameters(), None)
        return tree if p is None or p.device == device else copy.deepcopy(tree).to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: to_device(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def to_numpy(x) -> np.ndarray:
    """A full host copy of a Sharded (on every process) or a tensor."""
    if isinstance(x, Sharded):
        x = all_gather(x)[0]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
