"""Population-parallel fitness evaluation over a mesh (counterpart of
``mlamg_tpu/parallel/pop_parallel.py``): the (P, W) population is split
over the mesh's ``pop`` axis and each device evaluates its shards; the
(P,) fitness is gathered back."""

from __future__ import annotations

from typing import Callable

import torch

from mlamg_torch.parallel import _comm
from mlamg_torch.parallel.mesh import Mesh


def shard_population_eval(fitness_vmapped: Callable, mesh: Mesh) -> Callable:
    """Wrap f((M, W) tensor) -> (M,) into a pop-sharded evaluator.

    The returned function takes the full (P, W) population (numpy or
    torch), pads it with copies of its last row to a multiple of the pop
    axis, calls ``f`` once per block of consecutive shards on one device
    (with that block's rows on that device) and returns the (P,) fitness
    on the CPU, in the dtype ``f`` returns.
    """
    lay = _comm.layout(mesh, "pop")

    def evaluate(population) -> torch.Tensor:
        pop = _comm.as_tensor(population)
        size = pop.shape[0]
        pad = (-size) % lay.num_shards
        if pad:
            pop = torch.cat([pop, pop[-1:].expand(pad, *pop.shape[1:])])
        rows = _comm.split(pop, lay)
        out = rows.map(lambda p: _comm.as_tensor(fitness_vmapped(p)).to(p.device))
        return _comm.all_gather(out)[0].cpu()[:size]

    return evaluate
