"""A module's weights as one flat vector, its GA folds and the GA's first
population (counterpart of ``mlamg_tpu/ga/codec.py``).

The order is ``jax.flatten_util.ravel_pytree``'s over the JAX package's
parameter tree: leaves in flax's tree order (sorted paths), each raveled
row major with Dense kernels as (in, out).  A vector, a noise draw on it
or an optimiser state therefore lands on the same weights as in JAX.
Every weight belongs to a *fold*, named by the first ``fold_depth`` keys
of its path (depth 2: ``params/AggNetM``, ``params/CNet``,
``params/PNet``); the GA's crossover and mutation flip one coin per fold.
"""

from __future__ import annotations

import numpy as np
import torch

from mlamg_torch.convert import param_leaves
from mlamg_torch.utils import prng


def flatten_params(net):
    """(vec, unravel) of a module.

    vec     : (W,) tensor on the module's device and dtype
    unravel : vec -> the JAX package's parameter tree of numpy arrays
    """
    leaves = param_leaves(net)
    vec = torch.cat([_flat(p, k) for _, p, k in leaves]).detach().clone()
    shapes = [(path, tuple(p.shape[::-1]) if k else tuple(p.shape)) for path, p, k in leaves]

    def unravel(v) -> dict:
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        tree: dict = {}
        pos = 0
        for path, shape in shapes:
            size = int(np.prod(shape))
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = v[pos:pos + size].reshape(shape).copy()
            pos += size
        return tree

    return vec, unravel


def _flat(p: torch.Tensor, is_kernel: bool) -> torch.Tensor:
    return (p.T if is_kernel else p).reshape(-1)


@torch.no_grad()
def assign_flat(net, vec: torch.Tensor) -> None:
    """Write a flat vector (in :func:`flatten_params`' order) into the
    module's parameters."""
    pos = 0
    for _, p, is_kernel in param_leaves(net):
        size = p.numel()
        part = vec[pos:pos + size].to(device=p.device, dtype=p.dtype)
        p.copy_(part.view(p.shape[::-1]).T if is_kernel else part.view(p.shape))
        pos += size
    if pos != vec.shape[0]:
        raise ValueError(f"assign_flat: vector has {vec.shape[0]} weights, module {pos}")


def flat_grad(net) -> torch.Tensor:
    """The parameters' ``.grad`` as one vector in :func:`flatten_params`'
    order (zero where a parameter has no gradient)."""
    return torch.cat([_flat(p.grad if p.grad is not None else torch.zeros_like(p), k)
                      for _, p, k in param_leaves(net)])


def fold_ids(net, fold_depth: int = 2):
    """(fold_ids, fold_names): a (W,) int32 fold per weight in
    :func:`flatten_params`' order, and the fold names in order of first
    appearance (the index is the fold id)."""
    names: list[str] = []
    index: dict[str, int] = {}
    ids = []
    for path, p, _ in param_leaves(net):
        name = "/".join(path[:fold_depth])
        if name not in index:
            index[name] = len(names)
            names.append(name)
        ids.append(np.full(p.numel(), index[name], np.int32))
    return np.concatenate(ids), names


def init_population(key, vec, pop_size: int, perturb: float = 1.0) -> np.ndarray:
    """(P, W) numpy population in ``vec``'s dtype: row 0 the weights
    ``vec``, the rest ``vec`` plus ``prng.uniform(key, (P - 1, W), dtype,
    -perturb, perturb)``, JAX's draw bit for bit."""
    v = vec.detach().cpu().numpy() if isinstance(vec, torch.Tensor) else np.asarray(vec)
    noise = prng.uniform(key, (pop_size - 1, v.shape[0]), v.dtype, -perturb, perturb)
    return np.concatenate([v[None, :], v[None, :] + noise], axis=0)
