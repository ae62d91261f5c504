"""Evaluation of learned and classical two-level AMG (counterpart of the
evaluation half of ``mlamg_tpu/train.py``).

Every method reports the convergence factor of one two-level solve
(:func:`measured_conv`): b = 0 from a fixed unit-norm x0, multicolor
Gauss-Seidel by default, a dense LU of the Galerkin operator, NaN counted
as 1.0.  The baselines are Lloyd aggregation on the olson strength
(:func:`lloyd_reference_conv`) and Bellman-Ford from random centers
(:func:`random_reference_conv`), both with a Jacobi-smoothed prolongator;
the learned method is a :class:`~mlamg_torch.models.agg_interp.FullAggNet`
(:func:`evaluate_model_on_bundles`).  The random draws are the JAX
package's bit for bit (:mod:`mlamg_torch.utils.prng`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mlamg_torch.data.grid import Grid
from mlamg_torch.device import resolve_device
from mlamg_torch.graph.bellman_ford import bellman_ford, nearest_center_to_agg
from mlamg_torch.graph.lloyd import _lloyd_core
from mlamg_torch.graph.strength import strength_measure
from mlamg_torch.mg.cycle import twolevel_solve
from mlamg_torch.mg.interp import sa_interpolation_dense
from mlamg_torch.mg.smoothers import greedy_coloring
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng


@dataclasses.dataclass
class SolveOptions:
    res_tol: float = 1e-6
    max_iter: int = 300
    pre_smooth: int = 1
    post_smooth: int = 1
    jacobi_weight: float = 0.666
    singular: bool = False
    # "jacobi" | "multicolor_gs" | "chebyshev"
    smoother: str = "jacobi"
    # stop on ||x|| (b = 0) instead of the residual norm
    use_error_norm: bool = False


@dataclasses.dataclass
class GridBundle:
    """A grid's system on the device, ready for evaluation: ``k =
    ceil(alpha n)`` aggregates, x0 (``RandomState(0)`` normal, unit norm),
    the largest row degree and the greedy colouring."""

    A: CSR
    k: int
    x0: torch.Tensor
    width: int
    colors: torch.Tensor
    num_colors: int

    @staticmethod
    def from_grid(g: Grid, alpha: float, dtype=torch.float32, device=None) -> "GridBundle":
        dev = resolve_device(device)
        A = g.A.tocsr()
        n = A.shape[0]
        k = max(1, int(np.ceil(alpha * n)))
        x0 = np.random.RandomState(0).randn(n)
        x0 /= np.linalg.norm(x0)
        colors = greedy_coloring(A)
        return GridBundle(
            CSR.from_scipy(A, dtype=dtype, device=dev), k,
            torch.from_numpy(x0).to(device=dev, dtype=dtype),
            int(np.diff(A.indptr).max()),
            torch.from_numpy(colors.astype(np.int64)).to(dev),
            int(colors.max()) + 1,
        )


def measured_conv(A: CSR, P, x0: torch.Tensor, opts: SolveOptions, colors=None,
                  num_colors: int = 0) -> float:
    """Convergence factor of the two-level cycle with b = 0 (NaN -> 1.0)."""
    smoother_args = None
    if opts.smoother == "multicolor_gs":
        if colors is None:
            raise ValueError("multicolor_gs smoother needs a graph coloring")
        smoother_args = {"colors": colors, "num_colors": num_colors}
    use_res = (not opts.singular) and (not opts.use_error_norm)
    _, conv, _, _ = twolevel_solve(
        A, P, torch.zeros_like(x0), x0,
        pre_smoothing_steps=opts.pre_smooth,
        post_smoothing_steps=opts.post_smooth,
        jacobi_weight=opts.jacobi_weight,
        res_tol=opts.res_tol if use_res else None,
        error_tol=None if use_res else opts.res_tol,
        max_iter=opts.max_iter,
        singular=opts.singular,
        smoother=opts.smoother,
        smoother_args=smoother_args,
    )
    return 1.0 if math.isnan(conv) else conv


def bundle_conv(b: GridBundle, P, opts: SolveOptions) -> float:
    """:func:`measured_conv` of ``P`` on a bundle's system."""
    return measured_conv(b.A, P, b.x0, opts, colors=b.colors, num_colors=b.num_colors)


def _first_k(b: GridBundle, key) -> torch.Tensor:
    """The first k of ``permutation(key, n)``: seeds or centers."""
    return torch.from_numpy(prng.permutation(key, b.A.shape[0])[: b.k]).to(b.A.device)


def lloyd_aggregation_of(b: GridBundle, strength_kind: str = "abs", key=None,
                         maxiter: int = 10) -> torch.Tensor:
    """agg_id of Lloyd on the strength matrix from the first k of
    ``permutation(key, n)`` (``key`` = PRNGKey(0) unless given)."""
    C = strength_measure(b.A, strength_kind, width=b.width)
    agg_id, _ = _lloyd_core(C, _first_k(b, prng.PRNGKey(0) if key is None else key), maxiter)
    return agg_id


def lloyd_reference_conv(b: GridBundle, strength_kind: str = "abs",
                         opts: SolveOptions | None = None, key=None,
                         maxiter: int = 10) -> float:
    """Lloyd + Jacobi-SA baseline: one seeded Lloyd draw per grid,
    ``maxiter`` Lloyd iterations."""
    agg_id = lloyd_aggregation_of(b, strength_kind, key, maxiter)
    return bundle_conv(b, sa_interpolation_dense(b.A, agg_id, b.k), opts or SolveOptions())


def random_reference_conv(b: GridBundle, key=None, opts: SolveOptions | None = None,
                          strength_kind: str = "olson") -> float:
    """Random-centers baseline: the first k of ``permutation(key, n)``
    (``key`` = PRNGKey(42) unless given), Bellman-Ford on the strength
    matrix, Jacobi-SA."""
    opts = opts or SolveOptions()
    C = strength_measure(b.A, strength_kind, width=b.width)
    centers = _first_k(b, prng.PRNGKey(42) if key is None else key)
    _, nearest = bellman_ford(C, centers)
    agg_id = nearest_center_to_agg(centers, nearest)
    return bundle_conv(b, sa_interpolation_dense(b.A, agg_id, b.k), opts)


@torch.no_grad()
def evaluate_model_on_bundles(net, bundles, opts: SolveOptions | None = None) -> np.ndarray:
    """Per-grid conv factors of a FullAggNet's prolongator."""
    opts = opts or SolveOptions()
    out = []
    for b in bundles:
        _, P, _, _, _ = net(b.A, b.k)
        out.append(bundle_conv(b, P, opts))
    return np.asarray(out)
