"""The learned two-level solver as one build and one solve: a trained
:class:`~mlamg_torch.models.agg_interp.FullAggNet` makes P = P-hat Agg of
a new operator, the build forms and factors P^T A P, and the solve runs
:func:`~mlamg_torch.mg.cycle.twolevel_solve` with multicolour Gauss-Seidel
on what the build made.

    h = build_learned_twolevel(net, A, k)
    x, conv, err, iters = learned_solve(h, b, res_tol=1e-6 * ||b||)

``evaluate_dataset``'s learned run and the benchmark's learned cell both
come through :func:`build_learned_twolevel`.

Spans (``utils/profiler.py``, while recording): a fenced root ``build``
holding the fenced ``coloring`` (where the caller gives no colouring),
the network's ``graph``, ``aggnet`` (``layer=i``), ``topk``, ``cnet``,
``bellman_ford``, ``pnet`` and ``remap``, then ``galerkin`` and
``coarse_factor``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.cycle import twolevel_solve
from mlamg_torch.mg.smoothers import _dinv, greedy_coloring
from mlamg_torch.models.agg_interp import LearnedParts
from mlamg_torch.ops.matmul import rap_dense
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils.profiler import SYNCS, Profiler


@dataclasses.dataclass(frozen=True)
class LearnedTwoLevel:
    """A built learned two-level hierarchy: the operator, P (CSR n x k),
    the dense coarse operator ``A_H`` = P^T A P and its factors
    ``coarse``, A's inverse diagonal, the colouring of the smoother, and
    ``parts``, what the network computed (AggNet's masks and scores per
    layer, the centers, CNet's C, agg_id, P-hat's values).  Every tensor
    is the build's own, neither copied nor read back."""

    A: CSR
    P: CSR
    A_H: torch.Tensor
    coarse: CoarseSolver
    Dinv: torch.Tensor
    colors: torch.Tensor
    num_colors: int
    parts: LearnedParts


def pattern_coloring(A: CSR):
    """(colours on A's device, their count): the greedy colouring of A's
    pattern (:func:`~mlamg_torch.mg.smoothers.greedy_coloring`), the
    pattern copied to the host in one read."""
    n = A.shape[0]
    SYNCS["coloring"] += 2  # the pattern read back, the colours copied over
    host = torch.cat([A.row, A.col]).cpu().numpy()
    row, col = host[: A.nnz_pad], host[A.nnz_pad:]
    live = row < n
    pattern = sp.csr_matrix((np.ones(int(live.sum()), np.float32), (row[live], col[live])),
                            shape=A.shape)
    colors = greedy_coloring(pattern).astype(np.int64)
    return torch.from_numpy(colors).to(A.device), int(colors.max()) + 1


@torch.no_grad()
def build_learned_twolevel(net, A: CSR, k: int, colors: torch.Tensor | None = None,
                           num_colors: int | None = None,
                           singular: bool = False) -> LearnedTwoLevel:
    """The learned two-level hierarchy of ``A`` with ``k`` aggregates: the
    colouring (unless ``colors`` and ``num_colors`` are given), the
    FullAggNet ``net``'s P, the Galerkin product P^T A P and its LU
    factors (bordered where ``singular``), and A's inverse diagonal."""
    with Profiler("build", fence=True):
        if colors is None:
            with Profiler("coloring", fence=True):
                colors, num_colors = pattern_coloring(A)
        parts = net.parts(A, k)
        with Profiler("galerkin", fence=True):
            A_H = rap_dense(A, parts.P)
        with Profiler("coarse_factor", fence=True):
            coarse = CoarseSolver.factor(A_H, singular=singular)
            Dinv = _dinv(A)
    return LearnedTwoLevel(A, parts.P, A_H, coarse, Dinv, colors, int(num_colors), parts)


@torch.no_grad()
def learned_solve(h: LearnedTwoLevel, b: torch.Tensor, x0: torch.Tensor | None = None, *,
                  res_tol: float, max_iter: int, pre_smoothing_steps: int = 1,
                  post_smoothing_steps: int = 1):
    """Two-level cycles with multicolour Gauss-Seidel on ``h`` from ``x0``
    (zero unless given) until ||b - A x|| <= ``res_tol``; returns
    :func:`~mlamg_torch.mg.cycle.twolevel_solve`'s (x, conv_factor, err,
    iters)."""
    return twolevel_solve(
        h.A, h.P, b, torch.zeros_like(b) if x0 is None else x0,
        pre_smoothing_steps=pre_smoothing_steps, post_smoothing_steps=post_smoothing_steps,
        res_tol=res_tol, max_iter=max_iter, smoother="multicolor_gs",
        smoother_args={"colors": h.colors, "num_colors": h.num_colors},
        coarse=h.coarse, Dinv=h.Dinv)
