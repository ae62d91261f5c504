"""Structured multilevel hierarchy: every level a DIA stencil, every
prolongator factored (counterpart of ``mlamg_tpu/mg/structured.py``).

The Galerkin coarse operator of a stencil matrix under box aggregation or
bilinear interpolation is again a stencil on the coarse grid.
:func:`dia_galerkin_probe` recovers it by colored probing: color the coarse
cells on a (2R+1, 2R+1) tile so no two same-colored cells share a row of
A_H, apply A_H = P^T A P to one indicator vector per color, and read each
diagonal out of the images.  Each application is SpMV-class work: on the
card, the ``dia_spmv`` kernel for A and every factor of P.

The JAX package's ``block`` (the TPU's pre-blocked DIA layout) and
``jit_probe`` (one XLA program per probe) options have no counterpart:
the port keeps the flat layout and runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.cycle import Hierarchy
from mlamg_torch.mg.factored import BilinearP2D, BoxAgg2D, factored_sa
from mlamg_torch.mg.smoothers import _dinv
from mlamg_torch.ops import matmul
from mlamg_torch.ops.dia import DIA
from mlamg_torch.utils.profiler import Profiler


def _decompose_offsets(offsets, nx: int):
    """Map DIA offsets o = dy*nx + dx to 2-D displacements (|dx| < nx/2)."""
    out = []
    for o in offsets:
        dx = ((o + nx // 2) % nx) - nx // 2
        dy = (o - dx) // nx
        out.append((dy, dx))
    return out


def probe_reach(A: DIA, P) -> tuple:
    """((ncy, ncx), (Ry, Rx)): the coarse grid of ``P`` and the per-axis
    reach of the coarse stencil P^T A P.  ``P`` is a :class:`FactoredSA`
    over a :class:`BoxAgg2D` or a :class:`BilinearP2D`."""
    if isinstance(P, BilinearP2D):
        nx, ncy, ncx = P.nx, P.ncy, P.ncx
    else:
        T = P.T
        if not isinstance(T, BoxAgg2D):
            raise TypeError("probing requires a structured prolongator")
        nx, ncy, ncx = T.nx, T.ny // T.sy, T.nx // T.sx
    disp = _decompose_offsets(A.offsets, nx)
    ry = max((abs(dy) for dy, _ in disp), default=0)
    rx = max((abs(dx) for _, dx in disp), default=0)
    if isinstance(P, BilinearP2D):
        return (ncy, ncx), P.coarse_reach(ry, rx)
    s = P.smooth_steps  # ceil: S^s^T A S^s reach, box-coarsened
    return (ncy, ncx), (-(-(2 * s + 1) * ry // T.sy), -(-(2 * s + 1) * rx // T.sx))


def dia_galerkin_probe(A: DIA, P) -> DIA:
    """Coarse Galerkin operator P^T A P as a DIA on the coarse grid.

    ``P`` is a :class:`FactoredSA` over a :class:`BoxAgg2D` or a
    :class:`BilinearP2D`.  Setup cost: (2R+1)^2 applications of P^T A P.
    The probes are built in the promoted type of P and A, as JAX promotes
    them."""
    (ncy, ncx), (Ry, Rx) = probe_reach(A, P)
    k = ncy * ncx
    # linearized offsets Dy*ncx + Dx are unique (and probe colors do not
    # alias) only when the coarse grid exceeds the stencil reach per axis
    if ncx <= 2 * Rx or ncy <= 2 * Ry:
        raise ValueError(
            f"dia_galerkin_probe: coarse grid ({ncy}, {ncx}) is too narrow "
            f"for the coarse stencil reach ({Ry}, {Rx}) — offsets would "
            "alias; stop coarsening earlier (larger min_coarse) or use a "
            "smaller box side"
        )
    cy_stride, cx_stride = 2 * Ry + 1, 2 * Rx + 1

    dtype = torch.promote_types(P.dtype, A.dtype)
    dev = A.device
    iy = torch.arange(ncy, device=dev)[:, None]
    ix = torch.arange(ncx, device=dev)[None, :]
    color_y = iy % cy_stride
    color_x = ix % cx_stride

    # one probe per color: indicator over same-colored coarse cells
    images = {}
    with Profiler("probes", fence=True):
        for cy in range(cy_stride):
            for cx in range(cx_stride):
                probe = ((color_y == cy) & (color_x == cx)).to(dtype).reshape(k)
                y = P.restrict(matmul.spmv(A, P.interp(probe)))
                images[(cy, cx)] = y.reshape(ncy, ncx)

    # read the coarse stencil: A_H[I, I + (Dy, Dx)] = image_{color(I+D)}[I]
    offsets = []
    rows = []
    with Profiler("stencil_read", fence=True):
        for Dy in range(-Ry, Ry + 1):
            for Dx in range(-Rx, Rx + 1):
                inside = ((iy + Dy >= 0) & (iy + Dy < ncy)
                          & (ix + Dx >= 0) & (ix + Dx < ncx))
                data = torch.zeros((ncy, ncx), dtype=dtype, device=dev)
                for cy in range(cy_stride):
                    for cx in range(cx_stride):
                        img = images[((cy + Dy) % cy_stride, (cx + Dx) % cx_stride)]
                        mask = (color_y == cy) & (color_x == cx) & inside
                        data = torch.where(mask, img, data)
                offsets.append(Dy * ncx + Dx)
                rows.append(data.reshape(k))
        return DIA(torch.stack(rows), tuple(offsets), (k, k))


def build_structured_hierarchy(
    A: DIA,
    ny: int,
    nx: int,
    *,
    sides=(16, 8),
    omega: float = 0.65,
    min_coarse: int = 64,
    coarse_method: str = "inverse",
    smooth_steps=1,
    kind: str = "sa",
) -> Hierarchy:
    """All-DIA hierarchy for a stencil operator on an (ny, nx) grid, on
    ``A``'s device.

    ``sides[l]`` is the box side at level l; coarsening stops early when
    the grid no longer divides, k <= min_coarse, or the coarse grid is too
    narrow for the probe.  ``kind="sa"`` builds factored smoothed-
    aggregation prolongators over ``sides[l]``-boxes with ``smooth_steps``
    factors per level (int or per-level tuple; one factor takes ``omega``,
    several the Chebyshev weights of the level's ``lmax``).
    ``kind="bilinear"`` builds side-2 :class:`BilinearP2D` prolongators;
    every side must then be 2 and ``smooth_steps``/``omega`` are ignored.

    Each level's ``lmax`` is the Gershgorin bound of D^-1 A, kept as a host
    float.  The coarsest operator is inverted densely (``coarse_method``).

    Spans (``utils/profiler.py``, while recording), each fenced: ``build``;
    per level a ``level`` (``level=l``) holding ``lmax`` (Dinv and the
    Gershgorin bound, read on the host), ``prolongator`` and ``galerkin``
    (:func:`dia_galerkin_probe`: ``probes``, the applications of P^T A P,
    then ``stencil_read``, the colour masks); then ``coarse_factor``.
    """
    As = [A]
    Ps = []
    Dinvs = []
    lmaxs = []
    cy, cx = ny, nx
    level_A = A
    steps = (
        tuple(smooth_steps) if np.ndim(smooth_steps) else
        (int(smooth_steps),) * len(sides)
    )
    with Profiler("build", fence=True):
        for lvl, (side, s_l) in enumerate(zip(sides, steps)):
            sy = sx = side
            if kind == "bilinear" and side != 2:
                raise ValueError("kind='bilinear' requires every side to be 2")
            if cy % sy or cx % sx or (cy // sy) * (cx // sx) <= min_coarse:
                break
            with Profiler("level", level=lvl, fence=True):
                with Profiler("lmax", fence=True):
                    Dinv_l = _dinv(level_A)
                    # Gershgorin bound of D^-1 A (a power iteration's
                    # underestimate can put the true lmax outside the
                    # Chebyshev interval)
                    lmax_l = float(torch.max(level_A.data.abs().sum(0) * Dinv_l.abs()))
                with Profiler("prolongator", fence=True):
                    if kind == "bilinear":
                        P = BilinearP2D(ny=cy, nx=cx)
                    else:
                        P = factored_sa(
                            level_A, BoxAgg2D(ny=cy, nx=cx, sy=sy, sx=sx),
                            omega=None if s_l > 1 else omega,
                            smooth_steps=s_l, lmax=lmax_l,
                        )
                try:
                    with Profiler("galerkin", fence=True):
                        A_next = dia_galerkin_probe(level_A, P)
                except ValueError:
                    break  # coarse grid too narrow for the stencil reach: stop here
            Dinvs.append(Dinv_l)
            lmaxs.append(lmax_l)
            cy, cx = cy // sy, cx // sx
            Ps.append(P)
            As.append(A_next)
            level_A = A_next
        with Profiler("coarse_factor", fence=True):
            coarse = CoarseSolver.factor(As[-1].todense(), method=coarse_method)
    return Hierarchy(tuple(As[:-1]), tuple(Ps), tuple(Dinvs), coarse, tuple(lmaxs))
