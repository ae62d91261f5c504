"""Factored prolongators for the structured hierarchy: apply P without
ever materializing it (counterpart of ``mlamg_tpu/mg/factored.py``).

The smoothed-aggregation prolongator is P = S_s ... S_1 T, each S_i =
I - w_i D^-1 A sharing A's diagonals and T the aggregation operator:

    interp    P e   = S (T e)      one broadcast + one DIA SpMV per factor
    restrict  P^T r = T^T (S^T r)  one DIA SpMV per factor + one box sum

S^T is kept as its own DIA (:func:`dia_transpose`), so restriction is also
a forward SpMV: on the card every factor goes through the ``dia_spmv``
kernel.  A CSR operator (or a DIA without a stored main diagonal) gets CSR
factors, S^T by :func:`~mlamg_torch.ops.matmul.transpose`.
:class:`BilinearP2D` is the geometric side-2 prolongator, applied by
strided slices on the 2-D grid view.

T is structured box aggregation (:class:`BoxAgg2D`) or any assignment
vector (:class:`AggOp`).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mlamg_torch.mg.interp import sa_omega
from mlamg_torch.mg.smoothers import _dinv
from mlamg_torch.ops import matmul
from mlamg_torch.ops.dia import DIA, dia_jacobi_operator
from mlamg_torch.ops.segment import slot_sum
from mlamg_torch.ops.sparse import CSR, segment_slots


def dia_transpose(A: DIA) -> DIA:
    """A.T as its own DIA (negated offsets, shifted diagonals):
    data'[d', j] = A[j + o', j] = data[d(-o'), j + o']."""
    rows = []
    for d, o in enumerate(A.offsets):
        row = A.data[d]
        if o <= 0:  # new offset -o >= 0: shift left, zero tail
            rows.append(F.pad(row[-o:], (0, -o)))
        else:  # new offset -o < 0: shift right, zero head
            rows.append(F.pad(row[:-o], (o, 0)))
    data = torch.stack(rows) if rows else A.data.clone()
    return DIA(data, tuple(-o for o in A.offsets), (A.shape[1], A.shape[0]))


@dataclasses.dataclass(frozen=True)
class BoxAgg2D:
    """Structured (sy, sx) box aggregation of a row-major (ny, nx) grid.

    Node (iy, ix) -> aggregate (iy // sy) * (nx // sx) + (ix // sx), the
    numbering of a row-major coarse grid.  T e repeats each coarse value
    over its box; T^T v sums each box, over y first and then over x,
    as reshape + sum (the JAX package writes both as 0/1 matmuls, a TPU
    layout choice; the box sums then differ in summation order only)."""

    ny: int
    nx: int
    sy: int
    sx: int

    @property
    def n(self) -> int:
        return self.ny * self.nx

    @property
    def k(self) -> int:
        return (self.ny // self.sy) * (self.nx // self.sx)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.k)

    @property
    def agg_id(self) -> torch.Tensor:
        i = torch.arange(self.n)
        iy, ix = i // self.nx, i % self.nx
        return (iy // self.sy) * (self.nx // self.sx) + ix // self.sx

    def interp(self, e: torch.Tensor) -> torch.Tensor:
        """T e: broadcast each coarse value over its box; e is (k,) or (k, c)."""
        ncy, ncx = self.ny // self.sy, self.nx // self.sx
        c_shape = tuple(e.shape[1:])
        E = e.reshape(ncy, 1, ncx, 1, *c_shape)
        E = E.expand(ncy, self.sy, ncx, self.sx, *c_shape)
        return E.reshape(self.n, *c_shape)

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        """T^T v: sum each box; v is (n,) or (n, c)."""
        ncy, ncx = self.ny // self.sy, self.nx // self.sx
        c_shape = tuple(v.shape[1:])
        V = v.reshape(ncy, self.sy, self.nx, *c_shape).sum(1)
        V = V.reshape(ncy, ncx, self.sx, *c_shape).sum(2)
        return V.reshape(self.k, *c_shape)


@dataclasses.dataclass(frozen=True)
class AggOp:
    """Aggregation by an assignment vector: node i -> aggregate agg_id[i];
    ``agg_id[i] >= k`` marks an unassigned node, a zero row of T.  T e is
    a gather; T^T v sums each aggregate's entries in node order."""

    agg_id: torch.Tensor  # (n,) int64
    n: int
    k: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.k)

    @cached_property
    def _slots(self) -> torch.Tensor:
        return segment_slots(self.agg_id.clamp(max=self.k), self.k)

    def interp(self, e: torch.Tensor) -> torch.Tensor:
        """T e; e is (k,) or (k, c)."""
        out = e[self.agg_id.clamp(0, self.k - 1)]
        keep = self.agg_id < self.k
        return torch.where(keep[:, None] if e.ndim > 1 else keep, out, torch.zeros_like(out))

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        """T^T v; v is (n,) or (n, c)."""
        return slot_sum(v, self._slots)


@dataclasses.dataclass(frozen=True)
class BilinearP2D:
    """Vertex-centered bilinear prolongator with side-2 coarsening.

    Coarse node (jy, jx) sits on fine node (2*jy + 1, 2*jx + 1); the 1-D
    stencil is [1/2, 1, 1/2] with the Dirichlet wall as zero.  Under
    Galerkin RAP a compact 9-point stencil stays a compact 9-point stencil
    at every level.  Both applications are separable strided passes on the
    2-D view; a trailing batch dimension (k, c) / (n, c) is carried along.
    """

    ny: int
    nx: int

    def __post_init__(self):
        if self.ny % 2 or self.nx % 2:
            raise ValueError("BilinearP2D requires even grid sides")

    @property
    def ncy(self) -> int:
        return self.ny // 2

    @property
    def ncx(self) -> int:
        return self.nx // 2

    @property
    def n(self) -> int:
        return self.ny * self.nx

    @property
    def k(self) -> int:
        return self.ncy * self.ncx

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.k)

    @property
    def dtype(self) -> torch.dtype:
        # float32 whatever the operator's type, as in the JAX package; its
        # values (0, 1/4, 1/2, 1) are exact in any float type
        return torch.float32

    @staticmethod
    def _interp_axis(E: torch.Tensor, axis: int) -> torch.Tensor:
        """out[2j+1] = E[j], out[2j] = (E[j-1] + E[j]) / 2 along ``axis``."""
        m = E.shape[axis]
        left = torch.cat([torch.zeros_like(E.narrow(axis, 0, 1)),
                          E.narrow(axis, 0, m - 1)], axis)
        even = 0.5 * (left + E)
        out = torch.stack([even, E], axis + 1)
        return out.reshape(*E.shape[:axis], 2 * m, *E.shape[axis + 1:])

    @staticmethod
    def _restrict_axis(V: torch.Tensor, axis: int) -> torch.Tensor:
        """Transpose of :meth:`_interp_axis`: r[j] = V[2j+1] + (V[2j] + V[2j+2]) / 2."""
        W = V.reshape(*V.shape[:axis], V.shape[axis] // 2, 2, *V.shape[axis + 1:])
        even, odd = W.select(axis + 1, 0), W.select(axis + 1, 1)
        m = even.shape[axis]
        even_next = torch.cat([even.narrow(axis, 1, m - 1),
                               torch.zeros_like(even.narrow(axis, 0, 1))], axis)
        return odd + 0.5 * (even + even_next)

    def interp(self, e: torch.Tensor) -> torch.Tensor:
        """P e: (k,) or (k, c) coarse vector to (n,) / (n, c) fine."""
        c_shape = tuple(e.shape[1:])
        E = e.reshape(self.ncy, self.ncx, *c_shape)
        E = self._interp_axis(self._interp_axis(E, 0), 1)
        return E.reshape(self.n, *c_shape)

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        """P^T v: (n,) or (n, c) fine vector to (k,) / (k, c) coarse."""
        c_shape = tuple(v.shape[1:])
        V = v.reshape(self.ny, self.nx, *c_shape)
        V = self._restrict_axis(self._restrict_axis(V, 0), 1)
        return V.reshape(self.k, *c_shape)

    # dense-block applications share the vector code path (trailing batch dim)
    interp_mm = interp
    restrict_mm = restrict

    def densify(self) -> torch.Tensor:
        """Dense (n, k) P: tests and small problems only."""
        return self.interp(torch.eye(self.k, dtype=torch.float32))

    def coarse_reach(self, ry: int, rx: int) -> Tuple[int, int]:
        """Per-axis reach of P^T A P for a fine reach-(ry, rx) stencil."""
        return (ry + 2) // 2, (rx + 2) // 2


@dataclasses.dataclass(frozen=True)
class FactoredSA:
    """P = S_s ... S_1 T applied by its factors (never materialized).

    ``Ss[i]`` is the factor I - w_i D^-1 A (a DIA or a CSR), ``Sts[i]``
    its precomputed transpose, ``T`` a :class:`BoxAgg2D` or
    :class:`AggOp`.  The factors commute (all polynomials in D^-1 A), so
    application order is free."""

    Ss: tuple
    Sts: tuple
    T: object

    @property
    def shape(self) -> Tuple[int, int]:
        return self.T.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.Ss[0].data.dtype

    @property
    def smooth_steps(self) -> int:
        return len(self.Ss)

    def interp(self, e: torch.Tensor) -> torch.Tensor:
        u = self.T.interp(e)
        for S in self.Ss:
            u = matmul.spmv(S, u)
        return u

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        for St in self.Sts:
            r = matmul.spmv(St, r)
        return self.T.restrict(r)

    def interp_mm(self, E: torch.Tensor) -> torch.Tensor:
        """(n, c) = P @ E for a dense (k, c) block (setup time)."""
        U = self.T.interp(E)
        for S in self.Ss:
            U = matmul.spmm(S, U)
        return U

    def restrict_mm(self, V: torch.Tensor) -> torch.Tensor:
        """(k, c) = P.T @ V for a dense (n, c) block (setup time)."""
        for St in self.Sts:
            V = matmul.spmm(St, V)
        return self.T.restrict(V)

    def densify(self) -> torch.Tensor:
        """Dense (n, k) P: tests and small problems only."""
        S = self.Ss[0]
        return self.interp_mm(torch.eye(self.shape[1], dtype=self.dtype, device=S.device))


def _chebyshev_weights(lmax: float, smooth_steps: int, dtype: torch.dtype):
    """Inverse Chebyshev roots over [lmax/15, lmax], rounded as the JAX
    package rounds them when ``lmax`` is a scalar of the operator's type
    (as its structured hierarchy passes it): the cosines in float32, the
    rest in the operator's type (float32 or float64)."""
    dt = np.float64 if dtype == torch.float64 else np.float32
    lm = dt(lmax)
    a_b, b_b = lm / dt(15.0), lm
    ang = (2.0 * np.arange(1, smooth_steps + 1) - 1) / (2.0 * smooth_steps) * np.pi
    cos = np.cos(ang).astype(np.float32).astype(dt)
    roots = (a_b + b_b) / dt(2.0) + (b_b - a_b) / dt(2.0) * cos
    return [float(w) for w in dt(1.0) / roots]


def _csr_jacobi_smoother(A: CSR, Dinv: torch.Tensor, omega) -> CSR:
    """(I - omega D^-1 A) on A's pattern, as a CSR (the identity lands on
    the stored main diagonal only)."""
    n = A.shape[0]
    live = A.mask
    data = -omega * Dinv[A.row.clamp(max=n - 1)] * A.data
    data = torch.where(live & (A.row == A.col), data + 1.0, data)
    data = torch.where(live, data, torch.zeros_like(data))
    return CSR(data, A.row, A.col, A.indptr, A.shape, A.nnz)


def factored_sa(A, T, omega=None, power_iters: int = 30,
                smooth_steps: int = 1, lmax=None) -> FactoredSA:
    """Factored SA prolongator of a DIA or CSR operator over the
    aggregates ``T`` (:class:`BoxAgg2D` or :class:`AggOp`).

    With ``smooth_steps == 1`` one factor of weight ``omega`` (default
    (4/3) / rho(D^-1 A) by ``power_iters`` power iterations, ``sa_omega``);
    with s > 1 the weights are the inverse Chebyshev roots over
    [lmax/15, lmax] (``lmax`` defaults to rho(D^-1 A) from the same power
    iteration), so prod_i (1 - w_i t) is the minimax degree-s polynomial
    with p(0) = 1.  ``omega`` may also be a sequence of weights.  A DIA
    factor keeps A's diagonals; a CSR operator, or a DIA without a stored
    main diagonal (read back as a float32 CSR, as the JAX package does),
    gives CSR factors."""
    if not isinstance(A, (DIA, CSR)):
        raise TypeError(f"factored_sa: unsupported operator {type(A).__name__}")
    Dinv = _dinv(A)
    if omega is None:
        if smooth_steps == 1:
            omegas = [float(sa_omega(A, Dinv, iters=power_iters))]
        else:
            if lmax is None:  # (4/3) / omega in A's type, as JAX divides it
                lmax = float((4.0 / 3.0) / sa_omega(A, Dinv, iters=power_iters))
            omegas = _chebyshev_weights(float(lmax), smooth_steps, A.dtype)
    elif np.ndim(omega) == 0:
        omegas = [float(omega)] * max(smooth_steps, 1)
    else:
        omegas = [float(w) for w in omega]

    Ss, Sts = [], []
    for w in omegas:
        S = dia_jacobi_operator(A, Dinv, w) if isinstance(A, DIA) else None
        if S is not None:
            St = dia_transpose(S)
        else:
            A_csr = A if isinstance(A, CSR) else CSR.from_scipy(A.to_scipy(), device=A.device)
            S = _csr_jacobi_smoother(A_csr, Dinv, w)
            St = matmul.transpose(S)
        Ss.append(S)
        Sts.append(St)
    return FactoredSA(tuple(Ss), tuple(Sts), T)


def coarse_operator_factored(A, P, block: int = 128) -> torch.Tensor:
    """Dense Galerkin operator P^T A P, formed in column blocks; peak extra
    memory is one (n, block) slab (setup time only)."""
    k = P.shape[1]
    eye = torch.eye(k, dtype=P.dtype, device=A.device)
    cols = []
    for j0 in range(0, k, block):
        X = P.interp_mm(eye[:, j0: min(j0 + block, k)])  # (n, c)
        cols.append(P.restrict_mm(matmul.spmm(A, X)))  # (k, c)
    return torch.cat(cols, 1)
