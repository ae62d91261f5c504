"""Stationary smoothers (counterpart of ``mlamg_tpu/mg/smoothers.py``):
weighted and l1 Jacobi, Chebyshev, and multicolor Gauss-Seidel over a
greedy colouring, all SpMVs and axpys."""

from __future__ import annotations

import numpy as np
import torch

from mlamg_torch.ops.matmul import spmv, spmv_affine


def _dinv(A) -> torch.Tensor:
    d = A.diagonal()
    return 1.0 / torch.where(d != 0, d, torch.ones_like(d))


def jacobi(A, b, x, Dinv=None, omega: float = 0.666, nu: int = 2):
    """nu sweeps of weighted Jacobi: x += omega * Dinv * (b - A x)."""
    if Dinv is None:
        Dinv = _dinv(A)
    for _ in range(nu):
        x = x + omega * Dinv * (b - spmv(A, x))
    return x


def l1_jacobi(A, b, x, nu: int = 2):
    """Jacobi with the l1 diagonal d_i = sum_j |a_ij| (always convergent)."""
    absrow = spmv(A.abs(), torch.ones(A.shape[1], dtype=A.dtype, device=A.device))
    Dinv = 1.0 / torch.where(absrow > 0, absrow, torch.ones_like(absrow))
    for _ in range(nu):
        x = x + Dinv * (b - spmv(A, x))
    return x


def chebyshev(A, b, x, lmax: float, lmin_frac: float = 0.25, degree: int = 3,
              Dinv=None):
    """Chebyshev polynomial smoother on D^-1 A over [lmin_frac*lmax, lmax]
    (Saad, Iterative Methods, Alg. 12.1, on the D^-1-preconditioned
    system).  ``lmax`` is a host float, so the recurrence's scalars stay on
    the host."""
    if Dinv is None:
        Dinv = _dinv(A)
    lmax = float(lmax)
    lmin = lmax * lmin_frac
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0

    def resid(x):
        # Dinv * (b - A x), the affine form fused into the SpMV
        return Dinv * spmv_affine(A, x, c=b, alpha=-1.0)

    sigma1 = theta / delta
    d = resid(x) / theta
    x = x + d
    rho = 1.0 / sigma1
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * resid(x)
        x = x + d
        rho = rho_new
    return x


def greedy_coloring(A_scipy) -> np.ndarray:
    """Host-side greedy graph colouring in row order: each row takes the
    smallest colour none of its lower-numbered neighbours has.  Returns (n,)
    int32 colours: from the C++ loop of ``native/mlamg_native.cpp`` where
    it is built, else from :func:`greedy_coloring_py` (the same colours)."""
    from mlamg_torch import native

    if native.available():
        return native.greedy_coloring(A_scipy)[0]
    return greedy_coloring_py(A_scipy)


def greedy_coloring_py(A_scipy) -> np.ndarray:
    """:func:`greedy_coloring`'s loop in Python, for when the C++ library is
    not built."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A_scipy)
    n = A.shape[0]
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        nbrs = A.indices[A.indptr[i]: A.indptr[i + 1]]
        used = set(colors[nbrs[nbrs < i]])
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def multicolor_gauss_seidel(A, b, x, colors: torch.Tensor, num_colors: int, nu: int = 1,
                            Dinv=None):
    """Gauss-Seidel under a graph colouring: colours in sequence, each
    colour's rows at once (the full residual recomputed per colour).  Equal
    to a GS sweep in the colouring's order."""
    if Dinv is None:
        Dinv = _dinv(A)
    for _ in range(nu):
        for c in range(num_colors):
            upd = x + Dinv * (b - spmv(A, x))
            x = torch.where(colors == c, upd, x)
    return x
