"""Stationary smoothers (counterpart of ``mlamg_tpu/mg/smoothers.py``
:func:`jacobi` and :func:`chebyshev`): SpMVs and axpys only."""

from __future__ import annotations

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
