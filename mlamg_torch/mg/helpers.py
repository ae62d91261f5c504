"""Classic AMG analysis helpers (counterpart of ``mlamg_tpu/mg/helpers.py``,
role of ns/lib/helpers.py).

Dense numpy research utilities: ideal interpolation from a C/F splitting,
simple relax and two-level drivers, convergence-factor measurement,
optimal-omega search, matrix normalization, variable-coefficient 1D
generators.  These are analysis tools for small n, pure numpy and scipy,
so they give the JAX package's numbers bit for bit; the production
solvers live in :mod:`mlamg_torch.mg.cycle`.
"""

from __future__ import annotations

import numpy as np
import numpy.linalg as la
import scipy.optimize


def ideal_interpolation(A, picked_C) -> np.ndarray:
    """P = [ -A_FF^-1 A_FC ; I ] reordered to the natural ordering
    (reference helpers.py:40-66)."""
    A = np.asarray(A.todense() if hasattr(A, "todense") else A)
    picked_C = np.asarray(picked_C, bool)
    C = np.where(picked_C)[0]
    F = np.where(~picked_C)[0]
    A_FF = A[np.ix_(F, F)]
    A_FC = A[np.ix_(F, C)]
    n, k = A.shape[0], len(C)
    P = np.zeros((n, k))
    P[C, np.arange(k)] = 1.0
    P[F] = -la.solve(A_FF, A_FC)
    return P


def relax(A, u0, f, nu: int = 1, omega: float = 0.666) -> np.ndarray:
    """Weighted-Jacobi sweeps (reference helpers.py:99-105)."""
    A = np.asarray(A.todense() if hasattr(A, "todense") else A)
    u = u0.copy()
    Dinv = 1.0 / np.diag(A)
    for _ in range(nu):
        u = u + omega * Dinv * (f - A @ u)
    return u


def twolevel(A, P, A1, u0, f0, nu: int = 1, omega: float = 0.666) -> np.ndarray:
    """One dense two-level cycle (reference helpers.py:107-115)."""
    A = np.asarray(A.todense() if hasattr(A, "todense") else A)
    u = relax(A, u0, f0, nu, omega)
    f1 = P.T @ (f0 - A @ u)
    u1 = la.solve(A1, f1)
    u = u + P @ u1
    return relax(A, u, f0, nu, omega)


def det_conv_factor(A, picked_C, x, u, u_ref, omega: float) -> float:
    """Mean error-contraction factor over 15 cycles with ideal interpolation
    (reference helpers.py:169-189)."""
    P = ideal_interpolation(A, picked_C)
    A1 = P.T @ (np.asarray(A.todense() if hasattr(A, "todense") else A) @ P)
    u = u.copy()
    errs = []
    for _ in range(15):
        u = twolevel(A, P, A1, u, x, 1, omega)
        errs.append(la.norm(u - u_ref))
    errs = np.array(errs)
    return float(np.mean(errs[1:] / np.maximum(errs[:-1], 1e-300)))


def det_conv_factor_optimal_omega(A, picked_C, x, u, u_ref):
    """Scalar-minimize the cycle convergence factor over omega in (0, 1)
    (reference helpers.py:191-224)."""

    def obj(omega):
        return det_conv_factor(A, picked_C, x, u, u_ref, omega)

    opt = scipy.optimize.minimize_scalar(
        obj, bounds=(0.01, 0.99), method="bounded", options={"maxiter": 50}
    )
    return float(opt.fun), float(opt.x)


def grid_from_coarsening_factor(n: int, f: float):
    """Regular C/F splitting with coarsening factor f
    (reference helpers.py:155-167)."""
    if f > 1:
        f = int(f)
        C = np.zeros(n, bool)
        C[(n - 1) % f // 2 :: f] = True
        return C, ~C
    F = np.zeros(n, bool)
    f = int(1 / f)
    F[(n - 1) % f // 2 :: f] = True
    return ~F, F


def normalize_mat(A):
    """Rescale |entries| into [0.1, 1.0] for use as graph edge weights
    (reference helpers.py:265-274)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    d = np.abs(A.data.copy())
    d -= d.min()
    mx = d.max()
    if mx > 0:
        d /= mx
    d = d * 0.9 + 0.1
    return sp.csr_matrix((d, A.indices, A.indptr), shape=A.shape)


def gen_1d_poisson_fd(N: int) -> np.ndarray:
    """Dense 1D Poisson FD (reference helpers.py:232-235)."""
    h = 1.0 / (N + 1)
    return (1.0 / h**2) * (
        np.eye(N) * 2 - (np.eye(N, k=-1) + np.eye(N, k=1))
    )


def gen_1d_poisson_fd_vc(N: int, k) -> np.ndarray:
    """Variable-coefficient 1D Poisson: -(k u')' with k at the N+1 midpoints
    (reference helpers.py:237-263)."""
    k = np.asarray(k, float)
    assert len(k) == N + 1
    h = 1.0 / (N + 1)
    A = np.zeros((N, N))
    for i in range(N):
        A[i, i] = k[i] + k[i + 1]
        if i > 0:
            A[i, i - 1] = -k[i]
        if i < N - 1:
            A[i, i + 1] = -k[i + 1]
    return A / h**2


def random_u(n: int, scale: float = 1.0, rng=None) -> np.ndarray:
    """Uniform in [-scale, scale) from ``rng`` (numpy's global stream by
    default)."""
    rng = rng or np.random
    return (2 * (rng.rand(n) - 0.5)) * scale
