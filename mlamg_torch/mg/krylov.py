"""Preconditioned Krylov solvers (counterpart of ``mlamg_tpu/mg/krylov.py``):
CG for SPD systems and flexible GMRES for nonsymmetric systems with a
preconditioner that may change between applications (an AMG cycle run to
a tolerance, a Schur fieldsplit).

The JAX package runs each solve as one ``lax.while_loop``; here the loops
are Python on the host.  The vectors stay on the device; each inner step
reads its few scalars (the new Hessenberg column, the residual norm) to
the host once, and the Givens rotations and the back-substitution run
there in the vectors' float type, as JAX runs them on its scalars.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mlamg_torch.ops import matmul
from mlamg_torch.ops.bsr import BSR
from mlamg_torch.ops.dia import DIA
from mlamg_torch.ops.sparse import CSR, ELL
from mlamg_torch.ops.unstructured import WindowedELL


def _mv(A, x: torch.Tensor) -> torch.Tensor:
    """A sparse container's product, or ``A @ x`` (a dense tensor, or an
    operator object such as the fieldsplit's)."""
    if isinstance(A, (CSR, ELL, BSR, DIA, WindowedELL)):
        return matmul.spmv(A, x)
    return A @ x


def pcg(A, b: torch.Tensor, x0: torch.Tensor | None = None, *, M: Callable | None = None,
        tol: float = 1e-8, max_iter: int = 500):
    """Preconditioned conjugate gradients.  Returns (x, res_history, iters);
    the history holds each iteration's residual norm, zero beyond ``iters``.
    The first iteration always runs (as in the JAX package)."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = (lambda r: r) if M is None else M
    r = b - _mv(A, x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    hist = torch.zeros(max_iter, dtype=b.dtype, device=b.device)
    bnorm = float(torch.linalg.vector_norm(b))
    stop = tol * (bnorm if bnorm > 0 else 1.0)
    iters = 0
    while iters < max_iter:
        Ap = _mv(A, p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rn = torch.linalg.vector_norm(r)
        hist[iters] = rn
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        iters += 1
        if float(rn) <= stop:
            break
    return x, hist, iters


def _np_dtype(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def _arnoldi_cycle(A, b, x, M, m: int, stop: float):
    """One FGMRES(m) cycle from x: Arnoldi with modified Gram-Schmidt,
    Givens rotations applied as each column arrives, an exit on
    convergence (the rotated residual at or below ``stop``) or happy
    breakdown, and the masked back-substitution.  Returns (x, j_used, res)
    with ``res[:j_used]`` the rotated residual norms."""
    dt = _np_dtype(b)
    r = b - _mv(A, x)
    beta_t = torch.linalg.vector_norm(r)
    beta = dt(float(beta_t))
    V = [r / (beta_t if beta > 0 else torch.ones_like(beta_t))]
    Z = []
    R = np.zeros((m + 1, m), dt)  # the rotated (triangular) Hessenberg
    cs = np.zeros(m, dt)
    sn = np.zeros(m, dt)
    g = np.zeros(m + 1, dt)
    g[0] = beta
    res = np.zeros(m, dt)
    j = 0
    done = beta <= stop
    while not done and j < m:
        z = M(V[j])
        w = _mv(A, z)
        hs = []
        for i in range(j + 1):  # modified Gram-Schmidt against v_0..v_j
            hi = torch.dot(V[i], w)
            w = w - hi * V[i]
            hs.append(hi)
        hnext_t = torch.linalg.vector_norm(w)
        h = np.zeros(m + 1, dt)
        h[: j + 2] = torch.stack(hs + [hnext_t]).cpu().numpy()  # the host read
        hnext = h[j + 1]
        V.append(w / (hnext_t if hnext > 1e-30 else torch.ones_like(hnext_t)))
        Z.append(z)
        for i in range(j):  # the previous rotations
            hi = cs[i] * h[i] + sn[i] * h[i + 1]
            h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
            h[i] = hi
        denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
        c, s = (h[j] / denom, h[j + 1] / denom) if denom > 0 else (dt(1.0), dt(0.0))
        cs[j], sn[j] = c, s
        h[j] = c * h[j] + s * h[j + 1]
        h[j + 1] = 0.0
        R[:, j] = h
        gj = g[j]
        g[j] = c * gj
        g[j + 1] = -s * gj
        res[j] = abs(g[j + 1])
        done = res[j] <= stop or hnext <= 1e-30
        j += 1

    # back-substitution R[:j, :j] y = g[:j] (near-zero pivots divide by 1)
    y = np.zeros(m, dt)
    for i in range(j - 1, -1, -1):
        rii = R[i, i]
        y[i] = (g[i] - np.dot(R[i, :], y)) / (rii if abs(rii) > 1e-30 else dt(1.0))
    if j:
        x = x + torch.stack(Z).T @ torch.from_numpy(y[:j]).to(b.device)
    return x, j, res


def fgmres(A, b: torch.Tensor, x0: torch.Tensor | None = None, *, M: Callable | None = None,
           restart: int = 30, max_restarts: int = 20, tol: float = 1e-8):
    """Flexible GMRES(restart) with right preconditioning, PETSc KSPFGMRES
    semantics as in the JAX package: Z = M(V) is stored, so ``M`` may change
    between applications; the Givens-rotated residual is known at every
    inner step, and the inner loop exits on ``rnorm <= tol * |b|`` or on a
    happy breakdown; each cycle ends with a back-substitution and a restart
    check on the true residual.

    Returns (x, res_history, total_iters); the history has one entry per
    inner iteration, zeros beyond ``total_iters``.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    M = (lambda r: r) if M is None else M
    dt = _np_dtype(b)
    bnorm = dt(float(torch.linalg.vector_norm(b)))
    stop = dt(tol) * (bnorm if bnorm > 0 else dt(1.0))
    hist = np.zeros(max_restarts * restart, dt)
    iters = 0
    for _ in range(max_restarts):
        x, j_used, res = _arnoldi_cycle(A, b, x, M, restart, stop)
        hist[iters: iters + j_used] = res[:j_used]
        iters += j_used
        if dt(float(torch.linalg.vector_norm(b - _mv(A, x)))) <= stop:
            break
    return x, torch.from_numpy(hist).to(b.device), iters
