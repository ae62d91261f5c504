"""Differentiable AMG losses (counterpart of ``mlamg_tpu/models/loss.py``).

:func:`amg_loss` runs the two-level iteration on a batch of test vectors
and softmax-weights the per-vector convergence factors; everything is
differentiable in P (and A): the coarse solve is ``torch.linalg.solve_ex``
on the dense Galerkin operator (a singular one gives inf/NaN, as in JAX),
and the sparse products are the port's fixed-order
``spmm``/``spmm_t``/``rap_dense``.  Neumann (constant
nullspace) systems are bordered with a Lagrange row and column.
:func:`R_jacobi` and :func:`E_loss` are the dense energy-norm losses.
"""

from __future__ import annotations

import numpy as np
import torch

from mlamg_torch.ops.matmul import rap_dense, spmm, spmm_t
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy counterpart of a torch float type (for host draws)."""
    return np.dtype(str(dtype).split(".")[-1])


def make_test_vectors(n: int, num: int, key=None, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """(n, num) unit-norm columns of ``jax.random.normal(key, (n, num))``
    (``key`` = PRNGKey(0) unless given)."""
    key = prng.PRNGKey(0) if key is None else key
    x = torch.from_numpy(prng.normal(key, (n, num), numpy_dtype(dtype)))
    x = x.to(device=device, dtype=dtype)
    return x / torch.linalg.vector_norm(x, dim=0, keepdim=True)


def amg_loss(P, A: CSR, test_vecs: torch.Tensor, tot_num_loop: int = 5,
             neumann_solve_fix: bool = False, omega: float = 2.0 / 3.0, ridge: float = 0.0,
             smooth_fn=None) -> torch.Tensor:
    """Softmax-weighted convergence factor of interpolation ``P``.

    ``P``: dense (n, k) or CSR; ``A``: CSR (n, n); ``test_vecs``: (n, t).
    ``ridge`` adds ``ridge * trace(A_H) / k + 1e-12`` to the coarse
    diagonal, so a P with (near-)dead columns gives a large but finite
    loss.  ``smooth_fn`` replaces the weighted-Jacobi error sweep (an
    (n, t) -> (n, t) map applied once before and once after the coarse
    correction).
    The error is renormalised after each of the ``tot_num_loop + 1`` loops;
    each vector's factor is the geometric mean of its last two loop ratios.
    """
    d = A.diagonal()
    Dinv = omega / torch.where(d != 0, d, torch.ones_like(d))

    A_H = rap_dense(A, P)
    k = A_H.shape[0]
    if ridge:
        lam = ridge * torch.trace(A_H) / k + 1e-12
        A_H = A_H + lam * torch.eye(k, dtype=A_H.dtype, device=A_H.device)
    t = test_vecs.shape[1]
    if neumann_solve_fix:
        one = torch.ones((k, 1), dtype=A_H.dtype, device=A_H.device)
        A_H = torch.cat([torch.cat([A_H, one], 1),
                         torch.cat([one.T, torch.zeros_like(one[:1])], 1)], 0)

    # the dense products and the solve promote mixed float types, as JAX's do
    def P_mul(v):
        return spmm(P, v) if isinstance(P, CSR) else _promoted_matmul(P, v)

    def Pt_mul(v):
        return spmm_t(P, v) if isinstance(P, CSR) else _promoted_matmul(P.T, v)

    if smooth_fn is None:
        smooth_fn = lambda x: x - Dinv[:, None] * spmm(A, x)  # noqa: E731

    def iteration(x):
        x = smooth_fn(x)
        r_H = Pt_mul(spmm(A, x))
        if neumann_solve_fix:
            r_H = torch.cat([r_H, r_H.new_zeros((1, t))], 0)
        dt = torch.promote_types(A_H.dtype, r_H.dtype)
        e_H = torch.linalg.solve_ex(A_H.to(dt), -r_H.to(dt))[0]  # no singularity check, as in JAX
        if neumann_solve_fix:
            e_H = e_H[:-1]
        x = smooth_fn(x + P_mul(e_H))
        if neumann_solve_fix:
            x = x - x.mean(0, keepdim=True)
        return x

    x, ratios = test_vecs, []
    for _ in range(tot_num_loop + 1):
        x = iteration(x)
        nrm = torch.linalg.vector_norm(x, dim=0)
        ratios.append(nrm)
        x = x / nrm.clamp(min=1e-30)[None, :]
    n_err = 3
    convs = torch.stack(ratios[-(n_err - 1):]).prod(0) ** (1.0 / (n_err - 1))
    return torch.dot(torch.softmax(convs, 0), convs)


def _promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def R_jacobi(A, omega: float = 2.0 / 3.0) -> torch.Tensor:
    """Dense error propagation of weighted Jacobi, I - omega D^-1 A (small
    n only)."""
    Ad = A.todense() if isinstance(A, CSR) else A
    d = torch.diagonal(Ad)
    Dinv = 1.0 / torch.where(d != 0, d, torch.ones_like(d))
    return torch.eye(Ad.shape[0], dtype=Ad.dtype, device=Ad.device) - omega * Dinv[:, None] * Ad


def E_loss(A, P, omega: float = 2.0 / 3.0) -> torch.Tensor:
    """|| R (I - P (P^T A P)^-1 P^T A) R ||_F: the two-level error
    propagation in the Frobenius norm (small n only)."""
    Ad = A.todense() if isinstance(A, CSR) else A
    Pd = P.todense() if isinstance(P, CSR) else P
    R = R_jacobi(Ad, omega)
    AH = Pd.T @ Ad @ Pd
    n = Ad.shape[0]
    eye = torch.eye(n, dtype=Ad.dtype, device=Ad.device)
    correction = eye - Pd @ torch.linalg.solve_ex(AH, Pd.T @ Ad)[0]
    return torch.linalg.matrix_norm(R @ correction @ R, "fro")
