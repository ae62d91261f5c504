"""First-party P1 finite-element assembly (numpy, vectorized).

Counterpart of ``mlamg_tpu/data/fem.py`` (the pieces the random-hull FEM
problem family needs).  Pure numpy/scipy, so the assembled matrix is
bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.sparse as sp


def _kappa_at(kappa, cx, cy):
    """Evaluate kappa at centroid arrays; returns (m, 2, 2) tensors."""
    m = len(cx)
    K = np.empty((m, 2, 2))
    if kappa is None:
        K[:] = np.eye(2)
        return K
    for i in range(m):
        k = kappa(cx[i], cy[i])
        k = np.asarray(k, dtype=np.float64)
        if k.ndim == 0:
            K[i] = np.eye(2) * float(k)
        else:
            K[i] = k
    return K


def gradgradform(vertices: np.ndarray, elements: np.ndarray, kappa: Callable | None = None):
    """Assemble the P1 stiffness matrix for -div(kappa grad u).

    Vectorized over elements: per-triangle basis gradients from the inverse
    Jacobian, local 3x3 matrices K_ij = area * (grad_i . kappa grad_j),
    scattered into COO.
    Returns scipy CSR of shape (n, n).
    """
    v = np.asarray(vertices, dtype=np.float64)
    e = np.asarray(elements, dtype=np.int64)
    n = v.shape[0]
    p0, p1, p2 = v[e[:, 0]], v[e[:, 1]], v[e[:, 2]]

    # Jacobian columns, signed areas
    d1 = p1 - p0
    d2 = p2 - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * np.abs(det)
    if np.any(area <= 0):
        raise ValueError("degenerate elements in mesh")

    # Gradients of barycentric basis functions (each (m, 2))
    inv_det = 1.0 / det
    g1 = np.column_stack([d2[:, 1], -d2[:, 0]]) * inv_det[:, None]
    g2 = np.column_stack([-d1[:, 1], d1[:, 0]]) * inv_det[:, None]
    g0 = -(g1 + g2)
    G = np.stack([g0, g1, g2], axis=1)  # (m, 3, 2)

    centroid = (p0 + p1 + p2) / 3.0
    K = _kappa_at(kappa, centroid[:, 0], centroid[:, 1])  # (m, 2, 2)

    # local matrices: area * G K G^T   -> (m, 3, 3)
    KG = np.einsum("mab,mjb->mja", K, G)
    local = np.einsum("mia,mja->mij", G, KG) * area[:, None, None]

    rows = np.repeat(e, 3, axis=1).ravel()  # i index
    cols = np.tile(e, (1, 3)).ravel()  # j index
    A = sp.coo_matrix((local.ravel(), (rows, cols)), shape=(n, n))
    return A.tocsr()


def _basis_gradients(vertices: np.ndarray, elements: np.ndarray):
    """Per-element barycentric basis gradients G (m,3,2) and areas (m,)."""
    v = np.asarray(vertices, dtype=np.float64)
    e = np.asarray(elements, dtype=np.int64)
    p0, p1, p2 = v[e[:, 0]], v[e[:, 1]], v[e[:, 2]]
    d1 = p1 - p0
    d2 = p2 - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * np.abs(det)
    inv_det = 1.0 / det
    g1 = np.column_stack([d2[:, 1], -d2[:, 0]]) * inv_det[:, None]
    g2 = np.column_stack([-d1[:, 1], d1[:, 0]]) * inv_det[:, None]
    g0 = -(g1 + g2)
    return np.stack([g0, g1, g2], axis=1), area


def _scatter_local(local: np.ndarray, elements: np.ndarray, n: int):
    rows = np.repeat(elements, 3, axis=1).ravel()
    cols = np.tile(elements, (1, 3)).ravel()
    return sp.coo_matrix((local.ravel(), (rows, cols)), shape=(n, n)).tocsr()


def eliminate_dirichlet(A: sp.csr_matrix, vertices: np.ndarray, boundary: np.ndarray):
    """Restrict to interior dofs: A_d = R A R^T (reference ns/model/data.py:336-341)."""
    n = A.shape[0]
    interior = np.ones(n, dtype=bool)
    interior[boundary] = False
    R = sp.eye(n).tocsr()[interior]
    A_d = (R @ A @ R.T).tocsr()
    A_d.eliminate_zeros()
    return A_d, vertices[interior]


def anisotropic_kappa(epsilon: float = 1.0, theta: float = 0.0) -> Callable:
    """Rotated anisotropic diffusion tensor Q diag(1, eps) Q^T
    (reference ns/model/data.py:318-325)."""
    c, s = np.cos(theta), np.sin(theta)
    Q = np.array([[c, -s], [s, c]])
    K = Q @ np.diag([1.0, epsilon]) @ Q.T

    def kappa(x, y):
        return K

    return kappa
