"""First-party P1 finite-element assembly (numpy, vectorized).

Counterpart of ``mlamg_tpu/data/fem.py`` (the pieces the random-hull FEM
problem family, the structured Poisson problems and the cylinder-flow
Oseen system need).  Pure numpy/scipy, so the assembled matrix is
bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.sparse as sp


def regular_triangle_mesh(nx: int, ny: int):
    """Structured triangulation of the unit square: (vertices (n, 2)
    float64, elements (m, 3) int64), each cell split into two triangles
    (pyamg's gallery convention)."""
    assert nx > 1 and ny > 1
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, nx), np.linspace(0.0, 1.0, ny))
    v = np.column_stack([X.ravel(), Y.ravel()])
    idx = np.arange(nx * ny).reshape(ny, nx)
    ll, lr = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    ul, ur = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    e = np.vstack([np.column_stack([ll, lr, ul]), np.column_stack([lr, ur, ul])])
    return v, e.astype(np.int64)


def boundary_vertices_structured(vertices: np.ndarray) -> np.ndarray:
    """The vertices on the unit square's boundary, by coordinate test."""
    v = vertices
    on = ((v[:, 0] == v[:, 0].min()) | (v[:, 0] == v[:, 0].max())
          | (v[:, 1] == v[:, 1].min()) | (v[:, 1] == v[:, 1].max()))
    return np.where(on)[0]


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


def mass_form(vertices: np.ndarray, elements: np.ndarray) -> sp.csr_matrix:
    """Consistent P1 mass matrix M_ij = ∫ φ_i φ_j."""
    e = np.asarray(elements, dtype=np.int64)
    _, area = _basis_gradients(vertices, e)
    base = (np.ones((3, 3)) + np.eye(3)) / 12.0
    local = area[:, None, None] * base[None]
    return _scatter_local(local, e, np.asarray(vertices).shape[0])


def convection_form(vertices: np.ndarray, elements: np.ndarray, wind) -> sp.csr_matrix:
    """P1 convection C_ij = ∫ φ_i (w · ∇φ_j), wind evaluated at centroids.

    ``wind(x, y) -> (2,)`` or vectorized ``wind(xs, ys) -> (m, 2)``.
    """
    v = np.asarray(vertices, dtype=np.float64)
    e = np.asarray(elements, dtype=np.int64)
    G, area = _basis_gradients(v, e)
    cent = (v[e[:, 0]] + v[e[:, 1]] + v[e[:, 2]]) / 3.0
    w = np.asarray(wind(cent[:, 0], cent[:, 1]), dtype=np.float64)
    if w.ndim == 1:
        w = np.broadcast_to(w, (len(e), 2))
    wg = np.einsum("mc,mjc->mj", w, G)  # (m, 3): w . grad(phi_j)
    local = (area / 3.0)[:, None, None] * np.broadcast_to(wg[:, None, :], (len(e), 3, 3))
    return _scatter_local(local, e, v.shape[0])


def div_forms(vertices: np.ndarray, elements: np.ndarray):
    """Divergence coupling blocks (Bx, By): B^c[q, j] = ∫ φ_q ∂φ_j/∂x_c."""
    v = np.asarray(vertices, dtype=np.float64)
    e = np.asarray(elements, dtype=np.int64)
    G, area = _basis_gradients(v, e)
    out = []
    for c in range(2):
        local = (area / 3.0)[:, None, None] * np.broadcast_to(G[:, None, :, c], (len(e), 3, 3))
        out.append(_scatter_local(local, e, v.shape[0]))
    return out[0], out[1]


def bp_stabilization(vertices: np.ndarray, elements: np.ndarray) -> sp.csr_matrix:
    """Brezzi-Pitkäranta pressure stabilization Σ_T h_T² (∇p, ∇q)_T, which
    makes the equal-order P1-P1 velocity/pressure pair inf-sup stable."""
    v = np.asarray(vertices, dtype=np.float64)
    e = np.asarray(elements, dtype=np.int64)
    G, area = _basis_gradients(v, e)
    p0, p1, p2 = v[e[:, 0]], v[e[:, 1]], v[e[:, 2]]
    h2 = np.maximum.reduce([((p1 - p0) ** 2).sum(1), ((p2 - p1) ** 2).sum(1),
                            ((p0 - p2) ** 2).sum(1)])
    local = np.einsum("mia,mja->mij", G, G) * (area * h2)[:, None, None]
    return _scatter_local(local, e, v.shape[0])


def boundary_vertices_from_edges(line_cells: np.ndarray) -> np.ndarray:
    """Unique vertex ids touched by boundary ('line') cells."""
    return np.unique(np.asarray(line_cells).ravel())


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


def jump_kappa(jumps: np.ndarray) -> Callable:
    """Piecewise-constant diffusion by Voronoi regions of seed rows
    [x, y, d]: the d of the nearest seed (reference ns/model/data.py:349-394)."""
    jumps = np.asarray(jumps, dtype=np.float64)

    def kappa(x, y):
        d2 = (jumps[:, 0] - x) ** 2 + (jumps[:, 1] - y) ** 2
        return jumps[np.argmin(d2), 2]

    return kappa
