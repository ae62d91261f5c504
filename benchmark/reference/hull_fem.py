"""The random-hull P1 FEM operator and its plain SA Galerkin reference.

``random_hull_fem`` is a frozen copy of the measured package's
``Grid.random_2d_unstructured`` (isotropic: epsilon 1, theta 0) with the P1
stiffness assembly and the Dirichlet elimination it calls, so the
benchmark's matrix does not move when the package's generator does.  The
per-element diffusion tensor is the identity, broadcast instead of
evaluated element by element; the products are the same, so the matrix is
the package's bit for bit (held by ``tests/test_bench_data.py``).

``coarse_reference`` works the first SA coarse operator out again in
float64 from the harness's own matrix and the reference's own aggregation
(``sa_aggregation``).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp


def random_hull_fem(n_interior: int, seed: int, smooth_iters: int = 12) -> sp.csr_matrix:
    """float64 stiffness matrix of -laplace(u) on a quality random mesh of a
    random convex hull, Dirichlet nodes eliminated (n_interior rows)."""
    import scipy.spatial as spat

    rng = np.random.RandomState(seed)
    hull_pts = rng.rand(max(10, min(25, n_interior)), 2)
    hull = spat.ConvexHull(hull_pts)
    poly = hull_pts[hull.vertices]
    area = hull.volume
    h = float(np.sqrt(2.0 * area / (np.sqrt(3.0) * max(n_interior, 4))))

    # boundary nodes: polygon vertices and edge subdivisions at spacing ~h
    bpts = []
    nv = poly.shape[0]
    for i in range(nv):
        a, b = poly[i], poly[(i + 1) % nv]
        m = max(1, int(round(np.linalg.norm(b - a) / h)))
        t = np.arange(m, dtype=float)[:, None] / m
        bpts.append(a[None, :] * (1 - t) + b[None, :] * t)
    bpts = np.concatenate(bpts, axis=0)

    # interior seeds, rejection-sampled at a margin of h/2 from the edges
    lo, hi = poly.min(0), poly.max(0)
    edges = poly[(np.arange(nv) + 1) % nv] - poly
    normals = np.stack([-edges[:, 1], edges[:, 0]], axis=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)

    def inside(p, margin):
        d = ((p[:, None, :] - poly[None, :, :]) * normals[None, :, :]).sum(-1)
        return (d > margin).all(axis=1)

    ipts = np.zeros((0, 2))
    while ipts.shape[0] < n_interior:
        cand = lo + rng.rand(4 * n_interior + 64, 2) * (hi - lo)
        ipts = np.concatenate([ipts, cand[inside(cand, 0.5 * h)]], axis=0)
    ipts = ipts[:n_interior]

    nb = bpts.shape[0]
    pts = np.concatenate([bpts, ipts], axis=0)
    # Laplacian smoothing: interior points to the mean of their Delaunay
    # neighbours, boundary pinned
    for _ in range(smooth_iters):
        s = spat.Delaunay(pts).simplices
        src = np.concatenate([s[:, 0], s[:, 1], s[:, 2], s[:, 1], s[:, 2], s[:, 0]])
        dst = np.concatenate([s[:, 1], s[:, 2], s[:, 0], s[:, 0], s[:, 1], s[:, 2]])
        sums = np.zeros_like(pts)
        np.add.at(sums, src, pts[dst])
        deg = np.zeros(pts.shape[0])
        np.add.at(deg, src, 1.0)
        pts[nb:] = (sums / np.maximum(deg, 1.0)[:, None])[nb:]

    tri = spat.Delaunay(pts)
    v, e = tri.points, tri.simplices
    p0, p1, p2 = v[e[:, 0]], v[e[:, 1]], v[e[:, 2]]
    tarea = 0.5 * np.abs((p1 - p0)[:, 0] * (p2 - p0)[:, 1] - (p1 - p0)[:, 1] * (p2 - p0)[:, 0])
    e = e[tarea > 1e-12]
    A = _stiffness(v, e)
    interior = np.ones(v.shape[0], dtype=bool)
    interior[np.arange(nb)] = False
    R = sp.eye(v.shape[0]).tocsr()[interior]
    A_d = (R @ A @ R.T).tocsr()
    A_d.eliminate_zeros()
    return A_d


def _stiffness(vertices: np.ndarray, elements: np.ndarray) -> sp.csr_matrix:
    """P1 stiffness matrix of -div(K grad u) with K the identity."""
    v = np.asarray(vertices, dtype=np.float64)
    e = np.asarray(elements, dtype=np.int64)
    n = v.shape[0]
    p0, p1, p2 = v[e[:, 0]], v[e[:, 1]], v[e[:, 2]]
    d1, d2 = p1 - p0, p2 - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * np.abs(det)
    if np.any(area <= 0):
        raise ValueError("degenerate elements in mesh")
    inv_det = 1.0 / det
    g1 = np.column_stack([d2[:, 1], -d2[:, 0]]) * inv_det[:, None]
    g2 = np.column_stack([-d1[:, 1], d1[:, 0]]) * inv_det[:, None]
    G = np.stack([-(g1 + g2), g1, g2], axis=1)
    K = np.broadcast_to(np.eye(2), (e.shape[0], 2, 2))
    KG = np.einsum("mab,mjb->mja", K, G)
    local = np.einsum("mia,mja->mij", G, KG) * area[:, None, None]
    rows = np.repeat(e, 3, axis=1).ravel()
    cols = np.tile(e, (1, 3)).ravel()
    return sp.coo_matrix((local.ravel(), (rows, cols)), shape=(n, n)).tocsr()


def load_or_make(n_interior: int, seed: int, cache_dir: str) -> sp.csr_matrix:
    """The hull's matrix from ``cache_dir``, meshed and written there first
    if absent (to a temporary name, then renamed into place)."""
    path = os.path.join(cache_dir, f"hull_{n_interior}_{seed}.npz")
    if os.path.exists(path):
        return sp.load_npz(path).tocsr()
    A = random_hull_fem(n_interior, seed)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".partial.npz"
    sp.save_npz(tmp, A, compressed=False)
    os.replace(tmp, path)
    return A


def truncate_lump(A: sp.csr_matrix, theta: float, keep_override=None) -> sp.csr_matrix:
    """Drop entries with |a_ij| < theta sqrt(|a_ii a_jj|) and lump what is
    dropped onto the diagonal, clipped at half of it.  ``keep_override``
    (row, col, keep) sets the decision of the entries whose test lies
    within rounding of the threshold."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    coo = A.tocoo()
    d = np.asarray(A.diagonal(), np.float64)
    scale = np.sqrt(np.abs(d[coo.row] * d[coo.col])) + 1e-30
    diag = coo.row == coo.col
    keep = diag | (np.abs(coo.data) >= theta * scale)
    if keep_override is not None:
        keep = keep_override(coo.row, coo.col, np.abs(coo.data) / (theta * scale), keep)
    A2 = sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape).tocsr()
    dropped = np.bincount(coo.row, weights=np.where(keep, 0.0, coo.data), minlength=n)
    lump = np.maximum(dropped, -0.5 * np.abs(d))
    return (A2 + sp.diags(lump.astype(A.dtype))).tocsr()


def bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (the control's precision), as float64."""
    import torch

    return torch.from_numpy(np.asarray(a, np.float64)).to(torch.bfloat16).double().numpy()


def galerkin(A0: sp.csr_matrix, agg: np.ndarray, k: int, low: bool = False) -> sp.csr_matrix:
    """P^T A0 P with P = (I - omega D^-1 A0) T, T the aggregation of ``agg``
    and omega = 4/3 over the Gershgorin bound of D^-1 A0, in float64; with
    ``low``, A0, P, A0 P and the product rounded to bfloat16."""
    rnd = bf16 if low else (lambda a: a)
    A0 = sp.csr_matrix(A0, dtype=np.float64)
    A0.data = rnd(A0.data)
    n = A0.shape[0]
    d = A0.diagonal()
    absrow = np.asarray(abs(A0).sum(axis=1)).ravel()
    omega = (4.0 / 3.0) / np.max(absrow / np.abs(d))
    T = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, k))
    P = (T - sp.diags(omega / d) @ (A0 @ T)).tocsr()
    P.data = rnd(P.data)
    AP = (A0 @ P).tocsr()
    AP.data = rnd(AP.data)
    AH = (P.T @ AP).tocsr()
    AH.data = rnd(AH.data)
    return AH


def coarse_reference(A0: sp.csr_matrix, agg: np.ndarray, k: int, theta: float,
                     program: sp.csr_matrix, low: bool = False, near: float = 1e-3):
    """The first coarse operator: :func:`galerkin` truncated by
    :func:`truncate_lump`.  An entry whose test lies within ``near`` of the
    threshold takes the program's decision (kept where ``program``, in the
    same aggregate labels, holds it): rounding decides it, and it moves
    the operator by ~theta."""
    prog = sp.coo_matrix(program)
    held = np.sort(prog.row.astype(np.int64) * k + prog.col)

    def override(row, col, ratio, keep):
        close = np.abs(ratio - 1.0) < near
        if close.any():
            keys = row[close].astype(np.int64) * k + col[close]
            keep = keep.copy()
            keep[close] = np.isin(keys, held)
        return keep

    return truncate_lump(galerkin(A0, agg, k, low), theta, override)
