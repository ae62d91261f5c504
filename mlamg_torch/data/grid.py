"""Problem container, ``.grid`` IO and the problem generators.

Counterpart of ``mlamg_tpu/data/grid.py``: ``Grid`` with ``save``,
``load`` and ``load_dir``; the 1D finite-difference Laplacians (Dirichlet
and Neumann); P1 diffusion on the unit square (Dirichlet, Neumann, and
Voronoi jumps in the coefficient), on a given mesh, and on random convex
hulls; the 3D anisotropic Laplacian on a jittered tetrahedral mesh and by
finite differences; ``rotation_matrix_3d``.  Pure numpy/scipy, so a seed
gives a matrix bit-identical to the JAX package's.  A ``.grid`` file is a
bz2 pickle of ``{"A": (data, indices, indptr), "x", "extra"}``, read and
written by both packages.
"""

from __future__ import annotations

import bz2
import os
import pickle
from typing import Callable

import numpy as np
import scipy.sparse as sp

from mlamg_torch.data import fem


def pickle_save_bz2(fname: str, obj) -> None:
    with bz2.open(fname, "wb") as f:
        pickle.dump(obj, f)


def pickle_load_bz2(fname: str):
    """Unpickling runs code, so load only files this project wrote."""
    with bz2.open(fname, "rb") as f:
        return pickle.load(f)


class Grid:
    """A linear system with geometry: A (scipy CSR), x (n, dim) coords, extra."""

    def __init__(self, A_csr, x=None, extra=None):
        self.A = sp.csr_matrix(A_csr)
        self.x = x
        self.extra = dict(extra or {})

    @property
    def n(self) -> int:
        return self.A.shape[0]

    def save(self, fname: str) -> None:
        if ".grid" not in fname:
            fname = fname + ".grid"
        A = self.A.tocsr()
        pickle_save_bz2(fname, {"A": (A.data, A.indices, A.indptr), "x": self.x,
                                "extra": self.extra})

    @staticmethod
    def load(fname: str) -> "Grid":
        """Read a ``.grid`` file; ``extra["filename"]`` records its path.
        Unpickling runs code, so load only files this project wrote."""
        if ".grid" not in fname:
            fname = fname + ".grid"
        loaded = pickle_load_bz2(fname)
        extra = loaded.get("extra", {}) or {}
        extra["filename"] = fname
        A = loaded["A"]
        if isinstance(A, tuple):
            A = sp.csr_matrix(A)
        return Grid(A, loaded["x"], extra)

    @staticmethod
    def load_dir(directory: str) -> list:
        """Every ``.grid`` file of ``directory``, in file-name order."""
        return [Grid.load(os.path.join(directory, f))
                for f in sorted(os.listdir(directory)) if ".grid" in f.lower()]

    @staticmethod
    def structured_1d_poisson_dirichlet(n: int, xdim=(0, 1)) -> "Grid":
        """The 1D finite-difference Laplacian on n interior points, scaled
        by h^-2."""
        x = np.linspace(xdim[0], xdim[1], n + 2)[1:-1]
        h = abs(x[1] - x[0])
        A = (sp.eye(n) * 2 - sp.eye(n, k=-1) - sp.eye(n, k=1)) * (h ** -2.0)
        return Grid(A.tocsr(), np.column_stack((x, np.zeros_like(x))))

    @staticmethod
    def structured_1d_poisson_neumann(n: int, xdim=(0, 1)) -> "Grid":
        x = np.linspace(xdim[0], xdim[1], n)
        h = abs(x[1] - x[0])
        A = (sp.eye(n) * 2 - sp.eye(n, k=-1) - sp.eye(n, k=1)).tolil()
        A[0, 0] = 1
        A[0, 1] = -1
        A[-1, -1] = 1
        A[-1, -2] = -1
        A = A.tocsr() * (h ** -2.0)
        return Grid(A, np.column_stack((x, np.zeros_like(x))))

    @staticmethod
    def structured_2d_poisson_dirichlet(n_pts_x: int, n_pts_y: int, epsilon: float = 1.0,
                                        theta: float = 0.0) -> "Grid":
        """P1 diffusion (anisotropy ``epsilon`` at angle ``theta``) on the
        regular triangulation of the unit square, n_pts_x x n_pts_y
        interior vertices, Dirichlet boundary eliminated."""
        v, e = fem.regular_triangle_mesh(n_pts_x + 2, n_pts_y + 2)
        return Grid.mesh_2d_poisson_dirichlet(
            v, e, fem.boundary_vertices_structured(v), fem.anisotropic_kappa(epsilon, theta),
            {"epsilon": epsilon, "theta": theta})

    @staticmethod
    def mesh_2d_poisson_dirichlet(
        vertices, elements, boundary, kappa: Callable | None = None, extra=None
    ) -> "Grid":
        """FEM diffusion on an arbitrary triangle mesh with Dirichlet
        elimination (role of meshio_2d_poisson_dirichlet*, data.py:301-414)."""
        A = fem.gradgradform(vertices, elements, kappa=kappa)
        A_d, x_int = fem.eliminate_dirichlet(A, np.asarray(vertices)[:, :2], boundary)
        return Grid(A_d, x_int, extra)

    @staticmethod
    def structured_2d_poisson_neumann(
        n_pts_x: int, n_pts_y: int, epsilon: float = 1.0, theta: float = 0.0
    ) -> "Grid":
        v, e = fem.regular_triangle_mesh(n_pts_x, n_pts_y)
        kappa = fem.anisotropic_kappa(epsilon, theta)
        A = fem.gradgradform(v, e, kappa=kappa)
        return Grid(A, v, {"epsilon": epsilon, "theta": theta})

    @staticmethod
    def structured_2d_poisson_dirichlet_jumps(
        n_pts_x: int, n_pts_y: int, jumps: np.ndarray
    ) -> "Grid":
        v, e = fem.regular_triangle_mesh(n_pts_x + 2, n_pts_y + 2)
        boundary = fem.boundary_vertices_structured(v)
        return Grid.mesh_2d_poisson_dirichlet(
            v, e, boundary, fem.jump_kappa(jumps), {"jumps": jumps}
        )

    @staticmethod
    def random_2d_unstructured(
        n_interior: int, epsilon: float = 1.0, theta: float = 0.0, seed=None,
        smooth_iters: int = 12,
    ) -> "Grid":
        """Random unstructured 2D diffusion problem on a quality mesh over a
        random convex-hull domain — the gmsh-free analogue of the
        reference's random-hull generator (data.py:416-433,
        create_data.py:53-57).

        gmsh produces quality triangulations (bounded minimum angle); a raw
        Delaunay of uniform-random points does not (sliver triangles make
        the FEM operator far harder to solve than the reference's, skewing
        every convergence-factor comparison).  We recover gmsh-like quality
        without gmsh: boundary nodes are spaced ~h along the hull polygon,
        interior seeds are random, and ``smooth_iters`` rounds of Laplacian
        (Lloyd/CVT-style) smoothing — move every interior point to the mean
        of its Delaunay neighbors, boundary pinned — equilibrate the mesh.
        """
        import scipy.spatial as spat

        rng = np.random.RandomState(seed)
        # Random convex polygon domain (reference create_data.py:53).
        hull_pts = rng.rand(max(10, min(25, n_interior)), 2)
        hull = spat.ConvexHull(hull_pts)
        poly = hull_pts[hull.vertices]  # CCW polygon vertices
        # target spacing for ~n_interior interior nodes of a uniform mesh
        area = hull.volume
        h = float(np.sqrt(2.0 * area / (np.sqrt(3.0) * max(n_interior, 4))))

        # boundary nodes: polygon vertices + edge subdivisions at spacing ~h
        bpts = []
        nv = poly.shape[0]
        for i in range(nv):
            a, b = poly[i], poly[(i + 1) % nv]
            length = np.linalg.norm(b - a)
            m = max(1, int(round(length / h)))
            t = np.arange(m, dtype=float)[:, None] / m
            bpts.append(a[None, :] * (1 - t) + b[None, :] * t)
        bpts = np.concatenate(bpts, axis=0)

        # interior seeds: rejection-sample the polygon interior with a ~h/2
        # margin from the boundary (points at distance < h/2 from an edge
        # make thin triangles that smoothing cannot always fix)
        lo, hi = poly.min(0), poly.max(0)
        # inward edge normals for the CCW hull polygon
        edges = poly[(np.arange(nv) + 1) % nv] - poly
        normals = np.stack([-edges[:, 1], edges[:, 0]], axis=1)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)

        def inside(p, margin):
            d = ((p[:, None, :] - poly[None, :, :]) * normals[None, :, :]).sum(-1)
            return (d > margin).all(axis=1)

        ipts = np.zeros((0, 2))
        while ipts.shape[0] < n_interior:
            cand = lo + rng.rand(4 * n_interior + 64, 2) * (hi - lo)
            cand = cand[inside(cand, 0.5 * h)]
            ipts = np.concatenate([ipts, cand], axis=0)
        ipts = ipts[:n_interior]

        nb = bpts.shape[0]
        pts = np.concatenate([bpts, ipts], axis=0)

        # Laplacian smoothing sweeps: interior -> mean of Delaunay neighbors
        for _ in range(smooth_iters):
            tri = spat.Delaunay(pts)
            s = tri.simplices
            src = np.concatenate([s[:, 0], s[:, 1], s[:, 2], s[:, 1], s[:, 2], s[:, 0]])
            dst = np.concatenate([s[:, 1], s[:, 2], s[:, 0], s[:, 0], s[:, 1], s[:, 2]])
            sums = np.zeros_like(pts)
            np.add.at(sums, src, pts[dst])
            deg = np.zeros(pts.shape[0])
            np.add.at(deg, src, 1.0)
            new = sums / np.maximum(deg, 1.0)[:, None]
            pts[nb:] = new[nb:]  # boundary pinned; convexity keeps pts inside

        tri = spat.Delaunay(pts)
        v, e = tri.points, tri.simplices
        p0, p1, p2 = v[e[:, 0]], v[e[:, 1]], v[e[:, 2]]
        tarea = 0.5 * np.abs(
            (p1 - p0)[:, 0] * (p2 - p0)[:, 1] - (p1 - p0)[:, 1] * (p2 - p0)[:, 0]
        )
        e = e[tarea > 1e-12]
        boundary = np.arange(nb)
        kappa = fem.anisotropic_kappa(epsilon, theta)
        return Grid.mesh_2d_poisson_dirichlet(
            v, e, boundary, kappa, {"epsilon": epsilon, "theta": theta, "seed": seed}
        )

    @staticmethod
    def tet_3d_laplace_dirichlet(
        nx: int, ny: int, nz: int,
        epsilon: np.ndarray | None = None, R: np.ndarray | None = None,
        jitter: float = 0.25, seed=None,
    ) -> "Grid":
        """3D anisotropic Laplace on a TETRAHEDRAL P1 FEM mesh of the unit
        cube (each cell split into 6 tets, interior vertices jittered).

        This mirrors the reference's 3D data, which is Firedrake CG1 on
        UnitCubeMesh — i.e. *tetrahedral FEM*, not finite differences
        (utils/create_3d_laplace.py:36-40).  The distinction matters for
        the learned pipeline: a regular FD grid has an automorphic
        interior (identical stencil at every node), so a GNN on matrix
        features cannot distinguish interior nodes at all; the tet mesh's
        varying vertex degrees and jittered element shapes are exactly the
        symmetry-breaking structure the models key on.

        (nx, ny, nz) count cells per axis; K = R diag(eps) R^T.
        """
        eps = np.ones(3) if epsilon is None else np.asarray(epsilon, float)
        Rm = np.eye(3) if R is None else np.asarray(R, float)
        K = Rm @ np.diag(eps) @ Rm.T
        rng = np.random.RandomState(seed)

        vx, vy, vz = nx + 1, ny + 1, nz + 1
        xs = np.linspace(0, 1, vx)
        ys = np.linspace(0, 1, vy)
        zs = np.linspace(0, 1, vz)
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        verts = np.column_stack([X.ravel(), Y.ravel(), Z.ravel()])
        vid = np.arange(verts.shape[0]).reshape(vx, vy, vz)
        interior = (
            (X > 0) & (X < 1) & (Y > 0) & (Y < 1) & (Z > 0) & (Z < 1)
        ).ravel()
        h = np.array([xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]])
        verts[interior] += (rng.rand(int(interior.sum()), 3) - 0.5) * (
            2.0 * jitter * h
        )

        # 6-tet Kuhn split of each cell (consistent, no hanging faces)
        c000 = vid[:-1, :-1, :-1].ravel()
        c100 = vid[1:, :-1, :-1].ravel()
        c010 = vid[:-1, 1:, :-1].ravel()
        c110 = vid[1:, 1:, :-1].ravel()
        c001 = vid[:-1, :-1, 1:].ravel()
        c101 = vid[1:, :-1, 1:].ravel()
        c011 = vid[:-1, 1:, 1:].ravel()
        c111 = vid[1:, 1:, 1:].ravel()
        tets = np.concatenate([
            np.stack(t, axis=1) for t in (
                (c000, c100, c110, c111),
                (c000, c100, c101, c111),
                (c000, c010, c110, c111),
                (c000, c010, c011, c111),
                (c000, c001, c101, c111),
                (c000, c001, c011, c111),
            )
        ])

        # vectorized P1 tet stiffness with tensor K
        p0 = verts[tets[:, 0]]
        M = np.stack(
            [verts[tets[:, j]] - p0 for j in (1, 2, 3)], axis=1
        )  # (E, 3, 3) rows = edge vectors
        det = np.linalg.det(M)
        vol = np.abs(det) / 6.0
        Minv = np.linalg.inv(M)  # (E, 3, 3)
        g123 = np.transpose(Minv, (0, 2, 1))  # rows i: grad lambda_{i+1}
        g0 = -g123.sum(axis=1, keepdims=True)
        G = np.concatenate([g0, g123], axis=1)  # (E, 4, 3)
        KG = G @ K.T  # (E, 4, 3)
        local = np.einsum("eid,ejd->eij", G, KG) * vol[:, None, None]

        E = tets.shape[0]
        rows = np.repeat(tets, 4, axis=1).ravel()
        cols = np.tile(tets, (1, 4)).ravel()
        A = sp.coo_matrix(
            (local.ravel(), (rows, cols)),
            shape=(verts.shape[0],) * 2,
        ).tocsr()
        # Dirichlet: restrict to interior vertices
        ii = np.nonzero(interior)[0]
        A_d = A[ii][:, ii].tocsr()
        A_d.sum_duplicates()
        A_d.eliminate_zeros()
        # normalize to unit mean |entry|: every AMG quantity (conv factor,
        # P, strength ratios) is invariant to a scalar scaling of A, but
        # the GNN edge features |a_ij| are not — un-normalized 3D FEM
        # entries (~h*K ~ 0.1) sit outside the 2D families' O(1) feature
        # regime and dead-ReLU the edge heads
        A_d = A_d * (1.0 / max(np.abs(A_d.data).mean(), 1e-30))
        return Grid(A_d, verts[ii], {"epsilon": eps, "R": Rm, "fem": "tet"})

    @staticmethod
    def structured_3d_laplace_dirichlet(
        nx: int, ny: int, nz: int, epsilon: np.ndarray | None = None, R: np.ndarray | None = None
    ) -> "Grid":
        """3D anisotropic Laplace: -div(K grad u), K = R diag(eps) R^T, on a
        structured grid with a 7-point (plus cross-term) FD stencil.

        The Firedrake-free analogue of utils/create_3d_laplace.py:35-76;
        cross-derivative terms of the rotated tensor are discretized with
        centered differences.
        """
        eps = np.ones(3) if epsilon is None else np.asarray(epsilon, float)
        Rm = np.eye(3) if R is None else np.asarray(R, float)
        K = Rm @ np.diag(eps) @ Rm.T

        n = nx * ny * nz
        idx = np.arange(n).reshape(nx, ny, nz)
        h = 1.0 / (max(nx, ny, nz) + 1)

        rows, cols, vals = [], [], []

        def add(i, j, v):
            rows.append(i.ravel())
            cols.append(j.ravel())
            vals.append(np.full(i.size, v))

        # second-order terms K[d,d] * d^2/dx_d^2
        shifts = [
            ((1, 0, 0), K[0, 0]),
            ((0, 1, 0), K[1, 1]),
            ((0, 0, 1), K[2, 2]),
        ]
        diag = 2.0 * (K[0, 0] + K[1, 1] + K[2, 2]) / h**2
        add(idx, idx, diag)
        for (sx, sy, sz), kdd in shifts:
            a = idx[sx:, sy:, sz:]
            b = idx[: nx - sx, : ny - sy, : nz - sz]
            add(a, b, -kdd / h**2)
            add(b, a, -kdd / h**2)

        # mixed terms 2*K[a,b] * d^2/(dx_a dx_b): centered cross stencil
        cross = [((1, 1, 0), K[0, 1]), ((1, 0, 1), K[0, 2]), ((0, 1, 1), K[1, 2])]
        for (sx, sy, sz), kab in cross:
            if abs(kab) < 1e-14:
                continue
            c = kab / (2.0 * h**2)
            app = idx[sx:, sy:, sz:]
            amm = idx[: nx - sx, : ny - sy, : nz - sz]
            add(app, amm, -c)
            add(amm, app, -c)
            # opposite diagonal (+,-), (-,+)
            if (sx, sy, sz) == (1, 1, 0):
                a2, b2 = idx[1:, : ny - 1, :], idx[: nx - 1, 1:, :]
            elif (sx, sy, sz) == (1, 0, 1):
                a2, b2 = idx[1:, :, : nz - 1], idx[: nx - 1, :, 1:]
            else:
                a2, b2 = idx[:, 1:, : nz - 1], idx[:, : ny - 1, 1:]
            add(a2, b2, c)
            add(b2, a2, c)

        A = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n),
        ).tocsr()
        xs = np.linspace(0, 1, nx)
        ys = np.linspace(0, 1, ny)
        zs = np.linspace(0, 1, nz)
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        coords = np.column_stack([X.ravel(), Y.ravel(), Z.ravel()])
        return Grid(A, coords, {"epsilon": eps, "R": Rm})


def rotation_matrix_3d(ax: float, ay: float, az: float) -> np.ndarray:
    """XYZ Euler rotation (for anisotropic 3D problems, role of the rotation
    matrices in utils/create_3d_laplace.py)."""
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx
