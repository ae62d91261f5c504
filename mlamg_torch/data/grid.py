"""Problem container, ``.grid`` IO and the random-hull FEM generator.

Counterpart of ``mlamg_tpu/data/grid.py`` (``Grid`` with ``save``,
``load`` and ``load_dir``, ``structured_1d_poisson_dirichlet``,
``mesh_2d_poisson_dirichlet``, ``structured_2d_poisson_dirichlet`` and
``random_2d_unstructured``).  Pure numpy/scipy, so a seed gives a matrix
bit-identical to the JAX package's.  A ``.grid`` file is a bz2 pickle of
``{"A": (data, indices, indptr), "x", "extra"}``, read and written by both
packages.
"""

from __future__ import annotations

import bz2
import os
import pickle
from typing import Callable

import numpy as np
import scipy.sparse as sp

from mlamg_torch.data import fem


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
        with bz2.open(fname, "wb") as f:
            pickle.dump({"A": (A.data, A.indices, A.indptr), "x": self.x,
                         "extra": self.extra}, f)

    @staticmethod
    def load(fname: str) -> "Grid":
        """Read a ``.grid`` file; ``extra["filename"]`` records its path.
        Unpickling runs code, so load only files this project wrote."""
        if ".grid" not in fname:
            fname = fname + ".grid"
        with bz2.open(fname, "rb") as f:
            loaded = pickle.load(f)
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
