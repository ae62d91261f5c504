"""Unstructured cylinder-in-channel Oseen flow, DFG benchmark geometry
(counterpart of ``mlamg_tpu/data/cylflow.py``).

A Delaunay triangulation of the DFG 2D-2 channel around a cylinder,
discretized with equal-order P1-P1 velocity/pressure plus Brezzi-Pitkäranta
stabilization, linearized around a Poiseuille wind (Oseen), in the same
``StokesSystem`` block structure the MAC generator gives.  Pure
numpy/scipy, so every block is bit-identical to the JAX package's.

Geometry (DFG-2): channel [0, 2.2] x [0, 0.41], cylinder center
(0.2, 0.2), radius 0.05; parabolic inflow at x=0, no-slip walls and
cylinder, natural outflow at x=2.2.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from mlamg_torch.data.stokes import StokesSystem
from mlamg_torch.data.fem import (
    gradgradform,
    mass_form,
    convection_form,
    div_forms,
    bp_stabilization,
)


def cylinder_channel_mesh(
    h: float = 0.05,
    L: float = 2.2,
    H: float = 0.41,
    cx: float = 0.2,
    cy: float = 0.2,
    r: float = 0.05,
    seed: int = 0,
):
    """Delaunay mesh of the channel-minus-cylinder domain.

    Returns (vertices (n,2), elements (m,3)).  Point cloud: boundary
    rings (rectangle at spacing ~h, cylinder at spacing ~h/2) + interior
    lattice with alternate-row offset (near-equilateral triangles), minus
    points inside/near the hole; triangles whose centroid falls inside
    the cylinder are dropped.
    """
    pts = []
    nx = max(2, int(round(L / h)))
    ny = max(2, int(round(H / h)))
    xs = np.linspace(0.0, L, nx + 1)
    ys = np.linspace(0.0, H, ny + 1)
    # rectangle boundary
    pts.append(np.column_stack([xs, np.zeros_like(xs)]))
    pts.append(np.column_stack([xs, np.full_like(xs, H)]))
    pts.append(np.column_stack([np.zeros(ny - 1), ys[1:-1]]))
    pts.append(np.column_stack([np.full(ny - 1, L), ys[1:-1]]))
    # cylinder ring (finer: the solution varies fastest here)
    nc = max(16, int(round(2 * np.pi * r / (0.5 * h))))
    th = np.linspace(0.0, 2 * np.pi, nc, endpoint=False)
    pts.append(np.column_stack([cx + r * np.cos(th), cy + r * np.sin(th)]))
    # interior lattice, offset alternate rows
    interior = []
    for j, y in enumerate(ys[1:-1], start=1):
        off = 0.5 * h if j % 2 else 0.0
        row_x = xs[1:-1] + off
        row_x = row_x[(row_x > 0.25 * h) & (row_x < L - 0.25 * h)]
        interior.append(np.column_stack([row_x, np.full(len(row_x), y)]))
    interior = np.concatenate(interior, axis=0)
    d = np.hypot(interior[:, 0] - cx, interior[:, 1] - cy)
    interior = interior[d > r + 0.55 * h]
    pts.append(interior)
    P = np.concatenate(pts, axis=0)

    from scipy.spatial import Delaunay

    tri = Delaunay(P)
    e = tri.simplices
    cent = P[e].mean(axis=1)
    keep = np.hypot(cent[:, 0] - cx, cent[:, 1] - cy) > r * 0.999
    e = e[keep]
    # drop sliver triangles hugging the hole (area << h^2)
    p0, p1, p2 = P[e[:, 0]], P[e[:, 1]], P[e[:, 2]]
    area = 0.5 * np.abs(
        (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
        - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0])
    )
    e = e[area > 1e-3 * h * h]
    # drop vertices that lost all their elements
    used = np.zeros(len(P), bool)
    used[e.ravel()] = True
    remap = -np.ones(len(P), np.int64)
    remap[used] = np.arange(used.sum())
    return P[used], remap[e]


def classify_boundary(v: np.ndarray, L=2.2, H=0.41, cx=0.2, cy=0.2, r=0.05,
                      tol=1e-9):
    """(inflow, walls, cylinder, outflow) vertex-id arrays."""
    inflow = np.where(np.abs(v[:, 0]) < tol)[0]
    outflow = np.where(np.abs(v[:, 0] - L) < tol)[0]
    walls = np.where(
        (np.abs(v[:, 1]) < tol) | (np.abs(v[:, 1] - H) < tol)
    )[0]
    d = np.hypot(v[:, 0] - cx, v[:, 1] - cy)
    cyl = np.where(d < r * (1 + 1e-6))[0]
    return inflow, walls, cyl, outflow


def cylinder_flow_system(
    h: float = 0.05,
    Re: float = 100.0,
    dt: float | None = None,
    U: float = 1.5,
    beta: float = 0.05,
) -> StokesSystem:
    """Stabilized P1-P1 Oseen system on the cylinder channel.

    Velocity unknowns are the non-Dirichlet (interior + outflow) nodes
    for each component; Dirichlet data (parabolic inflow u=(4U y(H-y)/H², 0),
    no-slip walls/cylinder) is eliminated into the right-hand side.
    Block form  [[F, Bᵀ], [B, -C]]  with C the Brezzi-Pitkäranta
    stabilization — consumed by SchurFieldsplitSolver / PCDR unchanged.
    """
    L_, H_ = 2.2, 0.41
    v, e = cylinder_channel_mesh(h=h, L=L_, H=H_)
    n = v.shape[0]
    inflow, walls, cyl, _ = classify_boundary(v, L=L_, H=H_)
    dir_nodes = np.unique(np.concatenate([inflow, walls, cyl]))
    free = np.setdiff1d(np.arange(n), dir_nodes)

    def wind(x, y):
        return np.column_stack(
            [4.0 * U * y * (H_ - y) / H_**2, np.zeros_like(y)]
        )

    K = gradgradform(v, e)
    M = mass_form(v, e)
    C = convection_form(v, e, wind)
    Bx, By = div_forms(v, e)

    F1 = (K / Re + C).tocsr()
    if dt is not None:
        F1 = (F1 + M / dt).tocsr()

    # Dirichlet values: inflow parabola on x-velocity, zero elsewhere
    uDx = np.zeros(n)
    uDx[inflow] = 4.0 * U * v[inflow, 1] * (H_ - v[inflow, 1]) / H_**2
    uDy = np.zeros(n)

    R = sp.eye(n, format="csr")[free]
    F_s = (R @ F1 @ R.T).tocsr()
    F = sp.block_diag([F_s, F_s], format="csr")
    Bxf = (Bx @ R.T).tocsr()
    Byf = (By @ R.T).tocsr()
    B = sp.hstack([Bxf, Byf], format="csr")
    Cstab = (beta * bp_stabilization(v, e)).tocsr()

    f = np.concatenate([-(F1 @ uDx)[free], -(F1 @ uDy)[free]])
    g = -(Bx @ uDx + By @ uDy)

    Fp = F1  # pressure convection-diffusion(-reaction) shares the scalar op
    Mu_diag = np.concatenate([(M @ np.ones(n))[free]] * 2)
    M_free = (R @ M @ R.T).tocsr()
    velocity_mass = sp.block_diag([M_free, M_free], format="csr")

    sys_ = StokesSystem(
        F=F,
        B=B,
        Mp=M.tocsr(),
        Ap=K.tocsr(),
        Fp=Fp.tocsr(),
        Mu_diag=Mu_diag,
        f=f,
        g=g,
        shape_u=(len(free), 2),
        shape_p=(n,),
        dt=dt,
        Re=Re,
        C=Cstab,
    )
    sys_.vertices = v
    sys_.elements = e
    # implicit-Euler forcing needs M_v @ u_old / dt (FEM mass, not identity)
    sys_.velocity_mass = velocity_mass
    sys_.free_velocity_nodes = free
    sys_.dirichlet = (dir_nodes, uDx, uDy)
    # the natural outflow condition pins the pressure there; PCD operators
    # must carry the same Dirichlet pin (deploy/preconditioners.py)
    _, _, _, outflow = classify_boundary(v, L=L_, H=H_)
    sys_.pressure_pin_nodes = outflow
    return sys_
