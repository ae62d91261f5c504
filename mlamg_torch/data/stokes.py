"""Staggered-grid (MAC) Stokes / Oseen saddle-point systems (counterpart of
``mlamg_tpu/data/stokes.py``).

Finite-difference MAC discretizations of

    (1/Re) (-lap u) + (w . grad) u + (1/dt) u + grad p = f
    div u = 0

on the unit square with Dirichlet (enclosed-flow) velocity BCs, in block
form [[F, B^T], [B, 0]], plus the pressure auxiliary operators (mass Mp,
stiffness Ap, convection-diffusion Fp) that the PCD(R) preconditioner
needs.  Pure numpy/scipy, so every block is bit-identical to the JAX
package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class StokesSystem:
    """Blocks of the MAC saddle-point system (scipy CSR)."""

    F: sp.csr_matrix          # velocity convection-diffusion(-reaction)
    B: sp.csr_matrix          # divergence: (n_p, n_u)
    Mp: sp.csr_matrix         # pressure mass
    Ap: sp.csr_matrix         # pressure Laplacian (Neumann)
    Fp: sp.csr_matrix         # pressure convection-diffusion
    Mu_diag: np.ndarray       # velocity mass diagonal
    f: np.ndarray             # momentum rhs
    g: np.ndarray             # continuity rhs
    shape_u: tuple
    shape_p: tuple
    dt: float | None
    Re: float
    # optional pressure-pressure block (e.g. Brezzi-Pitkäranta stabilization
    # for equal-order pairs): saddle matrix is [[F, B^T], [B, -C]]
    C: sp.csr_matrix | None = None

    @property
    def n_u(self) -> int:
        return self.F.shape[0]

    @property
    def n_p(self) -> int:
        return self.B.shape[0]

    def saddle_matrix(self) -> sp.csr_matrix:
        """Full [[F, B^T], [B, -C]] operator (C = 0 when unstabilized)."""
        Z = (-self.C) if self.C is not None else sp.csr_matrix(
            (self.n_p, self.n_p)
        )
        return sp.bmat([[self.F, self.B.T], [self.B, Z]], format="csr")

    def rhs(self) -> np.ndarray:
        return np.concatenate([self.f, self.g])


def _laplacian_1d(n, h):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)) / h**2


def _neumann_laplacian_1d(n, h):
    L = sp.lil_matrix((n, n))
    for i in range(n):
        L[i, i] = 2.0
        if i > 0:
            L[i, i - 1] = -1.0
        else:
            L[i, i] -= 1.0
        if i < n - 1:
            L[i, i + 1] = -1.0
        else:
            L[i, i] -= 1.0
    return (L / h**2).tocsr()


def _upwind_convection_1d(n, h, w):
    """First-order upwind d/dx with constant wind w."""
    if w >= 0:
        return w * sp.diags([1.0, -1.0], [0, -1], shape=(n, n)) / h
    return w * sp.diags([1.0, -1.0], [1, 0], shape=(n, n)) / h


def lid_driven_cavity(
    n: int = 16,
    Re: float = 100.0,
    dt: float | None = None,
    wind: tuple = (1.0, 0.0),
) -> StokesSystem:
    """MAC Oseen system on an n x n unit-square grid.

    Velocity unknowns are interior u (x-velocity on vertical edges,
    (n-1) x n) and v (y-velocity on horizontal edges, n x (n-1)); pressure
    at the n x n cell centres.  ``wind`` is the constant Oseen advection
    velocity (0,0 gives Stokes); ``dt`` adds the (1/dt) mass reaction term
    of an implicit time step (what makes the PCDR 'R' term matter,
    reference PCDR.py:152-154).
    """
    h = 1.0 / n
    nu_x = (n - 1) * n   # u unknowns
    nu_y = n * (n - 1)   # v unknowns
    n_p = n * n

    # -- momentum operator per component: (1/Re) * 2D Laplacian + upwind
    #    convection + (1/dt) I, with Dirichlet walls baked in
    def component_op(nx_, ny_):
        Lx = _laplacian_1d(nx_, h)
        Ly = _laplacian_1d(ny_, h)
        Ix = sp.eye(nx_)
        Iy = sp.eye(ny_)
        A = (1.0 / Re) * (sp.kron(Iy, Lx) + sp.kron(Ly, Ix))
        Cx = _upwind_convection_1d(nx_, h, wind[0])
        Cy = _upwind_convection_1d(ny_, h, wind[1])
        A = A + sp.kron(Iy, Cx) + sp.kron(Cy, Ix)
        if dt is not None:
            A = A + sp.eye(nx_ * ny_) / dt
        return sp.csr_matrix(A)

    Fu = component_op(n - 1, n)
    Fv = component_op(n, n - 1)
    F = sp.block_diag([Fu, Fv], format="csr")

    # -- divergence B: p-cell (i, j) gets (u[i,j] - u[i-1,j] + v[i,j] - v[i,j-1]) / h
    rows, cols, vals = [], [], []

    def u_idx(i, j):  # i in [0, n-2], j in [0, n-1]
        return j * (n - 1) + i

    def v_idx(i, j):  # i in [0, n-1], j in [0, n-2]
        return nu_x + j * n + i

    def p_idx(i, j):
        return j * n + i

    for j in range(n):
        for i in range(n):
            P = p_idx(i, j)
            if i < n - 1:  # u on right face
                rows.append(P); cols.append(u_idx(i, j)); vals.append(1.0 / h)
            if i > 0:      # u on left face
                rows.append(P); cols.append(u_idx(i - 1, j)); vals.append(-1.0 / h)
            if j < n - 1:  # v on top face
                rows.append(P); cols.append(v_idx(i, j)); vals.append(1.0 / h)
            if j > 0:      # v on bottom face
                rows.append(P); cols.append(v_idx(i, j - 1)); vals.append(-1.0 / h)
    B = sp.csr_matrix((vals, (rows, cols)), shape=(n_p, nu_x + nu_y))

    # -- pressure auxiliaries
    Mp = sp.eye(n_p, format="csr") * h**2
    Lx = _neumann_laplacian_1d(n, h)
    Ap = sp.csr_matrix(sp.kron(sp.eye(n), Lx) + sp.kron(Lx, sp.eye(n)))
    Cpx = _upwind_convection_1d(n, h, wind[0])
    Cpy = _upwind_convection_1d(n, h, wind[1])
    Fp = sp.csr_matrix(
        (1.0 / Re) * Ap + sp.kron(sp.eye(n), Cpx) + sp.kron(Cpy, sp.eye(n))
    )

    Mu_diag = np.full(nu_x + nu_y, h**2)

    # lid-driven rhs: the moving top wall enters the u-momentum equations of
    # the top row through the eliminated Dirichlet value u_lid = 1
    f = np.zeros(nu_x + nu_y)
    lid = 1.0
    for i in range(n - 1):
        f[u_idx(i, n - 1)] += (1.0 / Re) * lid / h**2
    g = np.zeros(n_p)

    return StokesSystem(
        F=F, B=B, Mp=Mp, Ap=Ap, Fp=Fp, Mu_diag=Mu_diag, f=f, g=g,
        shape_u=(n - 1, n), shape_p=(n, n), dt=dt, Re=Re,
    )
