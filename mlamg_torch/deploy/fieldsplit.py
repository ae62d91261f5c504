"""Schur-complement fieldsplit solver for saddle-point systems (counterpart
of ``mlamg_tpu/deploy/fieldsplit.py``).

FGMRES on the block system [[F, B^T], [B, -C]] (C = 0 unless the system is
stabilized), right-preconditioned by the full Schur factorization

    M^-1 [r_u; r_p]:  u* = F^-1 r_u
                      p  = -S^-1 (r_p - B u*)
                      u  = u* - F^-1 B^T p

with F^-1 a dense LU (or a given momentum solver) and S^-1 a pluggable
preconditioner (PCDR, learned AMG, SA).
"""

from __future__ import annotations

from typing import Callable

import torch

from mlamg_torch.deploy.preconditioners import dense_lu
from mlamg_torch.device import resolve_device
from mlamg_torch.mg.krylov import fgmres
from mlamg_torch.ops import matmul
from mlamg_torch.ops.bsr import BSR
from mlamg_torch.ops.sparse import CSR


class SchurFieldsplitSolver:
    """``schur_pc(r_p) -> ~S^-1 r_p``; ``momentum_solver(r_u) -> ~F^-1 r_u``
    (default: a dense LU of F, built on the device, its seconds in
    ``lu_seconds``).  ``momentum_bs`` stores F as a BSR with that block
    size (2 or 3 for 2-D or 3-D vector dofs)."""

    def __init__(self, system, schur_pc: Callable, momentum_solver: Callable | None = None,
                 dtype=torch.float32, momentum_bs: int | None = None, device=None):
        dev = resolve_device(device)
        self.sys = system
        if momentum_bs:
            self.F = BSR.from_scipy(system.F, bs=momentum_bs, dtype=dtype, device=dev)
        else:
            self.F = CSR.from_scipy(system.F, dtype=dtype, device=dev)
        self.B = CSR.from_scipy(system.B, dtype=dtype, device=dev)
        self.n_u = system.n_u
        self.n_p = system.n_p
        self.lu_seconds = 0.0
        if momentum_solver is None:
            lu, self.lu_seconds = dense_lu(system.F, dtype, dev)
            momentum_solver = lu.solve
        self.momentum_solver = momentum_solver
        self.schur_pc = schur_pc
        C = getattr(system, "C", None)
        self.C = CSR.from_scipy(C, dtype=dtype, device=dev) if C is not None else None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        u, p = x[: self.n_u], x[self.n_u:]
        ru = matmul.spmv(self.F, u) + matmul.spmv_t(self.B, p)
        rp = matmul.spmv(self.B, u)
        if self.C is not None:
            rp = rp - matmul.spmv(self.C, p)
        return torch.cat([ru, rp])

    def preconditioner(self, r: torch.Tensor) -> torch.Tensor:
        ru, rp = r[: self.n_u], r[self.n_u:]
        u_star = self.momentum_solver(ru)
        p = -self.schur_pc(rp - matmul.spmv(self.B, u_star))
        u = u_star - self.momentum_solver(matmul.spmv_t(self.B, p))
        return torch.cat([u, p])

    def solve(self, b: torch.Tensor | None = None, tol: float = 1e-8, restart: int = 30,
              max_restarts: int = 20):
        """Returns (x, residual_history, iterations); ``b`` defaults to the
        system's right-hand side."""
        if b is None:
            b = torch.from_numpy(self.sys.rhs()).to(self.B.data.device, self.B.dtype)
        return fgmres(_CallableOp(self.matvec, self.n_u + self.n_p), b, M=self.preconditioner,
                      restart=restart, max_restarts=max_restarts, tol=tol)


class _CallableOp:
    """An operator given as a matvec, for :mod:`mlamg_torch.mg.krylov`."""

    def __init__(self, mv, n: int):
        self._mv = mv
        self.shape = (n, n)

    def __matmul__(self, x):
        return self._mv(x)
