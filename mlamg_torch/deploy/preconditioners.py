"""Deployable preconditioners (counterpart of
``mlamg_tpu/deploy/preconditioners.py``).

- :class:`LearnedAMGPreconditioner`, the MLAMG role: greedy C/F
  coarsening, P from a trained C/F-interpolation network (or Jacobi-SA on
  the splitting), a dense-LU coarse operator, and an apply of two-level
  iterations up to a residual tolerance.
- :class:`SAPreconditioner`, the PyAMG role: smoothed-aggregation V-cycles
  over :func:`~mlamg_torch.mg.cycle.build_hierarchy`.
- :class:`PCDRPreconditioner`: the pressure-convection-diffusion-reaction
  Schur approximation S^-1 ~ Kp^-1 Fp Mp^-1 + Rp^-1, Rp = dt B D^-1 B^T.

Each dense operator is built on the device from its CSR (a scatter into a
device tensor, :func:`dense_lu`), never through a host ``toarray``: at
cavity n 128 the velocity block alone is 32,512² entries.  Each setup
records the seconds its dense LU factorizations took in ``lu_seconds``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mlamg_torch.deploy.options import Options
from mlamg_torch.device import resolve_device
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.cycle import build_hierarchy, vcycle
from mlamg_torch.ops import matmul
from mlamg_torch.ops.sparse import CSR


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dense_lu(A_scipy, dtype, device, singular: bool = False) -> tuple[CoarseSolver, float]:
    """(LU of the dense A, seconds): A scattered into a dense tensor on
    ``device`` from its CSR, then factored (Lagrange-bordered when
    ``singular``)."""
    _sync(device)
    t0 = time.perf_counter()
    lu = CoarseSolver.factor(CSR.from_scipy(A_scipy, dtype=dtype, device=device).todense(),
                             singular=singular)
    _sync(device)
    return lu, time.perf_counter() - t0


class LearnedAMGPreconditioner:
    """Two-level learned AMG as a preconditioner callback.

    Options (prefix ``mlamg_``): ``amg_rtol`` (default 1e-8),
    ``greedy_theta`` (0.56), ``jacobi_weight`` (2/3), ``max_iter`` (100),
    ``pnet_model`` (a checkpoint of the C/F-interpolation network, whose
    ``extra.net_config`` gives its architecture; without it, and without
    ``net``, P is Jacobi-SA on the greedy splitting).  ``net`` is a port
    :class:`~mlamg_torch.models.cf_interp.CFInterpolationNetwork` with its
    weights.
    """

    def __init__(self, A_scipy, options: Options | None = None, net=None,
                 dtype=torch.float32, device=None):
        from mlamg_torch.convert import cfnet_from_params
        from mlamg_torch.graph.coarsening import greedy_coarsening
        from mlamg_torch.mg.interp import smoothed_aggregation
        from mlamg_torch.models.cf_interp import cf_rank
        from mlamg_torch.utils.checkpoint import load_checkpoint

        dev = resolve_device(device)
        opts = (options or Options()).scoped("mlamg_")
        self.rtol = opts.get_scalar("amg_rtol", 1e-8)
        self.theta = opts.get_scalar("greedy_theta", 0.56)
        self.omega = opts.get_scalar("jacobi_weight", 2.0 / 3.0)
        self.max_iter = opts.get_int("max_iter", 100)
        model_path = opts.get_string("pnet_model", "")

        n = A_scipy.shape[0]
        self.A = CSR.from_scipy(A_scipy, dtype=dtype, device=dev)
        d = A_scipy.diagonal()
        self.Dinv = torch.from_numpy(self.omega / np.where(d != 0, d, 1.0)).to(dev, dtype)

        _, _, C = greedy_coarsening(A_scipy, self.theta)
        is_coarse = np.zeros(n, bool)
        is_coarse[C] = True
        c_rank, num_c = cf_rank(is_coarse)
        self.num_coarse = num_c
        c_rank_t = torch.from_numpy(c_rank.astype(np.int64)).to(dev)

        if net is None and model_path:
            ck = load_checkpoint(model_path)
            net = cfnet_from_params(ck["best_params"], (ck.get("extra") or {}).get("net_config"),
                                    device=dev, dtype=dtype)
        if net is not None:
            with torch.no_grad():
                P = net(self.A, torch.from_numpy(is_coarse).to(dev), c_rank_t, num_c)
            R = P
        else:
            # Jacobi-SA with every node tied to a coarse column (its C rank).
            # F nodes before the first C node have rank -1; the JAX package
            # keeps that column: its gather and its dense scatter wrap it to
            # the last coarse column and its segment sum drops it, so there
            # the restriction R is not P's transpose.  Both are kept.
            P = smoothed_aggregation(self.A, c_rank_t, num_c)
            neg = P.col < 0
            zero = torch.zeros_like(P.col)
            R = CSR(torch.where(neg, torch.zeros_like(P.data), P.data),
                    torch.where(neg, zero + n, P.row), torch.where(neg, zero, P.col),
                    P.indptr, P.shape, P.nnz)
            P = CSR(P.data, P.row, torch.where(neg, P.col + num_c, P.col), P.indptr, P.shape,
                    P.nnz)
        self.P, self.R = P, R
        A_H = matmul.rap_dense(self.A, P)
        _sync(dev)
        t0 = time.perf_counter()
        self.coarse = CoarseSolver.factor(A_H)
        _sync(dev)
        self.lu_seconds = time.perf_counter() - t0

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        """Two-level iterations from x = 0 (Jacobi, coarse correction,
        Jacobi) until |b - A x| <= amg_rtol or ``max_iter``.  With amg_rtol
        0 the norm is not read: it meets the test only when the residual is
        exactly 0, and then further iterations leave x as it is."""
        A, Dinv = self.A, self.Dinv
        x = torch.zeros_like(b)
        for _ in range(self.max_iter):
            x = x + Dinv * (b - matmul.spmv(A, x))
            r = b - matmul.spmv(A, x)
            x = x + matmul.spmv(self.P, self.coarse.solve(matmul.spmv_t(self.R, r)))
            x = x + Dinv * (b - matmul.spmv(A, x))
            if self.rtol > 0 and float(torch.linalg.vector_norm(b - matmul.spmv(A, x))) <= self.rtol:
                break
        return x


class SAPreconditioner:
    """Smoothed-aggregation V-cycles as a preconditioner.  Options prefix
    ``pyamg_``: ``amg_max_levels`` (3), ``cycles`` (1), ``alpha`` (0.1)."""

    def __init__(self, A_scipy, options: Options | None = None, dtype=torch.float32,
                 device=None):
        dev = resolve_device(device)
        opts = (options or Options()).scoped("pyamg_")
        max_levels = opts.get_int("amg_max_levels", 3)
        self.cycles = opts.get_int("cycles", 1)
        alpha = opts.get_scalar("alpha", 0.1)
        width = int(np.diff(A_scipy.indptr).max())
        self.A = CSR.from_scipy(A_scipy, dtype=dtype, device=dev)
        self.h = build_hierarchy(self.A, alpha=alpha, max_levels=max_levels, width=width)
        self.lu_seconds = None  # the coarsest LU is part of build_hierarchy

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        x = torch.zeros_like(b)
        for _ in range(self.cycles):
            x = vcycle(self.h, b, x)
        return x


class PCDRPreconditioner:
    """S^-1 ~ Kp^-1 Fp Mp^-1 + Rp^-1 with Rp = dt B diag(Mu)^-1 B^T, every
    sub-solve a dense LU.

    On a flow with an open boundary (``pressure_pin_nodes``) the natural
    outflow condition pins the pressure there, and Kp and Rp carry the same
    Dirichlet pin; an enclosed flow keeps the Lagrange pinning
    (``singular``).  An equal-order (P1-P1) system adds its stabilization
    block C to Rp, which is singular on the checkerboard modes without it.
    """

    def __init__(self, system, dtype=torch.float32, device=None):
        import scipy.sparse as sp

        dev = resolve_device(device)
        pin = np.asarray(getattr(system, "pressure_pin_nodes", []), np.int64)
        singular = pin.size == 0

        def apply_pin(A):
            if singular:
                return A
            A = A.tolil()
            A[pin, :] = 0.0
            A[:, pin] = 0.0
            A[pin, pin] = 1.0
            return A.tocsr()

        self.Fp = CSR.from_scipy(system.Fp, dtype=dtype, device=dev)
        self.Mp_solver, t_m = dense_lu(system.Mp, dtype, dev)
        self.Kp_solver, t_k = dense_lu(apply_pin(system.Ap.copy()), dtype, dev, singular)
        self.lu_seconds = t_m + t_k
        self.Rp_solver = None
        if system.dt is not None:
            Rp = (system.B @ sp.diags(1.0 / system.Mu_diag) @ system.B.T) * system.dt
            if getattr(system, "C", None) is not None:
                Rp = Rp + system.C
            self.Rp_solver, t_r = dense_lu(apply_pin(Rp.tocsr()), dtype, dev, singular)
            self.lu_seconds += t_r

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Kp_solver.solve(matmul.spmv(self.Fp, self.Mp_solver.solve(x)))
        if self.Rp_solver is not None:
            y = y + self.Rp_solver.solve(x)
        return y
