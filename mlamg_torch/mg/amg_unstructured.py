"""Large-scale unstructured multilevel SA-AMG with a factored prolongator
(counterpart of ``mlamg_tpu/mg/amg_unstructured.py``).

Setup per level: RCM order -> strength -> Lloyd aggregation -> SA omega
from a Gershgorin bound -> Galerkin product A_H = P^T A P on the host
(scipy).  Level operators are stored RCM-ordered as :class:`WindowedELL`
(``fmt="well"``, the CUDA kernel's layout) or :class:`CSR`.

The cycle never materializes P: interpolation and restriction apply the
factors directly,

    P e   = u - omega * Dinv * (A @ u),   u = e[agg]          (one SpMV)
    P^T r = segment_sum(r - omega * A @ (Dinv * r), agg)      (one SpMV)

(valid for symmetric A, checked at setup), so every level's work is
SpMV-class streaming through the level operator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.ops import matmul
from mlamg_torch.ops.segment import segment_sum
from mlamg_torch.ops.sparse import CSR

# ---------------------------------------------------------------------------
# Pattern computation and truncation (host, scipy)
# ---------------------------------------------------------------------------


def galerkin_patterns(A_sp, agg: np.ndarray, k: int, smooth_steps: int = 1):
    """(P_pat, AP_pat, AH_pat) scipy boolean patterns for P = S^s T."""
    import scipy.sparse as sp

    A_sp = sp.csr_matrix(A_sp)
    n = A_sp.shape[0]
    Bpat = sp.csr_matrix(
        (np.ones(A_sp.nnz, np.float64), A_sp.indices, A_sp.indptr), shape=(n, n)
    )
    coo = A_sp.tocoo()
    Ppat = sp.csr_matrix(
        (np.ones(A_sp.nnz, np.float64), (coo.row, agg[coo.col])), shape=(n, k)
    )
    Ppat.sum_duplicates()
    Ppat.data[:] = 1.0
    for _ in range(smooth_steps - 1):
        Ppat = (Bpat @ Ppat).tocsr()
        Ppat.data[:] = 1.0
    Ppat.sort_indices()
    APpat = (Bpat @ Ppat).tocsr()
    APpat.data[:] = 1.0
    AHpat = (Ppat.T.tocsr() @ APpat).tocsr()
    AHpat.data[:] = 1.0
    AHpat.sort_indices()
    APpat.sort_indices()
    return Ppat, APpat, AHpat


def truncate_lump(A_sp, theta: float, mode: str = "lump_clip"):
    """Drop coarse-operator entries with |a_ij| < theta*sqrt(|a_ii a_jj|).

    The keep criterion is symmetric, so the pattern stays symmetric, as the
    factored restriction requires.  ``mode="drop"`` removes small entries;
    ``"lump_clip"`` also lumps the dropped mass onto the diagonal, clipped
    so no diagonal loses more than half its value.
    """
    import scipy.sparse as sp

    if theta <= 0:
        return A_sp
    A_sp = sp.csr_matrix(A_sp)
    n = A_sp.shape[0]
    coo = A_sp.tocoo()
    d = np.asarray(A_sp.diagonal(), np.float64)
    scale = np.sqrt(np.abs(d[coo.row] * d[coo.col])) + 1e-30
    diag = coo.row == coo.col
    keep = diag | (np.abs(coo.data) >= theta * scale)
    A2 = sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A_sp.shape
    ).tocsr()
    if mode == "lump_clip":
        dropped = np.bincount(
            coo.row, weights=np.where(keep, 0.0, coo.data), minlength=n
        )
        lump = np.maximum(dropped, -0.5 * np.abs(d))
        A2 = (A2 + sp.diags(lump.astype(A_sp.dtype))).tocsr()
    A2.sort_indices()
    return A2


# ---------------------------------------------------------------------------
# Hierarchy containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ULevel:
    """One level: operator + factored-P ingredients.

    ``omegas`` and ``lmax`` are host floats (f32 values) so the cycle's
    scalar arithmetic never waits on the device.
    """

    A: Any  # WindowedELL or CSR
    Dinv: torch.Tensor  # (n,) f32
    agg: torch.Tensor  # (n,) int64 aggregate ids in [0, k)
    omegas: Tuple[float, ...]  # SA prolongator smoothing weights
    lmax: float  # Gershgorin bound of D^-1 A (Chebyshev smoothing)
    k: int


@dataclasses.dataclass(frozen=True)
class UHierarchy:
    levels: Tuple[ULevel, ...]
    coarse: CoarseSolver

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1


def _level_operator(A_sp, fmt: str, block_rows: int, device):
    if fmt == "well":
        from mlamg_torch.ops.unstructured import WindowedELL

        return WindowedELL.from_scipy(A_sp, block_rows=block_rows, device=device)
    if fmt == "csr":
        return CSR.from_scipy(A_sp, dtype=torch.float32, device=device)
    raise ValueError(f"unknown level operator format: {fmt}")


def _make_level(lev: Mapping, fmt: str, block_rows: int, device) -> ULevel:
    """ULevel from host data: scipy ``A``, ``Dinv``, ``agg``, ``omegas``,
    ``lmax``, ``k``."""
    return ULevel(
        _level_operator(lev["A"], fmt, block_rows, device),
        torch.tensor(np.asarray(lev["Dinv"], np.float32), device=device),
        torch.tensor(np.asarray(lev["agg"], np.int64), device=device),
        tuple(float(w) for w in np.asarray(lev["omegas"], np.float32).reshape(-1)),
        float(np.float32(lev["lmax"])),
        int(lev["k"]),
    )


# ---------------------------------------------------------------------------
# Cycle
# ---------------------------------------------------------------------------


def interp_factored(lev: ULevel, e_H: torch.Tensor) -> torch.Tensor:
    """P e_H = prod_i (I - w_i D^-1 A) (e_H injected through the
    aggregation); the factors commute, so application order is free."""
    u = e_H[lev.agg]
    for w in lev.omegas:
        u = u - w * lev.Dinv * matmul.spmv(lev.A, u)
    return u


def restrict_factored(lev: ULevel, r: torch.Tensor) -> torch.Tensor:
    """P^T r for symmetric A: segment-sum of prod_i (I - w_i A D^-1) r."""
    for w in lev.omegas:
        r = r - w * matmul.spmv(lev.A, lev.Dinv * r)
    return segment_sum(r, lev.agg, lev.k)


def uvcycle(h: UHierarchy, b: torch.Tensor, x: torch.Tensor, *,
            omega_jac: float = 0.666, nu: int = 1, smoother: str = "chebyshev",
            lmin_frac: float = 1.0 / 30.0, gamma: int = 1) -> torch.Tensor:
    """One multigrid cycle; all levels SpMV-class work.

    ``smoother="chebyshev"`` runs a degree-``nu+1`` Chebyshev polynomial per
    pre/post smooth, ``"jacobi"`` ``nu`` weighted-Jacobi sweeps.
    ``gamma=1`` is a V-cycle, ``gamma=2`` a W-cycle.
    """
    from mlamg_torch.mg.smoothers import chebyshev

    if smoother not in ("chebyshev", "jacobi"):
        raise ValueError(f"unknown smoother: {smoother}")

    def smooth(lev, b, x):
        if smoother == "chebyshev":
            return chebyshev(lev.A, b, x, 1.1 * lev.lmax, lmin_frac=lmin_frac,
                             degree=nu + 1, Dinv=lev.Dinv)
        for _ in range(nu):
            r = matmul.spmv_affine(lev.A, x, c=b, alpha=-1.0)
            x = x + omega_jac * lev.Dinv * r
        return x

    def descend(l, b, x):
        lev = h.levels[l]
        x = smooth(lev, b, x)
        r = matmul.spmv_affine(lev.A, x, c=b, alpha=-1.0)
        r_H = restrict_factored(lev, r)
        if l + 1 == len(h.levels):
            e_H = h.coarse.solve(r_H)
        else:
            e_H = descend(l + 1, r_H, torch.zeros_like(r_H))
            for _ in range(gamma - 1):
                e_H = descend(l + 1, r_H, e_H)
        x = x + interp_factored(lev, e_H)
        return smooth(lev, b, x)

    return descend(0, b, x)


def uvcycle_solve(h: UHierarchy, b: torch.Tensor, x0: torch.Tensor, *,
                  res_tol: float = 1e-10, max_iter: int = 100,
                  omega_jac: float = 0.666, nu: int = 1,
                  smoother: str = "chebyshev", lmin_frac: float = 1.0 / 30.0,
                  gamma: int = 1):
    """Iterated cycles until ||b - A x|| <= res_tol or ``max_iter``, with
    the conv-factor readout.  Returns (x, conv, err, iters)."""
    from mlamg_torch.mg.cycle import _conv_factor

    A = h.levels[0].A
    err = torch.zeros(max_iter, dtype=x0.dtype, device=x0.device)
    x = x0
    iters = 0
    while iters < max_iter:
        x = uvcycle(h, b, x, omega_jac=omega_jac, nu=nu, smoother=smoother,
                    lmin_frac=lmin_frac, gamma=gamma)
        e = torch.linalg.vector_norm(matmul.spmv_affine(A, x, c=b, alpha=-1.0))
        err[iters] = e
        iters += 1
        if float(e) <= res_tol:
            break
    return x, _conv_factor(err, iters), err, iters


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def build_unstructured_hierarchy(
    A_sp,
    *,
    alpha: float = 0.1,
    max_levels: int = 4,
    min_coarse: int = 800,
    strength_kind: str = "abs",
    lloyd_maxiter: int = 3,
    seed_mode: str = "stride",
    smooth_steps: int = 1,
    trunc_theta: float = 0.02,
    seed: int = 0,
    coarse_method: str = "inverse",
    fmt: str | None = None,
    block_rows: int = 8,
    profile_out: dict | None = None,
    rap_mode: str = "auto",
    device=None,
):
    """SA multilevel setup for a symmetric scipy operator.

    Per level: RCM order -> strength -> Lloyd aggregation -> SA omegas from
    a Gershgorin bound -> host Galerkin RAP -> truncation.  ``fmt`` is
    ``"well"`` (default on CUDA) or ``"csr"`` (default on the CPU).

    Setup runs on ``device``: strength and Lloyd on the hierarchy's device,
    the Galerkin product in scipy (``rap_mode="auto"``; the device product,
    ``"device"``, is not ported yet and raises).  ``seed`` seeds the
    ``torch.Generator`` of ``seed_mode="random"``.  ``profile_out``, when given, receives seconds
    per setup stage.

    Returns (hierarchy, perm): solve in permuted space, i.e. x =
    unpermute(solution of (P A P^T) y = b[perm]).
    """
    import scipy.sparse as sp
    from mlamg_torch import native
    from mlamg_torch.graph.lloyd import lloyd_aggregation
    from mlamg_torch.graph.strength import strength_measure

    dev = resolve_device(device)
    if fmt is None:
        fmt = "well" if dev.type == "cuda" else "csr"
    if rap_mode != "auto":
        raise NotImplementedError(
            f"rap_mode={rap_mode!r}: only the host Galerkin product ('auto') is "
            "ported; the pattern-masked device product needs spgemm_masked "
            "(ROADMAP.md Queue 1 item 10)"
        )
    if seed_mode not in ("stride", "random"):
        raise ValueError(f"unknown seed_mode: {seed_mode}")

    A_sp = sp.csr_matrix(A_sp).astype(np.float32)
    if (abs(A_sp - A_sp.T) > 1e-6 * abs(A_sp).max()).nnz:
        raise ValueError(
            "build_unstructured_hierarchy requires a symmetric operator "
            "(the factored restriction applies A in place of A^T)"
        )

    prof: dict = {}

    def _tick(label, t0):
        prof[label] = prof.get(label, 0.0) + (time.time() - t0)
        return time.time()

    generator = torch.Generator().manual_seed(seed)
    levels: list[dict] = []
    perm0 = None
    level_A = A_sp
    for lvl in range(max_levels - 1):
        t = time.time()
        n = level_A.shape[0]
        # RCM-order this level (fine level: banded columns for the SpMV;
        # coarse levels: keeps aggregate numbering banded for the next one)
        perm = np.asarray(native.rcm_ordering(level_A))
        level_A = level_A[perm][:, perm].tocsr()
        level_A.sort_indices()
        if lvl == 0:
            perm0 = perm
        else:
            # the parent's aggregate ids follow the relabeling
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            levels[-1]["agg"] = inv[levels[-1]["agg"]]
        t = _tick("rcm_reorder", t)

        d = np.asarray(level_A.diagonal())
        Dinv = (1.0 / np.where(d != 0, d, 1.0)).astype(np.float32)
        if n <= min_coarse:
            break
        k = int(np.ceil(alpha * n))

        A_setup = CSR.from_scipy(level_A, dtype=torch.float32, device=dev)
        C = strength_measure(A_setup, strength_kind)
        if seed_mode == "stride":
            # the level is RCM-ordered, so an index stride is a spatially
            # stratified seeding
            seeds = np.unique(np.linspace(0, n - 1, k).round().astype(np.int32))
            k = int(seeds.shape[0])
            agg_id, _, _ = lloyd_aggregation(C, maxiter=lloyd_maxiter, seeds=seeds)
        else:
            agg_id, _, _ = lloyd_aggregation(
                C, ratio=alpha, maxiter=lloyd_maxiter, generator=generator
            )
        agg = agg_id.cpu().numpy().copy()
        t = _tick("strength_lloyd", t)
        un = agg >= k
        if un.any():
            # nodes unreachable from every seed: singleton aggregates
            agg[un] = k + np.arange(int(un.sum()))
            k += int(un.sum())
        # drop empty aggregates (they would give zero coarse rows)
        used = np.unique(agg)
        if used.shape[0] < k:
            remap = np.zeros(k, np.int64)
            remap[used] = np.arange(used.shape[0])
            agg = remap[agg]
            k = int(used.shape[0])

        # rigorous Gershgorin bound of D^-1 A (a power iteration's
        # underestimate puts the true lmax outside the Chebyshev interval)
        coo = level_A.tocoo()
        absrow = np.bincount(coo.row, weights=np.abs(coo.data), minlength=n)
        lmax = np.float32(np.max(absrow / np.abs(np.where(d != 0, d, 1.0))))
        lmax_s = lmax if lmax > 0 else np.float32(1.0)
        if smooth_steps == 1:
            omegas = np.array([np.float32(4.0 / 3.0) / lmax_s], np.float32)
        else:
            # inverse Chebyshev roots over [lmax/15, lmax]
            a_b = lmax_s / np.float32(15.0)
            b_b = lmax_s
            ang = (2.0 * np.arange(1, smooth_steps + 1) - 1) / (2.0 * smooth_steps) * np.pi
            roots = (a_b + b_b) / np.float32(2.0) + (b_b - a_b) / np.float32(2.0) * np.cos(ang).astype(np.float32)
            omegas = (np.float32(1.0) / roots).astype(np.float32)
        t = _tick("sa_omegas", t)

        T_host = sp.csr_matrix(
            (np.ones(n, np.float32), (np.arange(n), agg)), shape=(n, k)
        )
        DinvA = (sp.diags(Dinv) @ level_A).tocsr()
        Psp = T_host
        for w in omegas.astype(np.float64):
            Psp = (Psp - np.float32(w) * (DinvA @ Psp)).tocsr()
        t = _tick("p_smooth", t)
        AH_sp = (Psp.T @ (level_A @ Psp)).tocsr()
        t = _tick("rap", t)
        AH_sp.sum_duplicates()
        AH_sp.eliminate_zeros()
        AH_sp = truncate_lump(AH_sp, trunc_theta)
        t = _tick("truncate", t)

        levels.append(dict(A=level_A, Dinv=Dinv, agg=agg, omegas=omegas,
                           lmax=lmax, k=k))
        level_A = AH_sp

    t = time.time()
    ulevels = tuple(_make_level(lev, fmt, block_rows, dev) for lev in levels)
    t = _tick("repack", t)
    coarse = CoarseSolver.factor(
        torch.from_numpy(level_A.toarray().astype(np.float32)).to(dev),
        method=coarse_method,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _tick("coarse_factor", t)
    if profile_out is not None:
        profile_out.update(prof)
    return UHierarchy(ulevels, coarse), perm0

