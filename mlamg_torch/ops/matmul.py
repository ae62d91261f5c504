"""Sparse matrix products (counterpart of ``mlamg_tpu/ops/matmul.py``
:func:`spmv`, :func:`spmv_affine`, :func:`spmv_t`, :func:`spmm`,
:func:`spmm_t`, :func:`transpose`, :func:`spgemm_masked`, :func:`rap_dense`
and :func:`densify`).

A :class:`WindowedELL` goes to ``well_spmv`` and a :class:`DIA` to
``dia_spmv`` (the hand-written CUDA kernels on the card; the JAX package
sends only a pre-blocked DIA on a TPU to its kernel, the port every DIA on
CUDA).  A :class:`CSR` or :class:`ELL` runs as a gather plus an in-order
slot sum (:func:`~mlamg_torch.ops.sparse.slot_sum`): the JAX package's
gather plus ``segment_sum`` in the order the CPU adds it, and the same
order on every run on the card.  A :class:`BSR` is a batched product of
its blocks.  A dense tensor is a matmul.
"""

from __future__ import annotations

import torch

from mlamg_torch.ops.bsr import BSR, bsr_spmv, bsr_spmv_t
from mlamg_torch.ops.dia import DIA, dia_spmm, dia_spmv, dia_spmv_t
from mlamg_torch.ops.segment import ordered_sum
from mlamg_torch.ops.sparse import COO, CSR, ELL, slot_sum
from mlamg_torch.ops.unstructured import WindowedELL, well_spmv


def _ell_rowsum(data: torch.Tensor, col: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """sum_s data[:, s] * X[col[:, s]] in slot order; X is (n,) or (n, k)."""
    return ordered_sum(data[..., None] * X[col] if X.ndim == 2 else data * X[col], 1)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a dense tensor, CSR, ELL, BSR, DIA or WindowedELL A and
    a dense (n,) x."""
    if isinstance(A, torch.Tensor):
        return A @ x
    if isinstance(A, BSR):
        return bsr_spmv(A, x)
    if isinstance(A, WindowedELL):
        return well_spmv(A, x)
    if isinstance(A, DIA):
        return dia_spmv(A, x)
    if isinstance(A, ELL):
        return _ell_rowsum(A.data, A.col, x)
    if isinstance(A, CSR):
        return slot_sum(A.data * x[A.col], A.row_slots)
    raise TypeError(f"spmv: unsupported operand {type(A).__name__}")


def spmv_affine(A, x: torch.Tensor, c: torch.Tensor | None = None,
                alpha: float = 1.0) -> torch.Tensor:
    """y = alpha * (A @ x) + c; one kernel pass for a WindowedELL or DIA."""
    if isinstance(A, WindowedELL):
        return well_spmv(A, x, c=c, alpha=alpha)
    if isinstance(A, DIA):
        return dia_spmv(A, x, c=c, alpha=alpha)
    y = spmv(A, x)
    if alpha != 1.0:
        y = alpha * y
    return y if c is None else y + c


def spmv_t(A, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x without forming the transpose (dense, DIA, BSR, CSR or
    ELL A)."""
    if isinstance(A, DIA):
        return dia_spmv_t(A, x)
    if isinstance(A, BSR):
        return bsr_spmv_t(A, x)
    return spmm_t(A, x)


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a dense, DIA, CSR or ELL A (m, n) and a dense X (n, k)."""
    if isinstance(A, torch.Tensor):
        return A @ X
    if isinstance(A, DIA):
        return dia_spmm(A, X)
    if isinstance(A, ELL):
        return _ell_rowsum(A.data, A.col, X)
    if isinstance(A, CSR):
        return slot_sum(A.data[:, None] * X[A.col], A.row_slots)
    raise TypeError(f"spmm: unsupported operand {type(A).__name__}")


def spmm_t(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A.T @ X for a dense, CSR or ELL A (m, n) and a dense X (m,) or
    (m, k); each column's terms add in entry order."""
    if isinstance(A, torch.Tensor):
        return A.T @ X
    scale = (lambda d, v: d[:, None] * v) if X.ndim == 2 else (lambda d, v: d * v)
    if isinstance(A, ELL):
        m, w = A.data.shape
        contrib = scale(A.data.reshape(-1), X.repeat_interleave(w, dim=0))
        return slot_sum(contrib, A.col_slots)
    if isinstance(A, CSR):
        rows = A.row.clamp(max=A.shape[0] - 1)
        return slot_sum(scale(A.data, X[rows]), A.col_slots)
    raise TypeError(f"spmm_t: unsupported operand {type(A).__name__}")


def transpose(A) -> CSR:
    """A.T as a CSR (a CSR or COO A), by the stable (row, col) sort of the
    flipped coordinates; padding keeps the sentinel row and goes to the
    tail."""
    m, n = A.shape
    mask = A.row < m
    flipped = COO(A.data, torch.where(mask, A.col, torch.full_like(A.col, n)),
                  torch.where(mask, A.row, torch.zeros_like(A.row)), (n, m), A.nnz)
    return flipped.sort_rows()


def spgemm_masked(A, B, pattern: CSR, *, a_width: int, b_width: int) -> CSR:
    """(A @ B) on the sparsity pattern of ``pattern``.

    For every pattern entry (i, j), sum_k A[i, k] * B[k, j] from A's
    fixed-width row i against B's fixed-width rows: an (nnz, a_width,
    b_width) contraction with no sort.  B's rows hold each column once, so
    the inner sum has one term; the a_width terms add in slot order.
    """
    m = A.shape[0]
    A_ell = A if isinstance(A, ELL) else A.to_ell(a_width)
    B_ell = B if isinstance(B, ELL) else B.to_ell(b_width)
    i = pattern.row.clamp(max=m - 1)
    a_cols, a_vals = A_ell.col[i], A_ell.data[i]  # (E, wa)
    b_cols, b_vals = B_ell.col[a_cols], B_ell.data[a_cols]  # (E, wa, wb)
    match = b_cols == pattern.col[:, None, None]
    inner = torch.where(match, b_vals, torch.zeros_like(b_vals)).sum(2)
    vals = ordered_sum(a_vals * inner, 1)
    return pattern.with_data(torch.where(pattern.mask, vals, torch.zeros_like(vals)))


def densify(P) -> torch.Tensor:
    """Dense view of a dense, CSR or ELL operator (small operators only)."""
    return P if isinstance(P, torch.Tensor) else P.todense()


def rap_dense(A, P) -> torch.Tensor:
    """Dense coarse Galerkin operator P.T @ A @ P, shape (k, k); a CSR or
    ELL ``P`` is densified first (duplicate coordinates sum)."""
    P = densify(P)
    return P.T @ spmm(A, P)
