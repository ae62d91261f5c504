"""Sparse matrix products (counterpart of ``mlamg_tpu/ops/matmul.py``).

A :class:`WindowedELL` goes to ``well_spmv`` and a :class:`DIA` to
``dia_spmv`` (the hand-written CUDA kernels on the card; the JAX package
sends only a pre-blocked DIA on a TPU to its kernel, the port every DIA on
CUDA).  A :class:`CSR` or :class:`ELL` runs as a gather plus an in-order
slot sum (:func:`~mlamg_torch.ops.segment.slot_sum`): the JAX package's
gather plus ``segment_sum`` in the order the CPU adds it, and the same
order on every run on the card.  A :class:`BSR` is a batched product of
its blocks.  A dense tensor is a matmul.

The sparse-sparse products keep JAX's static capacities.  :func:`spgemm`,
:func:`rap` and :func:`rap_fused` expand every candidate product term
and :func:`coalesce` them (one sort by (row, col), duplicates summed,
padded to ``nnz_out``; past ``nnz_out`` the largest coordinates are
dropped and an overflow flag says so).  :func:`spgemm_masked` computes a
product only on a pattern known beforehand, with no sort, in chunks of
pattern entries.  All are differentiable with respect to the values.
"""

from __future__ import annotations

import torch

from mlamg_torch.ops.bsr import BSR, bsr_spmv, bsr_spmv_t
from mlamg_torch.ops.dia import DIA, dia_spmm, dia_spmv, dia_spmv_t
from mlamg_torch.ops.segment import ordered_sum, slot_sum
from mlamg_torch.ops.sparse import COO, CSR, ELL
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
    if alpha == -1.0 and c is not None:
        return c - y  # the bits of -y + c, in one pass
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


def coalesce(data: torch.Tensor, row: torch.Tensor, col: torch.Tensor, shape,
             nnz_out: int, return_overflow: bool = False):
    """Sort COO triplets by (row, col), sum duplicates, pad to ``nnz_out``.

    Entries with ``row >= shape[0]`` are padding.  One sort of the int64
    key row * (n + 1) + col (the order of the JAX package's packed or
    two-key sort); each run of equal keys is one output entry, added into
    its slot (a dump slot takes the padding and every slot past
    ``nnz_out``).  If the coalesced nnz exceeds ``nnz_out`` the largest
    coordinates are dropped; with ``return_overflow`` the pair (CSR,
    overflowed) is returned, ``overflowed`` a 0-d bool tensor, and a
    caller that builds a hierarchy must check it.
    """
    m, n = shape
    mask = row < m
    key = torch.where(mask, row * (n + 1) + col, torch.full_like(row, m * (n + 1)))
    key, order = torch.sort(key)
    d = torch.where(mask, data, torch.zeros_like(data))[order]
    r = key // (n + 1)
    c = key - r * (n + 1)
    rm = r < m
    new_seg = torch.ones_like(rm)
    new_seg[1:] = key[1:] != key[:-1]
    first = new_seg & rm  # the first entry of each output coordinate
    seg = torch.cumsum(first, 0) - 1
    count = first.sum()
    seg = torch.where(rm, seg, torch.full_like(seg, nnz_out)).clamp(max=nnz_out)
    out_data = d.new_zeros(nnz_out + 1).index_add(0, seg, d)[:nnz_out]
    used = torch.arange(nnz_out, device=row.device) < count
    dump = torch.where(first, seg, torch.full_like(seg, nnz_out))
    out_row = torch.full((nnz_out + 1,), m, dtype=r.dtype, device=r.device)
    out_row = out_row.scatter(0, dump, r)[:nnz_out]
    out_col = torch.zeros(nnz_out + 1, dtype=c.dtype, device=c.device).scatter(0, dump, c)
    out_row = torch.where(used, out_row, torch.full_like(out_row, m))
    out_col = torch.where(used, out_col[:nnz_out], torch.zeros_like(out_row))
    out_data = torch.where(used, out_data, torch.zeros_like(out_data))
    indptr = torch.searchsorted(out_row, torch.arange(m + 1, dtype=r.dtype, device=r.device))
    out = CSR(out_data, out_row, out_col, indptr, (m, n), nnz_out)
    return (out, count > nnz_out) if return_overflow else out


def spgemm(A: CSR, B, *, nnz_out: int, b_width: int | None = None,
           return_overflow: bool = False):
    """C = A @ B with a static capacity ``nnz_out``: every A entry (i, k, a)
    times B's (fixed-width, ``b_width``) row k, then :func:`coalesce`.  A
    slot with a zero B value (B's padding, or a stored zero) makes no
    entry."""
    m, p = A.shape
    if B.shape[0] != p:
        raise ValueError(f"spgemm: shapes {A.shape} and {B.shape} do not chain")
    B_ell = B if isinstance(B, ELL) else B.to_ell(b_width)
    bk = A.col.clamp(max=p - 1)
    b_cols, b_vals = B_ell.col[bk], B_ell.data[bk]  # (nnz_A, w)
    vals = (A.data[:, None] * b_vals).reshape(-1)
    rows = A.row[:, None].expand_as(b_cols).reshape(-1)
    rows = torch.where((b_vals != 0).reshape(-1), rows, torch.full_like(rows, m))
    return coalesce(vals, rows, b_cols.reshape(-1), (m, B.shape[1]), nnz_out,
                    return_overflow=return_overflow)


def rap(A: CSR, P: CSR, *, nnz_ap: int, nnz_out: int, a_width: int, p_width: int,
        return_overflow: bool = False):
    """Galerkin product P^T A P by two :func:`spgemm` (A P, then P^T (A P));
    with ``return_overflow`` also whether either exceeded its capacity."""
    AP, ov1 = spgemm(A, P, nnz_out=nnz_ap, b_width=p_width, return_overflow=True)
    out, ov2 = spgemm(transpose(P), AP, nnz_out=nnz_out,
                      b_width=min(nnz_ap, a_width * p_width), return_overflow=True)
    return (out, ov1 | ov2) if return_overflow else out


def rap_fused(A: CSR, P, *, k: int, nnz_out: int, p_width: int,
              return_overflow: bool = False):
    """Galerkin product P^T A P as one expansion and one :func:`coalesce`:
    every A entry (i, j, a) against P's (fixed-width) rows i and j,

        A_H[r, s] += P[i, r] * a * P[j, s],

    nnz(A) * p_width^2 candidate terms; A's padding and P's zero slots make
    no entry.  ``k`` is the coarse size (P's columns)."""
    m = A.shape[0]
    P_ell = P if isinstance(P, ELL) else P.to_ell(p_width)
    i, j = A.row.clamp(max=m - 1), A.col.clamp(max=m - 1)
    pi_cols, pi_vals = P_ell.col[i], P_ell.data[i]  # (nnz_A, wp)
    pj_cols, pj_vals = P_ell.col[j], P_ell.data[j]
    vals = (A.data[:, None, None] * pi_vals[:, :, None]) * pj_vals[:, None, :]
    shape = vals.shape
    live = A.mask[:, None, None] & (pi_vals != 0)[:, :, None] & (pj_vals != 0)[:, None, :]
    rows = torch.where(live, pi_cols[:, :, None].expand(shape), torch.full(shape, k,
                       dtype=pi_cols.dtype, device=pi_cols.device))
    return coalesce(vals.reshape(-1), rows.reshape(-1), pj_cols[:, None, :].expand(shape).reshape(-1),
                    (k, k), nnz_out, return_overflow=return_overflow)


def spgemm_masked(A, B, pattern: CSR, *, a_width: int, b_width: int,
                  chunk: int | None = None) -> CSR:
    """(A @ B) on the sparsity pattern of ``pattern``.

    For every pattern entry (i, j), sum_k A[i, k] * B[k, j] from A's
    fixed-width row i against B's fixed-width rows, with no sort: slot by
    slot s of A's row, B's row k = A.col[i, s] is matched against j, and
    every slot that holds column j adds (duplicate coordinates sum, as
    scipy sums them).  The a_width terms add in slot order, one
    elementwise add per slot, so where B's rows hold each column once the
    card gives the CPU's bits.  ``chunk``
    takes that many pattern entries at a time (default: all), so a step
    holds (chunk, b_width) elements; the (E, a_width, b_width) expansion of
    the JAX package is never formed.
    """
    m = A.shape[0]
    A_ell = A if isinstance(A, ELL) else A.to_ell(a_width)
    B_ell = B if isinstance(B, ELL) else B.to_ell(b_width)

    b_col32 = B_ell.col.to(torch.int32)  # halves the largest gather

    def contract(rows, cols):
        i = rows.clamp(max=m - 1)
        cols = cols.to(torch.int32)[:, None]
        out = None
        for s in range(A_ell.width):
            k = A_ell.col[i, s]
            b_vals = B_ell.data[k]  # (E, wb)
            match = b_col32[k] == cols
            term = A_ell.data[i, s] * torch.where(match, b_vals, torch.zeros_like(b_vals)).sum(1)
            out = term if out is None else out + term
        return out if out is not None else B_ell.data.new_zeros(rows.shape)

    E = pattern.row.shape[0]
    if chunk is None or chunk >= E:
        vals = contract(pattern.row, pattern.col)
    else:
        vals = torch.cat([contract(pattern.row[s:s + chunk], pattern.col[s:s + chunk])
                          for s in range(0, E, chunk)])
    return pattern.with_data(torch.where(pattern.mask, vals, torch.zeros_like(vals)))


def densify(P) -> torch.Tensor:
    """Dense view of a dense, CSR or ELL operator (small operators only)."""
    return P if isinstance(P, torch.Tensor) else P.todense()


def rap_dense(A, P) -> torch.Tensor:
    """Dense coarse Galerkin operator P.T @ A @ P, shape (k, k); a CSR or
    ELL ``P`` is densified first (duplicate coordinates sum)."""
    P = densify(P)
    return P.T @ spmm(A, P)
