"""Aggregation-based interpolation (counterpart of ``mlamg_tpu/mg/interp.py``).

The tentative prolongator of an aggregate assignment, smoothed by one
weighted-Jacobi step,

    P = (I - omega D^-1 A) Agg,   omega = (4/3) / rho(D^-1 A),

with rho from power iteration; as a dense (n, k) tensor or as a CSR with
A's pattern and aggregate-mapped columns.
"""

from __future__ import annotations

import torch

from mlamg_torch.graph.strength import power_iteration_lmax
from mlamg_torch.mg.smoothers import _dinv
from mlamg_torch.ops.matmul import spmm
from mlamg_torch.ops.sparse import CSR


def tentative_dense(agg_id: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """(n, k) one-hot tentative prolongator (rows with agg_id >= k are zero)."""
    return (agg_id[:, None] == torch.arange(k, device=agg_id.device)).to(dtype)


def sa_omega(A, Dinv: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """(4/3) / rho(D^-1 A) via power iteration, a 0-d tensor."""
    lmax = power_iteration_lmax(A, Dinv, iters=iters).abs()
    return (4.0 / 3.0) / torch.where(lmax > 0, lmax, torch.ones_like(lmax))


def sa_interpolation_dense(A, agg_id: torch.Tensor, k: int, omega=None,
                           power_iters: int = 30) -> torch.Tensor:
    """Dense (n, k) Jacobi-smoothed-aggregation prolongator."""
    Dinv = _dinv(A)
    if omega is None:
        omega = sa_omega(A, Dinv, iters=power_iters)
    T = tentative_dense(agg_id, k, dtype=A.dtype)
    return T - omega * Dinv[:, None] * spmm(A, T)


def smoothed_aggregation(A: CSR, agg_id: torch.Tensor, k: int, omega=None,
                         power_iters: int = 30) -> CSR:
    """Sparse Jacobi-smoothed-aggregation prolongator: A's pattern with each
    column j remapped to agg_id[j]; duplicates stay (every product sums
    them)."""
    n = A.shape[0]
    Dinv = _dinv(A)
    if omega is None:
        omega = sa_omega(A, Dinv, iters=power_iters)
    live = A.mask
    rsafe = A.row.clamp(max=n - 1)
    s_data = -omega * Dinv[rsafe] * A.data
    s_data = torch.where(live & (A.row == A.col), s_data + 1.0, s_data)
    return remap_columns(A, s_data, agg_id, k)


def remap_columns(A: CSR, data: torch.Tensor, agg_id: torch.Tensor, k: int,
                  n_real: int | None = None) -> CSR:
    """The (n, k) CSR with A's pattern, ``data`` as values and column j
    moved to agg_id[j]; entries whose column is unassigned (>= k) become
    padding in place.  With ``n_real`` (a grid padded to a shape bucket)
    the kept entries of rows n_real and above hold 1.0."""
    n = A.shape[0]
    new_col = agg_id[A.col]
    keep = A.mask & (new_col < k)
    data = torch.where(keep, data, torch.zeros_like(data))
    if n_real is not None:
        pad_row = keep & (A.row.clamp(max=n - 1) >= n_real)
        data = torch.where(pad_row, torch.ones_like(data), data)
    return CSR(
        data,
        torch.where(keep, A.row, torch.full_like(A.row, n)),
        torch.where(keep, new_col, torch.zeros_like(new_col)),
        A.indptr, (n, k), A.nnz,
    )
