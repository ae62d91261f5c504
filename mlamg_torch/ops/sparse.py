"""Padded CSR container (counterpart of ``mlamg_tpu/ops/sparse.py``).

Padding follows the JAX package's convention: padded entries have
``row == shape[0]`` (an out-of-range sentinel that segment reductions
drop), ``col == 0`` and ``data == 0``, and sit at the tail.  Row and column
ids are int64, the index type of torch's scatter/gather ops.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CSR:
    """Row-sorted padded COO plus indptr.

    Invariants: entries sorted by (row, col); padding at the tail;
    ``indptr`` has length m+1 with ``indptr[m] == nnz``.
    """

    data: torch.Tensor  # (nnz_pad,)
    row: torch.Tensor  # (nnz_pad,) int64, shape[0] in padding slots
    col: torch.Tensor  # (nnz_pad,) int64, 0 in padding slots
    indptr: torch.Tensor  # (m+1,) int64
    shape: Tuple[int, int]
    nnz: int

    @property
    def nnz_pad(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def mask(self) -> torch.Tensor:
        """(nnz_pad,) boolean: True for real entries."""
        return self.row < self.shape[0]

    @staticmethod
    def from_scipy(A, nnz_pad: int | None = None, dtype=torch.float32,
                   device=None) -> "CSR":
        import scipy.sparse as sp

        device = resolve_device(device)
        A = sp.csr_matrix(A)
        A.sort_indices()
        m, n = (int(s) for s in A.shape)
        nnz = int(A.nnz)
        if nnz_pad is None:
            nnz_pad = max(round_up(nnz, 128), 128)
        if nnz_pad < nnz:
            raise ValueError(f"nnz_pad={nnz_pad} < nnz={nnz}")
        data = np.zeros(nnz_pad, np.float64)  # holds f32/f64 values exactly
        row = np.full(nnz_pad, m, np.int64)
        col = np.zeros(nnz_pad, np.int64)
        data[:nnz] = A.data
        col[:nnz] = A.indices
        row[:nnz] = np.repeat(np.arange(m, dtype=np.int64), np.diff(A.indptr))
        indptr = np.asarray(A.indptr, np.int64)
        return CSR(
            torch.from_numpy(data).to(device=device, dtype=dtype),
            torch.from_numpy(row).to(device),
            torch.from_numpy(col).to(device),
            torch.from_numpy(indptr).to(device),
            (m, n),
            nnz,
        )

    def to_scipy(self):
        import scipy.sparse as sp

        m, n = self.shape
        keep = (self.row < m).cpu().numpy()
        d = self.data.cpu().numpy()[keep]
        r = self.row.cpu().numpy()[keep]
        c = self.col.cpu().numpy()[keep]
        return sp.coo_matrix((d, (r, c)), shape=(m, n)).tocsr()

    def diagonal(self) -> torch.Tensor:
        """Dense (m,) diagonal."""
        m, _ = self.shape
        on_diag = (self.row == self.col) & self.mask
        vals = torch.where(on_diag, self.data, torch.zeros_like(self.data))
        out = torch.zeros(m + 1, dtype=self.dtype, device=self.device)
        return out.index_add_(0, self.row, vals)[:m]

    def with_data(self, data: torch.Tensor) -> "CSR":
        if data.shape != self.data.shape:
            raise ValueError(f"data shape {tuple(data.shape)} != {tuple(self.data.shape)}")
        return dataclasses.replace(self, data=data)

    def abs(self) -> "CSR":
        return self.with_data(self.data.abs())
