"""Block sparse rows (counterpart of ``mlamg_tpu/ops/bsr.py``): bs x bs
dense blocks in a fixed-width block-ELL layout, the container of a
vector-valued velocity block (2-D: bs 2, 3-D: bs 3), one column index per
block.

Padding slots hold block column ``nbc`` (the number of block columns) and a
zero block.  Both products add in a fixed order with elementwise ops
(:func:`~mlamg_torch.ops.segment.ordered_sum`, :func:`slot_sum`), so the
card computes the CPU's bits.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.ops.segment import ordered_sum, slot_sum
from mlamg_torch.ops.sparse import segment_slots


@dataclasses.dataclass(frozen=True)
class BSR:
    """``data`` (nbr, w, bs, bs) blocks, ``col`` (nbr, w) int64 block
    columns (``nbc`` in padding slots); ``shape`` is the scalar (m, n)."""

    data: torch.Tensor
    col: torch.Tensor
    shape: Tuple[int, int]
    bs: int

    @property
    def nbr(self) -> int:
        return self.shape[0] // self.bs

    @property
    def nbc(self) -> int:
        return self.shape[1] // self.bs

    @cached_property
    def col_slots(self) -> torch.Tensor:
        """(nbc, w') positions in the flattened slots of each block column."""
        return segment_slots(self.col.reshape(-1), self.nbc)

    @staticmethod
    def from_scipy(A, bs: int, dtype=torch.float32, device=None) -> "BSR":
        """Any scipy sparse matrix whose dimensions bs divides.  The blocks
        pass through float32 on the way, as the JAX package stages them, so
        a float64 BSR holds float32-rounded values."""
        import scipy.sparse as sp

        device = resolve_device(device)
        m, n = A.shape
        if m % bs or n % bs:
            raise ValueError(f"shape {A.shape} not divisible by bs={bs}")
        Ab = sp.bsr_matrix(A.tocsr(), blocksize=(bs, bs))
        Ab.sort_indices()
        nbr, nbc = m // bs, n // bs
        widths = np.diff(Ab.indptr)
        w = max(int(widths.max(initial=1)), 1)
        rows = np.repeat(np.arange(nbr), widths)
        slots = np.arange(Ab.indices.size) - np.repeat(Ab.indptr[:-1], widths)
        col = np.full((nbr, w), nbc, np.int64)
        data = np.zeros((nbr, w, bs, bs), np.float32)
        col[rows, slots] = Ab.indices
        data[rows, slots] = Ab.data
        return BSR(torch.from_numpy(data).to(device=device, dtype=dtype),
                   torch.from_numpy(col).to(device), (int(m), int(n)), bs)

    def to_scipy(self):
        import scipy.sparse as sp

        col = self.col.cpu().numpy()
        data = self.data.cpu().numpy().astype(np.float64)
        rows_b, slots = np.nonzero(col < self.nbc)
        bs = self.bs
        blocks = data[rows_b, slots]  # (nnzb, bs, bs)
        r = (rows_b[:, None, None] * bs + np.arange(bs)[None, :, None]
             + np.zeros((1, 1, bs), int)).ravel()
        c = (col[rows_b, slots][:, None, None] * bs + np.arange(bs)[None, None, :]
             + np.zeros((1, bs, 1), int)).ravel()
        return sp.coo_matrix((blocks.ravel(), (r, c)), shape=self.shape).tocsr()


def bsr_spmv(A: BSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: one gather of x's blocks (a zero block for padding), each
    block's row times its x block, then the slots added in order."""
    xb = torch.cat([x.reshape(A.nbc, A.bs), x.new_zeros((1, A.bs))])
    g = xb[A.col]  # (nbr, w, bs)
    y = ordered_sum(ordered_sum(A.data * g[:, :, None, :], 3), 1)
    return y.reshape(A.shape[0])


def bsr_spmv_t(A: BSR, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x: each slot's block transposed times its row's x block,
    summed into its block column in slot order."""
    xb = x.reshape(A.nbr, A.bs)
    contrib = ordered_sum(A.data * xb[:, None, :, None], 2)  # (nbr, w, bs)
    return slot_sum(contrib.reshape(-1, A.bs), A.col_slots).reshape(A.shape[1])
