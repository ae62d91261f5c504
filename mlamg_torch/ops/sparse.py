"""Padded COO, CSR and ELL containers (counterpart of ``mlamg_tpu/ops/sparse.py``).

Padding follows the JAX package's convention: padded entries have
``row == shape[0]`` (an out-of-range sentinel that segment reductions
drop), ``col == 0`` and ``data == 0``, and sit at the tail.  Row and column
ids are int64, the index type of torch's scatter/gather ops.

Sums over a row or a column never scatter: :func:`segment_slots` lists
each segment's entries in entry order, and
:func:`~mlamg_torch.ops.segment.slot_sum` (one kernel launch on the card)
adds them slot by slot.  That is the order of the JAX package's
``segment_sum`` on the CPU, and it is the same on every run on the card,
where ``index_add_`` would add in the order its atomics land.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.utils.profiler import SYNCS


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def segment_slots(ids: torch.Tensor, num_segments: int,
                  width: int | None = None) -> torch.Tensor:
    """(num_segments, width) positions of each segment's entries, in entry
    order; ``len(ids)`` fills the empty slots.  Ids >= ``num_segments`` are
    dropped.  ``width`` defaults to the largest segment; a smaller one
    raises."""
    E = ids.shape[0]
    key = ids.clamp(max=num_segments)
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    # counted by index_add_, which (unlike bincount) reads no size back
    counts = torch.zeros(num_segments + 1, dtype=torch.int64, device=ids.device)
    counts.index_add_(0, key, torch.ones_like(key))
    longest = 0
    if num_segments:
        SYNCS["segment_slots"] += 1
        longest = int(counts[:num_segments].max())
    if width is None:
        width = longest
    elif longest > width:
        raise ValueError(f"segment_slots: width={width} is smaller than the "
                         f"largest segment ({longest} entries)")
    first = torch.cumsum(counts, 0) - counts
    within = torch.arange(E, device=ids.device) - first[skey]
    slot = torch.where(skey < num_segments, skey * width + within,
                       torch.full_like(skey, num_segments * width))
    out = torch.full((num_segments * width + 1,), E, dtype=torch.int64, device=ids.device)
    return out.scatter_(0, slot, order)[:-1].view(num_segments, width)


def _padded(nnz: int, nnz_pad: int | None, m: int):
    """Host (data, row, col) buffers of ``nnz_pad`` slots (default: nnz
    rounded up to 128) holding the padding convention."""
    if nnz_pad is None:
        nnz_pad = max(round_up(nnz, 128), 128)
    if nnz_pad < nnz:
        raise ValueError(f"nnz_pad={nnz_pad} < nnz={nnz}")
    # float64 holds float32 and float64 values exactly
    return (np.zeros(nnz_pad, np.float64), np.full(nnz_pad, m, np.int64),
            np.zeros(nnz_pad, np.int64))


@dataclasses.dataclass(frozen=True)
class COO:
    """Padded COO matrix; entries need not be sorted.  Padding entries have
    ``row == shape[0]``, ``col == 0`` and ``data == 0``; ``nnz`` counts
    every slot the producer filled (it may be a capacity bound)."""

    data: torch.Tensor  # (nnz_pad,)
    row: torch.Tensor  # (nnz_pad,) int64
    col: torch.Tensor  # (nnz_pad,) int64
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
                   device=None) -> "COO":
        """COO of a scipy matrix in its own entry order, padded to
        ``nnz_pad`` (default: nnz rounded up to 128)."""
        device = resolve_device(device)
        A = A.tocoo()
        m, n = (int(s) for s in A.shape)
        nnz = int(A.nnz)
        data, row, col = _padded(nnz, nnz_pad, m)
        data[:nnz], row[:nnz], col[:nnz] = A.data, A.row, A.col
        return COO(torch.from_numpy(data).to(device=device, dtype=dtype),
                   torch.from_numpy(row).to(device), torch.from_numpy(col).to(device),
                   (m, n), nnz)

    def todense(self) -> torch.Tensor:
        """Dense (m, n); duplicate coordinates sum (in entry order on the
        CPU)."""
        m, n = self.shape
        flat = torch.where(self.mask, self.row * n + self.col,
                           torch.full_like(self.row, m * n))
        out = torch.zeros(m * n + 1, dtype=self.dtype, device=self.device)
        return out.index_add(0, flat, self.data)[:-1].view(m, n)

    def to_scipy(self):
        """scipy CSR of the real entries (duplicates summed)."""
        import scipy.sparse as sp

        m, n = self.shape
        keep = self.mask.cpu().numpy()
        return sp.coo_matrix(
            (self.data.detach().cpu().numpy()[keep],
             (self.row.cpu().numpy()[keep], self.col.cpu().numpy()[keep])),
            shape=(m, n)).tocsr()

    def sort_rows(self) -> "CSR":
        """Stable (row, col) sort into CSR form, as two stable argsorts
        (column, then row): entries with equal coordinates keep their
        order, and padding goes to the tail."""
        m, _ = self.shape
        order_c = torch.sort(self.col, stable=True).indices
        order_r = torch.sort(self.row[order_c], stable=True).indices
        perm = order_c[order_r]
        row = self.row[perm]
        indptr = torch.searchsorted(row, torch.arange(m + 1, dtype=row.dtype, device=row.device))
        return CSR(self.data[perm], row, self.col[perm], indptr, self.shape, self.nnz)


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
        data, row, col = _padded(nnz, nnz_pad, m)
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

    @staticmethod
    def from_dense(A: torch.Tensor, nnz_pad: int) -> "CSR":
        """CSR of the first ``nnz_pad`` nonzeros of a dense (m, n) tensor
        in row-major order, padded to ``nnz_pad``; ``nnz`` is the static
        bound ``nnz_pad``, as in the JAX package (tests and small
        operators)."""
        m, n = (int(s) for s in A.shape)
        flat = A.reshape(-1)
        present = flat != 0
        # real entries first (the stable sort keeps row-major order)
        perm = torch.sort((~present).to(torch.uint8), stable=True).indices[:nnz_pad]
        keep = present[perm]
        row = torch.where(keep, perm // n, torch.full_like(perm, m))
        col = torch.where(keep, perm % n, torch.zeros_like(perm))
        data = torch.where(keep, flat[perm], torch.zeros_like(flat[perm]))
        indptr = torch.searchsorted(row, torch.arange(m + 1, dtype=row.dtype, device=row.device))
        return CSR(data, row, col, indptr, (m, n), nnz_pad)

    def as_coo(self) -> COO:
        return COO(self.data, self.row, self.col, self.shape, self.nnz)

    def to_scipy(self):
        return self.as_coo().to_scipy()

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
        out = dataclasses.replace(self, data=data)
        for name in ("row_slots", "col_slots"):  # same pattern, same slots
            if name in self.__dict__:
                out.__dict__[name] = self.__dict__[name]
        return out

    def abs(self) -> "CSR":
        return self.with_data(self.data.abs())

    def _masked(self, keep: torch.Tensor) -> "CSR":
        """Values zeroed where ``keep`` is False; the pattern stays."""
        return self.with_data(torch.where(keep, self.data, torch.zeros_like(self.data)))

    def triu(self, k: int = 0) -> "CSR":
        return self._masked(self.col - self.row >= k)

    def tril(self, k: int = 0) -> "CSR":
        return self._masked(self.col - self.row <= k)

    def scale_rows(self, s: torch.Tensor) -> "CSR":
        """diag(s) @ A."""
        return self.with_data(self.data * s[self.row.clamp(max=self.shape[0] - 1)])

    def scale_cols(self, s: torch.Tensor) -> "CSR":
        """A @ diag(s)."""
        return self.with_data(self.data * s[self.col])

    def row_degrees(self) -> torch.Tensor:
        """(m,) number of stored entries per row."""
        return self.indptr[1:] - self.indptr[:-1]

    @cached_property
    def row_slots(self) -> torch.Tensor:
        """(m, max row degree) entry positions of each row (see
        :func:`segment_slots`); built once per pattern."""
        return segment_slots(self.row, self.shape[0])

    @cached_property
    def col_slots(self) -> torch.Tensor:
        """(n, max column degree) entry positions of each column."""
        col = torch.where(self.mask, self.col, torch.full_like(self.col, self.shape[1]))
        return segment_slots(col, self.shape[1])

    def to_ell(self, width: int | None = None) -> "ELL":
        """ELL repack: each row's entries in order, zero-filled (col 0)."""
        slots = self.row_slots if width is None else segment_slots(self.row, self.shape[0], width)
        zero = torch.zeros(1, dtype=self.dtype, device=self.device)
        data = torch.cat([self.data, zero])[slots]
        col = torch.cat([self.col, torch.zeros(1, dtype=self.col.dtype, device=self.device)])[slots]
        return ELL(data, col, self.shape)

    def todense(self) -> torch.Tensor:
        """Dense (m, n); duplicate coordinates sum in entry order."""
        return self.to_ell().todense()


@dataclasses.dataclass(frozen=True)
class ELL:
    """Fixed-width rows: ``data`` (m, w) and ``col`` (m, w) int64, value 0
    and column 0 in padding slots."""

    data: torch.Tensor
    col: torch.Tensor
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @cached_property
    def col_slots(self) -> torch.Tensor:
        """(n, w') positions in the flattened slots of each column."""
        return segment_slots(self.col.reshape(-1), self.shape[1])

    @staticmethod
    def from_scipy(A, width: int | None = None, dtype=torch.float32,
                   device=None) -> "ELL":
        """ELL of a scipy matrix, each row's entries in column order and
        zero-filled to ``width`` (default: the largest row degree).
        float32 packs through the C++ ``csr_to_ell`` (numpy where it is not
        built), other types through numpy, as in the JAX package."""
        import scipy.sparse as sp

        from mlamg_torch import native

        device = resolve_device(device)
        A = sp.csr_matrix(A)
        A.sort_indices()
        m, n = (int(s) for s in A.shape)
        deg = np.diff(A.indptr)
        w = int(deg.max(initial=0)) if width is None else int(width)
        if w < deg.max(initial=0):
            raise ValueError(f"ELL width {w} < largest row degree {deg.max()}")
        if dtype == torch.float32:
            data, col = native.csr_to_ell(A, w)
        else:
            data, col = native.csr_to_ell_numpy(A, w, np.float64)
        return ELL(torch.from_numpy(data).to(device=device, dtype=dtype),
                   torch.from_numpy(col.astype(np.int64)).to(device), (m, n))

    def to_scipy(self):
        """scipy CSR of the stored nonzeros (zero slots dropped)."""
        import scipy.sparse as sp

        m, n = self.shape
        d = self.data.detach().cpu().numpy().ravel()
        r = np.repeat(np.arange(m), self.width)
        c = self.col.cpu().numpy().ravel()
        keep = d != 0
        return sp.coo_matrix((d[keep], (r[keep], c[keep])), shape=(m, n)).tocsr()

    def todense(self) -> torch.Tensor:
        """Dense (m, n); duplicate coordinates sum in slot order."""
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.dtype, device=self.device)
        for s in range(self.width):  # one entry per row per call: no collisions
            out.scatter_add_(1, self.col[:, s:s + 1], self.data[:, s:s + 1])
        return out
