"""SpMV for unstructured (RCM-ordered) matrices: sliced ELL on Hopper.

Counterpart of ``mlamg_tpu/ops/unstructured.py``.  The TPU kernel
``well_spmv_pallas`` windows x per row block and rebuilds the gather from
lane gathers because the TPU cannot gather across VMEM rows; Hopper
gathers natively, so the port keeps only what the kernel computes,

    y = alpha * (A @ x) + c.

:class:`WindowedELL` holds two layouts of the same matrix.

The ELL arrays are JAX's slot-major values with *absolute* column ids in
place of the TPU's window-relative ones, with n_pad = 128 * block_rows * nb:

    data (w, n_pad) f32  slot-major ELL values
    col  (w, n_pad) i32  absolute column ids

Padding slots of a row repeat the row's first column with value 0; empty
and padding rows use col = row with value 0 (the JAX layout's convention,
so ``col`` equals JAX's ``rel + 128 * window_start``).  They feed
:func:`well_spmv_reference`, the plain version that CPU tensors run and
the oracle of the kernel on the card.

The sliced pack (SELL-C-sigma, C = :data:`SLICE` = 32 rows, one warp) is
what the CUDA kernel ``ops/csrc/well_spmv.cu`` reads.  Inside windows of
``sigma`` rows, rows are sorted by degree (largest first, stable by row
id), then cut into slices of 32; each slice is only as wide as its widest
row, so the pack streams close to nnz slots where the ELL streams
w * n_pad:

    row_perm  (S*32,)  i32  row of each slice lane (>= n: a dummy lane)
    slice_ptr (S+1,)   i32  first slot of each slice
    slice_w   (S,)     i32  slots per row in each slice
    sdata     (slots,) f32  values; slot j of lane l in slice s sits at
    scol      (slots,) i32    slice_ptr[s] + 32 * j + l

Padding slots carry value 0 and the row's first column (empty rows: their
own row; dummy lanes: column 0), so a row's slots are its ELL slots cut
short.  The kernel splits each slice's slots over ``lanes`` warps (slot j
to part j % lanes); :func:`sliced_spmv_reference` repeats its arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.ops import _build

SLICE = 32  # rows per slice: one warp, so every slot load is one 128 B access
SIGMA = 256  # rows per degree-sorting window
LANES = (1, 2, 4, 8)  # warps that share one slice's slots
LANE_THREADS = 1 << 18  # ~ resident threads of the card (132 SMs x 2048)


def choose_lanes(n: int) -> int:
    """Warps per slice for an n-row operator: the fewest that give the
    launch at least LANE_THREADS threads, at most 8."""
    for lanes in LANES:
        if n * lanes >= LANE_THREADS:
            return lanes
    return LANES[-1]


@dataclasses.dataclass(frozen=True)
class WindowedELL:
    """Slot-major ELL with absolute columns and its sliced pack (see
    module docstring)."""

    data: torch.Tensor  # (w, n_pad) f32
    col: torch.Tensor  # (w, n_pad) i32
    shape: Tuple[int, int]
    nnz: int
    block_rows: int  # 128-row tiles per block; n_pad is a multiple of 128*block_rows
    row_perm: torch.Tensor  # (S*SLICE,) i32
    slice_ptr: torch.Tensor  # (S+1,) i32
    slice_w: torch.Tensor  # (S,) i32
    sdata: torch.Tensor  # (slots,) f32
    scol: torch.Tensor  # (slots,) i32
    sigma: int
    lanes: int  # warps per slice in the kernel, from choose_lanes

    @property
    def width(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_pad(self) -> int:
        return int(self.data.shape[1])

    @property
    def n_slices(self) -> int:
        return int(self.slice_w.shape[0])

    @property
    def slots(self) -> int:
        return int(self.sdata.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_scipy(A, block_rows: int = 8, dtype=torch.float32,
                   device=None, sigma: int = SIGMA) -> "WindowedELL":
        """Build both layouts from an (RCM-ordered) square scipy matrix."""
        import scipy.sparse as sp

        device = resolve_device(device)
        A = sp.csr_matrix(A)
        A.sort_indices()
        n = A.shape[0]
        R = block_rows * 128
        n_pad = -(-n // R) * R
        deg = np.diff(A.indptr)
        w = int(deg.max()) if n else 0
        # padding slots of a live row repeat its first column
        live = deg > 0
        first = np.arange(n)
        first[live] = A.indices[A.indptr[:-1][live]]

        col = np.tile(np.arange(n_pad, dtype=np.int64)[:, None], (1, w))
        val = np.zeros((n_pad, w), np.float64)
        rows = np.repeat(np.arange(n), deg)
        offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
        col[rows, offs] = A.indices
        val[rows, offs] = A.data
        pad = (np.arange(w)[None, :] >= deg[:, None]) & live[:, None]
        col[:n][pad] = np.broadcast_to(first[:, None], (n, w))[pad]

        pack = _sliced_pack(A, deg, first, sigma)
        i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
        return WindowedELL(
            torch.from_numpy(np.ascontiguousarray(val.T)).to(device=device, dtype=dtype),
            i32(col.T), (n, A.shape[1]), int(A.nnz), block_rows,
            i32(pack["row_perm"]), i32(pack["slice_ptr"]), i32(pack["slice_w"]),
            torch.from_numpy(pack["sdata"]).to(device=device, dtype=dtype),
            i32(pack["scol"]), int(sigma), choose_lanes(n),
        )


def _sliced_pack(A, deg: np.ndarray, first: np.ndarray, sigma: int) -> dict:
    """The sliced pack of a CSR matrix with sorted indices (module
    docstring); ``first`` is each row's padding column."""
    if sigma < 1:
        raise ValueError(f"sigma must be positive, got {sigma}")
    n = A.shape[0]
    S = -(-n // SLICE)
    rows = np.arange(n)
    order = np.lexsort((rows, -deg, rows // sigma))  # window, degree desc, row id
    row_perm = np.arange(S * SLICE)
    row_perm[:n] = order
    lane_deg = np.zeros(S * SLICE, np.int64)
    lane_deg[:n] = deg[order]
    slice_w = lane_deg.reshape(S, SLICE).max(1, initial=0)
    slice_ptr = np.zeros(S + 1, np.int64)
    np.cumsum(SLICE * slice_w, out=slice_ptr[1:])
    slots = int(slice_ptr[-1])
    if slots >= 2**31:
        raise ValueError(f"sliced pack has {slots} slots; the kernel indexes at most 2**31 - 1")

    # every slot starts as padding: the lane's padding column, value 0
    lane_col = np.zeros(S * SLICE, np.int64)
    lane_col[:n] = first[order]
    slice_of = np.repeat(np.arange(S), SLICE * slice_w)
    lane_of = slice_of * SLICE + (np.arange(slots) - slice_ptr[slice_of]) % SLICE
    scol = lane_col[lane_of]
    sdata = np.zeros(slots, A.data.dtype)
    # slot q of the row in lane p sits at slice_ptr[p // 32] + 32 q + p % 32
    lane_of_row = np.empty(n, np.int64)
    lane_of_row[order] = rows
    p = np.repeat(lane_of_row, deg)
    q = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    at = slice_ptr[p // SLICE] + SLICE * q + p % SLICE
    scol[at] = A.indices
    sdata[at] = A.data
    return dict(row_perm=row_perm, slice_ptr=slice_ptr, slice_w=slice_w,
                sdata=sdata, scol=scol)


def well_spmv_reference(W: WindowedELL, x: torch.Tensor,
                        c: torch.Tensor | None = None,
                        alpha: float = 1.0) -> torch.Tensor:
    """Plain PyTorch y = alpha * (A @ x) + c: gather, sum over slots in
    order, scale, add."""
    n = W.shape[0]
    xp = x.new_zeros(W.n_pad)
    xp[:n] = x
    y = (W.data * xp[W.col]).sum(0)[:n]
    if alpha != 1.0:
        y = y * alpha
    return y if c is None else y + c


def _sum_in_order(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 one row after another, from zero (``Tensor.sum``
    picks its own order)."""
    acc = t.new_zeros(t.shape[1:])
    for row in t:
        acc = acc + row
    return acc


def sliced_spmv_reference(W: WindowedELL, x: torch.Tensor,
                          c: torch.Tensor | None = None, alpha: float = 1.0,
                          lanes: int | None = None) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch, over the sliced pack:
    each part p < ``lanes`` (default ``W.lanes``) sums its slots j = p,
    p + lanes, ... in order; then the parts in order, then alpha, then c;
    the result goes to y[row_perm].  It reads nothing back from the
    device."""
    lanes = W.lanes if lanes is None else lanes
    n = W.shape[0]
    width = W.width  # the widest slice holds the widest row
    lane = torch.arange(W.n_slices * SLICE, device=W.device)
    start = W.slice_ptr[:-1].long().repeat_interleave(SLICE) + lane % SLICE
    j = torch.arange(width, device=W.device)[:, None]
    live = j < W.slice_w.repeat_interleave(SLICE)[None, :]
    at = torch.where(live, start[None, :] + SLICE * j, 0)
    if width:
        prod = torch.where(live, W.sdata[at] * x[W.scol[at].long()], 0.0)
    else:
        prod = x.new_zeros((0, lane.shape[0]))
    acc = _sum_in_order(prod[0::lanes])
    for p in range(1, lanes):
        acc = acc + _sum_in_order(prod[p::lanes])
    rows = W.row_perm.long().clamp(max=n)  # dummy lanes go to a spare slot n
    if alpha != 1.0:
        acc = acc * alpha
    if c is not None:
        acc = acc + torch.cat([c, c.new_zeros(1)])[rows]
    y = x.new_empty(n + 1)
    y[rows] = acc
    return y[:n]


def _well_spmv_cuda(W: WindowedELL, x: torch.Tensor, c, alpha: float):
    n = W.shape[0]
    if W.sdata.dtype != torch.float32 or W.scol.dtype != torch.int32:
        raise ValueError("well_spmv: the CUDA kernel takes float32 sdata and int32 scol")
    if W.lanes not in LANES:
        raise ValueError(f"well_spmv: lanes must be one of {LANES}, got {W.lanes}")
    if x.dtype != torch.float32 or (c is not None and c.dtype != torch.float32):
        raise ValueError("well_spmv: the CUDA kernel takes float32 x and c")
    _build.check_vector("well_spmv", "x", x, n, W.device)
    if c is not None:
        _build.check_vector("well_spmv", "c", c, n, W.device)
    y = torch.empty(n, dtype=torch.float32, device=W.device)
    _build.launch("well_spmv", "well_spmv_f32", W.sdata, W.sdata.data_ptr(),
                  W.scol.data_ptr(), W.slice_ptr.data_ptr(), W.slice_w.data_ptr(),
                  W.row_perm.data_ptr(), x.data_ptr(), None if c is None else c.data_ptr(),
                  y.data_ptr(), n, W.n_slices, W.lanes, float(alpha))
    return y


def well_spmv(W: WindowedELL, x: torch.Tensor, c: torch.Tensor | None = None,
              alpha: float = 1.0) -> torch.Tensor:
    """y = alpha * (A @ x) + c.  A CUDA tensor launches the hand-written
    kernel over the sliced pack (and raises if it cannot); a CPU tensor
    takes the plain version over the ELL arrays."""
    if x.device.type == "cuda":
        return _well_spmv_cuda(W, x, c, alpha)
    if x.device.type == "cpu":
        return well_spmv_reference(W, x, c, alpha)
    raise ValueError(f"well_spmv: unsupported device {x.device}")


def rcm_spmv_setup(A, dtype=torch.float32, device=None):
    """(perm, WindowedELL) for an arbitrary scipy matrix: RCM-reorder
    (native C++ with scipy fallback), then build the layout.

    y_orig = inverse_perm(well_spmv(W, x[perm])).
    """
    import scipy.sparse as sp
    from mlamg_torch import native

    A = sp.csr_matrix(A)
    perm = np.asarray(native.rcm_ordering(A))
    Ap = A[perm][:, perm].tocsr()
    return perm, WindowedELL.from_scipy(Ap, dtype=dtype, device=device)
