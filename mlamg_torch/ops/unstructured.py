"""SpMV for unstructured (RCM-ordered) matrices: slot-major ELL on Hopper.

Counterpart of ``mlamg_tpu/ops/unstructured.py``.  The TPU kernel
``well_spmv_pallas`` windows x per row block and rebuilds the gather from
lane gathers because the TPU cannot gather across VMEM rows; Hopper
gathers natively, so the port keeps only what the kernel computes,

    y = alpha * (A @ x) + c,

over the same slot-major ELL values, with *absolute* column ids in place of
the TPU's window-relative ones.  The CUDA kernel is
``ops/csrc/well_spmv.cu``; :func:`well_spmv_reference` is its plain PyTorch
version, used for CPU tensors and as the kernel's oracle on the card.

Layout (:class:`WindowedELL`), with n_pad = 128 * block_rows * nb as in JAX:

    data (w, n_pad) f32  slot-major ELL values
    col  (w, n_pad) i32  absolute column ids

Padding slots of a row repeat the row's first column with value 0; empty
and padding rows use col = row with value 0 (the JAX layout's convention,
so ``col`` equals JAX's ``rel + 128 * window_start``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.ops import _build

# Kernel launches by name; a wrapper adds one per successful launch.
LAUNCHES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class WindowedELL:
    """Slot-major ELL with absolute columns (see module docstring)."""

    data: torch.Tensor  # (w, n_pad) f32
    col: torch.Tensor  # (w, n_pad) i32
    shape: Tuple[int, int]
    nnz: int
    block_rows: int  # 128-row tiles per block; n_pad is a multiple of 128*block_rows

    @property
    def width(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_pad(self) -> int:
        return int(self.data.shape[1])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_scipy(A, block_rows: int = 8, dtype=torch.float32,
                   device=None) -> "WindowedELL":
        """Build the layout from an (RCM-ordered) square scipy matrix."""
        import scipy.sparse as sp

        device = resolve_device(device)
        A = sp.csr_matrix(A)
        A.sort_indices()
        n = A.shape[0]
        R = block_rows * 128
        n_pad = -(-n // R) * R
        deg = np.diff(A.indptr)
        w = int(deg.max()) if n else 0

        col = np.tile(np.arange(n_pad, dtype=np.int64)[:, None], (1, w))
        val = np.zeros((n_pad, w), np.float64)
        rows = np.repeat(np.arange(n), deg)
        offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
        col[rows, offs] = A.indices
        val[rows, offs] = A.data
        # padding slots of a live row repeat its first column
        live = deg > 0
        first = np.zeros(n, np.int64)
        first[live] = A.indices[A.indptr[:-1][live]]
        pad = (np.arange(w)[None, :] >= deg[:, None]) & live[:, None]
        col[:n][pad] = np.broadcast_to(first[:, None], (n, w))[pad]

        data = torch.from_numpy(np.ascontiguousarray(val.T))
        colt = torch.from_numpy(np.ascontiguousarray(col.T.astype(np.int32)))
        return WindowedELL(
            data.to(device=device, dtype=dtype), colt.to(device),
            (n, A.shape[1]), int(A.nnz), block_rows,
        )


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


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.kernel_library("well_spmv")
        p = ctypes.c_void_p
        lib.well_spmv_f32.argtypes = [
            p, p, p, p, p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, p,
        ]
        lib.well_spmv_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_vector(name: str, v: torch.Tensor, n: int, device) -> None:
    if v.dtype != torch.float32 or v.shape != (n,) or not v.is_contiguous():
        raise ValueError(
            f"well_spmv: {name} must be a contiguous float32 ({n},) tensor, "
            f"got {v.dtype} {tuple(v.shape)} contiguous={v.is_contiguous()}"
        )
    if v.device != device:
        raise ValueError(f"well_spmv: {name} is on {v.device}, operator on {device}")


def _well_spmv_cuda(W: WindowedELL, x: torch.Tensor, c, alpha: float):
    n = W.shape[0]
    dev = W.device
    if W.data.dtype != torch.float32 or W.col.dtype != torch.int32:
        raise ValueError("well_spmv: the CUDA kernel takes float32 data and int32 col")
    if not (W.data.is_contiguous() and W.col.is_contiguous()):
        raise ValueError("well_spmv: operator arrays must be contiguous")
    _check_vector("x", x, n, dev)
    if c is not None:
        _check_vector("c", c, n, dev)
    if dev.index != torch.cuda.current_device():
        raise ValueError(
            f"well_spmv: operands on {dev} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    y = torch.empty(n, dtype=torch.float32, device=dev)
    rc = _lib().well_spmv_f32(
        W.data.data_ptr(), W.col.data_ptr(), x.data_ptr(),
        None if c is None else c.data_ptr(), y.data_ptr(),
        n, W.n_pad, W.width, float(alpha),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"well_spmv: kernel launch failed with CUDA error {rc}")
    LAUNCHES["well_spmv"] += 1
    return y


def well_spmv(W: WindowedELL, x: torch.Tensor, c: torch.Tensor | None = None,
              alpha: float = 1.0) -> torch.Tensor:
    """y = alpha * (A @ x) + c.  A CUDA tensor launches the hand-written
    kernel (and raises if it cannot); a CPU tensor takes the plain version."""
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
