"""DIA (diagonal) storage of stencil matrices and its SpMV on Hopper.

Counterpart of ``mlamg_tpu/ops/dia.py`` and of the TPU kernel
``dia_spmv_pallas`` (``mlamg_tpu/ops/pallas_kernels.py``).  A matrix with D
stored diagonals does SpMV as

    y = alpha * sum_d  data[d] * x[i + off_d]  + c

with ``data[d, i] = A[i, i + off_d]`` (0 where the diagonal runs off the
matrix).  :func:`dia_spmv` launches the hand-written CUDA kernel
``ops/csrc/dia_spmv.cu`` for a CUDA tensor; :func:`dia_spmv_reference` is
its plain PyTorch version, used for CPU tensors and as the kernel's oracle
on the card.

The port keeps the flat (D, n) layout.  The JAX package's pre-blocked
(D, n/128, 128) relayout (``pallas_kernels.blocked_dia``) exists for the
TPU's (8, 128) tiling and has no counterpart here.  ``dia_spmv_t``,
``dia_spmm`` and ``dia_jacobi_operator`` are plain PyTorch, as the JAX
package computes them in XLA outside any kernel.  :func:`auto_format`
picks DIA or ELL from a matrix's structure.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.ops import _build

# Most diagonals the CUDA kernel takes (its offsets travel by value in the
# launch parameters; must equal DIA_MAX_D in csrc/dia_spmv.cu).
DIA_MAX_D = 64

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage: ``data[d, i] = A[i, i + offsets[d]]`` (0 where the
    diagonal runs off the matrix); ``offsets`` sorted ascending when built
    by :meth:`from_scipy`."""

    data: torch.Tensor  # (D, n)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def data2d(self) -> torch.Tensor:
        """(D, n) diagonals.  The port stores no blocked layout, so this is
        ``data`` itself."""
        return self.data

    @staticmethod
    def from_scipy(A, dtype=torch.float32, device=None) -> "DIA":
        """DIA of a square scipy matrix.  float32 goes through the C++
        extraction (numpy where it is not built); other types through
        numpy in that type, as in the JAX package."""
        import scipy.sparse as sp

        from mlamg_torch import native

        device = resolve_device(device)
        if dtype not in _NP_DTYPES:
            raise ValueError(f"DIA.from_scipy: unsupported dtype {dtype}")
        A = sp.csr_matrix(A)
        n, m = A.shape
        if n != m:
            raise ValueError(f"DIA requires a square matrix, got {A.shape}")
        if dtype == torch.float32:
            offs, data = native.csr_to_dia(A)
        else:
            offs, data = native.csr_to_dia_numpy(A, _NP_DTYPES[dtype])
        return DIA(torch.from_numpy(data).to(device),
                   tuple(int(o) for o in offs), (n, m))

    @staticmethod
    def num_diagonals(A_scipy) -> int:
        from mlamg_torch import native

        return native.count_diagonals(A_scipy)

    def to_scipy(self):
        import scipy.sparse as sp

        n = self.shape[0]
        data = self.data.cpu().numpy()
        rows, cols, vals = [], [], []
        for d, off in enumerate(self.offsets):
            r = np.arange(max(0, -off), min(n, n - off))
            rows.append(r)
            cols.append(r + off)
            vals.append(data[d, r])
        if not rows:
            return sp.csr_matrix(self.shape, dtype=data.dtype)
        return sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=self.shape,
        ).tocsr()

    def todense(self) -> torch.Tensor:
        """Dense (n, n) tensor on the operator's device."""
        return torch.from_numpy(self.to_scipy().toarray()).to(self.device)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return self.data.new_zeros(self.shape[0])


def _reach(offsets) -> Tuple[int, int]:
    """(largest |negative offset|, largest positive offset), 0 if none."""
    max_neg = max((-o for o in offsets if o < 0), default=0)
    max_pos = max((o for o in offsets if o > 0), default=0)
    return max_neg, max_pos


def dia_spmv_reference(A: DIA, x: torch.Tensor, c: torch.Tensor | None = None,
                       alpha: float = 1.0) -> torch.Tensor:
    """Plain PyTorch y = alpha * (A @ x) + c: pad x with zeros, sum the
    shifted products over the diagonals in order, scale, add."""
    n = A.shape[0]
    max_neg, max_pos = _reach(A.offsets)
    xp = torch.nn.functional.pad(x, (max_neg, max_pos))
    y = None
    for d, off in enumerate(A.offsets):
        term = A.data[d] * xp[max_neg + off: max_neg + off + n]
        y = term if y is None else y + term
    if y is None:
        y = torch.zeros_like(x)
    if alpha != 1.0:
        y = y * alpha
    return y if c is None else y + c


def _dia_spmv_cuda(A: DIA, x: torch.Tensor, c, alpha: float) -> torch.Tensor:
    n = A.shape[0]
    D = len(A.offsets)
    if D > DIA_MAX_D:
        raise ValueError(f"dia_spmv: the CUDA kernel takes at most {DIA_MAX_D} "
                         f"diagonals, got {D}")
    if A.data.dtype != torch.float32 or x.dtype != torch.float32 or (
            c is not None and c.dtype != torch.float32):
        raise ValueError("dia_spmv: the CUDA kernel takes float32 operands")
    if A.data.shape != (D, n) or not A.data.is_contiguous():
        raise ValueError(f"dia_spmv: data must be a contiguous ({D}, {n}) tensor")
    y = torch.empty(n, dtype=torch.float32, device=A.device)
    offsets = (ctypes.c_int64 * max(D, 1))(*A.offsets)
    _build.launch("dia_spmv", "dia_spmv_f32", A.data, A.data.data_ptr(),
                  ctypes.cast(offsets, ctypes.c_void_p), D, x.data_ptr(),
                  None if c is None else c.data_ptr(), y.data_ptr(), n, float(alpha))
    return y


def dia_spmv(A: DIA, x: torch.Tensor, c: torch.Tensor | None = None,
             alpha: float = 1.0) -> torch.Tensor:
    """y = alpha * (A @ x) + c.  A CUDA tensor launches the hand-written
    kernel (and raises if it cannot); a CPU tensor takes the plain version.
    On both, x and c must be contiguous (n,) tensors on A's device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dia_spmv: unsupported device {x.device}")
    _build.check_vector("dia_spmv", "x", x, A.shape[0], A.device)
    if c is not None:
        _build.check_vector("dia_spmv", "c", c, A.shape[0], A.device)
    if x.device.type == "cuda":
        return _dia_spmv_cuda(A, x, c, alpha)
    return dia_spmv_reference(A, x, c, alpha)


def dia_spmv_t(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x: column j receives data[d, j - off] * x[j - off] from
    diagonal d (both shifted by -off, static slices)."""
    n = A.shape[0]
    max_neg, max_pos = _reach(A.offsets)
    xp = torch.nn.functional.pad(x, (max_pos, max_neg))
    dp = torch.nn.functional.pad(A.data, (max_pos, max_neg))
    y = torch.zeros_like(x)
    for d, off in enumerate(A.offsets):
        lo = max_pos - off
        y = y + dp[d, lo: lo + n] * xp[lo: lo + n]
    return y


def dia_spmm(A: DIA, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a dense (n, k) X: shifted products on 2-D slabs."""
    n = A.shape[0]
    max_neg, max_pos = _reach(A.offsets)
    Xp = torch.nn.functional.pad(X, (0, 0, max_neg, max_pos))
    Y = torch.zeros_like(X)
    for d, off in enumerate(A.offsets):
        Y = Y + A.data[d][:, None] * Xp[max_neg + off: max_neg + off + n]
    return Y


def dia_jacobi_operator(A: DIA, Dinv: torch.Tensor, omega: float) -> DIA | None:
    """M = I - omega * diag(Dinv) @ A as a DIA sharing A's offsets, so one
    weighted-Jacobi sweep is the affine map x' = M x + omega * Dinv * b, one
    :func:`dia_spmv` pass.  ``None`` when the main diagonal is not stored."""
    if 0 not in A.offsets:
        return None
    data = -omega * Dinv[None, :] * A.data
    data[A.offsets.index(0)] += 1.0
    return DIA(data, A.offsets, A.shape)


def auto_format(A_scipy, max_diagonals: int = 32, dtype=torch.float32, device=None):
    """The container for this matrix's structure: a DIA for a square matrix
    of at most ``max_diagonals`` stored diagonals (a stencil), an ELL
    otherwise."""
    from mlamg_torch.ops.sparse import ELL

    if A_scipy.shape[0] == A_scipy.shape[1] and DIA.num_diagonals(A_scipy) <= max_diagonals:
        return DIA.from_scipy(A_scipy, dtype=dtype, device=device)
    return ELL.from_scipy(A_scipy, dtype=dtype, device=device)
