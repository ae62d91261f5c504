"""Sparse matrix-vector products (counterpart of ``mlamg_tpu/ops/matmul.py``
:func:`spmv`, :func:`spmv_affine`, :func:`spmv_t` and :func:`spmm`).

A :class:`WindowedELL` goes to ``well_spmv`` and a :class:`DIA` to
``dia_spmv`` (the hand-written CUDA kernels on the card; the JAX package
sends only a pre-blocked DIA on a TPU to its kernel, the port every DIA on
CUDA).  A :class:`CSR` runs as a gather plus ``index_add_`` (the JAX
package's gather plus ``segment_sum``); a dense tensor is a matmul.
``spmv_t`` and ``spmm`` take DIA and dense operands.
"""

from __future__ import annotations

import torch

from mlamg_torch.ops.dia import DIA, dia_spmm, dia_spmv, dia_spmv_t
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.ops.unstructured import WindowedELL, well_spmv


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a dense tensor, CSR, DIA or WindowedELL A and a dense
    (n,) x."""
    if isinstance(A, torch.Tensor):
        return A @ x
    if isinstance(A, WindowedELL):
        return well_spmv(A, x)
    if isinstance(A, DIA):
        return dia_spmv(A, x)
    if isinstance(A, CSR):
        m = A.shape[0]
        # padded entries carry row == m and land in the dropped slot m
        y = torch.zeros(m + 1, dtype=x.dtype, device=x.device)
        return y.index_add_(0, A.row, A.data * x[A.col])[:m]
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
    """y = A.T @ x without forming the transpose (dense or DIA A)."""
    if isinstance(A, torch.Tensor):
        return A.T @ x
    if isinstance(A, DIA):
        return dia_spmv_t(A, x)
    raise TypeError(f"spmv_t: unsupported operand {type(A).__name__}")


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a dense or DIA A (m, n) and a dense X (n, k)."""
    if isinstance(A, torch.Tensor):
        return A @ X
    if isinstance(A, DIA):
        return dia_spmm(A, X)
    raise TypeError(f"spmm: unsupported operand {type(A).__name__}")
