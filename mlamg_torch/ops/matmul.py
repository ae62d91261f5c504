"""Sparse matrix-vector products (counterpart of ``mlamg_tpu/ops/matmul.py``
:func:`spmv` / :func:`spmv_affine`).

A :class:`WindowedELL` goes to ``well_spmv`` (the hand-written CUDA kernel
on the card); a :class:`CSR` runs as a gather plus ``index_add_`` (the JAX
package's gather plus ``segment_sum``); a dense tensor is a matmul.
"""

from __future__ import annotations

import torch

from mlamg_torch.ops.sparse import CSR
from mlamg_torch.ops.unstructured import WindowedELL, well_spmv


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a dense tensor, CSR or WindowedELL A and a dense (n,) x."""
    if isinstance(A, torch.Tensor):
        return A @ x
    if isinstance(A, WindowedELL):
        return well_spmv(A, x)
    if isinstance(A, CSR):
        m = A.shape[0]
        # padded entries carry row == m and land in the dropped slot m
        y = torch.zeros(m + 1, dtype=x.dtype, device=x.device)
        return y.index_add_(0, A.row, A.data * x[A.col])[:m]
    raise TypeError(f"spmv: unsupported operand {type(A).__name__}")


def spmv_affine(A, x: torch.Tensor, c: torch.Tensor | None = None,
                alpha: float = 1.0) -> torch.Tensor:
    """y = alpha * (A @ x) + c; one kernel pass for a WindowedELL."""
    if isinstance(A, WindowedELL):
        return well_spmv(A, x, c=c, alpha=alpha)
    y = spmv(A, x)
    if alpha != 1.0:
        y = alpha * y
    return y if c is None else y + c
