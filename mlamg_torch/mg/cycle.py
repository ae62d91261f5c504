"""Convergence-factor readout (counterpart of ``mlamg_tpu/mg/cycle.py``
:func:`_conv_factor`)."""

from __future__ import annotations

import math

import torch


def _conv_factor(err: torch.Tensor, iters: int) -> float:
    """Geometric-mean convergence factor over the last ``min(iters//3, 10)``
    residual norms of ``err[:iters]``; 0.0 below 6 iterations (or with a
    zero base), 1.0 for a non-finite history (the failure convention of
    the JAX package).  The ratio is taken in ``err``'s dtype and the root
    in double precision."""
    iters = int(iters)
    err_n = min(iters // 3, 10)
    last = err[max(iters - 1, 0)]
    base = err[max(iters - err_n, 0)]
    last_f, base_f = float(last), float(base)
    if not (math.isfinite(last_f) and math.isfinite(base_f)):
        return 1.0
    if iters < 6 or base_f <= 0:
        return 0.0
    conv = float(last / base) ** (1.0 / max(err_n - 1, 1))
    return conv if math.isfinite(conv) else 1.0
