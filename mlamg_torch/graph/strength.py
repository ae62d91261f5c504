"""Strength-of-connection measures (counterpart of
``mlamg_tpu/graph/strength.py`` :func:`strength_measure`).

The outputs are edge distances for Lloyd/Bellman-Ford aggregation
(smaller = nodes cluster together sooner).
"""

from __future__ import annotations

import torch

from mlamg_torch.ops.sparse import CSR


def strength_measure(A: CSR, kind: str = "abs") -> CSR:
    """Named strength measures: ``abs``, ``unit`` and ``invabs``.

    ``evolution`` and ``olson`` need the pattern-masked SpGEMM, which the
    port does not have yet.
    """
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    if kind == "abs":
        return A.abs()
    if kind == "unit":
        return A.with_data(torch.where(A.mask, zero + 1.0, zero))
    if kind == "invabs":
        return A.with_data(
            torch.where(A.mask, 1.0 / A.data.abs().clamp(min=1e-30), zero)
        )
    if kind in ("evolution", "olson"):
        raise NotImplementedError(
            f"strength_measure({kind!r}) needs spgemm_masked, which is not "
            "ported yet (ROADMAP.md Queue 1 items 2-3)"
        )
    raise ValueError(f"unknown strength measure: {kind}")
