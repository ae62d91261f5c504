"""Strength-of-connection measures (counterpart of
``mlamg_tpu/graph/strength.py``).

The outputs are edge distances for Lloyd/Bellman-Ford aggregation
(smaller = nodes cluster together sooner).  The evolution measure evolves
the identity through ``k`` weighted-Jacobi steps on A's pattern and turns
relative persistence into a distance:

    Z    = (I - omega D^-1 A)^k        (pattern-masked, omega = 1/rho(D^-1 A))
    d_ij = |Z_ii| / (|Z_ij| + eps),    d_ii = 0.

``evolution`` = ev + 0.1 * unit, ``olson`` = ev + 1/|a|.
"""

from __future__ import annotations

import torch

from mlamg_torch.mg.smoothers import _dinv
from mlamg_torch.ops.matmul import spgemm_masked, spmv
from mlamg_torch.ops.segment import tree_sum
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u . v added in :func:`tree_sum`'s order: the same bits on the card
    and on the CPU."""
    return tree_sum(u * v)[0]


def power_iteration_lmax(A, Dinv=None, iters: int = 30, key=None) -> torch.Tensor:
    """Largest eigenvalue (in magnitude) of D^-1 A (or A without ``Dinv``),
    a 0-d tensor.  The start vector is ``normal(PRNGKey(1), (n,))``, drawn
    as the JAX package draws it (:mod:`mlamg_torch.utils.prng`).  Norms and
    dot products add in a fixed order, so the aggregations that follow from
    lmax (olson strength, Lloyd) are the same on the card and the CPU."""
    n = A.shape[0]
    np_dtype = torch.empty((), dtype=A.dtype).numpy().dtype
    v = torch.from_numpy(prng.normal(prng.PRNGKey(1) if key is None else key, (n,), np_dtype))
    v = v.to(A.device)
    v = v / torch.sqrt(_dot(v, v))

    def apply(v):
        w = spmv(A, v)
        return w if Dinv is None else w * Dinv

    for _ in range(iters):
        w = apply(v)
        v = w / (torch.sqrt(_dot(w, w)) + 1e-30)
    w = apply(v)
    return _dot(v, w) / (_dot(v, v) + 1e-30)


def evolution_strength(A: CSR, *, k: int = 2, width: int, eps: float = 1e-12) -> CSR:
    """Evolution-based distance matrix on A's pattern (see module
    docstring); ``width`` bounds A's row degree."""
    n = A.shape[0]
    Dinv = _dinv(A)
    lmax = power_iteration_lmax(A, Dinv).abs()
    omega = 1.0 / torch.where(lmax > 0, lmax, torch.ones_like(lmax))

    # S = I - omega * Dinv A on A's pattern
    live = A.mask
    rsafe = A.row.clamp(max=n - 1)
    on_diag = live & (A.row == A.col)
    zero = torch.zeros_like(A.data)
    s_data = -omega * Dinv[rsafe] * A.data
    s_data = torch.where(on_diag, s_data + 1.0, s_data)
    S = A.with_data(torch.where(live, s_data, zero))

    Z = S
    for _ in range(k - 1):
        Z = spgemm_masked(Z, S, A, a_width=width, b_width=width)

    zii = Z.diagonal().abs()[rsafe]
    dist = zii / (Z.data.abs() + eps)
    dist = torch.where(A.row == A.col, zero, dist)
    return A.with_data(torch.where(live, dist, zero))


def strength_measure(A: CSR, kind: str = "abs", *, width: int | None = None) -> CSR:
    """Named strength measures: ``abs``, ``unit``, ``invabs``, and
    ``evolution`` and ``olson``, which need ``width`` (A's largest row
    degree)."""
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    unit = torch.where(A.mask, zero + 1.0, zero)
    if kind == "abs":
        return A.abs()
    if kind == "unit":
        return A.with_data(unit)
    inv = torch.where(A.mask, 1.0 / A.data.abs().clamp(min=1e-30), zero)
    if kind == "invabs":
        return A.with_data(inv)
    if kind in ("evolution", "olson"):
        if width is None:
            raise ValueError(f"strength_measure({kind!r}) needs width (the largest row degree)")
        ev = evolution_strength(A, width=width)
        return A.with_data(ev.data + (0.1 * unit if kind == "evolution" else inv))
    raise ValueError(f"unknown strength measure: {kind}")


STRENGTH_MEASURES = ("abs", "unit", "invabs", "evolution", "olson")
