"""State carried across from the JAX package.

The ported paths have no learned weights: their state is the multilevel
hierarchy.  :func:`uhierarchy_from_numpy` builds the port's
:class:`UHierarchy` and :func:`hierarchy_from_numpy` the structured
:class:`Hierarchy` from plain numpy/scipy data, exactly what ``np.asarray``
pulls out of the JAX package's hierarchies.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.mg.amg_unstructured import UHierarchy, _make_level
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.cycle import Hierarchy
from mlamg_torch.mg.factored import BilinearP2D, BoxAgg2D, FactoredSA
from mlamg_torch.ops.dia import DIA


def uhierarchy_from_numpy(levels: Sequence[Mapping], coarse: Mapping, *,
                          fmt: str, device=None, block_rows: int = 8) -> UHierarchy:
    """Port hierarchy from host data.

    ``levels``: per level a mapping with the scipy operator ``A`` and
    ``Dinv``, ``agg``, ``omegas``, ``lmax``, ``k``.  ``coarse``: ``lu``,
    ``piv`` (0-based, as JAX and scipy return them), ``singular`` and
    ``method``.  ``fmt`` is ``"well"`` or ``"csr"``.
    """
    dev = resolve_device(device)
    ulevels = tuple(_make_level(lev, fmt, block_rows, dev) for lev in levels)
    return UHierarchy(ulevels, _coarse_from_numpy(coarse, dev, np.float32))


def _coarse_from_numpy(coarse: Mapping, device, dtype=None) -> CoarseSolver:
    """CoarseSolver from ``lu`` (the inverse for ``method="inverse"``),
    ``piv`` (0-based, as JAX and scipy return them), ``singular`` and
    ``method``; ``lu`` in ``dtype`` (default: its own)."""
    method = str(coarse["method"])
    lu = torch.tensor(np.asarray(coarse["lu"], dtype), device=device)
    if method == "lu":
        # LAPACK (and so torch) pivots are 1-based
        piv = torch.tensor(np.asarray(coarse["piv"], np.int32) + 1, device=device)
    else:
        piv = torch.zeros(0, dtype=torch.int32, device=device)
    return CoarseSolver(lu, piv, bool(coarse["singular"]), method)


def _dia_from_numpy(m: Mapping, device) -> DIA:
    """DIA from ``data`` ((D, n), or the JAX package's blocked
    (D, n/128, 128), which is flattened), ``offsets`` and ``shape``."""
    offsets = tuple(int(o) for o in m["offsets"])
    shape = tuple(int(s) for s in m["shape"])
    data = np.asarray(m["data"]).reshape(len(offsets), shape[0])
    return DIA(torch.tensor(data, device=device), offsets, shape)


def _prolongator_from_numpy(m: Mapping, device):
    """``{"ny", "nx"}`` is a :class:`BilinearP2D`; ``{"Ss", "Sts", "T"}``
    with DIA mappings and ``T = {"ny", "nx", "sy", "sx"}`` a
    :class:`FactoredSA` over a :class:`BoxAgg2D`."""
    if "Ss" not in m:
        return BilinearP2D(ny=int(m["ny"]), nx=int(m["nx"]))
    T = BoxAgg2D(**{k: int(m["T"][k]) for k in ("ny", "nx", "sy", "sx")})
    return FactoredSA(tuple(_dia_from_numpy(S, device) for S in m["Ss"]),
                      tuple(_dia_from_numpy(S, device) for S in m["Sts"]), T)


def hierarchy_from_numpy(As: Sequence[Mapping], Ps: Sequence[Mapping],
                         Dinvs: Sequence, lmaxs: Sequence, coarse: Mapping, *,
                         device=None) -> Hierarchy:
    """Structured hierarchy from host data, in the data's own float type.

    ``As``: per level a DIA mapping (``data``, ``offsets``, ``shape``).
    ``Ps``: per level a prolongator mapping (see
    :func:`_prolongator_from_numpy`).  ``Dinvs`` and ``lmaxs``: per level
    the inverse diagonal and the spectrum bound.  ``coarse``: ``lu`` (the
    inverse for ``method="inverse"``), ``piv`` (0-based), ``singular`` and
    ``method`` (see :func:`_coarse_from_numpy`).
    """
    dev = resolve_device(device)
    return Hierarchy(
        tuple(_dia_from_numpy(A, dev) for A in As),
        tuple(_prolongator_from_numpy(P, dev) for P in Ps),
        tuple(torch.tensor(np.asarray(d), device=dev) for d in Dinvs),
        _coarse_from_numpy(coarse, dev),
        tuple(float(v) for v in lmaxs),
    )
