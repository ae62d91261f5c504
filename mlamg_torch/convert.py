"""State carried across from the JAX package.

This slice has no learned weights: its state is the multilevel hierarchy.
:func:`uhierarchy_from_numpy` builds the port's :class:`UHierarchy` from
plain numpy/scipy data, exactly what ``np.asarray`` pulls out of a JAX
``UHierarchy`` (level operators via ``to_scipy()``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.mg.amg_unstructured import UHierarchy, _make_level
from mlamg_torch.mg.coarse import CoarseSolver


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
    method = str(coarse["method"])
    lu = torch.tensor(np.asarray(coarse["lu"], np.float32), device=dev)
    if method == "lu":
        # LAPACK (and so torch) pivots are 1-based
        piv = torch.tensor(np.asarray(coarse["piv"], np.int32) + 1, device=dev)
    else:
        piv = torch.zeros(0, dtype=torch.int32, device=dev)
    return UHierarchy(ulevels, CoarseSolver(lu, piv, bool(coarse["singular"]), method))
