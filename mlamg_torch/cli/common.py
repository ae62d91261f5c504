"""Shared CLI helpers (counterpart of ``mlamg_tpu/cli/common.py``)."""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from mlamg_torch.data.grid import Grid


def parse_bool_str(v: str) -> bool:
    return str(v).lower() in ("t", "true", "1", "yes")


def dataset_bf_width(grids) -> int:
    """Largest row or column degree over a dataset's matrices: the width of
    the pull-mode Bellman-Ford and of the graphs' ``in_ell``.  Both assume
    a symmetric sparsity pattern, which is checked here so an unsuitable
    dataset fails at setup instead of dropping edges later."""
    w = 1
    for i, g in enumerate(grids):
        A = sp.csr_matrix(g.A)
        pat = A.copy()
        pat.data = np.ones_like(pat.data)
        if (pat != pat.T).nnz != 0:
            name = (g.extra or {}).get("filename", f"grid {i}")
            raise ValueError(
                f"{name}: sparsity pattern is not symmetric; the pull-mode "
                "Bellman-Ford and the in_ell message sums need a symmetric "
                "pattern (symmetrize it, or use bf_width=None)"
            )
        w = max(w, int(np.diff(A.indptr).max()), int(np.diff(A.tocsc().indptr).max()))
    return w


def load_dataset_grids(system: str):
    """(train, test) Grids of ``system/train`` and ``system/test``, or of
    ``system`` itself for both when those do not exist."""
    train_dir = os.path.join(system, "train")
    test_dir = os.path.join(system, "test")
    if not (os.path.exists(train_dir) and os.path.exists(test_dir)):
        train_dir = test_dir = system
    return Grid.load_dir(train_dir), Grid.load_dir(test_dir)
