"""Shared CLI helpers (counterpart of ``mlamg_tpu/cli/common.py``)."""

from __future__ import annotations

import json
import os

import numpy as np
import scipy.sparse as sp

from mlamg_torch.data.grid import Grid
from mlamg_torch.train import lloyd_reference_conv


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


def reference_settings(strength_measure: str, opts) -> dict:
    """The measurement settings a reference-conv cache is keyed by."""
    return {
        "strength": strength_measure,
        "res_tol": opts.res_tol,
        "max_iter": opts.max_iter,
        "pre": opts.pre_smooth,
        "post": opts.post_smooth,
        "smoother": opts.smoother,
        "error_norm": opts.use_error_norm,
        "singular": opts.singular,
    }


def compute_reference_convs(bundles, strength_measure: str, opts, grids=None,
                            cache_path: str | None = None,
                            write_path: str | None = None) -> np.ndarray:
    """Lloyd reference conv of each bundle (``lloyd_reference_conv``, at
    least 1e-6), set as its ``ref_conv``.

    ``cache_path`` names a cache to read (the JAX package's
    ``.ref_convs_<strength>.json`` beside each split): a grid whose file
    name it holds under the same settings is not measured again.  The
    convs measured here, with the cached ones, are written only to
    ``write_path`` (a temporary file renamed into place), never to
    ``cache_path``.  ``grids`` supplies the file names.
    """
    settings = reference_settings(strength_measure, opts)
    cache = {}
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                payload = json.load(f)
            if payload.get("settings") == settings:
                cache = dict(payload.get("convs", {}))
        except (OSError, ValueError):
            cache = {}

    def grid_key(i):
        fname = (grids[i].extra or {}).get("filename", "") if grids is not None else ""
        return os.path.basename(fname) if fname else None

    measured = False
    for i, b in enumerate(bundles):
        key = grid_key(i)
        if key is not None and key in cache:
            b.ref_conv = float(cache[key])
            continue
        b.ref_conv = max(lloyd_reference_conv(b, strength_measure, opts), 1e-6)
        measured = True
        if key is not None:
            cache[key] = b.ref_conv
    if write_path and measured:
        os.makedirs(os.path.dirname(write_path) or ".", exist_ok=True)
        tmp = write_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"settings": settings, "convs": cache}, f)
        os.replace(tmp, write_path)
    return np.asarray([b.ref_conv for b in bundles])
