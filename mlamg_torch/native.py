"""ctypes binding of the host C++ runtime ``native/mlamg_native.cpp``
(counterpart of ``mlamg_tpu/native/__init__.py``: ``rcm_ordering``,
``count_diagonals``, ``csr_to_dia``, ``csr_to_ell``, ``greedy_coloring``,
``required_halo``, ``bellman_ford`` and ``fem_p1_assemble``).

The library is compiled from the repository's source at first use by
``g++ -O3 -fPIC -shared`` into ``mlamg_torch/_build/`` (no
``-march=native``, and never a library built on another host; see
``ops/_build.py``).  Without a compiler or the source, ``rcm_ordering``
falls back to scipy exactly as the JAX package does, so both packages give
the same permutation on the same machine; the DIA and ELL packings fall
back to numpy (:func:`csr_to_dia_numpy`, :func:`csr_to_ell_numpy`), which
give the same results, as do the numpy fallbacks of
:func:`required_halo`, :func:`bellman_ford` and :func:`fem_p1_assemble`
(the JAX package's own); :func:`mlamg_torch.mg.smoothers.greedy_coloring`
runs :func:`greedy_coloring` where the library is built and its own Python
loop (the same colours) where it is not.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np

from mlamg_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[1] / "native" / "mlamg_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        return None
    command = (cxx, *CXX_FLAGS)
    try:
        out = _build.library_path("mlamg_native", SOURCE, command)
        _build.compile_library(command, SOURCE, out)
        lib = ctypes.CDLL(str(out))
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    i64 = ctypes.c_int64
    lib.rcm_ordering.restype = None
    lib.rcm_ordering.argtypes = [i64, p_i64, p_i32, p_i32]
    lib.count_diagonals.restype = i64
    lib.count_diagonals.argtypes = [i64, p_i64, p_i32]
    lib.csr_to_dia.restype = i64
    lib.csr_to_dia.argtypes = [i64, p_i64, p_i32, p_f32, p_i64, p_f32]
    lib.csr_to_ell.restype = ctypes.c_int
    lib.csr_to_ell.argtypes = [i64, p_i64, p_i32, p_f32, i64, p_f32, p_i32]
    lib.greedy_coloring.restype = ctypes.c_int32
    lib.greedy_coloring.argtypes = [i64, p_i64, p_i32, p_i32]
    lib.required_halo.restype = i64
    lib.required_halo.argtypes = [i64, p_i64, p_i32, i64]
    lib.bellman_ford.restype = None
    lib.bellman_ford.argtypes = [i64, p_i64, p_i32, p_f32, p_i32, i64, p_f32, p_i32]
    lib.fem_p1_assemble.restype = None
    lib.fem_p1_assemble.argtypes = [i64, p_f64, p_i64, p_f64, p_i64, p_i64, p_f64]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def rcm_ordering(A) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[k] = old index of new k)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    lib = _load()
    if lib is not None:
        perm = np.empty(n, np.int32)
        lib.rcm_ordering(
            n, np.ascontiguousarray(A.indptr, np.int64),
            np.ascontiguousarray(A.indices, np.int32), perm,
        )
        return perm
    import scipy.sparse.csgraph as csgraph

    return np.asarray(
        csgraph.reverse_cuthill_mckee(A, symmetric_mode=True), np.int32
    )


def _csr_parts(A):
    """(indptr i64, indices i32, data f32, n) of ``A`` with sorted indices."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sort_indices()
    return (
        np.ascontiguousarray(A.indptr, np.int64),
        np.ascontiguousarray(A.indices, np.int32),
        np.ascontiguousarray(A.data, np.float32),
        A.shape[0],
    )


def count_diagonals(A) -> int:
    """Number of distinct stored diagonals (offsets col - row) of ``A``."""
    lib = _load()
    if lib is not None:
        indptr, indices, _, n = _csr_parts(A)
        return int(lib.count_diagonals(n, indptr, indices))
    import scipy.sparse as sp

    coo = sp.csr_matrix(A).tocoo()
    return len(np.unique(coo.col - coo.row))


def csr_to_dia_numpy(A, dtype=np.float32):
    """(offsets (D,) i64 sorted, data (D, n) ``dtype``) with
    ``data[d, i] = A[i, i + offsets[d]]`` and zeros elsewhere: one
    ``np.searchsorted`` over the sorted distinct offsets, no per-entry
    Python work."""
    import scipy.sparse as sp

    coo = sp.csr_matrix(A).tocoo()
    diff = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(diff)
    data = np.zeros((len(offsets), A.shape[0]), dtype)
    data[np.searchsorted(offsets, diff), coo.row] = coo.data
    return offsets, data


def csr_to_dia(A):
    """(offsets (D,) i64 sorted, data (D, n) f32) of a square matrix: the
    C++ extraction, or :func:`csr_to_dia_numpy` where it is not built."""
    lib = _load()
    if lib is None:
        return csr_to_dia_numpy(A, np.float32)
    indptr, indices, data, n = _csr_parts(A)
    cap = int(lib.count_diagonals(n, indptr, indices))
    offsets = np.empty(cap, np.int64)
    out = np.empty((cap, n), np.float32)
    d = int(lib.csr_to_dia(n, indptr, indices, data, offsets, out.reshape(-1)))
    return offsets[:d], out[:d]


def csr_to_ell_numpy(A, width: int | None = None, dtype=np.float32):
    """(data (n, w) ``dtype``, cols (n, w) i32): each row's entries in
    column order, then zeros (column 0); raises if a row holds more than
    ``width`` entries (default: the largest row degree)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    deg = np.diff(A.indptr)
    w = int(deg.max(initial=0)) if width is None else int(width)
    if deg.max(initial=0) > w:
        raise ValueError(f"row degree exceeds width {w}")
    data = np.zeros((n, w), dtype)
    cols = np.zeros((n, w), np.int32)
    rows = np.repeat(np.arange(n), deg)
    offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    data[rows, offs] = A.data
    cols[rows, offs] = A.indices
    return data, cols


def csr_to_ell(A, width: int | None = None):
    """(data (n, w) f32, cols (n, w) i32): the C++ packing, or
    :func:`csr_to_ell_numpy` where it is not built."""
    lib = _load()
    if lib is None:
        return csr_to_ell_numpy(A, width)
    indptr, indices, data, n = _csr_parts(A)
    w = int(np.diff(indptr).max(initial=0)) if width is None else int(width)
    out_d = np.empty((n, w), np.float32)
    out_c = np.empty((n, w), np.int32)
    if lib.csr_to_ell(n, indptr, indices, data, w, out_d, out_c) != 0:
        raise ValueError(f"row degree exceeds width {w}")
    return out_d, out_c


def greedy_coloring(A):
    """(colors (n,) i32, num_colors): the C++ greedy colouring in row order,
    each row the smallest colour its lower-numbered neighbours leave free.
    Needs the library (:func:`available`); callers use
    :func:`mlamg_torch.mg.smoothers.greedy_coloring`, which falls back to
    its Python loop."""
    lib = _load()
    if lib is None:
        raise RuntimeError("greedy_coloring: the native library is not built")
    indptr, indices, _, n = _csr_parts(A)
    colors = np.empty(n, np.int32)
    return colors, int(lib.greedy_coloring(n, indptr, indices, colors))


def required_halo(A, n_loc: int) -> int:
    """Halo width a partition of ``A`` into blocks of ``n_loc`` rows needs:
    the farthest any stored column lies outside its row's block (0 when
    every entry is inside)."""
    lib = _load()
    if lib is not None:
        indptr, indices, _, n = _csr_parts(A)
        return int(lib.required_halo(n, indptr, indices, n_loc))
    import scipy.sparse as sp

    coo = sp.csr_matrix(A).tocoo()
    lo = (coo.row // n_loc) * n_loc
    halo = np.maximum(lo - coo.col, coo.col - (lo + n_loc) + 1)
    return int(max(0, halo.max())) if len(halo) else 0


def bellman_ford(A, centers):
    """(dist (n,) f32, nearest (n,) i32): multi-source shortest paths over
    the float32 weights of ``A`` (entry (i, j) an edge i -> j), the host
    oracle; unreachable nodes keep inf and -1.  Without the library, the
    JAX package's fallback: relax every edge at once until nothing
    improves, resolving the improved edges one by one in COO order.  It
    relaxes with the float32 weights, as the library does: the JAX
    package's relaxes with ``A``'s own, and on float64 weights that float32
    does not hold it never ends (a sum rounded up when stored as float32
    stays larger than the float64 candidate)."""
    indptr, indices, data, n = _csr_parts(A)
    centers = np.ascontiguousarray(centers, np.int32)
    dist = np.full(n, np.inf, np.float32)
    nearest = np.full(n, -1, np.int32)
    lib = _load()
    if lib is not None:
        lib.bellman_ford(n, indptr, indices, data, centers, len(centers), dist, nearest)
        return dist, nearest
    import scipy.sparse as sp

    dist[centers] = 0.0
    nearest[centers] = centers
    coo = sp.csr_matrix(A).tocoo()
    weights = coo.data.astype(np.float32)
    changed = True
    while changed:
        better = dist[coo.row] + weights < dist[coo.col]
        changed = bool(better.any())
        for r, c, w in zip(coo.row[better], coo.col[better], weights[better]):
            if dist[r] + w < dist[c]:
                dist[c] = dist[r] + w
                nearest[c] = nearest[r]
    return dist, nearest


def fem_p1_assemble(vertices, triangles, kappa_tensors):
    """COO triplets (rows, cols, vals), 9 per triangle, of the P1 stiffness
    matrix with a (2, 2) kappa tensor per triangle (``kappa_tensors`` is
    (n_tri, 2, 2)); float64 throughout."""
    v = np.ascontiguousarray(np.asarray(vertices)[:, :2], np.float64)
    t = np.ascontiguousarray(triangles, np.int64)
    k = np.ascontiguousarray(kappa_tensors, np.float64)
    n_tri = len(t)
    lib = _load()
    if lib is not None:
        rows = np.empty(9 * n_tri, np.int64)
        cols = np.empty(9 * n_tri, np.int64)
        vals = np.empty(9 * n_tri, np.float64)
        lib.fem_p1_assemble(n_tri, v.reshape(-1), t.reshape(-1), k.reshape(-1), rows, cols, vals)
        return rows, cols, vals
    p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    d1 = p1 - p0
    d2 = p2 - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * np.abs(det)
    inv_det = 1.0 / det
    g1 = np.column_stack([d2[:, 1], -d2[:, 0]]) * inv_det[:, None]
    g2 = np.column_stack([-d1[:, 1], d1[:, 0]]) * inv_det[:, None]
    G = np.stack([-(g1 + g2), g1, g2], axis=1)  # (m, 3, 2) gradients of the hat functions
    KG = np.einsum("mab,mjb->mja", k, G)
    local = np.einsum("mia,mja->mij", G, KG) * area[:, None, None]
    rows = np.repeat(t, 3, axis=1).ravel()
    cols = np.tile(t, (1, 3)).ravel()
    return rows.astype(np.int64), cols.astype(np.int64), local.ravel()
