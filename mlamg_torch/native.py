"""ctypes binding of the host C++ runtime ``native/mlamg_native.cpp``
(counterpart of ``mlamg_tpu/native/__init__.py``; only ``rcm_ordering``
is on the port's path so far).

The library is compiled from the repository's source at first use by
``g++ -O3 -fPIC -shared`` into ``mlamg_torch/_build/`` (no
``-march=native``, and never a library built on another host; see
``ops/_build.py``).  Without a compiler or the source, ``rcm_ordering``
falls back to scipy exactly as the JAX package does, so both packages give
the same permutation on the same machine.
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
    lib.rcm_ordering.restype = None
    lib.rcm_ordering.argtypes = [ctypes.c_int64, p_i64, p_i32, p_i32]
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
