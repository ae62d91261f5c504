"""PETSc binary matrix and vector files (counterpart of
``mlamg_tpu/data/petsc_io.py``): the format production solves dump their
operators in.

  Mat: int32 big-endian [MAT_FILE_CLASSID=1211216, m, n, nnz],
       then row counts (m), column indices (nnz), float64 values (nnz)
  Vec: [VEC_FILE_CLASSID=1211214, n], then float64 values (n)
"""

from __future__ import annotations

import numpy as np

MAT_FILE_CLASSID = 1211216
VEC_FILE_CLASSID = 1211214


def read_petsc_mat(fname: str):
    """Read a PETSc binary matrix -> scipy CSR."""
    import scipy.sparse as sp

    with open(fname, "rb") as f:
        header = np.fromfile(f, dtype=">i4", count=4)
        if len(header) != 4 or header[0] != MAT_FILE_CLASSID:
            raise ValueError(f"{fname}: not a PETSc binary Mat")
        m, n, nnz = (int(v) for v in header[1:])
        row_counts = np.fromfile(f, dtype=">i4", count=m)
        indices = np.fromfile(f, dtype=">i4", count=nnz)
        data = np.fromfile(f, dtype=">f8", count=nnz)
    indptr = np.concatenate([[0], np.cumsum(row_counts)]).astype(np.int64)
    return sp.csr_matrix(
        (data.astype(np.float64), indices.astype(np.int64), indptr), shape=(m, n)
    )


def read_petsc_vec(fname: str) -> np.ndarray:
    with open(fname, "rb") as f:
        header = np.fromfile(f, dtype=">i4", count=2)
        if len(header) != 2 or header[0] != VEC_FILE_CLASSID:
            raise ValueError(f"{fname}: not a PETSc binary Vec")
        n = int(header[1])
        return np.fromfile(f, dtype=">f8", count=n).astype(np.float64)


def write_petsc_mat(fname: str, A) -> None:
    """Write scipy matrix in PETSc binary format (round-trip/testing)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    with open(fname, "wb") as f:
        np.asarray([MAT_FILE_CLASSID, A.shape[0], A.shape[1], A.nnz], ">i4").tofile(f)
        np.diff(A.indptr).astype(">i4").tofile(f)
        A.indices.astype(">i4").tofile(f)
        A.data.astype(">f8").tofile(f)


def write_petsc_vec(fname: str, v) -> None:
    v = np.asarray(v, np.float64)
    with open(fname, "wb") as f:
        np.asarray([VEC_FILE_CLASSID, len(v)], ">i4").tofile(f)
        v.astype(">f8").tofile(f)
