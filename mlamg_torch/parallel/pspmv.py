"""Row-partitioned SpMV over the mesh's ``row`` axis (counterpart of
``mlamg_tpu/parallel/pspmv.py``).

A matrix's rows are split into contiguous shards in ELL layout and the
vector is split the same way.  :func:`pspmv` gathers the whole vector
and multiplies with global column ids; :func:`pspmv_halo`, for a banded
matrix (a mesh ordered along an axis), takes only h boundary entries from
each ring neighbour, O(h) traffic in place of O(n).  The products are
plain torch operations, differentiable within one process.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.parallel import _comm
from mlamg_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class PartitionedELL:
    """Row-sharded ELL.

    data : (S, n_loc, w) values
    col  : (S, n_loc, w) int64: global ids (``halo`` None) or local-extended
           ids in [0, 2*halo + n_loc) when ``halo`` is set
    """

    data: torch.Tensor
    col: torch.Tensor
    shape: Tuple[int, int]
    num_shards: int
    halo: int | None

    @property
    def n_loc(self) -> int:
        return int(self.data.shape[1])

    @staticmethod
    def from_scipy(A, num_shards: int, halo: int | None = None, dtype=torch.float32,
                   device=None) -> "PartitionedELL":
        """Partition a scipy matrix into ``num_shards`` contiguous row
        blocks of ``ceil(n / num_shards)`` rows (the last zero-padded), each
        row's entries in column order.  With ``halo=h``, raises ValueError
        at the first row with a column outside its block's rows +- h, and
        stores local-extended column ids."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        A.sort_indices()
        n = A.shape[0]
        n_loc = -(-n // num_shards)
        deg = np.diff(A.indptr)
        w = int(deg.max())
        rows = np.repeat(np.arange(n), deg)
        slot = np.arange(A.nnz) - A.indptr[rows]
        c = A.indices.astype(np.int64)
        if halo is not None:
            lo = (rows // n_loc) * n_loc
            bad = (c < lo - halo) | (c >= lo + n_loc + halo)
            if bad.any():
                row = rows[bad.argmax()]
                raise ValueError(f"matrix bandwidth exceeds halo={halo} at row {row}")
            c = c - (lo - halo)
        data = np.zeros((num_shards * n_loc, w), torch.empty(0, dtype=dtype).numpy().dtype)
        col = np.zeros((num_shards * n_loc, w), np.int64)
        data[rows, slot] = A.data
        col[rows, slot] = c
        dev = resolve_device(device)
        return PartitionedELL(
            torch.from_numpy(data.reshape(num_shards, n_loc, w)).to(dev),
            torch.from_numpy(col.reshape(num_shards, n_loc, w)).to(dev),
            (n, A.shape[1]), num_shards, halo)

    def shard_x(self, x, mesh: Mesh | None = None):
        """(n,) vector -> (S, n_loc) row-sharded layout (zero padded): a
        tensor on the matrix's device, or with ``mesh`` this process's
        shards of it."""
        x = _comm.as_tensor(x)
        S, n_loc = self.num_shards, self.n_loc
        xs = x.new_zeros((S * n_loc,) + tuple(x.shape[1:]), device=x.device)
        xs[: self.shape[0]] = x
        xs = xs.reshape((S, n_loc) + tuple(x.shape[1:]))
        if mesh is not None:
            return _comm.split(xs, self.row_layout(mesh))
        return xs.to(self.data.device)

    def to_global(self, mesh: Mesh):
        """(data, col) split over the mesh's row axis (this process's
        shards)."""
        lay = self.row_layout(mesh)
        return _comm.split(self.data, lay), _comm.split(self.col, lay)

    def row_layout(self, mesh: Mesh) -> _comm.Layout:
        lay = _comm.layout(mesh, "row")
        if lay.num_shards != self.num_shards:
            raise ValueError(f"a {self.num_shards}-shard matrix on a mesh of "
                             f"{lay.num_shards} row shards")
        return lay


def as_sharded(A: PartitionedELL, v, mesh: Mesh, dtype=None) -> _comm.Sharded:
    """``v`` as this process's row shards: a :class:`~_comm.Sharded` as
    it is, an (S, n_loc, ...) array split, an (n, ...) vector laid out by
    :meth:`PartitionedELL.shard_x` first."""
    if isinstance(v, _comm.Sharded):
        return v if dtype is None else v.map(lambda p: p.to(dtype))
    v = _comm.as_tensor(v)
    if v.shape[:2] != (A.num_shards, A.n_loc):
        v = A.shard_x(v)
    return _comm.split(v, A.row_layout(mesh), dtype)


def _gather_slots(src: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """src (s, m, ...) gathered per shard at col (s, n_loc, w):
    (s, n_loc, w, ...)."""
    sid = torch.arange(src.shape[0], device=src.device).view(-1, 1, 1)
    return src[sid, col]


def local_spmv(data: torch.Tensor, col: torch.Tensor, x_ext: torch.Tensor) -> torch.Tensor:
    """Each shard's ELL product against its halo-extended vector."""
    return (data * _gather_slots(x_ext, col)).sum(-1)


def pspmv(A: PartitionedELL, xs, mesh: Mesh) -> _comm.Sharded:
    """General row-partitioned SpMV: all-gather x, local ELL product with
    global column ids.  ``xs`` (S, n_loc), sharded or not; returns the
    (S, n_loc) result sharded."""
    if A.halo is not None:
        raise ValueError("use pspmv_halo for halo-encoded matrices")
    data, col = A.to_global(mesh)
    full = _comm.Sharded(tuple(_comm.all_gather(as_sharded(A, xs, mesh))), data.layout)
    return _comm.zip_map(lambda d, c, f: (d * f.reshape(-1)[c]).sum(-1), data, col, full)


def pspmv_halo(A: PartitionedELL, xs, mesh: Mesh) -> _comm.Sharded:
    """Halo-exchange row-partitioned SpMV: h boundary entries from each
    ring neighbour, then one local ELL product on the extended vector."""
    if A.halo is None:
        raise ValueError("pspmv_halo needs a halo-encoded matrix")
    data, col = A.to_global(mesh)
    return _comm.zip_map(local_spmv, data, col,
                         _comm.ring_halo(as_sharded(A, xs, mesh), A.halo, 0.0))


def partitioned_jacobi(A: PartitionedELL, dinv, b, xs, mesh: Mesh, omega: float = 0.666,
                       nu: int = 2, use_halo: bool = True) -> _comm.Sharded:
    """Row-partitioned weighted-Jacobi sweeps (the distributed smoother);
    dinv, b and xs are (S, n_loc), sharded or not."""
    mv = pspmv_halo if use_halo else pspmv
    dinv, b, x = (as_sharded(A, v, mesh) for v in (dinv, b, xs))
    for _ in range(nu):
        x = _comm.zip_map(lambda xp, dp, bp, yp: xp + omega * dp * (bp - yp),
                          x, dinv, b, mv(A, x, mesh))
    return x
