"""Row-partitioned Bellman-Ford with halo min-exchange (counterpart of
``mlamg_tpu/parallel/pbf.py``).

The distance and nearest-center vectors are split like the matrix rows;
each sweep relaxes the shard-local rows against a halo-extended view of
(dist, nearest) from the ring neighbours, and a sum of the shards'
change flags decides termination (one host read per sweep).  Nearest
center ids travel as integers (the JAX package sends them as floats).
"""

from __future__ import annotations

import torch

from mlamg_torch.parallel import _comm
from mlamg_torch.parallel.mesh import Mesh
from mlamg_torch.parallel.pspmv import PartitionedELL, _gather_slots, as_sharded


def pbf_partition(C, num_shards: int, halo: int, dtype=torch.float64,
                  device=None) -> PartitionedELL:
    """Partition a (possibly directed) strength graph for :func:`pbf`.

    ``pbf`` relaxes each local row i from its stored entries (pull form),
    so a stored entry (i, j) acts as the edge j -> i; the serial kernel
    treats C[i, j] as the edge i -> j, so storing C^T makes the two equal
    for any directed C.
    """
    import scipy.sparse as sp

    return PartitionedELL.from_scipy(sp.csr_matrix(C).T.tocsr(), num_shards, halo=halo,
                                     dtype=dtype, device=device)


def halo_relax(data, col, dist, near, h: int, n: int, first_min: bool, max_iter: int):
    """Multi-source relaxation sweeps over row-sharded (data, col) until
    no distance changes (or ``max_iter`` sweeps) from the Sharded (dist,
    near).  A stored weight 0 is an absent slot.  An improved row takes
    the nearest id of its first minimal slot (``first_min``) or, with
    ``near`` None, keeps no ids; else the smallest id among its minimal
    slots.  Returns (dist, near, sweeps)."""
    lay = dist.layout
    w = data.map(lambda d: torch.where(d != 0, d, torch.full_like(d, float("inf"))))
    sweeps = 0
    while sweeps < max_iter:
        sweeps += 1
        d_ext = _comm.ring_halo(dist, h, float("inf"))
        n_ext = None if near is None else _comm.ring_halo(near, h, n)
        new_d, new_n, flags = [], [], []
        for i, (dp, wp, cp) in enumerate(zip(dist.parts, w.parts, col.parts)):
            cand = _gather_slots(d_ext.parts[i], cp) + wp
            best = cand.min(-1).values
            improved = best < dp
            new_d.append(torch.where(improved, best, dp))
            flags.append(improved.any(-1))
            if near is None:
                continue
            nbr = _gather_slots(n_ext.parts[i], cp)
            if first_min:
                pick = nbr.gather(-1, cand.argmin(-1, keepdim=True))[..., 0]
            else:
                win = cand <= new_d[-1][..., None]
                pick = torch.where(win, nbr, torch.full_like(nbr, n)).min(-1).values
            new_n.append(torch.where(improved, pick, near.parts[i]))
        dist = _comm.Sharded(tuple(new_d), lay)
        if near is not None:
            near = _comm.Sharded(tuple(new_n), lay)
        if not bool(_comm.psum(_comm.Sharded(tuple(f.to(torch.int32) for f in flags), lay))[0]):
            break
    return dist, near, sweeps


def pbf(A: PartitionedELL, centers_mask_sharded, mesh: Mesh, max_iter: int | None = None):
    """Distributed multi-source Bellman-Ford.

    ``A`` holds the **transpose** of the serial kernel's graph (build it
    with :func:`pbf_partition`).  ``centers_mask_sharded`` is (S, n_loc)
    bool, True at centers.  Returns (dist (S, n_loc), nearest global id
    (S, n_loc), S * n_loc where unreachable), sharded; an improved node
    takes the id of its first minimal slot, as the JAX package's argmin
    does.
    """
    if A.halo is None:
        raise ValueError("pbf requires a halo-encoded partition")
    S, n_loc = A.num_shards, A.n_loc
    n = S * n_loc
    data, col = A.to_global(mesh)
    cmask = as_sharded(A, centers_mask_sharded, mesh)
    dist, near = [], []
    for b, m, d in zip(cmask.layout.local, cmask.parts, data.parts):
        gid = torch.arange(b.start * n_loc, b.stop * n_loc, device=m.device).view(m.shape)
        dist.append(torch.where(m, torch.zeros((), dtype=d.dtype, device=m.device),
                                torch.full((), float("inf"), dtype=d.dtype, device=m.device)))
        near.append(torch.where(m, gid, torch.full_like(gid, n)))
    return halo_relax(data, col, _comm.Sharded(tuple(dist), cmask.layout),
                      _comm.Sharded(tuple(near), cmask.layout), A.halo, n, True,
                      n if max_iter is None else max_iter)[:2]
