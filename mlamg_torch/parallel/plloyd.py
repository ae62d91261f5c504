"""Row-partitioned Lloyd aggregation, distributed graph k-means
(counterpart of ``mlamg_tpu/parallel/plloyd.py``).

Each Lloyd iteration, with the rows split over the mesh's ``row`` axis:

1. multi-source Bellman-Ford assignment by halo min-exchange sweeps
   (labels are center node ids, smallest id on ties);
2. boundary detection: one halo exchange of the assignment;
3. interiorness: the Bellman-Ford distance from the cluster boundary;
4. recentering: each cluster's most interior node, its smallest gid on
   ties, by per-shard ``scatter_reduce`` (amax, then amin of the gids of
   the winners) combined across shards by pmax / pmin.

The JAX package forms the per-cluster reductions as a dense (n_loc, k)
one-hot; the scatter gives the same result in O(n_loc).  The graph must be
halo-encoded, and stored transposed for a directed C (build it with
:func:`mlamg_torch.parallel.pbf_partition`).
"""

from __future__ import annotations

import numpy as np
import torch

from mlamg_torch.parallel import _comm
from mlamg_torch.parallel.mesh import Mesh
from mlamg_torch.parallel.pbf import halo_relax
from mlamg_torch.parallel.pspmv import PartitionedELL, _gather_slots


def plloyd(A: PartitionedELL, seeds, mesh: Mesh, maxiter: int = 10,
           bf_max_iter: int | None = None, record: dict | None = None):
    """Distributed Lloyd clustering from the (k,) global node ids
    ``seeds``.  Returns (agg (S, n_loc) cluster indices, k where
    unassigned, sharded; centers (k,) global ids, replicated).
    ``record["sweeps"]``, where given, collects each Bellman-Ford's sweep
    count."""
    sweeps = [] if record is None else record.setdefault("sweeps", [])
    S, n_loc, h = A.num_shards, A.n_loc, A.halo
    if h is None:
        raise ValueError("plloyd requires a halo-encoded partition")
    n = S * n_loc
    bf_max_iter = n if bf_max_iter is None else bf_max_iter
    data, col = A.to_global(mesh)
    lay = data.layout
    devs = [p.device for p in data.parts]
    gid = _comm.Sharded(tuple(torch.arange(b.start * n_loc, b.stop * n_loc, device=d)
                              .view(-1, n_loc) for b, d in zip(lay.local, devs)), lay)
    live = data.map(lambda d: d != 0)
    seeds = torch.tensor(np.asarray(seeds, np.int64))
    k = seeds.shape[0]
    dtype = A.data.dtype

    def inf_where(mask):
        return torch.where(mask, torch.zeros((), dtype=dtype, device=mask.device),
                           torch.full((), float("inf"), dtype=dtype, device=mask.device))

    def seed_state(centers):
        is_c = []
        for g, c in zip(gid.parts, centers):
            table = torch.zeros(n, dtype=torch.bool, device=c.device)
            table[c] = True
            is_c.append(table[g])
        near = _comm.Sharded(tuple(torch.where(m, g, torch.full_like(g, n))
                                   for m, g in zip(is_c, gid.parts)), lay)
        return _comm.Sharded(tuple(inf_where(m) for m in is_c), lay), near

    def to_label(near, centers):
        # position of each node's center gid in ``centers`` (the first one
        # where a center repeats), k where unassigned
        out = []
        for nr, c in zip(near.parts, centers):
            table = torch.full((n + 1,), k, dtype=torch.int64, device=c.device)
            table.scatter_reduce_(0, c, torch.arange(k, device=c.device), "amin")
            out.append(table[nr])
        return _comm.Sharded(tuple(out), lay)

    def assign(centers):
        dist0, near0 = seed_state(centers)
        dist, near, count = halo_relax(data, col, dist0, near0, h, n, False, bf_max_iter)
        sweeps.append(count)
        return dist, to_label(near, centers)

    centers = [seeds.to(d) for d in devs]
    for _ in range(maxiter):
        dist, agg = assign(centers)
        agg_ext = _comm.ring_halo(agg, h, k)
        boundary = []
        for a, ae, c, lv in zip(agg.parts, agg_ext.parts, col.parts, live.parts):
            nbr = _gather_slots(ae, c)
            cross = lv & (nbr != a[..., None]) & (nbr < k)
            boundary.append(cross.any(-1) & (a < k))
        interior, _, count = halo_relax(
            data, col, _comm.Sharded(tuple(inf_where(m) for m in boundary), lay), None, h, n,
            False, bf_max_iter)
        sweeps.append(count)
        vals, seg = [], []
        for a, di, dd in zip(agg.parts, interior.parts, dist.parts):
            v = torch.where(torch.isinf(di), dd, di)
            vals.append(torch.where(a < k, v, torch.full_like(v, float("-inf"))))
            seg.append(a.clamp(max=k - 1))
        # per-cluster argmax with the smallest gid on ties, across shards
        best_loc = [torch.full((v.shape[0], k), float("-inf"), dtype=dtype, device=v.device)
                    .scatter_reduce_(1, s, v, "amax") for v, s in zip(vals, seg)]
        best = _comm.pmax(_comm.Sharded(tuple(best_loc), lay))
        win_loc = []
        for v, s, g, bst in zip(vals, seg, gid.parts, best):
            cand = torch.where(v >= bst[s], g, torch.full_like(g, n))
            win_loc.append(torch.full((v.shape[0], k), n, dtype=torch.int64, device=v.device)
                           .scatter_reduce_(1, s, cand, "amin"))
        winner = _comm.pmin(_comm.Sharded(tuple(win_loc), lay))
        centers = [torch.where(w >= n, c, w) for w, c in zip(winner, centers)]
    _, agg = assign(centers)
    return agg, centers[0]
