"""The first level of the SA hierarchy's aggregation, worked out again in
plain numpy from the harness's own float32 matrix: reverse Cuthill-McKee
order, strength |a_ij|, stride seeds, Lloyd clustering by Bellman-Ford.

The rules are the hull configuration's (SA, ``lloyd_maxiter`` rounds,
``ceil(alpha n)`` seeds at an even stride of the RCM order):

- RCM: breadth-first from the lowest-degree node (the lowest index among
  equals), each node's unvisited neighbours in ascending degree (index
  order among equals), the whole order reversed; degree counts the row's
  stored entries.
- Bellman-Ford relaxes every edge at once, sweep after sweep, in float32;
  a node takes the smallest center id among the edges that reach its new
  distance.
- A Lloyd round assigns every node to its nearest seed, then moves each
  seed to the node of its cluster furthest from the cluster's boundary
  (a second Bellman-Ford from every node on an edge between clusters),
  the lowest node id among equals; a cluster with no node keeps its seed.
- After the rounds, a last assignment; unreachable nodes become single
  aggregates and empty aggregates are dropped.

Every distance is a float32 sum and every choice a min or a max, so a
sound program and this reference give the same partition.  Aggregates are
compared as partitions of the natural order, whatever their labels.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def rcm(A) -> np.ndarray:
    """perm[k] = the natural index of the k-th node in RCM order."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    deg = np.diff(A.indptr)
    rows = np.repeat(np.arange(n), deg)
    nbrs = A.indices[np.lexsort((A.indices, deg[A.indices], rows))].tolist()
    ptr = A.indptr.tolist()
    starts = np.lexsort((np.arange(n), deg)).tolist()
    visited = bytearray(n)
    order: list = []
    s = 0
    while len(order) < n:
        while visited[starts[s]]:
            s += 1
        root = starts[s]
        visited[root] = 1
        head = len(order)
        order.append(root)
        while head < len(order):
            u = order[head]
            head += 1
            for v in nbrs[ptr[u]:ptr[u + 1]]:
                if not visited[v]:
                    visited[v] = 1
                    order.append(v)
    return np.asarray(order[::-1], np.int64)


class _Graph:
    """C's edges i -> j (weight C[i, j], float32) grouped by their head j
    (``into``) and by their tail i (``out_of``), for segment minima."""

    def __init__(self, C: sp.csr_matrix):
        C = sp.csr_matrix(C, dtype=np.float32)
        C.sort_indices()
        self.n = C.shape[0]
        self.out_of = C
        self.into = C.T.tocsr()
        self.into.sort_indices()
        self.rows = np.repeat(np.arange(self.n), np.diff(C.indptr))

    @staticmethod
    def segmin(M: sp.csr_matrix, values: np.ndarray, empty) -> np.ndarray:
        """Per row of M, the minimum of ``values`` over its stored entries."""
        counts = np.diff(M.indptr)
        out = np.full(M.shape[0], empty, dtype=values.dtype)
        live = counts > 0
        if values.size:
            out[live] = np.minimum.reduceat(values, M.indptr[:-1][live])
        return out


def bellman_ford(g: _Graph, centers: np.ndarray):
    """(distance, nearest center's node id) from ``centers``; inf and n
    where unreachable."""
    n, M = g.n, g.into
    src, w = M.indices, M.data
    head = np.repeat(np.arange(n), np.diff(M.indptr))
    dist = np.full(n, np.inf, np.float32)
    dist[centers] = 0
    near = np.full(n, n, np.int64)
    near[centers] = centers
    for _ in range(n):
        cand = dist[src] + w
        best = g.segmin(M, cand, np.inf)
        improved = best < dist
        new = np.where(improved, best, dist)
        win = (cand <= new[head]) & improved[head]
        near = np.where(improved, g.segmin(M, np.where(win, near[src], n), n), near)
        dist = new
        if not improved.any():
            break
    return dist, near


def bellman_ford_from(g: _Graph, sources: np.ndarray) -> np.ndarray:
    """Undirected distances from every node where ``sources`` is true."""
    dist = np.where(sources, np.float32(0), np.float32(np.inf)).astype(np.float32)
    for _ in range(g.n):
        fwd = g.segmin(g.into, dist[g.into.indices] + g.into.data, np.inf)
        bwd = g.segmin(g.out_of, dist[g.out_of.indices] + g.out_of.data, np.inf)
        new = np.minimum(dist, np.minimum(fwd, bwd))
        changed = (new < dist).any()
        dist = new
        if not changed:
            break
    return dist


def _labels(centers: np.ndarray, near: np.ndarray, n: int) -> np.ndarray:
    k = centers.shape[0]
    inv = np.full(n + 1, k, np.int64)
    inv[centers] = np.arange(k)
    return inv[np.minimum(near, n)]


def lloyd(g: _Graph, seeds: np.ndarray, rounds: int) -> np.ndarray:
    """Aggregate ids after ``rounds`` Lloyd rounds and a last assignment
    (k = len(seeds) for an unreachable node)."""
    n, k = g.n, seeds.shape[0]
    C = g.out_of
    for _ in range(rounds):
        dist, near = bellman_ford(g, seeds)
        agg = _labels(seeds, near, n)
        cross = agg[g.rows] != agg[C.indices]
        boundary = np.zeros(n, bool)
        boundary[g.rows[cross]] = True
        boundary[C.indices[cross]] = True
        inner = bellman_ford_from(g, boundary)
        vals = np.where(np.isinf(inner), dist, inner)
        seg = np.minimum(agg, k - 1)
        best = np.full(k, -np.inf, np.float32)
        np.maximum.at(best, seg, vals)
        first = np.full(k, n, np.int64)
        is_best = vals >= best[seg]
        np.minimum.at(first, seg[is_best], np.arange(n)[is_best])
        seeds = np.where(first >= n, seeds, first)
    _, near = bellman_ford(g, seeds)
    return _labels(seeds, near, n)


def aggregate(A32: sp.csr_matrix, alpha: float, rounds: int):
    """(perm, agg, k): the RCM order, each RCM position's aggregate id in
    [0, k), and k, for the float32 matrix ``A32``."""
    perm = rcm(A32)
    A0 = sp.csr_matrix(A32, dtype=np.float32)[perm][:, perm].tocsr()
    n = A0.shape[0]
    k = int(np.ceil(alpha * n))
    seeds = np.unique(np.linspace(0, n - 1, k).round().astype(np.int64))
    C = abs(A0)
    agg = lloyd(_Graph(C), seeds, rounds)
    k = seeds.shape[0]
    lone = agg >= k
    agg[lone] = k + np.arange(int(lone.sum()))
    used, agg = np.unique(agg, return_inverse=True)
    return perm, agg.astype(np.int64), int(used.shape[0])


def nodes_apart(mine: np.ndarray, ref: np.ndarray) -> int:
    """The nodes whose aggregate, as a set of nodes, is not one of the
    reference's: the two label arrays compared as partitions, whatever
    their labels."""
    pairs = np.unique(np.stack([np.asarray(ref, np.int64), np.asarray(mine, np.int64)]), axis=1)
    ref_to = np.bincount(pairs[0])  # how many of mine each reference aggregate meets
    mine_to = np.bincount(pairs[1])
    same = (ref_to[ref] == 1) & (mine_to[mine] == 1)
    return int(mine.shape[0] - same.sum())
