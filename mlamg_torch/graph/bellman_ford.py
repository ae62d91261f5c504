"""Multi-source Bellman-Ford as iterated edge relaxation.

Counterpart of ``mlamg_tpu/graph/bellman_ford.py`` :func:`bellman_ford`
(push form), :func:`bellman_ford_pull`, :func:`nearest_center_to_agg` and
the assignment matrices :func:`agg_matrix_dense` and :func:`agg_matrix_csr`.
Each sweep relaxes every edge at once and runs until no distance changes
(or ``max_iter``); ties go to the smallest propagating center id.  Every
reduction is a min, which is order-free, so the result equals JAX's bit
for bit.  The host waits for the device (``SYNCS``, ``utils/profiler.py``)
at each sweep's test for change (``bellman_ford.sweep``) and at the pull
form's degree check (``bellman_ford.width``).
"""

from __future__ import annotations

import torch

from mlamg_torch.ops.segment import segment_min
from mlamg_torch.ops.sparse import COO, CSR
from mlamg_torch.utils.profiler import SYNCS


def bellman_ford(C, centers: torch.Tensor, max_iter: int | None = None):
    """Distances + nearest-center assignment from ``centers``.

    ``C`` is a CSR with non-negative weights; entry (i, j) is an edge
    i -> j.  Returns ``distance`` (n,) (inf where unreachable) and
    ``nearest`` (n,) int64 center id (n where unreachable).
    """
    n = C.shape[0]
    if max_iter is None:
        max_iter = n
    row, col = C.row, C.col
    live = row < n
    # padded entries (col 0) get +inf weight so they never relax node 0
    w = torch.where(live, C.data, torch.full_like(C.data, float("inf")))
    rsafe = row.clamp(max=n - 1)
    centers = centers.to(device=C.device, dtype=torch.int64)

    dist = torch.full((n,), float("inf"), dtype=C.dtype, device=C.device)
    dist.index_fill_(0, centers, 0.0)
    near = torch.full((n,), n, dtype=torch.int64, device=C.device)
    near[centers] = centers
    sentinel = torch.full_like(col, n)

    for _ in range(max_iter):
        cand = dist[rsafe] + w
        best = segment_min(cand, col, n)
        improved = best < dist
        new_dist = torch.where(improved, best, dist)
        # winner edges: those achieving the new minimum at an improved node
        win = live & (cand <= new_dist[col]) & improved[col]
        near_cand = segment_min(torch.where(win, near[rsafe], sentinel), col, n)
        near = torch.where(improved, near_cand, near)
        dist = new_dist
        SYNCS["bellman_ford.sweep"] += 1
        if not bool(improved.any()):
            break
    return dist, near


def _transpose_data_order(C) -> torch.Tensor:
    """Permutation p with ``C.data[p]`` = the transpose's values laid out on
    C's own (row, col) structure, for a C whose *pattern* is symmetric:
    a stable sort by (col, row), padding last."""
    n = C.shape[0]
    live = C.row < n
    ck = torch.where(live, C.col, torch.full_like(C.col, n))
    rk = torch.where(live, C.row, torch.full_like(C.row, n))
    return torch.sort(ck * (n + 1) + rk, stable=True).indices


def bellman_ford_pull(C, centers: torch.Tensor, *, width: int, max_iter: int | None = None):
    """Gather-only Bellman-Ford, the same contract as :func:`bellman_ford`
    for a C with a symmetric pattern (directed values).

    Each sweep pulls over the transposed weights laid out in ELL,
    ``dist_j = min_s dist[col[j, s]] + w^T[j, s]``: two (n, width) gathers
    and a row-min.  Empty slots hold the column sentinel n (which reads an
    appended +inf) and weight +inf, so they never relax anything.
    ``width`` bounds the row degree; a smaller one raises.
    """
    n = C.shape[0]
    if max_iter is None:
        max_iter = n
    live = C.row < n
    deg = torch.zeros(n + 1, dtype=torch.int64, device=C.device)
    deg.index_add_(0, C.row.clamp(max=n), torch.ones_like(C.row))  # padding to slot n
    SYNCS["bellman_ford.width"] += 1
    longest = int(deg[:n].max())
    if longest > width:
        raise ValueError(
            f"bellman_ford_pull: width={width} is smaller than the max row "
            f"degree {longest}; recompute width with dataset_bf_width"
        )
    data_t = C.data[_transpose_data_order(C)]
    rsafe = C.row.clamp(max=n - 1)
    within = torch.arange(C.row.shape[0], device=C.device) - C.indptr[rsafe]
    slot = torch.where(live & (within < width), rsafe * width + within,
                       torch.full_like(rsafe, n * width))
    sentinel = torch.full_like(C.col, n)
    colE = (torch.full((n * width + 1,), n, dtype=torch.int64, device=C.device)
            .scatter_(0, slot, torch.where(live, C.col, sentinel))[:-1].view(n, width))
    inf = torch.full_like(data_t, float("inf"))
    wE = (torch.full((n * width + 1,), float("inf"), dtype=C.dtype, device=C.device)
          .scatter_(0, slot, torch.where(live, data_t, inf))[:-1].view(n, width))

    centers = centers.to(device=C.device, dtype=torch.int64)
    dist = torch.full((n + 1,), float("inf"), dtype=C.dtype, device=C.device)
    dist.index_fill_(0, centers, 0.0)
    near = torch.full((n + 1,), n, dtype=torch.int64, device=C.device)
    near[centers] = centers
    for _ in range(max_iter):
        cand = dist[colE] + wE  # (n, width); slot n of dist stays +inf
        best = cand.min(1).values
        improved = best < dist[:n]
        new_dist = torch.where(improved, best, dist[:n])
        near_cand = torch.where(cand <= new_dist[:, None], near[colE],
                                torch.full_like(colE, n)).min(1).values
        near[:n] = torch.where(improved, near_cand, near[:n])
        dist[:n] = new_dist
        SYNCS["bellman_ford.sweep"] += 1
        if not bool(improved.any()):
            break
    return dist[:n], near[:n]


def nearest_center_to_agg(centers: torch.Tensor, nearest: torch.Tensor):
    """``agg_id[i] = j`` with ``centers[j] == nearest[i]`` (k where
    ``nearest[i]`` is the unreachable sentinel n)."""
    n = nearest.shape[0]
    k = centers.shape[0]
    inv = torch.full((n + 1,), k, dtype=torch.int64, device=nearest.device)
    inv[centers.to(torch.int64)] = torch.arange(k, device=nearest.device)
    return inv[nearest.clamp(max=n)]


def agg_matrix_dense(agg_id: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) one-hot aggregate assignment, float32 (a row of zeros where
    ``agg_id`` is k, unassigned)."""
    return (agg_id[:, None] == torch.arange(k, device=agg_id.device)).to(torch.float32)


def agg_matrix_csr(agg_id: torch.Tensor, k: int) -> CSR:
    """(n, k) aggregate assignment as a CSR with one slot per row (a
    padding slot where ``agg_id`` is k, unassigned)."""
    n = agg_id.shape[0]
    assigned = agg_id < k
    row = torch.where(assigned, torch.arange(n, device=agg_id.device), n)
    col = torch.where(assigned, agg_id.to(torch.int64), 0)
    data = assigned.to(torch.float32)
    return COO(data, row, col, (n, k), n).sort_rows()
