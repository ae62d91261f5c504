"""Multi-source Bellman-Ford as iterated edge relaxation (push form).

Counterpart of ``mlamg_tpu/graph/bellman_ford.py`` :func:`bellman_ford`
and :func:`nearest_center_to_agg`.  Each sweep relaxes every edge at once
with a segment-min over targets and runs until no distance changes (or
``max_iter``); ties go to the smallest propagating center id.  Both
reductions are order-free, so the result equals JAX's bit for bit.
"""

from __future__ import annotations

import torch

from mlamg_torch.ops.segment import segment_min


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
    dist[centers] = 0.0
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
        if not bool(improved.any()):
            break
    return dist, near


def nearest_center_to_agg(centers: torch.Tensor, nearest: torch.Tensor):
    """``agg_id[i] = j`` with ``centers[j] == nearest[i]`` (k where
    ``nearest[i]`` is the unreachable sentinel n)."""
    n = nearest.shape[0]
    k = centers.shape[0]
    inv = torch.full((n + 1,), k, dtype=torch.int64, device=nearest.device)
    inv[centers.to(torch.int64)] = torch.arange(k, device=nearest.device)
    return inv[nearest.clamp(max=n)]
