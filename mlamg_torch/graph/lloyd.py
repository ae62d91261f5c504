"""Lloyd aggregation (graph k-means), counterpart of
``mlamg_tpu/graph/lloyd.py``.

Alternate (1) assigning every node to its nearest seed by multi-source
Bellman-Ford and (2) moving each seed to the most interior node of its
cluster, the node furthest from the cluster boundary (a second
Bellman-Ford from all boundary nodes).  Every reduction is a min or max
with a min-node-id tie-break, so the aggregates equal JAX's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mlamg_torch.graph.bellman_ford import bellman_ford, nearest_center_to_agg
from mlamg_torch.ops.segment import segment_max, segment_min
from mlamg_torch.utils import prng


def _segment_argmax(values: torch.Tensor, seg: torch.Tensor,
                    node_id: torch.Tensor, k: int) -> torch.Tensor:
    """Per-segment argmax with min-node-id tie-break (>= n for an empty
    segment)."""
    best = segment_max(values, seg, k)
    is_best = values >= best[seg.clamp(max=k - 1)]
    n = node_id.shape[0]
    return segment_min(
        torch.where(is_best, node_id, torch.full_like(node_id, n)), seg, k
    )


def _bf_from_mask(C, source_mask: torch.Tensor, max_iter: int | None = None):
    """Undirected Bellman-Ford distances from ``{i : source_mask[i]}``."""
    n = C.shape[0]
    if max_iter is None:
        max_iter = n
    live = C.row < n
    w = torch.where(live, C.data, torch.full_like(C.data, float("inf")))
    r = C.row.clamp(max=n - 1)
    c = C.col
    zero = torch.zeros((), dtype=C.dtype, device=C.device)
    dist = torch.where(source_mask, zero, zero + float("inf"))
    for _ in range(max_iter):
        fwd = segment_min(dist[r] + w, c, n)
        bwd = segment_min(dist[c] + w, r, n)
        new = torch.minimum(dist, torch.minimum(fwd, bwd))
        changed = bool((new < dist).any())
        dist = new
        if not changed:
            break
    return dist


def lloyd_iteration(C, seeds: torch.Tensor):
    """One Lloyd step: (BF assign, recenter).  Returns (new_seeds, agg_id)."""
    n = C.shape[0]
    k = seeds.shape[0]
    node_id = torch.arange(n, device=C.device)

    dist, nearest = bellman_ford(C, seeds)
    agg_id = nearest_center_to_agg(seeds, nearest)

    # boundary nodes: incident to an inter-cluster edge
    live = C.row < n
    r = C.row.clamp(max=n - 1)
    cross = live & (agg_id[r] != agg_id[C.col])
    drop = torch.full_like(r, n)
    is_boundary = torch.zeros(n + 1, dtype=torch.bool, device=C.device)
    is_boundary[torch.where(cross, r, drop)] = True
    is_boundary[torch.where(cross, C.col, drop)] = True
    is_boundary = is_boundary[:n]

    interior_dist = _bf_from_mask(C, is_boundary)
    # a cluster with no boundary (isolated component) has every distance
    # inf; it falls back to distance-from-seed there
    vals = torch.where(torch.isinf(interior_dist), dist, interior_dist)
    # unassigned nodes (agg_id == k) join segment k-1, as in JAX
    seg = agg_id.clamp(max=k - 1)
    new_seeds = _segment_argmax(vals, seg, node_id, k)
    # clusters that lost all nodes keep their old seed
    new_seeds = torch.where(new_seeds >= n, seeds, new_seeds)
    return new_seeds, agg_id


def _lloyd_core(C, seeds: torch.Tensor, maxiter: int):
    for _ in range(maxiter):
        seeds, _ = lloyd_iteration(C, seeds)
    _, nearest = bellman_ford(C, seeds)
    return nearest_center_to_agg(seeds, nearest), seeds


def lloyd_distance(C, distance: str = "same"):
    """Edge-distance transform of C's stored values: 'unit' 1, 'abs' |c|,
    'inv' 1/|c|, 'same' c, 'sub' c - min(c)."""
    live = C.mask
    zero = torch.zeros((), dtype=C.dtype, device=C.device)
    if distance == "unit":
        data = torch.where(live, zero + 1.0, zero)
    elif distance == "abs":
        data = C.data.abs()
    elif distance == "inv":
        data = torch.where(live, 1.0 / C.data.abs().clamp(min=1e-30), zero)
    elif distance == "same":
        return C
    elif distance == "sub":
        cmin = torch.where(live, C.data, zero + float("inf")).min()
        data = torch.where(live, C.data - cmin, zero)
    else:
        raise ValueError(f"unrecognized distance={distance}")
    return C.with_data(data)


LLOYD_DISTANCES = ("unit", "abs", "inv", "same", "sub")


def lloyd_aggregation(C, ratio: float = 0.03, maxiter: int = 10, seeds=None, key=None,
                      distance: str = "same"):
    """Aggregate nodes by Lloyd clustering on the weighted graph ``C``.

    ``seeds`` gives the initial centers; without it the first
    ``k = ceil(ratio*n)`` of ``permutation(key, n)`` (``key`` defaults to
    ``PRNGKey(0)``), the JAX package's draw bit for bit
    (:mod:`mlamg_torch.utils.prng`).

    Returns (agg_id, roots, seeds): assignment vector, final centers,
    initial seeds.
    """
    C = lloyd_distance(C, distance)
    n = C.shape[0]
    if seeds is None:
        k = int(math.ceil(ratio * n))
        seeds = prng.permutation(prng.PRNGKey(0) if key is None else key, n)[:k]
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.from_numpy(np.asarray(seeds, np.int64))
    seeds = seeds.to(device=C.device, dtype=torch.int64)
    agg_id, roots = _lloyd_core(C, seeds, maxiter)
    return agg_id, roots, seeds
