"""Connected components by label propagation (counterpart of
``mlamg_tpu/graph/components.py``).

Every node repeatedly takes the smallest label among itself and its
neighbours, both edge directions, until a sweep changes nothing:
O(diameter) sweeps of two ``segment_min``s.  The sweeps run on the
tensors' device; the loop reads one "changed" flag per sweep.  Integer
minima are exact, so the labels equal the JAX package's.
"""

from __future__ import annotations

import torch

from mlamg_torch.ops.segment import segment_min


def _propagate(row: torch.Tensor, col: torch.Tensor, live: torch.Tensor, n: int,
               max_iter: int | None = None) -> torch.Tensor:
    """(n,) labels: the smallest node id of each component of the graph
    of the ``live`` edges row -> col, taken as undirected."""
    r = row.clamp(max=n - 1)
    sentinel = torch.full_like(r, n)
    label = torch.arange(n, dtype=torch.int64, device=row.device)
    for _ in range(n if max_iter is None else max_iter):
        fwd = segment_min(torch.where(live, label[r], sentinel), col, n)
        bwd = segment_min(torch.where(live, label[col], sentinel), r, n)
        new = torch.minimum(label, torch.minimum(fwd, bwd))
        changed = bool((new != label).any())
        label = new
        if not changed:
            break
    return label


def connected_components(C, max_iter: int | None = None) -> torch.Tensor:
    """(n,) component labels (the smallest node id of each component).

    ``C`` is any CSR/COO container; its stored entries are the edges,
    taken as undirected, and padding entries (row == n) are ignored."""
    n = C.shape[0]
    return _propagate(C.row, C.col, C.row < n, n, max_iter)


def num_connected_components(C) -> int:
    """Number of connected components."""
    label = connected_components(C)
    return int((label == torch.arange(C.shape[0], device=label.device)).sum())


def check_aggregates_connected(C, agg_id: torch.Tensor, k: int) -> bool:
    """True iff every aggregate induces a connected subgraph: label
    propagation over the edges inside aggregates gives exactly one
    component per non-empty aggregate (ids outside [0, k) are not
    aggregates)."""
    n = C.shape[0]
    agg_id = agg_id.to(C.row.device).long()
    live = (C.row < n) & (agg_id[C.row.clamp(max=n - 1)] == agg_id[C.col])
    label = _propagate(C.row, C.col, live, n)
    n_comp = int((label == torch.arange(n, device=label.device)).sum())
    present = torch.zeros(k, dtype=torch.int64, device=agg_id.device)
    ok = (agg_id >= 0) & (agg_id < k)
    present[agg_id[ok]] = 1
    return n_comp == int(present.sum())
