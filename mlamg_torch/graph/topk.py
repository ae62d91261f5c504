"""Top-k node selection (counterpart of ``mlamg_tpu/graph/topk.py``).

``jax.lax.top_k`` breaks ties by the earliest index; ``torch.topk``
promises no order, so the port takes the first k of a *stable* descending
sort, which keeps equal scores in index order.
"""

from __future__ import annotations

import torch


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of 1-D ``x``, ties to the earlier
    index."""
    return torch.sort(x.reshape(-1), descending=True, stable=True).indices[:k]


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """(n,) vector with 1.0 at the k largest entries of ``x``."""
    x = x.reshape(-1)
    return torch.zeros_like(x).index_fill_(0, topk_indices(x, k), 1.0)


def soft_topk_mask(x: torch.Tensor, k: int, sigma: float = 1.0) -> torch.Tensor:
    """Differentiable top-k: sigmoid((x - t) / sigma), with the threshold t
    the midpoint of the k-th and (k+1)-th largest entries (the smallest
    minus one when k = n), held constant under differentiation."""
    x = x.reshape(-1)
    vals = torch.sort(x.detach(), descending=True, stable=True).values
    t = (vals[k - 1] + vals[k]) / 2.0 if k < x.shape[0] else vals[-1] - 1.0
    return torch.sigmoid((x - t) / sigma)
