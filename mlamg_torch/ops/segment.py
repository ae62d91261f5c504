"""Segment reductions with ``jax.ops.segment_*`` semantics, and
:func:`tree_sum`, a sum in the JAX package's CPU order.

Ids >= ``num_segments`` are dropped (the padding sentinel convention), and
an empty segment holds the reduction's identity: +inf / -inf for floats,
the dtype's max / min for integers.  min and max are order-free, so these
give bit-identical results to JAX on the same inputs.
"""

from __future__ import annotations

import torch


def _identity(dtype: torch.dtype, reduce: str):
    if dtype.is_floating_point:
        return float("inf") if reduce == "amin" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "amin" else info.min


def _segment_reduce(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                    reduce: str) -> torch.Tensor:
    out = torch.full((num_segments + 1,), _identity(data.dtype, reduce),
                     dtype=data.dtype, device=data.device)
    out.scatter_reduce_(0, ids.clamp(max=num_segments), data, reduce=reduce,
                        include_self=True)
    return out[:num_segments]


def segment_min(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    return _segment_reduce(data, ids, num_segments, "amin")


def segment_max(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    return _segment_reduce(data, ids, num_segments, "amax")


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    out = torch.zeros(num_segments + 1, dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids.clamp(max=num_segments), data)[:num_segments]


def ordered_sum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """x summed over ``dim`` left to right, one elementwise add per slice:
    the same bits on the card as on the CPU, where a library reduction
    picks its own order."""
    parts = torch.unbind(x, dim)
    if not parts:
        return x.sum(dim)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 (kept, size 1) in the order the JAX package's CPU
    backend adds a long axis: zero-pad it evenly at both ends to a multiple
    of 32, add each window of 32 in order, repeat while more than 32 partial
    sums remain, then add those in order (:func:`ordered_sum` throughout)."""
    while x.shape[0] > 32:
        n = x.shape[0]
        pad = -(-n // 32) * 32 - n
        zeros = x.new_zeros((1,) + tuple(x.shape[1:]))
        x = torch.cat([zeros.expand(pad // 2, *x.shape[1:]), x,
                       zeros.expand(pad - pad // 2, *x.shape[1:])])
        x = ordered_sum(x.view(-1, 32, *x.shape[1:]), 1)
    return ordered_sum(x, 0)[None]
