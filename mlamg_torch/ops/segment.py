"""Segment reductions with ``jax.ops.segment_*`` semantics.

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
