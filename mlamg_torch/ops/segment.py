"""Segment reductions with ``jax.ops.segment_*`` semantics, and the sums
in the JAX package's CPU order: :func:`ordered_sum`, :func:`slot_sum` and
:func:`tree_sum`.

Ids >= ``num_segments`` are dropped (the padding sentinel convention), and
an empty segment holds the reduction's identity: +inf / -inf for floats,
the dtype's max / min for integers.  min and max are order-free, so these
give bit-identical results to JAX on the same inputs.

:func:`ordered_sum` and :func:`slot_sum` add left to right, one slice at a
time.  On a CUDA tensor each is one launch of the hand-written kernel
``ops/csrc/ordered_sum.cu`` (built at its first launch, counted in
``LAUNCHES["ordered_sum"]``), which gives the bits of the chain of adds
that :func:`ordered_sum_reference` and :func:`slot_sum_reference`, their
plain versions, run on any other device.  Under autograd the backward is
plain torch: each entry feeds exactly one chain, so its gradient is the
output's, broadcast or gathered.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mlamg_torch.ops import _build

# Most output dimensions a launch takes once neighbours are merged (must
# equal ORDERED_SUM_MAX_DIMS in ops/csrc/ordered_sum.cu).
MAX_DIMS = 8


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


def ordered_sum_reference(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Plain PyTorch :func:`ordered_sum`: one elementwise add per slice."""
    parts = torch.unbind(x, dim)
    if not parts:
        return x.sum(dim)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def slot_sum_reference(values: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`slot_sum`: gather behind a zero pad row, then
    :func:`ordered_sum_reference` over the slots."""
    pad = values.new_zeros((1,) + tuple(values.shape[1:]))
    return ordered_sum_reference(torch.cat([values, pad])[slots], 1)


def ordered_sum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """x summed over ``dim`` left to right, one elementwise add per slice:
    the same bits on the card as on the CPU, where a library reduction
    picks its own order.  A zero-length axis gives ``x.sum(dim)``."""
    if not x.is_cuda:
        return ordered_sum_reference(x, dim)
    dim = dim % x.ndim
    if x.shape[dim] == 0:
        return x.sum(dim)
    if x.requires_grad and torch.is_grad_enabled():
        return _OrderedSum.apply(x, dim)
    return _ordered_sum_cuda(x, dim)


def slot_sum(values: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_s values[slots[i, s]], added in slot order; a slot equal
    to ``len(values)`` adds +0.0 (``segment_slots``' empty slots)."""
    if not values.is_cuda:
        return slot_sum_reference(values, slots)
    if slots.shape[1] == 0:
        return values.new_zeros((slots.shape[0],) + tuple(values.shape[1:]))
    if values.requires_grad and torch.is_grad_enabled():
        return _SlotSum.apply(values, slots)
    return _slot_sum_cuda(values, slots)


class _OrderedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.shape = dim, x.shape
        return _ordered_sum_cuda(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.unsqueeze(ctx.dim).expand(ctx.shape), None


class _SlotSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, slots):
        ctx.save_for_backward(slots)
        ctx.E = values.shape[0]
        return _slot_sum_cuda(values, slots)

    @staticmethod
    def backward(ctx, grad):
        # what the plain version's gather gives back: each slot's gradient
        # accumulated into a zeroed copy of the padded values
        (slots,) = ctx.saved_tensors
        inner = tuple(grad.shape[1:])
        out = grad.new_zeros((ctx.E + 1,) + inner)
        out.index_put_((slots,), grad.unsqueeze(1).expand(tuple(slots.shape) + inner),
                       accumulate=True)
        return out[:ctx.E], None


def _geometry(sizes, strides) -> list:
    """The kernel's geometry of dimensions ``sizes`` read at ``strides``:
    [nd, sizes..., strides...] with size-1 dimensions dropped and each
    dimension merged into the one before it where that one steps over it
    exactly."""
    size, stride = [], []
    for n, s in zip(sizes, strides):
        if n == 1:
            continue
        if size and stride[-1] == n * s:
            size[-1] *= n
            stride[-1] = s
        else:
            size.append(n)
            stride.append(s)
    if len(size) > MAX_DIMS:
        raise ValueError(f"ordered_sum: the CUDA kernel takes at most {MAX_DIMS} output "
                         f"dimensions that do not merge, got {len(size)}")
    return [len(size), *size, *stride]


def _host_array(values) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*values)


# A plan depends only on shapes and strides, which the paths repeat, so
# each is built once: building one took 4-8 us of host, a fifth of the
# wrapper's time a call, on an H100 machine.
@functools.lru_cache(maxsize=4096)
def _ordered_plan(shape: torch.Size, strides: tuple, dim: int):
    """(output shape, the kernel's plan as a host array) of a sum over
    ``dim`` of a tensor of ``shape`` read at ``strides``."""
    out_shape = shape[:dim] + shape[dim + 1:]
    return out_shape, _host_array([out_shape.numel(), shape[dim], strides[dim],
                                   *_geometry(out_shape, strides[:dim] + strides[dim + 1:])])


@functools.lru_cache(maxsize=4096)
def _slot_plan(shape: torch.Size, strides: tuple, slots_shape: torch.Size,
               slots_strides: tuple):
    """(output shape, plan) of a slot sum of values of ``shape`` and
    ``strides`` over slots of ``slots_shape`` and ``slots_strides``."""
    m, w = slots_shape
    inner = shape[1:]
    return (m,) + inner, _host_array([m, inner.numel(), shape[0], strides[0], w,
                                      *slots_strides, *_geometry(inner, strides[1:])])


def _double(t: torch.Tensor) -> int:
    """The kernel's dtype flag of ``t``: 0 float32, 1 float64; raises for
    any other dtype."""
    if t.dtype is torch.float32:
        return 0
    if t.dtype is torch.float64:
        return 1
    raise ValueError(f"ordered_sum: the CUDA kernel takes float32 or float64, got {t.dtype}")


def _ordered_sum_cuda(x: torch.Tensor, dim: int) -> torch.Tensor:
    out_shape, plan = _ordered_plan(x.shape, x.stride(), dim)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if plan[0]:
        _build.launch("ordered_sum", "ordered_sum", x, _double(x), x.data_ptr(),
                      out.data_ptr(), plan)
    return out


def _slot_sum_cuda(values: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    if slots.ndim != 2 or slots.dtype != torch.int64 or slots.device != values.device:
        raise ValueError(f"slot_sum: slots must be a 2-D int64 tensor on {values.device}, "
                         f"got {slots.ndim}-D {slots.dtype} on {slots.device}")
    out_shape, plan = _slot_plan(values.shape, values.stride(), slots.shape, slots.stride())
    out = torch.empty(out_shape, dtype=values.dtype, device=values.device)
    if out.numel():
        _build.launch("ordered_sum", "slot_sum", values, _double(values), values.data_ptr(),
                      slots.data_ptr(), out.data_ptr(), plan)
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
