"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
requests, reduced to the device's busy time, the traced window and the
breakdown.

The requests run twice under the profiler.  The first pass traces the
device alone (tracing the host's operations slows the host and would
inflate the idle share): the window is the host clock's span of the
requests, busy time the union of the device's kernel, copy and set
intervals inside it, and the device operations are summed by name.  The
second pass traces the host's operations too, only to put each idle gap
(window time no device interval covers) down to what the host was doing
at its middle: the innermost host operation there (CUDA runtime calls left
out, so a launch counts to the operation that made it), under the
innermost ``bench.*`` span.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
TOP = 10


def traced(fn) -> dict:
    """Run ``fn()`` twice under the profiler (see module docstring); returns
    ``busy_s``, ``window_s`` and ``breakdown``."""
    device, (w0, w1) = _pass(fn, [ProfilerActivity.CUDA])
    busy, _ = _busy_and_gaps(device, w0, w1)
    device2, window2, host = _pass(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA], host=True)
    _, gaps = _busy_and_gaps(device2, *window2)
    per_op: dict = {}
    for a, b, name in device:
        if b > w0 and a < w1:
            per_op[name] = per_op.get(name, 0) + (min(b, w1) - max(a, w0))
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "breakdown": {"device_ops": _top(per_op), "idle_gaps": _top(_gap_owners(gaps, host))}}


def _pass(fn, activities, host: bool = False):
    """(device intervals, window, [host intervals]) of one traced ``fn()``;
    the window is the host clock's, in the trace's epoch nanoseconds."""
    from torch.autograd import DeviceType

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    if not card:  # the CPU tests: no device to trace
        activities = [ProfilerActivity.CPU]
    sync()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=activities) as prof:
            w0 = time.time_ns()
            with record_function(WINDOW):
                fn()
                sync()
            w1 = time.time_ns()
    device, hosts, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith("bench."):
                device.append((e.start_ns(), e.end_ns(), name))
        elif name == WINDOW:
            window = (e.start_ns(), e.end_ns())
        else:
            hosts.append((e.start_ns(), e.end_ns(), name))
    if card and not device:
        raise RuntimeError("the profiler trace holds no device activity")
    if not host:
        return device, (w0, w1)
    if window is None:
        raise RuntimeError("the profiler trace holds no window annotation")
    return device, window, hosts


def _busy_and_gaps(device, w0: int, w1: int):
    """(busy ns, idle gaps) of the device intervals inside [w0, w1]."""
    spans = sorted((max(a, w0), min(b, w1)) for a, b, _ in device if b > w0 and a < w1)
    busy, gaps, end = 0, [], w0
    for lo, hi in spans:
        if lo > end:
            gaps.append((end, lo))
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps


def _gap_owners(gaps, host) -> dict:
    """Idle ns per host activity (see module docstring)."""
    if not gaps:
        return {}
    g = np.array(gaps, dtype=np.int64)
    mid = (g[:, 0] + g[:, 1]) // 2
    order = np.argsort(mid)
    mid, length = mid[order], (g[:, 1] - g[:, 0])[order]

    def innermost(events):
        best = np.full(mid.shape, np.iinfo(np.int64).max)
        owner = np.full(mid.shape, -1)
        for i, (a, b, _) in enumerate(events):
            lo, hi = np.searchsorted(mid, a, "left"), np.searchsorted(mid, b, "right")
            if lo < hi:
                sel = slice(lo, hi)
                better = (b - a) < best[sel]
                best[sel] = np.where(better, b - a, best[sel])
                owner[sel] = np.where(better, i, owner[sel])
        return owner

    spans = [e for e in host if e[2].startswith("bench.")]
    ops = [e for e in host if not e[2].startswith(("bench.", "cuda"))]
    span_of, op_of = innermost(spans), innermost(ops)
    out: dict = {}
    for s, o, ns in zip(span_of, op_of, length):
        key = (spans[s][2] if s >= 0 else "outside spans") + " / " + (
            ops[o][2] if o >= 0 else "no op (Python)")
        out[key] = out.get(key, 0) + int(ns)
    return out


def _top(ns_by_name: dict) -> list:
    items = sorted(ns_by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:200], ns / 1e9] for name, ns in items]
