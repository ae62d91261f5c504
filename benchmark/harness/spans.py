"""The program's own spans (``mlamg_torch/utils/profiler.py``), read by the
per-layer metrics of the cycle and the setup: ``launches_per_cycle``,
``idle_fine_ms.cycle``, ``idle_coarse_ms.cycle``, ``galerkin_ms.request``
and ``galerkin_s.setup``.

It runs once per ``--trace 1`` run, after the harness's traced passes and
every per-layer reader listed before these, and caches what it read on the
``Run``:

- pass A, the recorder on and no ``torch.profiler``: builds of the
  operator at scale 1, three where the mix builds a hierarchy per request
  and one where set-up builds the only one; each build's fenced
  ``galerkin`` spans are summed.  Where the system holds a dataset (see
  ``core.py``), the three builds are of the first three items of the
  order drawn from a fixed seed.  A build without a root ``build`` span
  makes pass A read nothing.
- pass B, on the card only, the recorder on under a device-only profiler
  pass (``trace.py``'s first): three solves of b = A x, x standard normal
  from fixed seeds, to the configurations' 1e-6 ||b||, on the run's
  hierarchy, or on pass A's last build where the mix builds per request
  (x sized to that build's item).
  The program's spans and the device's intervals share one clock, so each
  idle gap (window time no device interval covers) goes to the innermost
  program span at its middle, as ``trace.py`` puts gaps down to host
  operations.  A gap under a ``level`` span of level 0 and no deeper one
  is the fine levels'; under a deeper ``level`` or a ``coarse_solve``, the
  coarse levels'; anywhere else, outside the cycle.

Each pass starts with a garbage collection: the harness's traced passes
leave their events behind, and a full collection inside a pass (0.1-0.7 s
on the host of an H100 machine) would read as the program's time.  A
program without the recorder (no ``Profiler.spans``) reads nothing.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import core
from harness import trace as tracing

BUILDS_PER_REQUEST = 3  # pass A's builds where the mix builds per request
SOLVES = 3  # pass B's solves
TOL = 1e-6  # every configuration's request.tol
SEED = 15  # the first solve's x; the others follow


def read(run) -> dict:
    """The readings of both passes, computed on the first call."""
    found = getattr(run, "program_spans", None)
    if found is None:
        found = run.program_spans = _read(run)
    return found


def _read(run) -> dict:
    from mlamg_torch.utils import profiler

    Profiler = profiler.Profiler
    if not hasattr(Profiler, "spans"):
        return {}
    was = Profiler.enabled
    Profiler.enabled = True
    try:
        per_request = run.hierarchy_s is None
        builds, h, item = _pass_a(run, Profiler, BUILDS_PER_REQUEST if per_request else 1)
        out = {}
        if builds:
            galerkin = [b["galerkin_s"] for b in builds]
            out["builds"] = builds
            if per_request:
                out["galerkin_ms.request"] = 1e3 * sum(galerkin) / len(galerkin)
            else:
                out["galerkin_s.setup"] = galerkin[0]
        if not per_request:
            h = run.hierarchy
        if run.device.type == "cuda":
            out.update(_pass_b(run, Profiler, profiler.LAUNCHES, h, item))
        return out
    finally:
        Profiler.enabled = was
        Profiler.reset()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pass_a(run, Profiler, count: int):
    """Per build: its host time (ended by a synchronise), its fenced
    ``build`` span, the share of it its child spans cover, and its
    ``galerkin`` spans' sum.  Returns them (none where a build has no root
    ``build`` span), the last build and its item (None without items)."""
    system = run.system
    items = getattr(system, "items", None)
    if items is None:
        A, order = system.operator(1.0), [None] * count
    else:
        order = core.item_order(SEED, core.TRACED, 0, items)
        order = [int(order[i % items]) for i in range(count)]
    builds, h, readable = [], None, True
    for item in order:
        if item is not None:
            A = system.operator(1.0, item)
        h = None  # the last build freed before the next
        Profiler.reset()
        gc.collect()
        _sync(run.device)
        t0 = time.perf_counter()
        h = system.build(A)
        _sync(run.device)
        host_s = time.perf_counter() - t0
        spans = Profiler.spans()
        root = next((s for s in spans if s.name == "build" and s.parent is None), None)
        if root is None:
            readable = False
            continue
        children = sum(s.duration_s for s in spans if s.parent is root)
        builds.append({"host_s": host_s, "build_s": root.duration_s,
                       "covered": children / root.duration_s,
                       "galerkin_s": sum(s.duration_s for s in spans if s.name == "galerkin")})
    return builds if readable else [], h, order[-1]


def _pass_b(run, Profiler, launches, h, item) -> dict:
    """Launches and idle gaps per cycle from ``SOLVES`` traced solves on
    ``h``, the hierarchy of ``item`` (None without items)."""
    system, dev = run.system, run.device
    rhs = []
    for i in range(SOLVES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + i)
        x = torch.randn(core.rows(system, item), generator=gen, device=dev)
        b = system.rhs(x, 1.0, *core.item_args(item))
        rhs.append((b, TOL * float(torch.linalg.vector_norm(b))))
    ends = []
    counted = dict(launches)

    def solves():
        for b, tol in rhs:
            system.solve(h, b, tol)
            _sync(dev)
            ends.append(time.time_ns())

    Profiler.reset()
    gc.collect()
    device, (w0, w1) = tracing._pass(solves, [torch.profiler.ProfilerActivity.CUDA])
    spans = list(Profiler.spans())
    kernels = {k: launches[k] - counted.get(k, 0) for k in ("dia_spmv", "well_spmv")}
    return reduce_pass_b(spans, device, w0, w1, ends, kernels)


def reduce_pass_b(spans, device, w0: int, w1: int, ends, kernels: dict) -> dict:
    """The cycle metrics from pass B's spans, device intervals ``(start_ns,
    end_ns, name)``, window, solve ends and counted kernel launches."""
    cycles = [s for s in spans if s.name == "cycle"]
    if not cycles:
        return {}
    starts = np.array(sorted(a for a, _, _ in device), dtype=np.int64)
    ops, first = 0, 0
    for end in ends:
        # the device operations from the solve's first cycle to its end
        c0 = next(c.start_ns for c in cycles if first <= c.start_ns <= end)
        ops += int(np.searchsorted(starts, end, "right") - np.searchsorted(starts, c0, "left"))
        first = end
    # the hand-written kernels in the whole pass, to hold against the counter
    traced = {k: sum(k in name for _, _, name in device) for k in kernels}
    busy, gaps = tracing._busy_and_gaps(device, w0, w1)
    idle = _idle_by_place(spans, gaps)
    n = len(cycles)
    return {"launches_per_cycle": ops / n,
            "idle_fine_ms.cycle": idle["fine"] / 1e6 / n,
            "idle_coarse_ms.cycle": idle["coarse"] / 1e6 / n,
            "cycles": n, "idle_outside_ms": idle["outside"] / 1e6,
            "idle_ms": sum(idle.values()) / 1e6, "window_ms": (w1 - w0) / 1e6,
            "idle_share": 1.0 - busy / (w1 - w0),
            "kernels_traced": traced, "kernels_counted": kernels}


def _place(span, memo: dict) -> str:
    """``fine``, ``coarse`` or ``outside``: where a gap under ``span`` (its
    innermost program span) falls."""
    key = id(span)
    if key not in memo:
        if span.name == "coarse_solve":
            memo[key] = "coarse"
        elif span.name == "level":
            memo[key] = "fine" if span.attrs.get("level") == 0 else "coarse"
        elif span.parent is None:
            memo[key] = "outside"
        else:
            memo[key] = _place(span.parent, memo)
    return memo[key]


def _idle_by_place(spans, gaps) -> dict:
    """Idle ns of ``gaps`` by the place of the innermost span at each gap's
    middle."""
    out = {"fine": 0, "coarse": 0, "outside": 0}
    if not gaps:
        return out
    g = np.array(gaps, dtype=np.int64)
    mid = (g[:, 0] + g[:, 1]) // 2
    order = np.argsort(mid)
    mid, length = mid[order], (g[:, 1] - g[:, 0])[order]
    best = np.full(mid.shape, np.iinfo(np.int64).max)
    owner = np.full(mid.shape, -1)
    closed = [s for s in spans if s.end_ns is not None]
    for i, s in enumerate(closed):
        lo, hi = np.searchsorted(mid, s.start_ns, "left"), np.searchsorted(mid, s.end_ns, "right")
        if lo < hi:
            sel = slice(lo, hi)
            # on a tie the later span, opened inside the other, is innermost
            better = (s.end_ns - s.start_ns) <= best[sel]
            best[sel] = np.where(better, s.end_ns - s.start_ns, best[sel])
            owner[sel] = np.where(better, i, owner[sel])
    memo: dict = {}
    for o, ns in zip(owner, length):
        out["outside" if o < 0 else _place(closed[o], memo)] += int(ns)
    return out
