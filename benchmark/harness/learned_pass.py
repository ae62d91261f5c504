"""The learned build's own spans and counters (``mlamg_torch/utils/
profiler.py``), read by ``gnn_ms.build``, ``bellman_ford_ms.build``,
``launches_per_build`` and ``host_syncs.request``.

It runs once per ``--trace 1`` run of a system that holds a dataset,
after the harness's traced passes, and caches what it read on the
``Run``.  Its items are the first three of the order drawn from a fixed
seed on the traced stream (``core.item_order``), each built at scale 1
and solved for b = A x, x standard normal from a fixed seed, to 1e-6 ||b||:

- pass S, the recorder on and no ``torch.profiler``: the three builds
  and solves; per build, its fenced ``aggnet``, ``cnet`` and ``pnet``
  spans summed (the GNNs) and its ``bellman_ford`` spans summed, and the
  stages under its root ``build`` span; ``SYNCS`` counted over the three
  builds and three solves.  A build without a root ``build`` span, or a
  program without ``SYNCS``, makes it read nothing.
- pass D, on the card only, the recorder off: the three builds under a
  device-only profiler pass (``trace.py``'s first); per build, the device
  operations that start between its start and the synchronise that ends
  it.

Each pass starts with a garbage collection, as ``spans.py``'s do.
"""

from __future__ import annotations

import gc
import time

import torch

from harness import core
from harness import trace as tracing

BUILDS = 3
TOL = 1e-6
SEED = 15
GNN = ("aggnet", "cnet", "pnet")


def read(run) -> dict:
    """The readings of both passes, computed on the first call."""
    found = getattr(run, "learned_pass", None)
    if found is None:
        found = run.learned_pass = _read(run)
    return found


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read(run) -> dict:
    from mlamg_torch.utils import profiler

    system = run.system
    items = getattr(system, "items", None)
    if items is None or not hasattr(profiler.Profiler, "spans") or not hasattr(profiler, "SYNCS"):
        return {}
    order = core.item_order(SEED, core.TRACED, 0, items)
    order = [int(order[i % items]) for i in range(BUILDS)]
    Profiler = profiler.Profiler
    was = Profiler.enabled
    Profiler.enabled = True
    try:
        out = _pass_s(run, Profiler, profiler.SYNCS, order)
    finally:
        Profiler.enabled = was
        Profiler.reset()
    if out and run.device.type == "cuda":
        out["launches_per_build"] = _pass_d(run, order)
    return out


def _rhs(system, item, device, i: int):
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + i)
    b = system.rhs(torch.randn(system.n_of(item), generator=gen, device=device), 1.0, item)
    return b, TOL * float(torch.linalg.vector_norm(b))


def _pass_s(run, Profiler, syncs, order) -> dict:
    system, dev = run.system, run.device
    gnn, bf, stages = [], [], {}
    rhs = [_rhs(system, item, dev, i) for i, item in enumerate(order)]
    ops = [system.operator(1.0, item) for item in order]
    Profiler.reset()
    gc.collect()
    _sync(dev)
    counted = dict(syncs)
    for (b, tol), A in zip(rhs, ops):
        Profiler.reset()
        h = system.build(A)
        spans = list(Profiler.spans())
        root = next((s for s in spans if s.name == "build" and s.parent is None), None)
        if root is None:
            return {}
        gnn.append(sum(s.duration_s for s in spans if s.name in GNN))
        bf.append(sum(s.duration_s for s in spans if s.name == "bellman_ford"))
        for s in spans:
            if s.parent is root:
                stages[s.name] = stages.get(s.name, 0.0) + s.duration_s
        stages["build"] = stages.get("build", 0.0) + root.duration_s
        system.solve(h, b, tol)
        _sync(dev)
    reads = {k: v - counted.get(k, 0) for k, v in syncs.items() if v != counted.get(k, 0)}
    n = len(order)
    return {"gnn_ms.build": 1e3 * sum(gnn) / n, "bellman_ford_ms.build": 1e3 * sum(bf) / n,
            "host_syncs.request": sum(reads.values()) / n, "syncs": reads,
            "stages_ms": {k: 1e3 * v / n for k, v in stages.items()}, "items": order}


def _pass_d(run, order) -> float:
    system, dev = run.system, run.device
    ops = [system.operator(1.0, item) for item in order]
    marks = []

    def builds():
        for A in ops:
            _sync(dev)
            t0 = time.time_ns()
            system.build(A)
            _sync(dev)
            marks.append((t0, time.time_ns()))

    gc.collect()
    device, _ = tracing._pass(builds, [torch.profiler.ProfilerActivity.CUDA])
    counts = [sum(t0 <= a <= t1 for a, _, _ in device) for t0, t1 in marks]
    return sum(counts) / len(counts)
