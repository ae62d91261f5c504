"""Nested wall-clock section profiler (counterpart of
``mlamg_tpu/utils/profiler.py``) and a device trace.

    Profiler.enabled = True
    with Profiler("generation"):
        ...
    Profiler.print_tree()

Sections are timed on the host clock.  A section around work on the card
measures the work only where that work ends in a synchronisation (a
readback to the host, as every conv factor is).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager


class _Node:
    __slots__ = ("label", "total", "count", "children")

    def __init__(self, label):
        self.label = label
        self.total = 0.0
        self.count = 0
        self.children: dict = {}


class Profiler:
    """Context-manager tree profiler, globally gated by ``Profiler.enabled``."""

    enabled = False
    _root = _Node("root")
    _stack = [_root]

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        if not Profiler.enabled:
            return self
        parent = Profiler._stack[-1]
        node = parent.children.get(self.label)
        if node is None:
            node = _Node(self.label)
            parent.children[self.label] = node
        Profiler._stack.append(node)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not Profiler.enabled:
            return False
        node = Profiler._stack.pop()
        node.total += time.perf_counter() - self._t0
        node.count += 1
        return False

    @classmethod
    def reset(cls):
        cls._root = _Node("root")
        cls._stack = [cls._root]

    @classmethod
    def tree(cls) -> dict:
        """{label: (total s, count, children)} of the sections so far."""
        def rec(node):
            return {c.label: (c.total, c.count, rec(c)) for c in node.children.values()}

        return rec(cls._root)

    @classmethod
    def print_tree(cls, file=None):
        def rec(node, depth):
            for child in node.children.values():
                print(
                    f'{"  " * depth}{child.label}: {child.total * 1e3:.2f} ms'
                    f" (x{child.count})",
                    file=file,
                )
                rec(child, depth + 1)

        rec(cls._root, 0)

    @staticmethod
    @contextmanager
    def device_trace(logdir: str):
        """A ``torch.profiler`` trace of the CPU and (where present) the
        CUDA activity inside the block, written to ``logdir/trace.json``
        (Chrome trace format, viewable in Perfetto)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
