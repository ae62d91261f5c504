"""The port's tracing: spans and counters (counterpart of
``mlamg_tpu/utils/profiler.py``, which keeps a tree of host-clock sections).

    Profiler.enabled = True
    with Profiler("generation"):
        with Profiler("level", level=0):
            ...
    Profiler.spans()        # the recorded spans, in the order they opened
    Profiler.print_tree()   # total and count per section, nested

**Spans.**  ``Profiler(name, fence=False, **attrs)`` is a context manager.
While ``Profiler.enabled`` is false it returns one shared no-op object:
the cost is one check of the flag.  While it is true, it returns a
:class:`Span` that records its name, its attributes, its start and end
from ``time.time_ns()`` (the clock of ``torch.profiler``'s event
timestamps), its parent (the innermost span open when it opened) and a
trace id shared by every span under one root.  ``fence=True`` synchronises
the CUDA device (where CUDA is initialised) before the end is stamped, so
the span's duration holds the device work it launched; the port fences
its build stages and never its cycles.

While recording *and* a ``torch.profiler`` session is active, each span is
also a RecordFunction range of the same name (``record_function`` below),
so the spans appear in the session's timeline (``export_chrome_trace``,
Perfetto).  Recording off emits no range at all.

Recorded spans stay in memory, at most ``MAX_SPANS`` of them; past that a
span is still timed but not stored, and ``Profiler.dropped`` counts it.
``Profiler.reset()`` clears the store.  The recorder is for one thread.

**Counters.**  ``LAUNCHES`` counts the launches of the hand-written CUDA
kernels by name; the kernels' wrappers count into it whether recording is
on or off; a CUDA graph's capture counts none, and each replay adds the
launches of the kernels it holds.
``GRAPHS`` counts the cycles of ``uvcycle_solve`` by how each ran:
``uvcycle.eager``, ``uvcycle.capture`` (captured as a CUDA graph, then
replayed once) or ``uvcycle.replay``; it too counts always.
``SYNCS`` counts where the learned two-level path makes the host wait for
the device (a value read back or a host array copied in), by site:
``coloring`` (the pattern read, the colours copied over),
``segment_slots`` (a slot table's longest segment), ``bellman_ford.width``
and ``bellman_ford.sweep`` (the pull form's degree check, each sweep's
test for change), ``twolevel.residual`` (each cycle's stopping test) and
``conv_factor`` (the convergence factor's norms); it too counts always,
on the CPU as on the card.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

LAUNCHES: collections.Counter = collections.Counter()
GRAPHS: collections.Counter = collections.Counter()
SYNCS: collections.Counter = collections.Counter()

# A span's range in a profiler session: a RecordFunction range, as
# torch.profiler.record_function opens, through the entry torch's compiled
# code uses (about 1.5 us a range on a CPU, where record_function takes
# about 12 us); record_function itself on a torch without it.
record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                          torch.profiler.record_function)

MAX_SPANS = 100_000


class _NoSpan:
    """The span returned while recording is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Span:
    """One recorded span; ``start_ns`` and ``end_ns`` on ``time.time_ns()``'s
    clock (``end_ns`` is None while it is open)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "trace_id", "_fence",
                 "_range")

    def __init__(self, name: str, attrs: dict, fence: bool):
        self.name, self.attrs, self._fence = name, attrs, fence
        self.start_ns = self.end_ns = self.parent = self.trace_id = self._range = None

    @property
    def duration_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        stack = Profiler._stack
        if stack:
            self.parent = stack[-1]
            self.trace_id = self.parent.trace_id
        else:
            Profiler._traces += 1
            self.trace_id = Profiler._traces
        stack.append(self)
        if len(Profiler._spans) < MAX_SPANS:
            Profiler._spans.append(self)
        else:
            Profiler.dropped += 1
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._fence and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        Profiler._stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


class Profiler:
    """The span recorder, globally gated by ``Profiler.enabled`` (see the
    module docstring)."""

    enabled = False
    dropped = 0
    _spans: list = []
    _stack: list = []
    _traces = 0

    def __new__(cls, name: str, *, fence: bool = False, **attrs):
        if not cls.enabled:
            return _NO_SPAN
        return Span(name, attrs, fence)

    @classmethod
    def spans(cls) -> list:
        """The recorded spans, in the order they opened."""
        return cls._spans

    @classmethod
    def reset(cls) -> None:
        """Clear the store and the count of dropped spans (spans still open
        close as usual)."""
        cls._spans = []
        cls.dropped = 0

    @staticmethod
    @contextlib.contextmanager
    def recording(on: bool = True):
        """Recording on (or left as it is, for ``on=False``) inside the
        block, restored after it."""
        was = Profiler.enabled
        Profiler.enabled = was or on
        try:
            yield
        finally:
            Profiler.enabled = was

    @classmethod
    def tree(cls) -> dict:
        """{name: (total s, count, children)} of the closed spans, spans of
        one name under one parent's name path merged."""
        root: dict = {}
        children_of: dict = {}  # id(span) -> the merged children of its path
        for s in cls._spans:
            siblings = root if s.parent is None else children_of.get(id(s.parent))
            if siblings is None:  # its parent was cleared or never stored
                continue
            node = siblings.setdefault(s.name, [0.0, 0, {}])
            if s.end_ns is not None:
                node[0] += s.duration_s
                node[1] += 1
            children_of[id(s)] = node[2]

        def frozen(nodes):
            return {k: (t, c, frozen(ch)) for k, (t, c, ch) in nodes.items()}

        return frozen(root)

    @classmethod
    def print_tree(cls, file=None) -> None:
        def rec(nodes, depth):
            for name, (total, count, children) in nodes.items():
                print(f'{"  " * depth}{name}: {total * 1e3:.2f} ms (x{count})', file=file)
                rec(children, depth + 1)

        rec(cls.tree(), 0)
