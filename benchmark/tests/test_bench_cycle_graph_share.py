"""``cycle_graph_share``'s reader: the share of replayed cycles from a
planted ``GRAPHS`` counter, None where no cycle was counted or the program
has no such counter, and what a tiny CPU run of the hull reads (every
cycle eager)."""

import collections
import time
import types

import pytest

from harness import core

READER = core.load_module(core.BENCH / "metrics" / "cycle_graph_share.py", "cycle_graph_share")


@pytest.fixture
def graphs():
    """The program's counter, emptied for the test and restored after it
    (the package counts into this object, imported by name)."""
    from mlamg_torch.utils.profiler import GRAPHS

    kept = collections.Counter(GRAPHS)
    GRAPHS.clear()
    yield GRAPHS
    GRAPHS.clear()
    GRAPHS.update(kept)


def test_share_from_a_planted_counter(graphs):
    graphs.update({"uvcycle.eager": 1, "uvcycle.capture": 1, "uvcycle.replay": 98})
    assert READER.read(types.SimpleNamespace()) == pytest.approx(0.98)


def test_no_cycle_reads_none(graphs):
    assert READER.read(types.SimpleNamespace()) is None
    graphs["other"] = 3
    assert READER.read(types.SimpleNamespace()) is None


def test_a_program_without_the_counter_reads_none(monkeypatch):
    from mlamg_torch.utils import profiler

    monkeypatch.delattr(profiler, "GRAPHS")
    assert READER.read(types.SimpleNamespace()) is None


def test_tiny_cpu_hull_run_reads_every_cycle_eager(tiny, graphs):
    result, _ = core.run("hull600k.rhs", 2**31 + 17, 0.3, True, time.perf_counter(),
                         device="cpu", loaded=tiny("hull600k.rhs"))
    assert result["correct"]
    assert result["metrics"]["cycle_graph_share"] == {"value": 0.0, "unit": "fraction"}
    assert graphs["uvcycle.eager"] > 0 and graphs["uvcycle.replay"] == 0
