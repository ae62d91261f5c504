"""``vcycle_graph_share``'s reader: the share of replayed cycles from a
planted ``GRAPHS`` counter, None where no ``vcycle`` call was counted or
the program has no such counter, and what a tiny CPU run of the Poisson
reads (the CPU graphs nothing, so the counter stays empty)."""

import collections
import time
import types

import pytest

from harness import core

READER = core.load_module(core.BENCH / "metrics" / "vcycle_graph_share.py", "vcycle_graph_share")


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
    graphs.update({"vcycle.eager": 1, "vcycle.capture": 1, "vcycle.replay": 98,
                   "uvcycle.eager": 50})
    assert READER.read(types.SimpleNamespace()) == pytest.approx(0.98)


def test_no_cycle_reads_none(graphs):
    assert READER.read(types.SimpleNamespace()) is None
    graphs.update({"other": 3, "uvcycle.replay": 7})
    assert READER.read(types.SimpleNamespace()) is None


def test_a_program_without_the_counter_reads_none(monkeypatch):
    from mlamg_torch.utils import profiler

    monkeypatch.delattr(profiler, "GRAPHS")
    assert READER.read(types.SimpleNamespace()) is None


def test_tiny_cpu_poisson_run_reads_none(tiny, graphs):
    result, _ = core.run("poisson4096.rhs", 2**31 + 19, 0.3, True, time.perf_counter(),
                         device="cpu", loaded=tiny("poisson4096.rhs"))
    assert result["correct"]
    assert "vcycle_graph_share" not in result["metrics"]
    assert not any(k.startswith("vcycle.") for k in graphs)
