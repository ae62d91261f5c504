"""The readers of the program's spans (``harness/spans.py``): the tiny CPU
cells' traced runs read the ``galerkin_*`` metrics on their cells and leave
the device's metrics out; the reduction of pass B on made-up spans and
device intervals; and a program without the recorder reads nothing."""

import json
import time
import types

import pytest

from harness import core, spans

DEVICE = {"launches_per_cycle", "idle_fine_ms.cycle", "idle_coarse_ms.cycle"}
CELLS = {"poisson4096.rhs": "galerkin_s.setup", "hull600k.rhs": "galerkin_s.setup",
         "poisson4096.setup": "galerkin_ms.request"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_reads_the_galerkin_spans_and_no_device_metric(tiny, cell):
    result, _ = core.run(cell, 2**31 + 13, 0.3, True, time.perf_counter(), device="cpu",
                         loaded=tiny(cell))
    assert result["correct"]
    metrics = result["metrics"]
    want = CELLS[cell]
    assert want in metrics and metrics[want]["value"] > 0
    assert not ({"galerkin_s.setup", "galerkin_ms.request"} - {want}) & set(metrics)
    assert not DEVICE & set(metrics)
    # the metrics that were there read as before
    assert {"cycle_ms", "cycles_per_solve"} <= set(metrics)


def test_every_configuration_solves_to_the_tolerance_pass_b_uses():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert json.loads((core.ROOT / c["file"]).read_text())["request"]["tol"] == spans.TOL


def _span(name, start, end, parent=None, **attrs):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end, parent=parent,
                                 attrs=attrs)


def test_pass_b_reduction_on_made_up_spans():
    # one solve: a cycle over [100, 200] with level 0 over [100, 200], level 1
    # over [130, 170] holding a coarse solve over [150, 160]; the solve ends at
    # 220, and a residual norm outside the cycle is [200, 215]
    cycle = _span("cycle", 100, 200)
    l0 = _span("level", 100, 200, cycle, level=0)
    l1 = _span("level", 130, 170, l0, level=1)
    cs = _span("coarse_solve", 150, 160, l1)
    pre = _span("pre_smooth", 100, 128, l0)
    norm = _span("residual_norm", 200, 215)
    device = [(90, 95, "fill"), (104, 110, "dia_spmv_kernel"), (120, 126, "mul"),
              (140, 146, "dia_spmv_kernel"), (155, 158, "gemv"), (180, 186, "add"),
              (205, 210, "norm")]
    out = spans.reduce_pass_b([cycle, l0, pre, l1, cs, norm], device, 90, 220, [220],
                              {"dia_spmv": 2, "well_spmv": 0})
    assert out["cycles"] == 1 and out["launches_per_cycle"] == 6
    assert out["kernels_traced"] == {"dia_spmv": 2, "well_spmv": 0}
    # gaps: [95,104] mid 99 outside; [110,120] mid 115 pre_smooth -> fine;
    # [126,140] mid 133 level 1 -> coarse; [146,155] mid 150 coarse solve;
    # [158,180] mid 169 level 1; [186,205] mid 195 level 0; [210,220] mid 215
    # residual norm -> outside
    assert out["idle_fine_ms.cycle"] == pytest.approx((10 + 19) / 1e6)
    assert out["idle_coarse_ms.cycle"] == pytest.approx((14 + 9 + 22) / 1e6)
    assert out["idle_outside_ms"] == pytest.approx((9 + 10) / 1e6)
    assert out["idle_ms"] * 1e6 == 130 - (5 + 6 + 6 + 6 + 3 + 6 + 5)
    assert out["idle_share"] == pytest.approx(out["idle_ms"] / out["window_ms"])


def test_no_cycle_span_reads_nothing():
    assert spans.reduce_pass_b([_span("solve", 0, 10)], [(1, 2, "k")], 0, 10, [10], {}) == {}


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from mlamg_torch.utils import profiler

    class Old:  # the recorder before it kept spans: a switch and a tree
        enabled = False

    monkeypatch.setattr(profiler, "Profiler", Old)
    run = types.SimpleNamespace()
    assert spans.read(run) == {} and run.program_spans == {}
    assert not Old.enabled
