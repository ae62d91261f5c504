"""The harness driven whole at tiny sizes on the CPU: the result line's
keys, a sound run read correct, and each fault a cell can have read
incorrect.  The faults are planted in the measured package underneath the
timed path: a cycle that returns its iterate unchanged, a cycle that
leaves half of the rows out of its update, an answer or a coarse operator
altered where it is produced, and another valid aggregation in the hull's
set-up.  (The cells run on one card: no exchange between cards to leave
out.)"""

import time

import pytest
import torch

from harness import core

CELLS = ("poisson4096.rhs", "poisson4096.setup", "hull600k.rhs")


def run(tiny, cell, trace=False, seconds=0.5):
    return core.run(cell, 2**31 + 11, seconds, trace, time.perf_counter(), device="cpu",
                    loaded=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_with_the_result_keys(tiny, cell):
    result, lines = run(tiny, cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "setup",
                            "check"]
    assert {"start_s", "card_s", "system_s", "libraries_s", "warmup_s"} <= set(
        result["setup"]["parts_s"])
    assert result["correct"] and result["attempted"] >= 1 and result["failed"] == 0
    assert {"solve_ms", "solve_p90_ms", "setup_s"} == set(result["metrics"])
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {"residual", "unconverged", "coarse_op"} <= set(result["check"])
    assert len(lines) == len(result["check"]) and all("limit" in line for line in lines)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_per_layer_metrics(tiny, cell):
    result, _ = run(tiny, cell, trace=True)
    assert list(result)[-3:] == ["breakdown", "setup", "check"] and result["correct"]
    assert {"cycle_ms", "cycles_per_solve"} <= set(result["metrics"])
    want = "hierarchy_ms.request" if cell.endswith(".setup") else "hierarchy_s.setup"
    assert want in result["metrics"]
    # the device's metrics are left out on the CPU, never read as 0
    assert not {"device_idle", "solve_mfu", "dia_spmv_roofline"} & set(result["metrics"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(cycle):
    return lambda h, b, x, **kw: x


def _half(cycle):
    def step(h, b, x, **kw):
        y = cycle(h, b, x, **kw)
        n = y.shape[0] // 2
        return torch.cat([y[:n], x[n:]])
    return step


def _nan_iterate(cycle):
    def step(h, b, x, **kw):
        y = cycle(h, b, x, **kw).clone()
        y[1] = float("nan")
        return y
    return step


def _altered_iterate(cycle):
    def step(h, b, x, **kw):
        y = cycle(h, b, x, **kw).clone()
        y[0] += 1.0
        return y
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered_iterate, _nan_iterate])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_cycle_reads_incorrect(tiny, monkeypatch, cell, fault):
    import mlamg_torch.mg.amg_unstructured as unstructured
    import mlamg_torch.mg.cycle as cycle

    if cell.startswith("hull"):
        monkeypatch.setattr(unstructured, "uvcycle", fault(unstructured.uvcycle))
    else:
        monkeypatch.setattr(cycle, "vcycle", fault(cycle.vcycle))
    result, _ = run(tiny, cell, seconds=0.2)
    assert not result["correct"]


def test_an_answer_altered_where_it_is_produced_reads_incorrect(tiny, monkeypatch):
    import mlamg_torch.mg.amg_unstructured as unstructured

    solve = unstructured.uvcycle_solve

    def altered(*a, **kw):
        x, conv, err, iters = solve(*a, **kw)
        x = x.clone()
        x[x.shape[0] // 3] *= 1.01
        return x, conv, err, iters

    monkeypatch.setattr(unstructured, "uvcycle_solve", altered)
    result, _ = run(tiny, "hull600k.rhs", seconds=0.2)
    assert result["failed"] == 0 and not result["correct"]
    assert result["check"]["residual"]["value"] > result["check"]["residual"]["limit"]


@pytest.mark.parametrize("cell", ["poisson4096.rhs", "poisson4096.setup"])
def test_a_coarse_operator_altered_where_it_is_produced_reads_incorrect(tiny, monkeypatch, cell):
    import mlamg_torch.mg.structured as structured

    probe = structured.dia_galerkin_probe

    def altered(A, P):
        A_H = probe(A, P)
        if A_H.shape[0] > 1024:  # the first coarse operator only
            A_H.data[4, 77] *= 1.001
        return A_H

    monkeypatch.setattr(structured, "dia_galerkin_probe", altered)
    result, _ = run(tiny, cell, seconds=0.2)
    assert result["failed"] == 0 and not result["correct"]
    assert result["check"]["coarse_op"]["value"] > result["check"]["coarse_op"]["limit"]


def _fewer_rounds(lloyd):
    return lambda C, maxiter, **kw: lloyd(C, maxiter=maxiter - 1, **kw)


def _seeds_moved(lloyd):
    return lambda C, maxiter, seeds, **kw: lloyd(C, maxiter=maxiter, seeds=seeds[1:] - 1, **kw)


@pytest.mark.parametrize("fault", [_fewer_rounds, _seeds_moved])
def test_another_valid_aggregation_reads_incorrect(tiny, monkeypatch, fault):
    import mlamg_torch.graph.lloyd as lloyd

    monkeypatch.setattr(lloyd, "lloyd_aggregation", fault(lloyd.lloyd_aggregation))
    result, _ = run(tiny, "hull600k.rhs", seconds=0.2)
    assert result["failed"] == 0 and not result["correct"]
    assert result["check"]["aggregation"]["value"] > 0
