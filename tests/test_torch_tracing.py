"""The port's span recorder (``mlamg_torch/utils/profiler.py``) and the
spans of the cycles and the builds, on the CPU: the span tree of a V-cycle
on a 64^2 bilinear hierarchy and of a W-cycle on a small hull, the shared
no-op and no ``record_function`` while recording is off, the spans as
``torch.profiler`` ranges while it is on, bitwise-equal results either way,
``profile_out`` read from the spans, and the tree ``train_dataset`` prints.
"""

import contextlib
import io

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mlamg_torch.data.grid import Grid
from mlamg_torch.mg import amg_unstructured as amg
from mlamg_torch.mg.cycle import vcycle, vcycle_solve
from mlamg_torch.mg.structured import build_structured_hierarchy
from mlamg_torch.ops.dia import DIA
from mlamg_torch.utils import profiler
from mlamg_torch.utils.profiler import Profiler

CYCLE = {"pre_smooth", "restrict", "interp", "post_smooth"}
HULL_BUILD = dict(alpha=0.2, max_levels=4, min_coarse=20, lloyd_maxiter=3, device="cpu")


@pytest.fixture(autouse=True)
def recorder():
    """Recording off and an empty store around each test (a test of the GA
    CLI in the same process leaves it on)."""
    was = Profiler.enabled
    Profiler.enabled = False
    Profiler.reset()
    yield
    Profiler.enabled = was
    Profiler.reset()


def poisson_dia(n: int) -> DIA:
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    A = (sp.kron(sp.eye(n), T) + sp.kron(T, sp.eye(n))).tocsr().astype(np.float32)
    return DIA.from_scipy(A, device="cpu")


@pytest.fixture(scope="module")
def bilinear64():
    A = poisson_dia(64)
    return A, build_structured_hierarchy(A, 64, 64, sides=(2,) * 6, min_coarse=16,
                                         kind="bilinear")


@pytest.fixture(scope="module")
def hull():
    A = sp.csr_matrix(Grid.random_2d_unstructured(1500, seed=3).A).astype(np.float32)
    h, perm = amg.build_unstructured_hierarchy(A, **HULL_BUILD)
    return A, h, perm


def rhs(n: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def children(spans, parent) -> list:
    return [s.name for s in spans if s.parent is parent]


def check_cycle_tree(spans, depth: int, gamma: int) -> None:
    """One ``cycle`` root; level l visited gamma^l times, each visit under
    the cycle (l = 0) or a visit of level l - 1, holding the smoothers, the
    transfers and either the next level's visits or the coarse solve."""
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["cycle"]
    cycle = roots[0]
    assert all(s.trace_id == cycle.trace_id and s.end_ns is not None for s in spans)
    levels = [s for s in spans if s.name == "level"]
    for l in range(depth):
        visits = [s for s in levels if s.attrs == {"level": l}]
        assert len(visits) == gamma ** l
        for v in visits:
            assert v.parent is cycle if l == 0 else (
                v.parent.name == "level" and v.parent.attrs["level"] == l - 1)
            names = children(spans, v)
            assert set(names) - {"level", "coarse_solve"} == CYCLE
            if l + 1 == depth:
                assert names == ["pre_smooth", "restrict", "coarse_solve", "interp",
                                 "post_smooth"]
            else:
                assert names == ["pre_smooth", "restrict"] + ["level"] * gamma + [
                    "interp", "post_smooth"]
    assert len(levels) == sum(gamma ** l for l in range(depth))
    assert sum(s.name == "coarse_solve" for s in spans) == gamma ** (depth - 1)
    for s in spans:
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns <= s.parent.end_ns


def test_vcycle_span_tree(bilinear64):
    A, h = bilinear64
    assert h.num_levels >= 3
    b = rhs(A.shape[0])
    Profiler.enabled = True
    vcycle(h, b, torch.zeros_like(b), nu=2, smoother="chebyshev")
    check_cycle_tree(Profiler.spans(), h.num_levels, gamma=1)


def test_w_uvcycle_span_tree(hull):
    A, h, perm = hull
    assert len(h.levels) == 3
    b = rhs(A.shape[0])
    Profiler.enabled = True
    amg.uvcycle(h, b, torch.zeros_like(b), nu=2, gamma=2)
    check_cycle_tree(Profiler.spans(), len(h.levels), gamma=2)


def test_solve_spans_hold_a_cycle_and_a_residual_norm_an_iteration(hull):
    A, h, perm = hull
    b = rhs(A.shape[0])
    Profiler.enabled = True
    _, _, _, iters = amg.uvcycle_solve(h, b, torch.zeros_like(b), res_tol=1e-4 * float(
        torch.linalg.vector_norm(b)), max_iter=30, nu=2, gamma=2)
    spans = Profiler.spans()
    solve = spans[0]
    assert solve.name == "solve" and solve.parent is None and iters > 1
    assert children(spans, solve) == ["cycle", "residual_norm"] * iters


def test_recording_off_records_nothing_and_calls_no_record_function(bilinear64, monkeypatch):
    A, h = bilinear64
    calls = []
    monkeypatch.setattr(profiler, "record_function",
                        lambda name: calls.append(name) or contextlib.nullcontext())
    assert Profiler("cycle") is Profiler("level", level=3, fence=True)
    b = rhs(A.shape[0])
    with profile(activities=[ProfilerActivity.CPU]):
        vcycle(h, b, torch.zeros_like(b), nu=2, smoother="chebyshev")
        build_structured_hierarchy(A, 64, 64, sides=(2,) * 6, min_coarse=16, kind="bilinear")
    assert Profiler.spans() == [] and calls == []
    # recording on and no profiler session: still no range
    Profiler.enabled = True
    vcycle(h, b, torch.zeros_like(b), nu=2, smoother="chebyshev")
    assert Profiler.spans() and calls == []
    # recording on under a session: a range a span
    Profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        vcycle(h, b, torch.zeros_like(b), nu=2, smoother="chebyshev")
    assert calls == [s.name for s in Profiler.spans()]


def test_spans_are_profiler_ranges_on_the_same_clock(bilinear64):
    A, h = bilinear64
    b = rhs(A.shape[0])
    Profiler.enabled = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with Profiler("warm"):  # the session's first range starts it
            pass
        Profiler.reset()
        vcycle(h, b, torch.zeros_like(b), nu=2, smoother="chebyshev")
    spans = Profiler.spans()
    names = {s.name for s in spans}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name() in names]
    assert len(events) == len(spans)
    slack = 50_000  # ns
    for name in names:
        mine = [s for s in spans if s.name == name]
        theirs = sorted((e for e in events if e.name() == name), key=lambda e: e.start_ns())
        assert len(mine) == len(theirs)
        for s, e in zip(mine, theirs):
            # the range opens before the span's start and closes after its end
            assert e.start_ns() - slack <= s.start_ns <= e.start_ns() + 2_000_000
            assert s.end_ns <= e.end_ns() + slack


def test_results_are_bitwise_equal_recording_on_and_off(hull, bilinear64):
    A_h, _, _ = hull
    A_p, _ = bilinear64
    out = {}
    for on in (False, True):
        Profiler.enabled = on
        hs = build_structured_hierarchy(A_p, 64, 64, sides=(2,) * 6, min_coarse=16,
                                        kind="bilinear")
        b = rhs(A_p.shape[0], 1)
        xs, _, _, it_s = vcycle_solve(hs, b, torch.zeros_like(b), res_tol=1e-5, max_iter=20)
        hu, perm = amg.build_unstructured_hierarchy(A_h, **HULL_BUILD)
        b = rhs(A_h.shape[0], 2)
        xu, _, _, it_u = amg.uvcycle_solve(hu, b, torch.zeros_like(b), res_tol=1e-5,
                                           max_iter=20, nu=2, gamma=2)
        out[on] = (hs, xs, it_s, hu, perm, xu, it_u)
    (hs0, xs0, its0, hu0, p0, xu0, itu0), (hs1, xs1, its1, hu1, p1, xu1, itu1) = out.values()
    assert Profiler.spans()  # the second pass recorded
    assert its0 == its1 and itu0 == itu1 and np.array_equal(p0, p1)
    assert torch.equal(xs0, xs1) and torch.equal(xu0, xu1)
    for a0, a1 in zip(hs0.As, hs1.As):
        assert a0.offsets == a1.offsets and torch.equal(a0.data, a1.data)
    assert hs0.lmaxs == hs1.lmaxs and torch.equal(hs0.coarse.lu, hs1.coarse.lu)
    for l0, l1 in zip(hu0.levels, hu1.levels):
        assert torch.equal(l0.A.data, l1.A.data) and torch.equal(l0.agg, l1.agg)
        assert l0.omegas == l1.omegas and l0.lmax == l1.lmax
    assert torch.equal(hu0.coarse.lu, hu1.coarse.lu)


@pytest.mark.parametrize("rap_mode", ["host", "device"])
def test_profile_out_reads_the_build_spans(hull, rap_mode):
    A = hull[0]
    prof: dict = {}
    h, _ = amg.build_unstructured_hierarchy(A, profile_out=prof, rap_mode=rap_mode, **HULL_BUILD)
    assert not Profiler.enabled  # recording was on for the build alone
    spans = Profiler.spans()
    build = spans[0]
    assert build.name == "build" and build.parent is None
    levels = [s for s in spans if s.name == "level"]
    assert all(s.parent is build for s in levels)
    stages = [s for s in spans if s.name not in ("build", "level")]
    assert all(s.parent is build or s.parent in levels for s in stages)
    want: dict = {}
    for s in stages:
        key = "rap" if s.name == "galerkin" else s.name
        want[key] = want.get(key, 0.0) + s.duration_s
    assert {k: v for k, v in prof.items() if k not in ("rap_branch", "rap_levels")} == want
    galerkin = [s.duration_s for s in stages if s.name == "galerkin"]
    assert [r["rap_s"] for r in prof["rap_levels"]] == galerkin
    # the last level span may end at the coarse size, before its stages
    assert len(galerkin) == len(prof["rap_branch"]) == len(h.levels)
    assert len(levels) in (len(h.levels), len(h.levels) + 1)
    assert ("patterns_host" in prof) == (rap_mode == "device")
    assert {"symmetry_check", "rcm_reorder", "strength_lloyd", "sa_omegas", "p_smooth",
            "rap", "truncate", "repack", "coarse_factor"} <= set(prof)


def test_verbose_prints_the_profile_from_the_spans(hull, capsys):
    amg.build_unstructured_hierarchy(hull[0], verbose=True, **HULL_BUILD)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("level 0: n=1500") and "[host rap]" in lines[0]
    assert lines[-1].startswith("setup profile (s): {") and "'rap'" in lines[-1]


def test_structured_build_spans(bilinear64):
    A, h = bilinear64
    Profiler.enabled = True
    build_structured_hierarchy(A, 64, 64, sides=(2,) * 6, min_coarse=16, kind="bilinear")
    spans = Profiler.spans()
    build = spans[0]
    assert build.name == "build" and build.parent is None
    # a level span per coarsening (h.num_levels counts the smoothed levels)
    levels = [s for s in spans if s.name == "level"]
    assert children(spans, build) == ["level"] * h.num_levels + ["coarse_factor"]
    assert [s.attrs["level"] for s in levels] == list(range(h.num_levels))
    for s in levels:
        assert children(spans, s) == ["lmax", "prolongator", "galerkin"]
    for s in spans:
        if s.name == "galerkin":
            assert children(spans, s) == ["probes", "stencil_read"]


def test_tree_nests_train_dataset_sections():
    Profiler.enabled = True
    with Profiler("lloyd benchmark"):
        pass
    for _ in range(2):
        with Profiler("generation"):
            with Profiler("fitness"):
                pass
            with Profiler("fitness"):
                pass
    tree = Profiler.tree()
    assert list(tree) == ["lloyd benchmark", "generation"]
    total, count, kids = tree["generation"]
    assert count == 2 and total > 0 and list(kids) == ["fitness"] and kids["fitness"][1] == 4
    assert tree["lloyd benchmark"][1:] == (1, {})
    out = io.StringIO()
    Profiler.print_tree(file=out)
    lines = out.getvalue().splitlines()
    assert [line.split(":")[0] for line in lines] == ["lloyd benchmark", "generation",
                                                      "  fitness"]
    assert lines[1].endswith("ms (x2)") and lines[2].endswith("ms (x4)")


def test_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiler, "MAX_SPANS", 3)
    Profiler.enabled = True
    with Profiler("a") as a:
        for _ in range(4):
            with Profiler("b") as b:
                pass
    assert [s.name for s in Profiler.spans()] == ["a", "b", "b"] and Profiler.dropped == 2
    assert a.end_ns >= b.end_ns >= b.start_ns  # a dropped span is still timed
    Profiler.reset()
    assert Profiler.spans() == [] and Profiler.dropped == 0


def test_trace_ids_follow_the_roots():
    Profiler.enabled = True
    with Profiler("request"):
        with Profiler("build"):
            pass
        with Profiler("solve"):
            pass
    with Profiler("other"):
        pass
    r, bld, sol, other = Profiler.spans()
    assert r.trace_id == bld.trace_id == sol.trace_id != other.trace_id
    assert bld.parent is r and sol.parent is r and other.parent is None


def test_a_fenced_span_synchronises_only_while_recording(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(1))
    with Profiler("stage", fence=True):
        pass
    assert synced == []
    Profiler.enabled = True
    with Profiler("stage", fence=True):
        pass
    with Profiler("cycle"):
        pass
    assert synced == [1]


def test_launches_has_one_home():
    from mlamg_torch.ops import _build, dia, segment, unstructured

    # the launcher counts into the profiler's store; no wrapper holds its own
    assert _build.LAUNCHES is profiler.LAUNCHES
    assert not any(hasattr(m, "LAUNCHES") for m in (dia, segment, unstructured))
