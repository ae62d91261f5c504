"""``uvcycle_solve``'s CUDA graph of one cycle (``mg/amg_unstructured.py``).

On a CUDA tensor the solve runs the hierarchy's first cycle eagerly,
captures the second as a graph and replays it; the tests marked ``cuda``
hold it on a small hull with a W(2,2) Chebyshev cycle against an eager loop
of ``uvcycle`` with the same residual test.  ``segment_sum``'s
``index_add_`` adds with float atomics on the card, so the eager loop does
not repeat itself bit for bit: two eager solves there differ by up to
4.2e-7 of the first residual norm in a cycle's norm (1.4% of a late
cycle's own norm) and by 3.3e-7 of ||x|| in x.  So the graphed solve is
held to the eager loop bit for bit under deterministic algorithms, where
``index_add_`` adds in a fixed order, and otherwise to the same cycle
count, each cycle's norm within 1e-5 of the first and x within 1e-5 of
||x||.  Also: the same ``well_spmv`` launch count, the ``GRAPHS`` counts,
one graph per cycle setting, the graph freed with its hierarchy, and the
solve's span tree.  On the CPU every cycle is eager and the solve equals
the eager loop bit for bit.

This file imports neither JAX nor ``mlamg_tpu``; on the card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_uvcycle_graph.py
"""

import gc
import weakref

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_torch.data.grid import Grid
from mlamg_torch.mg import amg_unstructured as amg
from mlamg_torch.mg.cycle import _conv_factor
from mlamg_torch.ops import matmul
from mlamg_torch.utils.profiler import GRAPHS, LAUNCHES, Profiler

CYCLE = dict(nu=2, gamma=2, smoother="chebyshev", lmin_frac=1.0 / 15.0)
BUILD = dict(alpha=0.2, max_levels=4, min_coarse=20, lloyd_maxiter=3, fmt="well")
MAX_ITER = 40
REL_TOL = 1e-6


@pytest.fixture(autouse=True)
def recorder():
    was = Profiler.enabled
    Profiler.enabled = False
    Profiler.reset()
    yield
    Profiler.enabled = was
    Profiler.reset()


@pytest.fixture(scope="module")
def hull_matrix():
    return sp.csr_matrix(Grid.random_2d_unstructured(1500, seed=3).A).astype(np.float32)


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def build(A, device):
    return amg.build_unstructured_hierarchy(A, device=device, **BUILD)[0]


def rhs(n: int, seed: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32)).to(device)


def solve(h, b, **cycle):
    tol = REL_TOL * float(torch.linalg.vector_norm(b))
    return amg.uvcycle_solve(h, b, torch.zeros_like(b), res_tol=tol, max_iter=MAX_ITER,
                             **{**CYCLE, **cycle})


def eager_solve(h, b):
    """The solve as an eager loop of ``uvcycle`` with the same residual
    test: what ``uvcycle_solve`` ran before it replayed graphs."""
    tol = REL_TOL * float(torch.linalg.vector_norm(b))
    A = h.levels[0].A
    err = torch.zeros(MAX_ITER, dtype=b.dtype, device=b.device)
    x, iters = torch.zeros_like(b), 0
    while iters < MAX_ITER:
        x = amg.uvcycle(h, b, x, **CYCLE)
        e = torch.linalg.vector_norm(matmul.spmv_affine(A, x, c=b, alpha=-1.0))
        err[iters] = e
        iters += 1
        if float(e) <= tol:
            break
    return x, _conv_factor(err, iters), err, iters


def graphs_since(before) -> dict:
    return {k: GRAPHS[k] - before.get(k, 0) for k in
            ("uvcycle.eager", "uvcycle.capture", "uvcycle.replay")}


# --- on the CPU -------------------------------------------------------------


def test_cpu_solve_is_the_eager_loop_bit_for_bit(hull_matrix):
    h = build(hull_matrix, "cpu")
    b = rhs(hull_matrix.shape[0], 0, "cpu")
    before = dict(GRAPHS)
    x, conv, err, iters = solve(h, b)
    counted = graphs_since(before)
    x_e, conv_e, err_e, iters_e = eager_solve(h, b)
    assert iters == iters_e > 2 and conv == conv_e
    assert torch.equal(x, x_e) and torch.equal(err, err_e)
    assert counted == {"uvcycle.eager": iters, "uvcycle.capture": 0, "uvcycle.replay": 0}
    assert h.graphs == {}


def test_cpu_cycle_spans_say_eager(hull_matrix):
    h = build(hull_matrix, "cpu")
    b = rhs(hull_matrix.shape[0], 1, "cpu")
    Profiler.enabled = True
    *_, iters = solve(h, b)
    spans = Profiler.spans()
    solve_span = spans[0]
    top = [s for s in spans if s.parent is solve_span]
    assert [s.name for s in top] == ["cycle", "residual_norm"] * iters
    assert [s.attrs for s in top if s.name == "cycle"] == [{"graph": "eager"}] * iters


def test_graphs_are_left_out_of_comparison_and_copies(hull_matrix):
    import dataclasses

    h = build(hull_matrix, "cpu")
    h.graphs["planted"] = object()
    twin = dataclasses.replace(h)
    assert twin == h and twin.graphs == {} and "graphs" not in repr(h)


# --- on the card ------------------------------------------------------------


@pytest.mark.cuda
def test_graphed_solve_holds_to_the_eager_loop(hull_matrix):
    dev = card()
    h = build(hull_matrix, dev)
    b = rhs(hull_matrix.shape[0], 0, dev)
    n0 = LAUNCHES["well_spmv"]
    x_e, conv_e, err_e, iters_e = eager_solve(h, b)
    torch.cuda.synchronize()
    n1 = LAUNCHES["well_spmv"]
    before = dict(GRAPHS)
    x, conv, err, iters = solve(h, b)
    torch.cuda.synchronize()
    n2 = LAUNCHES["well_spmv"]
    assert iters == iters_e > 3
    e, e_e = err[:iters].double(), err_e[:iters].double()
    assert torch.all((e - e_e).abs() <= 1e-5 * e_e[0])
    assert float(torch.linalg.vector_norm((x - x_e).double())) <= 1e-5 * float(
        torch.linalg.vector_norm(x_e.double()))
    assert n2 - n1 == n1 - n0 > 0
    assert graphs_since(before) == {"uvcycle.eager": 1, "uvcycle.capture": 1,
                                    "uvcycle.replay": iters - 2}
    # a second solve with a new b replays every cycle, on the graph's own buffers
    g = next(iter(h.graphs.values()))
    before = dict(GRAPHS)
    b2 = rhs(hull_matrix.shape[0], 1, dev)
    x2, _, err2, iters2 = solve(h, b2)
    x2_e, _, err2_e, iters2_e = eager_solve(h, b2)
    assert graphs_since(before) == {"uvcycle.eager": 0, "uvcycle.capture": 0,
                                    "uvcycle.replay": iters2}
    assert iters2 == iters2_e
    assert float(torch.linalg.vector_norm((x2 - x2_e).double())) <= 1e-5 * float(
        torch.linalg.vector_norm(x2_e.double()))
    # the answers are the caller's: the next solve leaves them as they are
    assert x2.data_ptr() != g.x.data_ptr() and x.data_ptr() != g.x.data_ptr()
    assert float(torch.linalg.vector_norm((x - x_e).double())) <= 1e-5 * float(
        torch.linalg.vector_norm(x_e.double()))


@pytest.mark.cuda
def test_graphed_solve_is_the_eager_loop_bit_for_bit_in_a_fixed_order(hull_matrix):
    dev = card()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        h = build(hull_matrix, dev)
        for seed in (5, 6):  # the first solve captures, the second replays only
            b = rhs(hull_matrix.shape[0], seed, dev)
            x_e, conv_e, err_e, iters_e = eager_solve(h, b)
            x, conv, err, iters = solve(h, b)
            assert iters == iters_e > 3 and conv == conv_e
            assert torch.equal(x, x_e) and torch.equal(err, err_e)
        assert len(h.graphs) == 1
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.cuda
def test_one_graph_per_cycle_setting(hull_matrix):
    dev = card()
    h = build(hull_matrix, dev)
    b = rhs(hull_matrix.shape[0], 2, dev)
    solve(h, b)
    assert len(h.graphs) == 1
    solve(h, b)
    assert len(h.graphs) == 1
    before = dict(GRAPHS)
    *_, iters = solve(h, b, gamma=1)
    assert len(h.graphs) == 2
    assert graphs_since(before) == {"uvcycle.eager": 1, "uvcycle.capture": 1,
                                    "uvcycle.replay": iters - 2}


@pytest.mark.cuda
def test_graph_is_freed_with_its_hierarchy(hull_matrix):
    dev = card()
    h = build(hull_matrix, dev)
    solve(h, rhs(hull_matrix.shape[0], 3, dev))
    (g,) = h.graphs.values()
    ref = weakref.ref(g)
    del g, h
    gc.collect()
    assert ref() is None


@pytest.mark.cuda
def test_graphed_solve_span_tree(hull_matrix):
    dev = card()
    h = build(hull_matrix, dev)
    b = rhs(hull_matrix.shape[0], 4, dev)
    for first in (True, False):  # the first solve captures, the second replays only
        Profiler.reset()
        Profiler.enabled = True
        *_, iters = solve(h, b)
        Profiler.enabled = False
        spans = Profiler.spans()
        solve_span = spans[0]
        top = [s for s in spans if s.parent is solve_span]
        assert solve_span.name == "solve"
        assert [s.name for s in top] == ["cycle", "residual_norm"] * iters
        modes = [s.attrs["graph"] for s in top if s.name == "cycle"]
        if first:
            assert modes == ["eager", "capture"] + ["replay"] * (iters - 2)
        else:
            assert modes == ["replay"] * iters
            # a replayed cycle has no spans inside it
            assert not any(s.parent is not None and s.parent.name == "cycle" for s in spans)
