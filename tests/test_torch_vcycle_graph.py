"""``vcycle``'s CUDA graph of one cycle (``mg/cycle.py``).

On a CUDA ``b`` over an all-DIA hierarchy, ``vcycle`` runs a cycle
setting's first call eagerly, captures the second as a graph and replays
it from then on, copying b and x into the graph's buffers.  The tests
marked ``cuda`` hold it on a 256^2 bilinear hierarchy with a Chebyshev
V(2,2) cycle against the eager recursion (``_cycle``) bit for bit: the
``dia_spmv`` kernel, the elementwise passes and the coarse inverse's
product add in a fixed order, with no atomics.  Also: a new b between
calls, the caller's x left alone by later calls, the ``GRAPHS`` and
``LAUNCHES`` counts, one graph per cycle setting, the graph freed with its
hierarchy, two hierarchies' graphs replayed in turns on their shared
memory pool, reserved memory flat under a new hierarchy a request, and
``build_hierarchy``'s (CSR and dense) hierarchies left eager.  On the CPU, ``vcycle`` is the recursion bit for bit and graphs
nothing.

This file imports neither JAX nor ``mlamg_tpu``; on the card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_vcycle_graph.py
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_torch.mg import cycle
from mlamg_torch.mg.structured import build_structured_hierarchy
from mlamg_torch.ops import matmul
from mlamg_torch.ops.dia import DIA
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils.profiler import GRAPHS, LAUNCHES

CYCLE = dict(nu=2, smoother="chebyshev")
KEYS = ("vcycle.eager", "vcycle.capture", "vcycle.replay")


def poisson2d(n: int) -> sp.csr_matrix:
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    return (sp.kron(sp.eye(n), T) + sp.kron(T, sp.eye(n))).tocsr().astype(np.float32)


def structured(n: int, device, min_coarse: int):
    A = DIA.from_scipy(poisson2d(n), device=device)
    return build_structured_hierarchy(A, n, n, sides=(2,) * 7, min_coarse=min_coarse,
                                      kind="bilinear")


def vector(n: int, seed: int, device) -> torch.Tensor:
    v = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return torch.from_numpy(v).to(device)


def eager(h, b, x, **kw):
    """The cycle as the recursion alone: what ``vcycle`` ran before it
    replayed graphs."""
    kw = {"omega": 0.666, "nu": 1, "smoother": "jacobi", "lmin_frac": 1.0 / 15.0, "gamma": 1,
          **kw}
    return cycle._cycle(cycle._levels(h, kw["smoother"]), h.coarse, cycle._interp,
                        cycle._restrict, b, x, **kw)


def counted() -> dict:
    return {k: GRAPHS[k] for k in KEYS}


def since(before: dict) -> dict:
    return {k: GRAPHS[k] - before[k] for k in KEYS}


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


# --- on the CPU -------------------------------------------------------------


@pytest.fixture(scope="module")
def bilinear64_cpu():
    return structured(64, "cpu", 16)


@pytest.mark.parametrize("kw", [CYCLE, dict(nu=1), dict(nu=(2, 1), smoother="chebyshev", gamma=2)],
                         ids=["chebyshev", "jacobi", "w_per_level_nu"])
def test_cpu_vcycle_is_the_recursion_bit_for_bit(bilinear64_cpu, kw):
    h = bilinear64_cpu
    b, x = vector(64 * 64, 0, "cpu"), vector(64 * 64, 1, "cpu")
    before = counted()
    for _ in range(3):
        y = cycle.vcycle(h, b, x, **kw)
        assert torch.equal(y, eager(h, b, x, **kw))
        x = y
    assert h.graphs == {} and since(before) == dict.fromkeys(KEYS, 0)


def test_cpu_csr_hierarchy_is_never_graphed():
    A = CSR.from_scipy(poisson2d(16), dtype=torch.float32, device="cpu")
    h = cycle.build_hierarchy(A, max_levels=2, min_coarse=16)
    b, x = vector(256, 2, "cpu"), torch.zeros(256)
    before = counted()
    for _ in range(3):
        y = cycle.vcycle(h, b, x)
        assert torch.equal(y, eager(h, b, x))
        x = y
    assert h.graphs == {} and since(before) == dict.fromkeys(KEYS, 0)


def test_graphs_are_left_out_of_comparison_and_copies(bilinear64_cpu):
    h = dataclasses.replace(bilinear64_cpu)
    h.graphs["planted"] = object()
    twin = dataclasses.replace(h)
    assert twin == h and twin.graphs == {} and "graphs" not in repr(h)


# --- on the card ------------------------------------------------------------


@pytest.fixture(scope="module")
def bilinear256():
    """A 256^2 bilinear hierarchy on the card (five levels, the coarse
    inverse 256^2), built once: each test that shares it keys a cycle
    setting of its own; a test that counts graphs builds its own."""
    return structured(256, card(), 64)


@pytest.mark.cuda
def test_replays_equal_eager_cycles_bit_for_bit():
    dev = card()
    h = structured(256, dev, 64)
    n = 256 * 256
    b = vector(n, 3, dev)
    before, x_g, x_e = counted(), torch.zeros_like(b), torch.zeros_like(b)
    launches = []
    for _ in range(6):
        n0 = LAUNCHES["dia_spmv"]
        x_g = cycle.vcycle(h, b, x_g, **CYCLE)
        n1 = LAUNCHES["dia_spmv"]
        x_e = eager(h, b, x_e, **CYCLE)
        launches.append((n1 - n0, LAUNCHES["dia_spmv"] - n1))
        assert torch.equal(x_g, x_e)
    assert since(before) == {"vcycle.eager": 1, "vcycle.capture": 1, "vcycle.replay": 4}
    assert len(h.graphs) == 1
    assert all(g == e > 0 for g, e in launches)
    # a replay ran the cycle: the residual fell
    r = torch.linalg.vector_norm(matmul.spmv_affine(h.As[0], x_g, c=b, alpha=-1.0))
    assert float(r) < 1e-2 * float(torch.linalg.vector_norm(b))


@pytest.mark.cuda
def test_a_new_b_between_calls_is_honoured(bilinear256):
    dev = card()
    h = bilinear256
    n = 256 * 256
    kw = dict(nu=2, smoother="chebyshev", gamma=1, lmin_frac=1.0 / 30.0)
    for seed in (4, 5, 6, 4):  # eager, capture, then replays, the first b again
        b, x = vector(n, seed, dev), vector(n, seed + 10, dev)
        assert torch.equal(cycle.vcycle(h, b, x, **kw), eager(h, b, x, **kw))


@pytest.mark.cuda
def test_the_callers_x_is_its_own(bilinear256):
    dev = card()
    h = bilinear256
    n = 256 * 256
    kw = dict(nu=1, smoother="chebyshev")
    b, x = vector(n, 7, dev), vector(n, 8, dev)
    want = eager(h, b, x, **kw)
    ys = [cycle.vcycle(h, b, x, **kw) for _ in range(3)]  # eager, capture, replay
    g = next(v for k, v in h.graphs.items() if k[2] == (1,) and k[0] == "chebyshev")
    assert all(torch.equal(y, want) for y in ys)
    assert len({y.data_ptr() for y in ys} | {g.x.data_ptr(), g.b.data_ptr()}) == 5
    ys[2].fill_(7.0)
    x_kept = x.clone()
    y = cycle.vcycle(h, b, x, **kw)
    assert torch.equal(y, want) and torch.equal(ys[1], want) and torch.equal(x, x_kept)


@pytest.mark.cuda
def test_one_graph_per_cycle_setting():
    dev = card()
    h = structured(256, dev, 64)
    n = 256 * 256
    b, x = vector(n, 9, dev), torch.zeros(n, device=dev)
    settings = [CYCLE, dict(nu=1, smoother="chebyshev"), dict(CYCLE, gamma=2),
                dict(nu=2), dict(nu=(2, 1), smoother="chebyshev")]
    for i, kw in enumerate(settings):
        before = counted()
        for _ in range(4):
            y = cycle.vcycle(h, b, x, **kw)
        assert torch.equal(y, eager(h, b, x, **kw))
        assert since(before) == {"vcycle.eager": 1, "vcycle.capture": 1, "vcycle.replay": 2}
        assert len(h.graphs) == i + 1
    # numpy's integer names the same setting as Python's
    before = counted()
    cycle.vcycle(h, b, x, nu=np.int64(2), smoother="chebyshev")
    assert since(before) == {"vcycle.eager": 0, "vcycle.capture": 0, "vcycle.replay": 1}
    assert len(h.graphs) == len(settings)


@pytest.mark.cuda
def test_graph_is_freed_with_its_hierarchy():
    dev = card()
    h = structured(256, dev, 64)
    b = vector(256 * 256, 11, dev)
    x = torch.zeros_like(b)
    for _ in range(2):
        x = cycle.vcycle(h, b, x, **CYCLE)
    (g,) = h.graphs.values()
    ref = weakref.ref(g)
    del g, h
    gc.collect()
    assert ref() is None


@pytest.mark.cuda
def test_build_hierarchy_hierarchies_stay_eager():
    dev = card()
    A = CSR.from_scipy(poisson2d(32), dtype=torch.float32, device=dev)
    h = cycle.build_hierarchy(A, max_levels=3, min_coarse=16)
    b = vector(32 * 32, 12, dev)
    x = torch.zeros_like(b)
    before = counted()
    for _ in range(4):
        x = cycle.vcycle(h, b, x)
    assert h.graphs == {} and since(before) == dict.fromkeys(KEYS, 0)


@pytest.mark.cuda
def test_hierarchies_share_the_pool_and_replay_in_turns():
    dev = card()
    n = 256 * 256
    hs = [structured(256, dev, 64), structured(256, dev, 64)]
    for h in hs:  # eager, then capture
        for _ in range(2):
            cycle.vcycle(h, vector(n, 13, dev), torch.zeros(n, device=dev), **CYCLE)
    before = counted()
    for i, h in enumerate(hs * 3):  # replays of the two graphs in turns
        b, x = vector(n, 20 + i, dev), vector(n, 40 + i, dev)
        assert torch.equal(cycle.vcycle(h, b, x, **CYCLE), eager(h, b, x, **CYCLE))
    assert since(before) == {"vcycle.eager": 0, "vcycle.capture": 0, "vcycle.replay": 6}


@pytest.mark.cuda
def test_a_hierarchy_a_request_holds_its_memory_flat():
    """A new hierarchy and graph a request, as a setup-per-request caller
    has: the freed graphs' temporaries are reused, so the allocator's
    reserved memory stops growing after the first request (with a private
    pool a graph, each freed graph's pool stayed reserved)."""
    dev = card()
    n = 256 * 256
    reserved = []
    for i in range(6):
        h = structured(256, dev, 64)
        b, x = vector(n, 60 + i, dev), torch.zeros(n, device=dev)
        for _ in range(3):
            x = cycle.vcycle(h, b, x, **CYCLE)
        del h, b, x
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
    assert max(reserved[2:]) <= reserved[1], reserved
