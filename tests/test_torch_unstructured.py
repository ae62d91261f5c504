"""Port parity, kernel module and graph layer: ``mlamg_torch`` against
``mlamg_tpu`` on the same numpy inputs (CPU).

The JAX side runs as its own tests run it: ``well_spmv_pallas`` in the
Pallas interpreter, everything else on the CPU backend.  On the CPU the
port's ``well_spmv`` is its plain version ``well_spmv_reference``; the CUDA
kernel is held against that version on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import importlib
import time

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp
import pytest
import torch

from mlamg_tpu import native as jnative
from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.graph.bellman_ford import bellman_ford as j_bellman_ford
from mlamg_tpu.graph.bellman_ford import nearest_center_to_agg as j_nearest_center_to_agg
from mlamg_tpu.graph import lloyd as jlloyd
from mlamg_tpu.graph.strength import strength_measure as jstrength
from mlamg_tpu.ops import matmul as jmatmul
from mlamg_tpu.ops.sparse import CSR as JCSR
from mlamg_tpu.ops.unstructured import WindowedELL as JWELL
from mlamg_tpu.ops.unstructured import rcm_spmv_setup as j_rcm_spmv_setup
from mlamg_tpu.ops.unstructured import well_spmv_pallas

from mlamg_torch import native
from mlamg_torch.data import Grid
from mlamg_torch.graph import lloyd as tlloyd
from mlamg_torch.graph.strength import strength_measure
from mlamg_torch.ops import matmul, segment
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.ops.unstructured import (
    WindowedELL, rcm_spmv_setup, well_spmv, well_spmv_reference,
)
from mlamg_torch.utils.profiler import LAUNCHES

# the module: the package re-exports its function under the same name, as
# mlamg_tpu.graph does
tbf = importlib.import_module("mlamg_torch.graph.bellman_ford")

CPU = "cpu"


def fem_matrix(n=800, seed=3):
    return sp.csr_matrix(JGrid.random_2d_unstructured(n, seed=seed).A).astype(np.float32)


def rcm_fem(n=800, seed=3):
    A = fem_matrix(n, seed)
    perm = jnative.rcm_ordering(A)
    return A[perm][:, perm].tocsr()


def banded_matrix(rng, n=700, band=60):
    A = sp.random(n, n, density=0.01, format="lil", random_state=rng)
    A.setdiag(1.0)
    coo = sp.csr_matrix(A).tocoo()
    keep = np.abs(coo.row - coo.col) <= band
    return sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n)
    ).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_close_to(y, ref):
    np.testing.assert_allclose(np.asarray(y), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


# ---------------------------------------------------------------------------
# Grid and RCM: numpy/scipy only, so bit-identical
# ---------------------------------------------------------------------------


def test_random_hull_grid_bit_identical():
    gj = JGrid.random_2d_unstructured(1500, seed=3)
    gt = Grid.random_2d_unstructured(1500, seed=3)
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(gt.A, name), getattr(gj.A, name))
    np.testing.assert_array_equal(gt.x, gj.x)
    assert gt.n == gj.n


@pytest.fixture(scope="module")
def native_rcm():
    """Both packages on their C++ RCM before a permutation is compared.

    The JAX binding builds ``native/libmlamg_native.so`` with ``make`` in
    place at first use and caches a failed load for the life of the process.
    When other test processes build it at the same moment, the load can
    fail, and that process then falls back to scipy's RCM, which gives
    another permutation.  Retry the load (for up to 60 s) until the library
    is whole."""
    deadline = time.time() + 60.0
    while not jnative.available() and time.time() < deadline:
        jnative._TRIED, jnative._LIB = False, None
        time.sleep(0.5)
    assert jnative.available() and native.available()


@pytest.mark.parametrize("seed", [3, 9])
def test_rcm_ordering_identical(seed, native_rcm):
    A = fem_matrix(1500, seed)
    np.testing.assert_array_equal(native.rcm_ordering(A), jnative.rcm_ordering(A))


# ---------------------------------------------------------------------------
# WindowedELL layout and the kernel module's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fem", "banded"])
def test_windowed_ell_layout_matches_jax(kind):
    A = rcm_fem() if kind == "fem" else banded_matrix(np.random.RandomState(0))
    J = JWELL.from_scipy(A)
    W = WindowedELL.from_scipy(A, device=CPU)
    w, n_pad = W.width, W.n_pad
    assert (w, n_pad) == (J.width, J.n_pad)
    assert W.shape == J.shape and W.nnz == J.nnz and W.block_rows == J.block_rows
    np.testing.assert_array_equal(W.data.numpy(), np.asarray(J.data).reshape(w, n_pad))
    # JAX's window-relative columns plus each block's window start
    RB, HB = J.block_rows, J.halo_blocks
    NR, WB = n_pad // 128, RB + 2 * HB
    nb = NR // RB
    starts = np.clip(np.arange(nb) * RB - HB, 0, max(NR, WB) - WB)
    absolute = np.asarray(J.rel).reshape(w, n_pad) + 128 * starts.repeat(RB * 128)[None, :]
    np.testing.assert_array_equal(W.col.numpy(), absolute)
    assert W.data.dtype == torch.float32 and W.col.dtype == torch.int32


@pytest.mark.parametrize("alpha,affine", [(1.0, False), (-1.0, True), (0.5, True)])
def test_well_spmv_reference_matches_pallas_fem(rng, alpha, affine):
    Ap = rcm_fem(seed=5)
    n = Ap.shape[0]
    x = rng.randn(n).astype(np.float32)
    c = rng.randn(n).astype(np.float32) if affine else None
    yj = well_spmv_pallas(JWELL.from_scipy(Ap), jnp.asarray(x),
                          c=None if c is None else jnp.asarray(c),
                          alpha=alpha, interpret=True)
    yt = well_spmv_reference(WindowedELL.from_scipy(Ap, device=CPU), t(x),
                             None if c is None else t(c), alpha)
    ref = alpha * (Ap.astype(np.float64) @ x) + (0.0 if c is None else c)
    assert_close_to(yt.numpy(), ref)
    assert_close_to(yt.numpy(), np.asarray(yj))


def test_well_spmv_reference_banded_uneven_degrees(rng):
    A = banded_matrix(rng)
    x = rng.randn(A.shape[0]).astype(np.float32)
    yj = well_spmv_pallas(JWELL.from_scipy(A), jnp.asarray(x), interpret=True)
    yt = well_spmv_reference(WindowedELL.from_scipy(A, device=CPU), t(x))
    assert_close_to(yt.numpy(), A @ x)
    assert_close_to(yt.numpy(), np.asarray(yj))


def test_rcm_spmv_setup_roundtrip(rng, native_rcm):
    A = fem_matrix(seed=9)
    perm, W = rcm_spmv_setup(A, device=CPU)
    perm_j, _ = j_rcm_spmv_setup(A)
    np.testing.assert_array_equal(perm, perm_j)
    n = A.shape[0]
    x = rng.randn(n).astype(np.float32)
    y_perm = well_spmv(W, t(x[perm])).numpy()
    y = np.empty(n, np.float32)
    y[perm] = y_perm
    assert_close_to(y, A @ x)


@pytest.mark.parametrize("fmt", ["well", "csr", "dense"])
def test_matmul_dispatch_matches_jax(rng, fmt):
    Ap = rcm_fem(seed=11)
    n = Ap.shape[0]
    x = rng.randn(n).astype(np.float32)
    c = rng.randn(n).astype(np.float32)
    if fmt == "well":
        At, Aj = WindowedELL.from_scipy(Ap, device=CPU), JWELL.from_scipy(Ap)
    elif fmt == "csr":
        At, Aj = CSR.from_scipy(Ap, device=CPU), JCSR.from_scipy(Ap)
    else:
        At, Aj = t(Ap.toarray()), jnp.asarray(Ap.toarray())
    assert_close_to(matmul.spmv(At, t(x)).numpy(), np.asarray(jmatmul.spmv(Aj, jnp.asarray(x))))
    yt = matmul.spmv_affine(At, t(x), c=t(c), alpha=-1.0).numpy()
    yj = np.asarray(jmatmul.spmv_affine(Aj, jnp.asarray(x), c=jnp.asarray(c), alpha=-1.0))
    assert_close_to(yt, yj)
    assert_close_to(yt, c - Ap.astype(np.float64) @ x)


def test_well_spmv_on_cpu_is_the_plain_version(rng):
    Ap = rcm_fem()
    W = WindowedELL.from_scipy(Ap, device=CPU)
    x = t(rng.randn(Ap.shape[0]).astype(np.float32))
    before = LAUNCHES["well_spmv"]
    torch.testing.assert_close(well_spmv(W, x, x, -2.0),
                               well_spmv_reference(W, x, x, -2.0), rtol=0, atol=0)
    assert LAUNCHES["well_spmv"] == before  # no kernel launch on the CPU


def test_csr_container_roundtrip_and_diagonal():
    A = fem_matrix(seed=5)
    C, J = CSR.from_scipy(A, device=CPU), JCSR.from_scipy(A)
    assert C.nnz_pad == J.nnz_pad and C.nnz == J.nnz and C.shape == J.shape
    np.testing.assert_array_equal(C.row.numpy(), np.asarray(J.row))
    np.testing.assert_array_equal(C.col.numpy(), np.asarray(J.col))
    np.testing.assert_array_equal(C.data.numpy(), np.asarray(J.data))
    np.testing.assert_array_equal(C.diagonal().numpy(), np.asarray(J.diagonal()))
    assert abs(C.to_scipy() - A).max() == 0
    np.testing.assert_array_equal(C.abs().data.numpy(), np.abs(np.asarray(J.data)))
    with pytest.raises(ValueError):
        C.with_data(C.data[:-1])


# ---------------------------------------------------------------------------
# Segment reductions and the graph layer: order-free, so exactly equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("op", ["segment_min", "segment_max"])
def test_segment_reductions_match_jax(rng, op, dtype):
    data = (rng.randn(200) * 50).astype(dtype)
    ids = rng.randint(0, 20, size=200)  # segments 20..29 stay empty
    ids[::11] = 40  # out of range: dropped
    got = getattr(segment, op)(t(data), t(ids.astype(np.int64)), 30).numpy()
    want = np.asarray(getattr(jax.ops, op)(jnp.asarray(data), jnp.asarray(ids), num_segments=30))
    empty = np.arange(20, 30)
    if np.issubdtype(dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    else:  # identities differ by index width: compare the live segments
        live = np.setdiff1d(np.arange(30), empty)
        np.testing.assert_array_equal(got[live], want[live])
        assert (got[empty] == np.iinfo(got.dtype).max if op == "segment_min"
                else got[empty] == np.iinfo(got.dtype).min).all()


@pytest.fixture(scope="module")
def hull_strength():
    A = rcm_fem(1500, seed=3)
    return A


@pytest.mark.parametrize("kind", ["abs", "unit", "invabs"])
def test_strength_measure_matches_jax(hull_strength, kind):
    A = hull_strength
    Ct = strength_measure(CSR.from_scipy(A, dtype=torch.float64, device=CPU), kind)
    Cj = jstrength(JCSR.from_scipy(A, dtype=jnp.float64), kind)
    np.testing.assert_array_equal(Ct.data.numpy(), np.asarray(Cj.data))


def test_strength_evolution_not_ported_yet(hull_strength):
    """Ported since: the evolution measures need the row-degree width and
    then equal JAX's on the hull."""
    A = hull_strength
    C = CSR.from_scipy(A, dtype=torch.float64, device=CPU)
    w = int(np.diff(sp.csr_matrix(A).indptr).max())
    for kind in ("evolution", "olson"):
        with pytest.raises(ValueError, match="width"):
            strength_measure(C, kind)
        want = jstrength(JCSR.from_scipy(A, dtype=jnp.float64), kind, width=w)
        np.testing.assert_allclose(strength_measure(C, kind, width=w).data.numpy(),
                                   np.asarray(want.data), rtol=1e-11, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bellman_ford_matches_jax_exactly(hull_strength, dtype):
    A = hull_strength
    n = A.shape[0]
    Ct = strength_measure(CSR.from_scipy(A, dtype=getattr(torch, dtype), device=CPU), "abs")
    Cj = jstrength(JCSR.from_scipy(A, dtype=getattr(jnp, dtype)), "abs")
    centers = np.unique(np.linspace(0, n - 1, n // 10).round().astype(np.int64))
    dt, nt = tbf.bellman_ford(Ct, t(centers))
    dj, nj = j_bellman_ford(Cj, jnp.asarray(centers, jnp.int32))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    at = tbf.nearest_center_to_agg(t(centers), nt)
    aj = j_nearest_center_to_agg(jnp.asarray(centers, jnp.int32), nj)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_bellman_ford_unreachable_nodes_get_sentinels():
    # two components; the only center sits in the first
    A = sp.block_diag([sp.diags([1.0, 1.0], [-1, 1], shape=(4, 4))] * 2).tocsr()
    C = CSR.from_scipy(A, device=CPU)
    dist, near = tbf.bellman_ford(C, torch.tensor([0]))
    assert torch.isinf(dist[4:]).all() and (near[4:] == 8).all()
    assert (near[:4] == 0).all()
    agg = tbf.nearest_center_to_agg(torch.tensor([0]), near)
    assert (agg[4:] == 1).all() and (agg[:4] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lloyd_aggregation_stride_seeds_matches_jax(hull_strength, dtype):
    A = hull_strength
    n = A.shape[0]
    Ct = strength_measure(CSR.from_scipy(A, dtype=getattr(torch, dtype), device=CPU), "abs")
    Cj = jstrength(JCSR.from_scipy(A, dtype=getattr(jnp, dtype)), "abs")
    seeds = np.unique(np.linspace(0, n - 1, int(np.ceil(0.2 * n))).round().astype(np.int32))
    at, rt, st = tlloyd.lloyd_aggregation(Ct, maxiter=5, seeds=seeds)
    aj, rj, sj = jlloyd.lloyd_aggregation(Cj, maxiter=5, seeds=seeds)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_segment_argmax_tie_break_and_empty_segment():
    vals = torch.tensor([1.0, 3.0, 3.0, 2.0, 5.0])
    seg = torch.tensor([0, 0, 0, 1, 1])
    node = torch.arange(5)
    got = tlloyd._segment_argmax(vals, seg, node, 3)
    want = jlloyd._segment_argmax(jnp.asarray(vals.numpy()), jnp.asarray(seg.numpy()),
                                  jnp.asarray(node.numpy()), 3)
    assert got[:2].tolist() == [1, 4] == np.asarray(want)[:2].tolist()
    assert int(got[2]) >= 5 and int(np.asarray(want)[2]) >= 5


@pytest.mark.parametrize("distance", ["unit", "abs", "inv", "same", "sub"])
def test_lloyd_distance_matches_jax(hull_strength, distance):
    A = hull_strength
    Ct = tlloyd.lloyd_distance(CSR.from_scipy(A, dtype=torch.float64, device=CPU), distance)
    Cj = jlloyd.lloyd_distance(JCSR.from_scipy(A, dtype=jnp.float64), distance)
    np.testing.assert_array_equal(Ct.data.numpy(), np.asarray(Cj.data))


def test_lloyd_random_seeds_follow_the_generator(hull_strength):
    """The generator is a jax.random key now: the seeds are
    permutation(key, n)[:k], JAX's draw bit for bit."""
    from mlamg_torch.utils import prng

    C = strength_measure(CSR.from_scipy(hull_strength, device=CPU), "abs")
    runs = [tlloyd.lloyd_aggregation(C, ratio=0.1, maxiter=2, key=prng.PRNGKey(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0][2], runs[1][2]) and not torch.equal(runs[0][2], runs[2][2])
    Cj = jstrength(JCSR.from_scipy(hull_strength, dtype=jnp.float32), "abs")
    _, _, seeds_j = jlloyd.lloyd_aggregation(Cj, ratio=0.1, maxiter=2, key=jax.random.PRNGKey(1))
    np.testing.assert_array_equal(runs[0][2].numpy(), np.asarray(seeds_j))
    assert runs[0][2].shape[0] == int(np.ceil(0.1 * hull_strength.shape[0]))
    assert int(runs[0][0].max()) < runs[0][2].shape[0]
