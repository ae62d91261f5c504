"""The evaluation path's operators, ``mlamg_torch`` against ``mlamg_tpu`` on
the same numpy inputs (CPU, float64): sparse products (and scipy), top-k
ties, power iteration and the evolution/olson strengths, pull-mode
Bellman-Ford, Lloyd from JAX's seeds, the greedy colouring, multicolor
Gauss-Seidel, smoothed aggregation and the two-level solve with each
smoother."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu.graph.bellman_ford import bellman_ford_pull as j_bellman_ford_pull
from mlamg_tpu.graph import lloyd as jlloyd
from mlamg_tpu.graph import strength as jstrength
from mlamg_tpu.graph.topk import topk_indices as j_topk_indices
from mlamg_tpu.graph.topk import topk_mask as j_topk_mask
from mlamg_tpu.mg import cycle as jcycle
from mlamg_tpu.mg import interp as jinterp
from mlamg_tpu.mg import smoothers as jsmoothers
from mlamg_tpu.ops import matmul as jmm
from mlamg_tpu.ops.sparse import CSR as JCSR

from mlamg_torch.data.grid import Grid
from mlamg_torch.graph import lloyd as tlloyd
from mlamg_torch.graph import strength as tstrength
from mlamg_torch.graph.topk import topk_indices, topk_mask
from mlamg_torch.mg import cycle as tcycle
from mlamg_torch.mg import interp as tinterp
from mlamg_torch.mg import smoothers as tsmoothers
from mlamg_torch.ops import matmul as tmm
from mlamg_torch.ops.segment import slot_sum, tree_sum
from mlamg_torch.ops.sparse import CSR, segment_slots

# the module: the package re-exports its function under the same name, as
# mlamg_tpu.graph does
tbf = importlib.import_module("mlamg_torch.graph.bellman_ford")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
F64 = torch.float64


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def pair(A, dtype=np.float64):
    A = sp.csr_matrix(A).astype(dtype)
    return JCSR.from_scipy(A, dtype=dtype), CSR.from_scipy(A, dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype, device=CPU)


@pytest.fixture(scope="module")
def grids():
    return {name: Grid.load_dir(os.path.join(REPO, "data_out", name, "test"))
            for name in ("2d_iso", "2d_aniso", "3d_iso")}


@pytest.fixture(scope="module")
def iso(grids):
    return grids["2d_iso"][2]  # n = 85


def assert_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


# ---------------------------------------------------------------------------
# sparse core
# ---------------------------------------------------------------------------


def random_csr(rng, m, n, density=0.15):
    A = sp.random(m, n, density=density, random_state=rng, format="csr")
    A.data = rng.randn(A.nnz)
    return A


@pytest.mark.parametrize("op", ["spmv", "spmv_t", "spmm", "spmm_t"])
@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_sparse_products_match_jax_and_scipy(rng, op, fmt):
    A = random_csr(rng, 40, 30)
    Aj, At = pair(A)
    if fmt == "ell":
        Aj, At = Aj.to_ell(), At.to_ell()
        np.testing.assert_array_equal(At.col.numpy(), np.asarray(Aj.col))
        np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))
    cols = {"spmv": 30, "spmv_t": 40, "spmm": 30, "spmm_t": 40}[op]
    X = rng.randn(cols) if op.startswith("spmv") else rng.randn(cols, 3)
    got = getattr(tmm, op)(At, t(X)).numpy()
    want = np.asarray(getattr(jmm, op)(Aj, jnp.asarray(X)))
    ref = (A.T if op.endswith("_t") else A) @ X
    assert_rel(got, want, 1e-14)
    assert_rel(got, ref, 1e-13)


def test_csr_spmv_adds_in_jax_order(iso):
    """CSR rows add their entries in entry order, as JAX's CPU segment_sum
    does: the float32 product is bit-equal."""
    Aj, At = pair(iso.A, np.float32)
    x = np.random.RandomState(1).randn(iso.n).astype(np.float32)
    np.testing.assert_array_equal(tmm.spmv(At, t(x)).numpy(), np.asarray(jmm.spmv(Aj, jnp.asarray(x))))


def test_slots_list_each_segment_in_entry_order():
    ids = torch.tensor([2, 0, 2, 5, 1, 2, 9])  # 9: dropped (>= 6)
    slots = segment_slots(ids, 6)
    assert slots.tolist() == [[1, 7, 7], [4, 7, 7], [0, 2, 5], [7, 7, 7], [7, 7, 7], [3, 7, 7]]
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0])
    assert slot_sum(vals, slots).tolist() == [2.0, 16.0, 37.0, 0.0, 0.0, 8.0]
    with pytest.raises(ValueError, match="width"):
        segment_slots(ids, 6, width=2)


def test_tree_sum_matches_jax_mean_bits():
    """The JAX package's CPU backend sums a long axis in windows of 32."""
    rng = np.random.RandomState(2)
    for n in (5, 33, 68, 250, 1872):
        for dtype in (np.float32, np.float64):
            X = rng.randn(n, 3).astype(dtype)
            want = np.asarray(jax.jit(lambda a: jnp.mean(a, axis=0))(X))
            got = (tree_sum(t(X)) * torch.tensor(1.0 / n, dtype=t(X).dtype))[0].numpy()
            np.testing.assert_array_equal(got, want)


def test_spgemm_masked_matches_jax_and_scipy(iso):
    A = sp.csr_matrix(iso.A)
    B = A.copy()
    B.data = np.random.RandomState(3).randn(B.nnz)
    w = int(np.diff(A.indptr).max())
    (Aj, At), (Bj, Bt) = pair(A), pair(B)
    got = tmm.spgemm_masked(At, Bt, At, a_width=w, b_width=w)
    want = jmm.spgemm_masked(Aj, Bj, Aj, a_width=w, b_width=w)
    assert_rel(got.data.numpy(), np.asarray(want.data), 1e-14)
    ref = (A @ B).multiply(A != 0)
    np.testing.assert_allclose(got.to_scipy().toarray(), ref.toarray(), rtol=0, atol=1e-12)


def test_rap_dense_sums_duplicate_coordinates(iso, rng):
    """A sparse P with duplicate (row, col) pairs (aggregate-remapped
    columns) densifies with the duplicates summed."""
    Aj, At = pair(iso.A)
    k = 9
    agg = rng.randint(0, k, size=iso.n)
    agg[:5] = k  # unassigned: their columns drop out
    vals = rng.randn(At.nnz_pad)
    Pt = tinterp.remap_columns(At, t(vals), t(agg), k)
    from mlamg_tpu.models.agg_interp import _phat_times_agg
    Pj = _phat_times_agg(Aj, jnp.asarray(vals), jnp.asarray(agg, jnp.int32), k)
    assert_rel(tmm.densify(Pt).numpy(), np.asarray(jmm.densify(Pj)), 1e-15)
    assert_rel(tmm.rap_dense(At, Pt).numpy(), np.asarray(jmm.rap_dense(Aj, Pj)), 1e-13)
    Ps = sp.csr_matrix((vals[:At.nnz] * (agg[iso.A.indices] < k),
                        (np.repeat(np.arange(iso.n), np.diff(iso.A.indptr)),
                         np.minimum(agg[iso.A.indices], k - 1))), shape=(iso.n, k))
    assert_rel(tmm.rap_dense(At, Pt).numpy(), (Ps.T @ iso.A @ Ps).toarray(), 1e-12)


# ---------------------------------------------------------------------------
# graph algorithms
# ---------------------------------------------------------------------------


def test_topk_breaks_ties_by_earliest_index():
    x = np.array([1.0, 3.0, 3.0, 0.0, 3.0, 2.0, 2.0, 0.0])
    for k in range(1, 9):
        np.testing.assert_array_equal(topk_indices(t(x), k).numpy(),
                                      np.asarray(j_topk_indices(jnp.asarray(x), k)))
        np.testing.assert_array_equal(topk_mask(t(x), k).numpy(),
                                      np.asarray(j_topk_mask(jnp.asarray(x), k)))
    zeros = np.zeros(50)  # FullAggNet's trained scores: all ties
    np.testing.assert_array_equal(topk_indices(t(zeros), 7).numpy(), np.arange(7))


@pytest.mark.parametrize("family", ["2d_iso", "2d_aniso", "3d_iso"])
def test_power_iteration_matches_jax(grids, family):
    A = grids[family][0].A
    Aj, At = pair(A)
    d = A.diagonal()
    got = tstrength.power_iteration_lmax(At, t(1.0 / d))
    want = jstrength.power_iteration_lmax(Aj, jnp.asarray(1.0 / d))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-13)


@pytest.mark.parametrize("kind", ["olson", "evolution"])
@pytest.mark.parametrize("family", ["2d_iso", "2d_aniso", "3d_iso"])
def test_strength_matches_jax(grids, family, kind):
    A = grids[family][1].A
    w = int(np.diff(A.indptr).max())
    Aj, At = pair(A)
    got = tstrength.strength_measure(At, kind, width=w).data.numpy()
    want = np.asarray(jstrength.strength_measure(Aj, kind, width=w).data)
    # lmax differs in its last bits (JAX's vdot adds in its own order) and
    # a small |Z_ij| amplifies that: the 3d grid's worst entry, also its
    # largest, is 1.83e-12 relative; the 2d grids' are below 1e-12
    np.testing.assert_allclose(got, want, rtol=1e-12 if family != "3d_iso" else 1e-11, atol=0)
    with pytest.raises(ValueError, match="width"):
        tstrength.strength_measure(At, kind)


@pytest.mark.parametrize("family", ["2d_iso", "2d_aniso", "3d_iso"])
def test_bellman_ford_pull_matches_jax_exactly(grids, family, rng):
    """Directed values on a symmetric pattern (the learned C's case)."""
    A = grids[family][3].A
    n = A.shape[0]
    C = sp.csr_matrix(A)
    C.data = rng.rand(C.nnz) + 0.1
    C.data[::7] = C.data[1::7][: len(C.data[::7])]  # equal weights: ties
    Cj, Ct = pair(C)
    centers = rng.choice(n, size=n // 10, replace=False)
    w = int(np.diff(C.indptr).max())
    dt, nt = tbf.bellman_ford_pull(Ct, t(centers), width=w)
    dj, nj = j_bellman_ford_pull(Cj, jnp.asarray(centers, jnp.int32), width=w)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    with pytest.raises(ValueError, match="width"):
        tbf.bellman_ford_pull(Ct, t(centers), width=w - 1)


def test_lloyd_draws_jax_seeds(iso):
    """Without seeds, Lloyd starts from permutation(PRNGKey(0), n)[:k]."""
    Aj, At = pair(iso.A)
    w = int(np.diff(iso.A.indptr).max())
    Ct = tstrength.strength_measure(At, "olson", width=w)
    Cj = jstrength.strength_measure(Aj, "olson", width=w)
    agg_t, roots_t, seeds_t = tlloyd.lloyd_aggregation(Ct, ratio=0.1, maxiter=10)
    agg_j, roots_j, seeds_j = jlloyd.lloyd_aggregation(Cj, ratio=0.1, maxiter=10)
    for a, b in ((seeds_t, seeds_j), (roots_t, roots_j), (agg_t, agg_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# smoothers, interpolation, two-level solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["2d_iso", "3d_iso"])
def test_greedy_coloring_is_jax_host_loop(grids, family):
    A = grids[family][0].A
    got = tsmoothers.greedy_coloring(A)
    np.testing.assert_array_equal(got, jsmoothers.greedy_coloring(A))
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    off = rows != A.indices
    assert (got[rows[off]] != got[A.indices[off]]).all()  # a proper colouring


@pytest.mark.parametrize("smoother", ["multicolor_gs", "l1_jacobi"])
def test_smoother_sweep_matches_jax(iso, rng, smoother):
    Aj, At = pair(iso.A)
    b, x = rng.randn(iso.n), rng.randn(iso.n)
    if smoother == "multicolor_gs":
        colors = jsmoothers.greedy_coloring(iso.A)
        nc = int(colors.max()) + 1
        got = tsmoothers.multicolor_gauss_seidel(At, t(b), t(x), t(colors.astype(np.int64)), nc)
        want = jsmoothers.multicolor_gauss_seidel(Aj, jnp.asarray(b), jnp.asarray(x),
                                                  jnp.asarray(colors), nc)
    else:
        got = tsmoothers.l1_jacobi(At, t(b), t(x))
        want = jsmoothers.l1_jacobi(Aj, jnp.asarray(b), jnp.asarray(x))
    assert_rel(got.numpy(), np.asarray(want), 1e-14)


def test_sa_interpolation_matches_jax(iso, rng):
    Aj, At = pair(iso.A)
    k = 9
    agg = rng.randint(0, k, size=iso.n)
    agg[3] = k  # an unassigned row is a zero row of the tentative P
    got = tinterp.sa_interpolation_dense(At, t(agg), k)
    want = jinterp.sa_interpolation_dense(Aj, jnp.asarray(agg, jnp.int32), k)
    assert_rel(got.numpy(), np.asarray(want), 1e-13)
    Ps_t = tinterp.smoothed_aggregation(At, t(agg), k)
    Ps_j = jinterp.smoothed_aggregation(Aj, jnp.asarray(agg, jnp.int32), k)
    assert_rel(tmm.densify(Ps_t).numpy(), np.asarray(jmm.densify(Ps_j)), 1e-13)
    assert_rel(tmm.densify(Ps_t).numpy(), got.numpy(), 1e-12)


@pytest.mark.parametrize("smoother", ["multicolor_gs", "jacobi", "chebyshev"])
@pytest.mark.parametrize("sparse_p", [False, True])
def test_twolevel_solve_matches_jax(iso, rng, smoother, sparse_p):
    """The evaluation's solve: b = 0, res_tol 1e-6; Chebyshev takes its
    lmax from power iteration; a sparse P runs through spmv/spmv_t."""
    Aj, At = pair(iso.A)
    k = 9
    agg = np.arange(iso.n) % k
    if sparse_p:
        Pt = tinterp.smoothed_aggregation(At, t(agg), k)
        Pj = jinterp.smoothed_aggregation(Aj, jnp.asarray(agg, jnp.int32), k)
    else:
        Pt = tinterp.sa_interpolation_dense(At, t(agg), k)
        Pj = jinterp.sa_interpolation_dense(Aj, jnp.asarray(agg, jnp.int32), k)
    colors = jsmoothers.greedy_coloring(iso.A)
    args = {"colors": colors, "num_colors": int(colors.max()) + 1}
    x0 = rng.randn(iso.n)
    x0 /= np.linalg.norm(x0)
    kw = dict(res_tol=1e-6, max_iter=300, smoother=smoother)
    _, conv_t, err_t, it_t = tcycle.twolevel_solve(
        At, Pt, torch.zeros(iso.n, dtype=F64), t(x0),
        smoother_args={"colors": t(colors.astype(np.int64)), "num_colors": args["num_colors"]},
        **kw)
    _, conv_j, err_j, it_j = jax.jit(lambda A, P, x: jcycle.twolevel_solve(
        A, P, jnp.zeros_like(x), x, smoother_args={"colors": jnp.asarray(colors),
                                                   "num_colors": args["num_colors"]}, **kw))(
        Aj, Pj, jnp.asarray(x0))
    assert it_t == int(it_j) > 3
    np.testing.assert_allclose(conv_t, float(conv_j), rtol=1e-9)
    assert_rel(err_t.numpy()[:it_t], np.asarray(err_j)[:it_t], 1e-9)
