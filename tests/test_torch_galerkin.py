"""Port parity, the sparse Galerkin setup: ``rap_masked``, ``rap_learned``,
``build_unstructured_hierarchy(rap_mode="device")`` (one and two
smoothing steps, the wide-level scipy branch, strength and Lloyd on the
CPU), ``build_hierarchy(sparse_levels=1)``, ``AggOp`` and the CSR
``factored_sa``, ``mlamg_torch`` against ``mlamg_tpu`` on the same numpy
inputs (CPU), on the JAX tests' 1500-node random hull.

Tolerances: float64 products 1e-12 relative (the sums run in another
order); the float32 hierarchies 1e-5 relative against JAX's (its masked
sums run in XLA's order), and 1e-4 between the device and host products,
JAX's own bound (``tests/test_amg_unstructured.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.graph.lloyd import lloyd_aggregation as j_lloyd
from mlamg_tpu.graph.strength import strength_measure as j_strength
from mlamg_tpu.mg import amg_unstructured as jamg
from mlamg_tpu.mg import cycle as jcycle
from mlamg_tpu.mg import factored as jfac
from mlamg_tpu.mg.interp import sa_omega as j_sa_omega
from mlamg_tpu.mg.interp import smoothed_aggregation as j_smoothed_aggregation
from mlamg_tpu.ops.sparse import CSR as JCSR

from mlamg_torch.mg import amg_unstructured as tamg
from mlamg_torch.mg import cycle, factored
from mlamg_torch.mg.interp import sa_interpolation_dense, smoothed_aggregation
from mlamg_torch.ops.dia import DIA
from mlamg_torch.ops.sparse import CSR

CPU = "cpu"
F64 = torch.float64
# tests/test_amg_unstructured.py::TestRapModes
RAP_BUILD = dict(alpha=0.1, max_levels=3, min_coarse=80, lloyd_maxiter=10, fmt="csr", seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's products here are thousands of small tensor ops: under
    pytest's parallel workers, torch's default of one thread per core
    oversubscribes the CPU and slows them several times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def rel_gap(a, b) -> float:
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return float(abs(a - b).max() / abs(b).max())


def poisson2d(nx):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


@pytest.fixture(scope="module")
def hull_grid():
    return sp.csr_matrix(JGrid.random_2d_unstructured(1500, seed=3).A).astype(np.float32)


@pytest.fixture(scope="module")
def jax_device_hierarchies(hull_grid):
    """JAX's rap_mode="device" hierarchies, one and two smoothing steps."""
    return {s: jamg.build_unstructured_hierarchy(hull_grid, rap_mode="device",
                                                 smooth_steps=s, **RAP_BUILD)
            for s in (1, 2)}


def level_ops(h):
    return [lev.A.to_scipy() for lev in h.levels]


def test_rap_masked_matches_jax_and_scipy(hull_grid):
    """SA's P (the same aggregates, float64) through both packages'
    rap_masked: within 1e-12 of JAX's and 1e-10 of scipy's P^T A P."""
    A = hull_grid.astype(np.float64)
    Aj = JCSR.from_scipy(A, dtype=jnp.float64)
    At = CSR.from_scipy(A, dtype=F64, device=CPU)
    w = int(np.diff(A.indptr).max())
    agg_id, _, _ = j_lloyd(j_strength(Aj, "abs", width=w), ratio=0.1, maxiter=3,
                           key=jax.random.PRNGKey(0))
    agg = np.asarray(agg_id)
    k = int(agg.max()) + 1
    d = np.asarray(A.diagonal())
    om = float(j_sa_omega(Aj, jnp.asarray(1.0 / d)))
    Pj = j_smoothed_aggregation(Aj, jnp.asarray(agg, jnp.int32), k, omega=om)
    Pt = smoothed_aggregation(At, t(agg).long(), k, omega=om)
    _, APpat, AHpat = jamg.galerkin_patterns(A, agg, k)
    widths = dict(a_width=w, p_width=w,
                  pt_width=int(np.bincount(agg[A.tocoo().col], minlength=k).max()),
                  ap_width=int(np.diff(APpat.indptr).max()))
    got = tamg.rap_masked(At, Pt, CSR.from_scipy(APpat, dtype=F64, device=CPU),
                          CSR.from_scipy(AHpat, dtype=F64, device=CPU), **widths)
    want = jamg.rap_masked(Aj, Pj, JCSR.from_scipy(APpat, dtype=jnp.float64),
                           JCSR.from_scipy(AHpat, dtype=jnp.float64), **widths)
    assert rel_gap(got.to_scipy(), want.to_scipy()) <= 1e-12
    Psp = Pt.to_scipy()
    Psp.sum_duplicates()
    assert rel_gap(got.to_scipy(), Psp.T @ A @ Psp) <= 1e-10


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rap_learned_matches_jax_and_scipy(hull_grid, dtype):
    """A random P-hat on A's coordinates with random aggregates (JAX's own
    test): duplicate (row, agg[col]) coordinates sum.  Against the float64
    scipy oracle within 2e-4 (JAX's bound) in float32, 1e-10 in float64;
    against JAX within 1e-5 / 1e-12 relative."""
    A = hull_grid.astype(dtype)
    n = A.shape[0]
    rng = np.random.RandomState(5)
    agg = rng.randint(0, n // 10, size=n).astype(np.int64)
    k = int(agg.max()) + 1
    coo = A.tocoo()
    phat = rng.randn(A.nnz).astype(dtype)
    jdt, tdt = jnp.dtype(dtype), (F64 if dtype == np.float64 else torch.float32)
    Aj = JCSR.from_scipy(A, dtype=jdt)
    At = CSR.from_scipy(A, dtype=tdt, device=CPU)
    data = np.concatenate([phat, np.zeros(At.nnz_pad - A.nnz, dtype)])
    Pj = JCSR(jnp.asarray(data), Aj.row, jnp.asarray(agg[np.asarray(Aj.col)].astype(np.int32)),
              Aj.indptr, (n, k), Aj.nnz)
    Pt = CSR(t(data), At.row, t(agg)[At.col], At.indptr, (n, k), At.nnz)
    P_sp = sp.csr_matrix((phat.astype(np.float64), (coo.row, agg[coo.col])), shape=(n, k))
    P_sp.sum_duplicates()
    oracle = (P_sp.T @ (A.astype(np.float64) @ P_sp)).toarray()
    got = tamg.rap_learned(At, Pt, A, agg, k).to_scipy().toarray()
    want = jamg.rap_learned(Aj, Pj, A, agg, k).to_scipy().toarray()
    if dtype == np.float32:
        np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
        assert rel_gap(got, want) <= 1e-5
    else:
        assert rel_gap(got, oracle) <= 1e-10 and rel_gap(got, want) <= 1e-12


@pytest.mark.parametrize("smooth_steps", [1, 2])
def test_device_hierarchy_matches_jax(hull_grid, jax_device_hierarchies, smooth_steps):
    """rap_mode="device" against JAX's: the same permutation, aggregates
    and sizes on every level, level operators and the coarse solve within
    1e-5 relative (float32), every level on the masked branch."""
    hj, perm_j = jax_device_hierarchies[smooth_steps]
    prof: dict = {}
    ht, perm_t = tamg.build_unstructured_hierarchy(
        hull_grid, rap_mode="device", smooth_steps=smooth_steps, device=CPU,
        profile_out=prof, **RAP_BUILD)
    np.testing.assert_array_equal(perm_t, perm_j)
    assert [lev.k for lev in ht.levels] == [lev.k for lev in hj.levels]
    for lt, lj in zip(ht.levels, hj.levels):
        np.testing.assert_array_equal(lt.agg.numpy(), np.asarray(lj.agg))
        np.testing.assert_allclose(np.asarray(lt.omegas), np.asarray(lj.omegas), rtol=0, atol=0)
    for At, Aj in zip(level_ops(ht), level_ops(hj)):
        assert rel_gap(At, Aj) <= 1e-5
    lu_j = np.asarray(hj.coarse.lu)
    assert np.abs(ht.coarse.lu.numpy() - lu_j).max() <= 1e-5 * np.abs(lu_j).max()
    assert prof["rap_branch"] == ["masked"] * len(ht.levels)
    assert all(r["pt_width"] * r["ap_width"] <= tamg.WIDE_SLOTS for r in prof["rap_levels"])


@pytest.mark.parametrize("smooth_steps", [1, 2])
def test_device_hierarchy_matches_host_within_jax_bound(hull_grid, smooth_steps):
    """Inside the port: the device product's levels within 1e-4 of the
    host product's (JAX's bound), with equal aggregates; strength and
    Lloyd on the CPU (setup_device="cpu") build the same hierarchy."""
    kw = dict(RAP_BUILD, smooth_steps=smooth_steps, device=CPU)
    prof: dict = {}
    hh, perm_h = tamg.build_unstructured_hierarchy(hull_grid, rap_mode="host", profile_out=prof,
                                                   **kw)
    hd, perm_d = tamg.build_unstructured_hierarchy(hull_grid, rap_mode="device", **kw)
    hc, _ = tamg.build_unstructured_hierarchy(hull_grid, rap_mode="device", setup_device="cpu",
                                              **kw)
    assert prof["rap_branch"] == ["host"] * len(hh.levels)
    np.testing.assert_array_equal(perm_h, perm_d)
    for lh, ld, lc in zip(hh.levels, hd.levels, hc.levels):
        assert lh.k == ld.k
        np.testing.assert_array_equal(lh.agg.numpy(), ld.agg.numpy())
        np.testing.assert_array_equal(lc.agg.numpy(), ld.agg.numpy())
        assert rel_gap(ld.A.to_scipy(), lh.A.to_scipy()) <= 1e-4
        assert abs(lc.A.to_scipy() - ld.A.to_scipy()).max() == 0


def test_wide_levels_take_the_scipy_product(hull_grid, jax_device_hierarchies, monkeypatch):
    """A level past WIDE_SLOTS reads P back and forms P^T A P in scipy:
    every level on that branch, still within 1e-5 of JAX's masked
    products."""
    monkeypatch.setattr(tamg, "WIDE_SLOTS", 0)
    prof: dict = {}
    ht, _ = tamg.build_unstructured_hierarchy(hull_grid, rap_mode="device", device=CPU,
                                              profile_out=prof, **RAP_BUILD)
    hj, _ = jax_device_hierarchies[1]
    assert prof["rap_branch"] == ["wide"] * len(ht.levels)
    for lt, lj in zip(ht.levels, hj.levels):
        np.testing.assert_array_equal(lt.agg.numpy(), np.asarray(lj.agg))
    for At, Aj in zip(level_ops(ht), level_ops(hj)):
        assert rel_gap(At, Aj) <= 1e-5


def test_setup_options_are_checked(hull_grid):
    for kw in (dict(rap_mode="gpu"), dict(setup_device="tpu")):
        with pytest.raises(ValueError, match="unknown"):
            tamg.build_unstructured_hierarchy(hull_grid, device=CPU, **kw)


def test_sparse_levels_hierarchy_matches_jax_and_solves(rng):
    """build_hierarchy(sparse_levels=1) on the 16^2 Poisson (JAX's test):
    the CSR coarse level, its P and the coarsest LU equal JAX's (1e-12
    relative), and vcycle_solve recovers x* to 1e-6."""
    A = poisson2d(16)
    n = A.shape[0]
    w = int(np.diff(A.indptr).max())
    kw = dict(alpha=0.15, max_levels=3, min_coarse=8, width=w, sparse_levels=1)
    hj = jcycle.build_hierarchy(JCSR.from_scipy(A, dtype=jnp.float64), **kw)
    ht = cycle.build_hierarchy(CSR.from_scipy(A, dtype=F64, device=CPU), **kw)
    assert isinstance(ht.As[1], CSR) and isinstance(ht.Ps[0], CSR) and len(ht.As) == len(hj.As)
    for name in ("row", "col", "indptr"):
        np.testing.assert_array_equal(getattr(ht.As[1], name).numpy(),
                                      np.asarray(getattr(hj.As[1], name)))
    assert rel_gap(ht.As[1].to_scipy(), hj.As[1].to_scipy()) <= 1e-12
    assert rel_gap(ht.Ps[0].to_scipy(), hj.Ps[0].to_scipy()) <= 1e-12
    lu_j = np.asarray(hj.coarse.lu)
    assert np.abs(ht.coarse.lu.numpy() - lu_j).max() <= 1e-12 * np.abs(lu_j).max()
    x_star = rng.randn(n)
    x, conv, err, iters = cycle.vcycle_solve(ht, t(A @ x_star), torch.zeros(n, dtype=F64),
                                             res_tol=1e-8)
    assert np.linalg.norm(x.numpy() - x_star) / np.linalg.norm(x_star) < 1e-6
    _, conv_j, _, iters_j = jcycle.vcycle_solve(hj, jnp.asarray(A @ x_star), jnp.zeros(n),
                                                res_tol=1e-8)
    assert iters == int(iters_j) and abs(conv - float(conv_j)) < 1e-6


def test_agg_op_matches_jax(rng):
    agg = np.array([0, 1, 1, 5, 0])  # node 3 unassigned (k = 2)
    Tt, Tj = factored.AggOp(t(agg), n=5, k=2), jfac.AggOp(jnp.asarray(agg, jnp.int32), n=5, k=2)
    assert Tt.shape == Tj.shape == (5, 2)
    np.testing.assert_array_equal(Tt.interp(t([2.0, 3.0])).numpy(), [2.0, 3.0, 3.0, 0.0, 2.0])
    for e, v in ((rng.randn(2), rng.randn(5)), (rng.randn(2, 3), rng.randn(5, 3))):
        np.testing.assert_array_equal(Tt.interp(t(e)).numpy(), np.asarray(Tj.interp(jnp.asarray(e))))
        np.testing.assert_allclose(Tt.restrict(t(v)).numpy(),
                                   np.asarray(Tj.restrict(jnp.asarray(v))), rtol=0, atol=1e-15)


@pytest.mark.parametrize("smooth_steps", [1, 2])
def test_csr_factored_sa_matches_jax(rng, smooth_steps):
    """factored_sa on a CSR over an AggOp (tests/test_factored.py's 32^2
    Poisson, 4x4 boxes): the CSR factors, interp, restrict, the dense P
    (= sa_interpolation_dense for one step) and coarse_operator_factored
    equal JAX's (1e-12)."""
    nx, side = 32, 4
    A = poisson2d(nx)
    iy, ix = np.divmod(np.arange(nx * nx), nx)
    agg = (iy // side) * (nx // side) + ix // side
    k = int(agg.max()) + 1
    Aj = JCSR.from_scipy(A, dtype=jnp.float64)
    At = CSR.from_scipy(A, dtype=F64, device=CPU)
    kw = dict(omega=0.65) if smooth_steps == 1 else dict(lmax=1.9)
    Pj = jfac.factored_sa(Aj, jfac.AggOp(jnp.asarray(agg), n=nx * nx, k=k),
                          smooth_steps=smooth_steps,
                          **{key: jnp.float64(v) for key, v in kw.items()})
    Pt = factored.factored_sa(At, factored.AggOp(t(agg), n=nx * nx, k=k),
                              smooth_steps=smooth_steps, **kw)
    assert Pt.smooth_steps == smooth_steps and all(isinstance(S, CSR) for S in Pt.Ss + Pt.Sts)
    for S, Sj in zip(Pt.Ss + Pt.Sts, Pj.Ss + Pj.Sts):
        assert abs(S.to_scipy() - Sj.to_scipy()).max() <= 1e-12
    e, r = rng.randn(k), rng.randn(nx * nx)
    np.testing.assert_allclose(Pt.interp(t(e)).numpy(), np.asarray(Pj.interp(jnp.asarray(e))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(Pt.restrict(t(r)).numpy(),
                               np.asarray(Pj.restrict(jnp.asarray(r))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Pt.densify().numpy(), np.asarray(Pj.densify()), rtol=0, atol=1e-12)
    if smooth_steps == 1:
        dense = sa_interpolation_dense(At, t(agg), k, omega=0.65)
        np.testing.assert_allclose(Pt.densify().numpy(), dense.numpy(), rtol=0, atol=1e-12)
    got = factored.coarse_operator_factored(At, Pt, block=40)
    want = np.asarray(jfac.coarse_operator_factored(Aj, Pj, block=40))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    # the same P over BoxAgg2D's structured aggregates and a DIA operator
    box = factored.factored_sa(DIA.from_scipy(A, dtype=F64, device=CPU),
                               factored.BoxAgg2D(nx, nx, side, side), smooth_steps=smooth_steps,
                               **kw)
    np.testing.assert_allclose(box.interp(t(e)).numpy(), Pt.interp(t(e)).numpy(), rtol=0,
                               atol=1e-12)
