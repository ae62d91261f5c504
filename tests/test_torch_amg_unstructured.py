"""Multilevel layer parity: smoothers, coarse solver, conv readout, the
unstructured SA-AMG hierarchy and its cycle, ``mlamg_torch`` against
``mlamg_tpu`` on the same numpy inputs (CPU, float32 where the JAX
package's hierarchy runs in float32)."""

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp
import pytest
import torch

from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.mg import amg_unstructured as jamg
from mlamg_tpu.mg.coarse import CoarseSolver as JCoarse
from mlamg_tpu.mg.cycle import _conv_factor as j_conv_factor
from mlamg_tpu.mg.smoothers import chebyshev as j_chebyshev
from mlamg_tpu.mg.smoothers import jacobi as j_jacobi
from mlamg_tpu.ops.sparse import CSR as JCSR

from mlamg_torch.convert import uhierarchy_from_numpy
from mlamg_torch.mg import amg_unstructured as tamg
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.cycle import _conv_factor
from mlamg_torch.mg.smoothers import chebyshev, jacobi
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.ops.unstructured import WindowedELL

CPU = "cpu"
# the kwargs of tests/test_amg_unstructured.py::test_wcycle_converges
BUILD = dict(alpha=0.2, max_levels=4, min_coarse=60, lloyd_maxiter=5)
SOLVE = dict(res_tol=1e-7, max_iter=60, nu=3, lmin_frac=1 / 15, gamma=2)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def hull_grid():
    return sp.csr_matrix(JGrid.random_2d_unstructured(1500, seed=3).A).astype(np.float32)


@pytest.fixture(scope="module")
def jax_hierarchy(hull_grid):
    return jamg.build_unstructured_hierarchy(hull_grid, fmt="csr", **BUILD)


@pytest.fixture(scope="module")
def jax_solve(hull_grid, jax_hierarchy):
    h, _ = jax_hierarchy
    n = hull_grid.shape[0]
    x0 = jnp.asarray(np.random.RandomState(0).randn(n).astype(np.float32))
    x, conv, err, iters = jax.jit(
        lambda h, b, x: jamg.uvcycle_solve(h, b, x, **SOLVE)
    )(h, jnp.zeros(n, jnp.float32), x0)
    return float(conv), int(iters)


def jax_hierarchy_numpy(h):
    """What np.asarray pulls out of a JAX UHierarchy (fmt='csr')."""
    levels = [
        dict(A=lev.A.to_scipy(), Dinv=np.asarray(lev.Dinv), agg=np.asarray(lev.agg),
             omegas=np.asarray(lev.omegas), lmax=np.asarray(lev.lmax), k=lev.k)
        for lev in h.levels
    ]
    coarse = dict(lu=np.asarray(h.coarse.lu), piv=np.asarray(h.coarse.piv),
                  singular=h.coarse.singular, method=h.coarse.method)
    return levels, coarse


def level_scipy(A):
    if isinstance(A, CSR):
        return A.to_scipy()
    W = A  # WindowedELL: rebuild from slot-major values and absolute columns
    n = W.shape[0]
    rows = np.broadcast_to(np.arange(W.n_pad), (W.width, W.n_pad))
    keep = (W.data.numpy() != 0) & (rows < n)
    return sp.csr_matrix(
        (W.data.numpy()[keep], (rows[keep], W.col.numpy()[keep])), shape=W.shape
    )


# ---------------------------------------------------------------------------
# Smoothers, coarse solver, conv readout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["csr", "well"])
def test_chebyshev_matches_jax(hull_grid, rng, fmt):
    A = hull_grid
    n = A.shape[0]
    b = rng.randn(n).astype(np.float32)
    x = rng.randn(n).astype(np.float32)
    d = A.diagonal()
    Dinv = (1.0 / d).astype(np.float32)
    lmax = float(np.abs(A).sum(1).max() / d.min())
    At = (CSR.from_scipy(A, device=CPU) if fmt == "csr"
          else WindowedELL.from_scipy(A, device=CPU))
    yt = chebyshev(At, t(b), t(x), lmax, lmin_frac=1 / 15, degree=5, Dinv=t(Dinv))
    yj = j_chebyshev(JCSR.from_scipy(A, dtype=jnp.float32), jnp.asarray(b),
                     jnp.asarray(x), jnp.float32(lmax), lmin_frac=1 / 15, degree=5,
                     Dinv=jnp.asarray(Dinv))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(yj)).max())


def test_jacobi_matches_jax(hull_grid, rng):
    A = hull_grid
    n = A.shape[0]
    b = rng.randn(n).astype(np.float32)
    x = rng.randn(n).astype(np.float32)
    yt = jacobi(CSR.from_scipy(A, device=CPU), t(b), t(x), omega=0.6, nu=3)
    yj = j_jacobi(JCSR.from_scipy(A, dtype=jnp.float32), jnp.asarray(b),
                  jnp.asarray(x), omega=0.6, nu=3)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(yj)).max())


@pytest.mark.parametrize("method", ["lu", "inverse"])
@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("rhs_cols", [0, 3])
def test_coarse_solver_matches_jax(rng, method, singular, rhs_cols):
    k = 40
    M = rng.randn(k, k)
    A = (M @ M.T + k * np.eye(k)).astype(np.float32)
    if singular:  # Neumann-like: rows sum to zero
        A = (A - np.diag(A.sum(1))).astype(np.float32)
        A = -A
    shape = (k,) if rhs_cols == 0 else (k, rhs_cols)
    r = rng.randn(*shape).astype(np.float32)
    if singular:
        r -= r.mean(0)
    et = CoarseSolver.factor(t(A), singular=singular, method=method).solve(t(r))
    ej = JCoarse.factor(jnp.asarray(A), singular=singular, method=method).solve(jnp.asarray(r))
    assert et.shape == tuple(np.asarray(ej).shape)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ej)).max())


HISTORIES = {
    "geometric": (0.5 ** np.arange(20), 20),
    "partial": (np.concatenate([0.3 ** np.arange(9), np.zeros(11)]), 9),
    "short": (0.5 ** np.arange(20), 5),
    "six": (0.7 ** np.arange(20), 6),
    "nan": (np.concatenate([0.5 ** np.arange(7), [np.nan]]), 8),
    "inf_base": (np.concatenate([[np.inf], 0.5 ** np.arange(9)]), 10),
    "zero_base": (np.zeros(12), 12),
    "none": (np.zeros(5), 0),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_conv_factor_matches_jax(name, dtype):
    err, iters = HISTORIES[name]
    err = err.astype(dtype)
    got = _conv_factor(t(err), iters)
    want = float(j_conv_factor(jnp.asarray(err), jnp.int32(iters)))
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-6, abs=0)


# ---------------------------------------------------------------------------
# Hierarchy and cycle
# ---------------------------------------------------------------------------


def test_galerkin_patterns_and_truncation_match_jax(hull_grid):
    A = hull_grid
    n = A.shape[0]
    agg = np.arange(n) // 7
    k = int(agg.max()) + 1
    for pt, pj in zip(tamg.galerkin_patterns(A, agg, k, smooth_steps=2),
                      jamg.galerkin_patterns(A, agg, k, smooth_steps=2)):
        assert abs(pt - pj).max() == 0 and pt.nnz == pj.nnz
    for mode in ("drop", "lump_clip"):
        Bt, Bj = tamg.truncate_lump(A, 0.3, mode), jamg.truncate_lump(A, 0.3, mode)
        assert Bt.nnz == Bj.nnz and abs(Bt - Bj).max() == 0


@pytest.mark.parametrize("fmt", ["well", "csr"])
def test_hierarchy_matches_jax(hull_grid, jax_hierarchy, jax_solve, fmt):
    hj, pj = jax_hierarchy
    ht, pt = tamg.build_unstructured_hierarchy(hull_grid, fmt=fmt, device=CPU, **BUILD)
    np.testing.assert_array_equal(pt, pj)
    assert ht.num_levels == hj.num_levels
    for lt, lj in zip(ht.levels, hj.levels):
        assert lt.k == lj.k
        np.testing.assert_array_equal(lt.agg.numpy(), np.asarray(lj.agg))
        At, Aj = level_scipy(lt.A), lj.A.to_scipy()
        assert abs(At - Aj).max() <= 1e-6 * abs(Aj).max()
        np.testing.assert_allclose(lt.omegas, np.asarray(lj.omegas), rtol=1e-6)
        np.testing.assert_allclose(lt.lmax, float(lj.lmax), rtol=1e-6)
        np.testing.assert_allclose(lt.Dinv.numpy(), np.asarray(lj.Dinv), rtol=1e-6)
    np.testing.assert_allclose(ht.coarse.lu.numpy(), np.asarray(hj.coarse.lu),
                               rtol=1e-4, atol=1e-4 * np.abs(np.asarray(hj.coarse.lu)).max())

    n = hull_grid.shape[0]
    x0 = t(np.random.RandomState(0).randn(n).astype(np.float32))
    _, conv, err, iters = tamg.uvcycle_solve(ht, torch.zeros(n), x0, **SOLVE)
    conv_j, iters_j = jax_solve
    assert abs(conv - conv_j) <= 1e-3, (conv, conv_j)
    assert abs(iters - iters_j) <= 1, (iters, iters_j)
    assert conv < 0.45  # the JAX test's bar for this configuration
    assert bool(torch.isfinite(err[:iters]).all())


@pytest.mark.parametrize("smoother,gamma", [("chebyshev", 2), ("chebyshev", 1), ("jacobi", 2)])
@pytest.mark.parametrize("fmt", ["well", "csr"])
def test_cycle_on_carried_state_matches_jax(hull_grid, jax_hierarchy, fmt, smoother, gamma):
    hj, _ = jax_hierarchy
    levels, coarse = jax_hierarchy_numpy(hj)
    ht = uhierarchy_from_numpy(levels, coarse, fmt=fmt, device=CPU)
    n = hull_grid.shape[0]
    rng = np.random.RandomState(4)
    b = rng.randn(n).astype(np.float32)
    x = rng.randn(n).astype(np.float32)
    kw = dict(nu=3, lmin_frac=1 / 15, gamma=gamma, smoother=smoother)
    yt = tamg.uvcycle(ht, t(b), t(x), **kw).numpy()
    yj = np.asarray(jamg.uvcycle(hj, jnp.asarray(b), jnp.asarray(x), **kw))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-4 * np.abs(yj).max())


def test_factored_transfer_on_carried_state_matches_jax(jax_hierarchy):
    hj, _ = jax_hierarchy
    levels, coarse = jax_hierarchy_numpy(hj)
    ht = uhierarchy_from_numpy(levels, coarse, fmt="well", device=CPU)
    rng = np.random.RandomState(6)
    for lt, lj in zip(ht.levels, hj.levels):
        e = rng.randn(lt.k).astype(np.float32)
        r = rng.randn(lt.A.shape[0]).astype(np.float32)
        pe_t = tamg.interp_factored(lt, t(e)).numpy()
        pe_j = np.asarray(jamg.interp_factored(lj, jnp.asarray(e)))
        np.testing.assert_allclose(pe_t, pe_j, rtol=0, atol=1e-5 * np.abs(pe_j).max())
        rt = tamg.restrict_factored(lt, t(r)).numpy()
        rj = np.asarray(jamg.restrict_factored(lj, jnp.asarray(r)))
        np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-5 * np.abs(rj).max())


def test_carried_lu_coarse_solver_matches_jax(rng):
    k = 30
    M = rng.randn(k, k)
    A = (M @ M.T + k * np.eye(k)).astype(np.float32)
    cj = JCoarse.factor(jnp.asarray(A), method="lu")
    r = rng.randn(k).astype(np.float32)
    h = uhierarchy_from_numpy(
        [], dict(lu=np.asarray(cj.lu), piv=np.asarray(cj.piv), singular=False,
                 method="lu"), fmt="csr", device=CPU)
    np.testing.assert_allclose(h.coarse.solve(t(r)).numpy(),
                               np.asarray(cj.solve(jnp.asarray(r))), rtol=1e-5)


def test_solves_permuted_system(hull_grid):
    """x = unpermute(solve of the permuted system) solves the original."""
    A = hull_grid
    n = A.shape[0]
    h, perm = tamg.build_unstructured_hierarchy(
        A, alpha=0.1, max_levels=3, min_coarse=80, device=CPU)
    assert isinstance(h.levels[0].A, CSR)  # CPU default format
    rhs = np.random.RandomState(1).randn(n).astype(np.float32)
    x, conv, err, iters = tamg.uvcycle_solve(
        h, t(rhs[perm]), torch.zeros(n), res_tol=1e-5, max_iter=80, nu=3,
        lmin_frac=1 / 15)
    sol = np.empty(n, np.float64)
    sol[perm] = x.numpy()
    res = np.linalg.norm(A.astype(np.float64) @ sol - rhs) / np.linalg.norm(rhs)
    assert res < 1e-4, res


def test_random_seed_mode_is_seeded(hull_grid):
    kw = dict(BUILD, seed_mode="random", fmt="csr", device=CPU)
    h1, _ = tamg.build_unstructured_hierarchy(hull_grid, seed=1, **kw)
    h2, _ = tamg.build_unstructured_hierarchy(hull_grid, seed=1, **kw)
    assert all(torch.equal(a.agg, b.agg) for a, b in zip(h1.levels, h2.levels))


def test_setup_rejects_asymmetric_and_unported_options(hull_grid):
    A = sp.csr_matrix(np.array([[2.0, -1.0], [0.0, 2.0]], np.float32))
    with pytest.raises(ValueError, match="symmetric"):
        tamg.build_unstructured_hierarchy(A, fmt="csr", device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tamg.build_unstructured_hierarchy(hull_grid, rap_mode="device", device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tamg.build_unstructured_hierarchy(hull_grid, strength_kind="olson", device=CPU)
