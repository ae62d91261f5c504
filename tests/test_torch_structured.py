"""Port parity, structured all-DIA path: factored prolongators, the probed
Galerkin operator, the hierarchy, the V-cycle and the two-level solve of
``mlamg_torch`` against ``mlamg_tpu`` on the same numpy inputs (CPU).

The JAX cycles are jitted and the grids stay at 16^2-64^2, so the file
runs in seconds.  On the CPU every DIA SpMV of the port is the plain
version ``dia_spmv_reference``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu.mg import cycle as jcycle
from mlamg_tpu.mg import factored as jfac
from mlamg_tpu.mg.coarse import CoarseSolver as JCoarseSolver
from mlamg_tpu.mg.structured import build_structured_hierarchy as j_build
from mlamg_tpu.mg.structured import dia_galerkin_probe as j_probe
from mlamg_tpu.ops.dia import DIA as JDIA
from mlamg_tpu.ops.pallas_kernels import blocked_dia

from mlamg_torch.convert import hierarchy_from_numpy
from mlamg_torch.mg import cycle, factored
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.structured import (
    _decompose_offsets, build_structured_hierarchy, dia_galerkin_probe,
)
from mlamg_torch.ops.dia import DIA
from mlamg_torch.ops.sparse import CSR

CPU = "cpu"
F64 = torch.float64


def poisson2d(ny, nx=None, aniso=1.0):
    nx = ny if nx is None else nx
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    Tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (aniso * sp.kron(Ty, sp.eye(nx)) + sp.kron(sp.eye(ny), Tx)).tocsr()


def pair(A, dtype=np.float64):
    """(JAX DIA, port DIA) of one scipy matrix."""
    tdt = F64 if dtype == np.float64 else torch.float32
    return JDIA.from_scipy(A, dtype=jnp.dtype(dtype)), DIA.from_scipy(A, dtype=tdt, device=CPU)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def close(got, want, atol=1e-12, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def assert_dia_equal(At, Aj, atol=1e-12):
    assert At.offsets == tuple(Aj.offsets) and At.shape == tuple(Aj.shape)
    close(At.data, np.asarray(Aj.data2d), atol)


# ---------------------------------------------------------------------------
# Factored prolongators
# ---------------------------------------------------------------------------


def test_dia_transpose_matches_jax():
    A = poisson2d(16) + sp.diags(np.linspace(0.1, 1.0, 256), 2, shape=(256, 256))
    Aj, At = pair(A.tocsr())
    assert_dia_equal(factored.dia_transpose(At), jfac.dia_transpose(Aj), atol=0)


@pytest.mark.parametrize("batch", [False, True])
def test_box_agg_matches_jax(rng, batch):
    Tj, Tt = jfac.BoxAgg2D(12, 16, 3, 4), factored.BoxAgg2D(12, 16, 3, 4)
    np.testing.assert_array_equal(Tt.agg_id.numpy(), np.asarray(Tj.agg_id))
    assert Tt.shape == Tj.shape == (192, 16)
    e = rng.randn(16, 3) if batch else rng.randn(16)
    v = rng.randn(192, 3) if batch else rng.randn(192)
    close(Tt.interp(t(e)), Tj.interp(jnp.asarray(e)), atol=0)
    close(Tt.restrict(t(v)), Tj.restrict(jnp.asarray(v)))


def test_bilinear_matches_jax(rng):
    Pj, Pt = jfac.BilinearP2D(8, 12), factored.BilinearP2D(8, 12)
    assert Pt.dtype == torch.float32 and Pt.shape == Pj.shape
    assert Pt.coarse_reach(1, 3) == Pj.coarse_reach(1, 3) == (1, 2)
    np.testing.assert_array_equal(Pt.densify().numpy(), np.asarray(Pj.densify()))
    for shape_k, shape_n in (((Pt.k,), (Pt.n,)), ((Pt.k, 3), (Pt.n, 3))):
        e, v = rng.randn(*shape_k), rng.randn(*shape_n)
        close(Pt.interp(t(e)), Pj.interp(jnp.asarray(e)), atol=0)
        close(Pt.restrict(t(v)), Pj.restrict(jnp.asarray(v)), atol=0)
    with pytest.raises(ValueError, match="even"):
        factored.BilinearP2D(7, 8)


@pytest.mark.parametrize("steps", [1, 2])
def test_factored_sa_factors_match_jax(rng, steps):
    Aj, At = pair(poisson2d(16, aniso=0.4))
    T = dict(ny=16, nx=16, sy=4, sx=4)
    if steps == 1:
        kw = dict(omega=0.7)
    else:  # lmax as the hierarchy passes it: a scalar of the operator's type
        kw = dict(lmax=2.3)
    Pj = jfac.factored_sa(Aj, jfac.BoxAgg2D(**T), smooth_steps=steps,
                          **{k: jnp.float64(v) if k == "lmax" else v for k, v in kw.items()})
    Pt = factored.factored_sa(At, factored.BoxAgg2D(**T), smooth_steps=steps, **kw)
    assert Pt.smooth_steps == steps and Pt.dtype == F64
    for S, Sj in zip(Pt.Ss + Pt.Sts, Pj.Ss + Pj.Sts):
        assert_dia_equal(S, Sj, atol=1e-15)
    e, v = rng.randn(16), rng.randn(256)
    close(Pt.interp(t(e)), Pj.interp(jnp.asarray(e)))
    close(Pt.restrict(t(v)), Pj.restrict(jnp.asarray(v)))
    close(Pt.densify(), Pj.densify())


def test_factored_sa_unported_defaults_raise(rng):
    """A dense operand raises; a DIA without a stored main diagonal gets
    the JAX package's CSR factors (A read back in float32, Dinv = 1, no
    identity added), the same as JAX's within 1e-12."""
    Aj, At = pair(poisson2d(8))
    T = factored.BoxAgg2D(8, 8, 2, 2)
    with pytest.raises(TypeError, match="unsupported operator"):
        factored.factored_sa(torch.eye(64), T, omega=0.6)
    no_diag = DIA(At.data[:2], At.offsets[:2], At.shape)
    no_diag_j = JDIA(Aj.data[:2], Aj.offsets[:2], Aj.shape)
    assert 0 not in no_diag.offsets
    Pt = factored.factored_sa(no_diag, T, omega=0.6)
    Pj = jfac.factored_sa(no_diag_j, jfac.BoxAgg2D(8, 8, 2, 2), omega=0.6)
    assert all(isinstance(S, CSR) for S in Pt.Ss + Pt.Sts)
    for S, Sj in zip(Pt.Ss + Pt.Sts, Pj.Ss + Pj.Sts):
        assert abs(S.to_scipy() - Sj.to_scipy()).max() <= 1e-12
    e, v = rng.randn(16), rng.randn(64)
    close(Pt.interp(t(e)), Pj.interp(jnp.asarray(e)))
    close(Pt.restrict(t(v)), Pj.restrict(jnp.asarray(v)))


@pytest.mark.parametrize("steps", [1, 2])
def test_factored_sa_default_omega_matches_jax(rng, steps):
    """omega=None: sa_omega's power iteration (one factor), or the
    Chebyshev weights of lmax = (4/3) / sa_omega (two factors)."""
    Aj, At = pair(poisson2d(16, aniso=0.3))
    Pj = jfac.factored_sa(Aj, jfac.BoxAgg2D(16, 16, 4, 4), smooth_steps=steps)
    Pt = factored.factored_sa(At, factored.BoxAgg2D(16, 16, 4, 4), smooth_steps=steps)
    assert Pt.smooth_steps == steps
    for S, Sj in zip(Pt.Ss + Pt.Sts, Pj.Ss + Pj.Sts):
        assert_dia_equal(S, Sj, atol=1e-10)
    close(Pt.densify(), Pj.densify(), atol=1e-10)
    v = rng.randn(256)
    close(Pt.restrict(t(v)), Pj.restrict(jnp.asarray(v)), atol=1e-10)


@pytest.mark.parametrize("kind", ["sa", "bilinear"])
def test_coarse_operator_factored_matches_jax(kind):
    Aj, At = pair(poisson2d(16, aniso=0.5))
    if kind == "sa":
        Pj = jfac.factored_sa(Aj, jfac.BoxAgg2D(16, 16, 4, 4), omega=0.66)
        Pt = factored.factored_sa(At, factored.BoxAgg2D(16, 16, 4, 4), omega=0.66)
    else:
        Pj, Pt = jfac.BilinearP2D(16, 16), factored.BilinearP2D(16, 16)
    close(factored.coarse_operator_factored(At, Pt, block=24),
          jfac.coarse_operator_factored(Aj, Pj, block=24))
    close(cycle.coarse_operator(At, Pt), jcycle.coarse_operator(Aj, Pj))


# ---------------------------------------------------------------------------
# Colored probing
# ---------------------------------------------------------------------------


def _probe_case(case):
    """(matrix, function making the prolongator from a module and a DIA)."""
    if case == "aniso_32_box4":
        return poisson2d(32, aniso=0.3), lambda m, Ad: m.factored_sa(
            Ad, m.BoxAgg2D(32, 32, 4, 4), omega=0.7)
    if case == "rect_24x48_box3x6":
        return poisson2d(24, 48), lambda m, Ad: m.factored_sa(
            Ad, m.BoxAgg2D(24, 48, 3, 6), omega=0.66)
    return poisson2d(16, 32, aniso=0.25), lambda m, Ad: m.BilinearP2D(16, 32)


@pytest.mark.parametrize("case", ["aniso_32_box4", "rect_24x48_box3x6", "bilinear_16x32"])
def test_probe_matches_jax(case):
    A, make = _probe_case(case)
    Aj, At = pair(A)
    AHj = j_probe(Aj, make(jfac, Aj))
    AHt = dia_galerkin_probe(At, make(factored, At))
    assert_dia_equal(AHt, AHj)
    if case == "bilinear_16x32":  # one level further down
        assert len(AHt.offsets) <= 9
        assert_dia_equal(dia_galerkin_probe(AHt, factored.BilinearP2D(8, 16)),
                         j_probe(AHj, jfac.BilinearP2D(8, 16)))


def test_probe_rejects_narrow_grid_and_decomposes_offsets():
    _, At = pair(poisson2d(8))
    P = factored.factored_sa(At, factored.BoxAgg2D(8, 8, 4, 4), omega=0.6)
    with pytest.raises(ValueError, match="too narrow"):
        dia_galerkin_probe(At, P)
    assert _decompose_offsets((-9, -8, -1, 0, 1, 7, 8), 8) == [
        (-1, -1), (-1, 0), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0)]


# ---------------------------------------------------------------------------
# Hierarchies
# ---------------------------------------------------------------------------

BILINEAR = dict(sides=(2,) * 6, min_coarse=16, kind="bilinear")
SA = dict(sides=(4, 4), min_coarse=8, smooth_steps=(2, 1), kind="sa")


def _hierarchies(cfg, dtype):
    A = poisson2d(64)
    Aj, At = pair(A, dtype)
    hj = j_build(Aj, 64, 64, block=False, **cfg)
    ht = build_structured_hierarchy(At, 64, 64, **cfg)
    return hj, ht


@pytest.fixture(scope="module")
def bilinear64():
    return _hierarchies(BILINEAR, np.float64)


@pytest.fixture(scope="module")
def sa64():
    return _hierarchies(SA, np.float64)


@pytest.fixture(scope="module")
def bilinear64_f32():
    return _hierarchies(BILINEAR, np.float32)


def _assert_hierarchy_matches(hj, ht):
    assert ht.num_levels == hj.num_levels
    for l in range(ht.num_levels):
        assert_dia_equal(ht.As[l], hj.As[l])
        close(ht.Dinvs[l], hj.Dinvs[l])
        close(ht.lmaxs[l], float(hj.lmaxs[l]))
        Pj, Pt = hj.Ps[l], ht.Ps[l]
        assert type(Pt).__name__ == type(Pj).__name__
        if isinstance(Pt, factored.FactoredSA):
            assert Pt.T == factored.BoxAgg2D(Pj.T.ny, Pj.T.nx, Pj.T.sy, Pj.T.sx)
            for S, Sj in zip(Pt.Ss + Pt.Sts, Pj.Ss + Pj.Sts):
                assert_dia_equal(S, Sj)
        else:
            assert (Pt.ny, Pt.nx) == (Pj.ny, Pj.nx)
    assert ht.coarse.method == hj.coarse.method == "inverse"
    close(ht.coarse.lu, hj.coarse.lu, atol=1e-10)


def test_bilinear_hierarchy_matches_jax(bilinear64):
    hj, ht = bilinear64
    assert ht.num_levels == 3 and ht.coarse.lu.shape == (64, 64)
    _assert_hierarchy_matches(hj, ht)


def test_sa_hierarchy_matches_jax(sa64):
    hj, ht = sa64
    # the second level's probe reach (3 * 2 / 4 -> 2) does not fit its 4x4
    # coarse grid, so coarsening stops there (the too-narrow break)
    assert ht.num_levels == 1 and [P.smooth_steps for P in ht.Ps] == [2]
    assert ht.As[0].shape == (4096, 4096) and ht.coarse.lu.shape == (256, 256)
    _assert_hierarchy_matches(hj, ht)


def test_bilinear_rejects_other_sides():
    _, At = pair(poisson2d(8))
    with pytest.raises(ValueError, match="every side to be 2"):
        build_structured_hierarchy(At, 8, 8, sides=(4,), min_coarse=1, kind="bilinear")


# ---------------------------------------------------------------------------
# Cycles
# ---------------------------------------------------------------------------

CYCLES = {
    "chebyshev_nu2": dict(nu=2, smoother="chebyshev"),
    "jacobi_nu1": dict(nu=1, smoother="jacobi"),
    "chebyshev_w_cycle": dict(nu=2, smoother="chebyshev", gamma=2),
    "jacobi_w_cycle": dict(nu=1, smoother="jacobi", gamma=2),
    "numpy_int_per_level_nu": dict(nu=(np.int64(2), 1), smoother="chebyshev"),
}


def _j_vcycle(h, b, x, **kw):
    return jax.jit(partial(jcycle.vcycle, **kw))(h, b, x)


@pytest.mark.parametrize("hier", ["bilinear", "sa"])
@pytest.mark.parametrize("name", list(CYCLES))
def test_vcycle_matches_jax(bilinear64, sa64, hier, name):
    hj, ht = bilinear64 if hier == "bilinear" else sa64
    kw = CYCLES[name]
    n = 64 * 64
    x0 = np.random.RandomState(0).randn(n)
    b = np.random.RandomState(1).randn(n)
    jkw = dict(kw, nu=tuple(int(v) for v in kw["nu"])) if not np.isscalar(kw["nu"]) else kw
    y_j = _j_vcycle(hj, jnp.asarray(b), jnp.asarray(x0), **jkw)
    y_t = cycle.vcycle(ht, t(b), t(x0), **kw)
    close(y_t, y_j, atol=1e-10)


def test_vcycle_accepts_numpy_int_nu(bilinear64):
    _, ht = bilinear64
    x0 = t(np.random.RandomState(0).randn(64 * 64))
    b = torch.zeros_like(x0)
    assert torch.equal(cycle.vcycle(ht, b, x0, nu=np.int64(2)), cycle.vcycle(ht, b, x0, nu=2))
    with pytest.raises(ValueError, match="unknown smoother"):
        cycle.vcycle(ht, b, x0, smoother="gs")


def test_vcycle_solve_f32_matches_jax(bilinear64_f32):
    hj, ht = bilinear64_f32
    n = 64 * 64
    x0 = np.random.RandomState(0).randn(n).astype(np.float32)
    b = np.random.RandomState(1).randn(n).astype(np.float32)
    # nu=1 keeps all 12 residuals above the float32 floor (nu=2 reaches it
    # after 8 cycles, and its conv factor then reads rounding noise)
    run = jax.jit(partial(jcycle.vcycle_solve, res_tol=0.0, max_iter=12, nu=1))
    _, conv_j, err_j, it_j = run(hj, jnp.asarray(b), jnp.asarray(x0))
    x, conv_t, err_t, it_t = cycle.vcycle_solve(ht, t(b), t(x0), res_tol=0.0,
                                                max_iter=12, nu=1)
    assert it_t == int(it_j) == 12 and x.dtype == torch.float32
    assert abs(conv_t - float(conv_j)) <= 1e-4
    close(err_t, err_j, rtol=1e-3, atol=0)


@pytest.mark.parametrize("blocked", [False, True])
def test_hierarchy_from_numpy_carries_the_jax_hierarchy(bilinear64, sa64, blocked):
    for hj in (bilinear64[0], sa64[0]):
        def dia(A):
            A = blocked_dia(A) if blocked else A
            return {"data": np.asarray(A.data), "offsets": A.offsets, "shape": A.shape}

        def prol(P):
            if isinstance(P, jfac.BilinearP2D):
                return {"ny": P.ny, "nx": P.nx}
            return {"Ss": [dia(S) for S in P.Ss], "Sts": [dia(S) for S in P.Sts],
                    "T": {"ny": P.T.ny, "nx": P.T.nx, "sy": P.T.sy, "sx": P.T.sx}}

        ht = hierarchy_from_numpy(
            [dia(A) for A in hj.As], [prol(P) for P in hj.Ps],
            [np.asarray(d) for d in hj.Dinvs], [float(v) for v in hj.lmaxs],
            {"lu": np.asarray(hj.coarse.lu), "piv": np.asarray(hj.coarse.piv),
             "singular": hj.coarse.singular, "method": hj.coarse.method},
            device=CPU,
        )
        assert ht.As[0].data.shape == (5, 64 * 64) and ht.As[0].dtype == F64
        n = 64 * 64
        x0 = np.random.RandomState(2).randn(n)
        b = np.zeros(n)
        y_j = _j_vcycle(hj, jnp.asarray(b), jnp.asarray(x0), nu=2, smoother="chebyshev")
        close(cycle.vcycle(ht, t(b), t(x0), nu=2, smoother="chebyshev"), y_j, atol=1e-10)


# ---------------------------------------------------------------------------
# Two-level solve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twolevel64():
    A = poisson2d(64)
    Aj, At = pair(A)
    Pj = jfac.factored_sa(Aj, jfac.BoxAgg2D(64, 64, 8, 8), omega=0.65)
    Pt = factored.factored_sa(At, factored.BoxAgg2D(64, 64, 8, 8), omega=0.65)
    cj = JCoarseSolver.factor(jcycle.coarse_operator(Aj, Pj), method="inverse")
    ct = CoarseSolver.factor(cycle.coarse_operator(At, Pt), method="inverse")
    close(ct.lu, cj.lu, atol=1e-10)
    return Aj, Pj, cj, At, Pt, ct


def _j_twolevel(Aj, Pj, b, x0, fused=None, **kw):
    """JAX two-level solve with the fused sweep forced on or off (JAX picks
    it only for a blocked DIA on a TPU)."""
    if fused is not None:
        kw["fused_jacobi"] = fused
    return jax.jit(partial(jcycle.twolevel_solve, **kw))(Aj, Pj, b, x0)


@pytest.mark.parametrize("fused", [False, True])
def test_twolevel_solve_matches_jax(twolevel64, fused):
    Aj, Pj, cj, At, Pt, ct = twolevel64
    n = 64 * 64
    x0 = np.random.RandomState(0).randn(n)
    b = np.zeros(n)
    kw = dict(res_tol=0.1, max_iter=60)  # 8x8 boxes: conv ~0.94, stops near 40
    _, conv_j, err_j, it_j = _j_twolevel(Aj, Pj, jnp.asarray(b), jnp.asarray(x0), fused,
                                         coarse=cj, **kw)
    x, conv_t, err_t, it_t = cycle.twolevel_solve(At, Pt, t(b), t(x0), coarse=ct,
                                                  fused_jacobi=fused, **kw)
    assert it_t == int(it_j) and 6 <= it_t < 60
    np.testing.assert_allclose(conv_t, float(conv_j), rtol=1e-10)
    close(err_t[:it_t], np.asarray(err_j)[:it_t], rtol=1e-9, atol=0)


@pytest.mark.parametrize("max_iter", [1, 2, 7])
def test_twolevel_solve_short_buffers_match_jax(twolevel64, max_iter):
    """The conv readout with fewer than 3 iterations (err_n = 0) reads the
    buffer at index ``iters``; JAX clamps it into the buffer."""
    Aj, Pj, cj, At, Pt, ct = twolevel64
    x0 = np.random.RandomState(5).randn(64 * 64)
    b = np.zeros(64 * 64)
    kw = dict(res_tol=0.0, max_iter=max_iter, fused_jacobi=True)
    _, conv_j, err_j, it_j = _j_twolevel(Aj, Pj, jnp.asarray(b), jnp.asarray(x0),
                                         coarse=cj, **kw)
    _, conv_t, err_t, it_t = cycle.twolevel_solve(At, Pt, t(b), t(x0), coarse=ct, **kw)
    assert it_t == int(it_j) == max_iter
    np.testing.assert_allclose(conv_t, float(conv_j), rtol=1e-10)
    close(err_t, err_j, rtol=1e-10, atol=0)


def test_twolevel_solve_builds_its_coarse_and_takes_chebyshev(twolevel64):
    Aj, Pj, _, At, Pt, _ = twolevel64
    n = 64 * 64
    x0 = np.random.RandomState(3).randn(n)
    b = np.random.RandomState(4).randn(n)
    kw = dict(error_tol=0.0, max_iter=8, smoother="chebyshev",
              smoother_args={"lmax": 2.0}, pre_smoothing_steps=2)
    xj, conv_j, _, it_j = _j_twolevel(Aj, Pj, jnp.asarray(b), jnp.asarray(x0), False, **kw)
    xt, conv_t, _, it_t = cycle.twolevel_solve(At, Pt, t(b), t(x0), **kw)
    assert it_t == int(it_j) == 8
    close(xt, xj, atol=1e-9)
    np.testing.assert_allclose(conv_t, float(conv_j), rtol=1e-9)


def test_twolevel_solve_unported_options_raise(twolevel64):
    """Only a missing tolerance and an unknown smoother raise now: the
    multicolor Gauss-Seidel smoother and Chebyshev's power-iteration lmax
    (unported in slice 2) match JAX."""
    Aj, Pj, cj, At, Pt, ct = twolevel64
    x = torch.zeros(64 * 64, dtype=F64)
    with pytest.raises(RuntimeError, match="res_tol or error_tol"):
        cycle.twolevel_solve(At, Pt, x, x, coarse=ct)
    with pytest.raises(ValueError, match="unknown smoother"):
        cycle.twolevel_solve(At, Pt, x, x, res_tol=0.0, smoother="sor", coarse=ct)
    from mlamg_tpu.mg.smoothers import greedy_coloring

    colors = greedy_coloring(poisson2d(64))
    x0 = np.random.RandomState(2).randn(64 * 64)
    for smoother, args_j, args_t in (
        ("multicolor_gs", {"colors": jnp.asarray(colors), "num_colors": 2},
         {"colors": t(colors.astype(np.int64)), "num_colors": 2}),
        ("chebyshev", {}, {}),
    ):
        kw = dict(res_tol=0.0, max_iter=6, smoother=smoother)
        _, conv_j, err_j, _ = _j_twolevel(Aj, Pj, jnp.zeros(64 * 64), jnp.asarray(x0), False,
                                          coarse=cj, smoother_args=args_j, **kw)
        _, conv_t, err_t, _ = cycle.twolevel_solve(At, Pt, torch.zeros_like(t(x0)), t(x0),
                                                   coarse=ct, smoother_args=args_t, **kw)
        np.testing.assert_allclose(conv_t, float(conv_j), rtol=1e-9)
        close(err_t, err_j, rtol=1e-9, atol=0)
