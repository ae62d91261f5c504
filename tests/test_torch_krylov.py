"""Port parity, the solver layer of the Navier-Stokes path: COO and
transpose, BSR products, pcg and fgmres, build_hierarchy and the greedy
C/F splittings of ``mlamg_torch`` against ``mlamg_tpu`` on the same numpy
inputs (CPU, float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu.data.stokes import lid_driven_cavity
from mlamg_tpu.graph import coarsening as jcoarse
from mlamg_tpu.graph import lloyd as jlloyd
from mlamg_tpu.mg import cycle as jcycle
from mlamg_tpu.mg import krylov as jkrylov
from mlamg_tpu.ops import bsr as jbsr
from mlamg_tpu.ops import matmul as jmatmul
from mlamg_tpu.ops import sparse as jsparse

from mlamg_torch.data.cylflow import cylinder_flow_system
from mlamg_torch.graph import coarsening
from mlamg_torch.mg import cycle, krylov
from mlamg_torch.ops import bsr, matmul
from mlamg_torch.ops.sparse import COO, CSR

F64 = torch.float64


def t(a, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return out if dtype is None else out.to(dtype)


def pinned(A):
    """A with dof 0 pinned (train_cf_interp's pinned pressure Laplacian)."""
    A = A.tolil()
    A[0, :] = 0.0
    A[:, 0] = 0.0
    A[0, 0] = 1.0
    return sp.csr_matrix(A)


def assert_csr_equal(got, want):
    for name in ("data", "row", "col", "indptr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert tuple(got.shape) == tuple(want.shape) and got.nnz == want.nnz


def random_coo(rng, m=40, n=30, nnz=300, pad=20):
    """Unsorted triplets with duplicate coordinates and tail padding."""
    row = np.concatenate([rng.randint(0, m, nnz), np.full(pad, m)])
    col = np.concatenate([rng.randint(0, n, nnz), np.zeros(pad, int)])
    data = np.concatenate([rng.randn(nnz), np.zeros(pad)])
    return data, row, col, (m, n), nnz + pad


def test_coo_sort_rows_and_transpose_bit_for_bit(rng):
    data, row, col, shape, nnz = random_coo(rng)
    j = jsparse.COO(jnp.asarray(data), jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32),
                    shape, nnz)
    p = COO(t(data), t(row), t(col), shape, nnz)
    assert_csr_equal(p.sort_rows(), j.sort_rows())
    assert_csr_equal(matmul.transpose(p), jmatmul.transpose(j))
    A = sp.random(50, 35, density=0.1, random_state=3, format="csr")
    assert_csr_equal(matmul.transpose(CSR.from_scipy(A, dtype=F64, device="cpu")),
                     jmatmul.transpose(jsparse.CSR.from_scipy(A, dtype=jnp.float64)))
    assert abs(matmul.transpose(CSR.from_scipy(A, dtype=F64, device="cpu")).to_scipy()
               - A.T).max() == 0


@pytest.mark.parametrize("bs", [2, 3])
def test_bsr_products_match_jax(rng, bs):
    s = lid_driven_cavity(n=7, Re=100.0, dt=0.1)  # n_u 84 = 2*42 = 3*28
    A = sp.kron(sp.eye(bs), s.F[:84, :84]).tocsr() + sp.random(
        84 * bs, 84 * bs, density=0.02, random_state=bs, format="csr")
    Aj = jbsr.BSR.from_scipy(A, bs=bs, dtype=jnp.float64)
    At = bsr.BSR.from_scipy(A, bs=bs, dtype=F64, device="cpu")
    np.testing.assert_array_equal(At.col.numpy(), np.asarray(Aj.col))
    np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))
    x = rng.randn(A.shape[1])
    y = rng.randn(A.shape[0])
    np.testing.assert_allclose(matmul.spmv(At, t(x)).numpy(),
                               np.asarray(jmatmul.spmv(Aj, jnp.asarray(x))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(matmul.spmv_t(At, t(y)).numpy(),
                               np.asarray(jbsr.bsr_spmv_t(Aj, jnp.asarray(y))), rtol=0,
                               atol=1e-12)
    assert abs(At.to_scipy() - Aj.to_scipy()).max() == 0
    with pytest.raises(ValueError, match="divisible"):
        bsr.BSR.from_scipy(A[:, :-1], bs=bs, device="cpu")


def krylov_cases():
    s = lid_driven_cavity(n=12, Re=100.0, dt=0.1)
    return {"laplacian": pinned(lid_driven_cavity(n=8).Ap),
            "convection": (s.Fp + sp.eye(s.n_p)).tocsr()}


@pytest.mark.parametrize("case", ["laplacian", "convection"])
@pytest.mark.parametrize("precond", [False, True])
def test_pcg_and_fgmres_match_jax(rng, case, precond):
    A = krylov_cases()[case]
    b = rng.randn(A.shape[0])
    d = A.diagonal()
    Mj = (lambda r: r / jnp.asarray(d)) if precond else None
    Mt = (lambda r: r / t(d)) if precond else None
    Aj = jsparse.CSR.from_scipy(A, dtype=jnp.float64)
    At = CSR.from_scipy(A, dtype=F64, device="cpu")
    runs = [("fgmres", dict(restart=20, max_restarts=20, tol=1e-9))]
    if case == "laplacian":
        runs.append(("pcg", dict(tol=1e-9, max_iter=200)))
    for name, kw in runs:
        xj, hj, ij = getattr(jkrylov, name)(Aj, jnp.asarray(b), M=Mj, **kw)
        xt, ht, it = getattr(krylov, name)(At, t(b), M=Mt, **kw)
        assert it == int(ij) and it > 3, (name, it, int(ij))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(xj)).max())
        if name == "fgmres":
            np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                                       atol=1e-10 * np.linalg.norm(b))
        # (CG's recursively updated residual drifts with the order of the dot
        # products near convergence, 37% at 1e-7 |b| here, while x agrees to
        # 1e-13: its history is held to its length)
        assert ht[:it].all() and not ht[it:].any()
        if it < kw.get("max_iter", 400):  # converged: the true residual meets tol
            assert np.linalg.norm(A @ xt.numpy() - b) <= 1e-9 * np.linalg.norm(b) * 1.0001


def test_fgmres_zero_rhs_and_restart_history():
    A = CSR.from_scipy(krylov_cases()["convection"], dtype=F64, device="cpu")
    x, hist, iters = krylov.fgmres(A, torch.zeros(A.shape[0], dtype=F64), tol=1e-8)
    assert iters == 0 and not x.any() and not hist.any()


def record_lloyd(monkeypatch, module, sink):
    """Wrap ``module.lloyd_aggregation`` so that each call's agg_id lands in
    ``sink``."""
    real = module.lloyd_aggregation

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        sink.append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(module, "lloyd_aggregation", wrapped)


@pytest.mark.parametrize("alpha", [0.1, 0.2])
@pytest.mark.parametrize("pin", [False, True])
def test_build_hierarchy_matches_jax(rng, monkeypatch, alpha, pin):
    """Lloyd + dense RAP on the cavity's pressure Laplacian (n 32, so that
    both alphas coarsen twice before min_coarse 64): the same
    aggregates per level, operators and prolongators within 1e-10.  The raw
    Laplacian is singular (Neumann), so its coarsest LU is exactly singular
    and a cycle's result is set by rounding: the V-cycle is compared on
    the pinned one."""
    Ap = lid_driven_cavity(n=32, Re=100.0, dt=0.1).Ap
    A = pinned(Ap) if pin else Ap
    aggs_j, aggs_t = [], []
    record_lloyd(monkeypatch, jlloyd, aggs_j)
    record_lloyd(monkeypatch, cycle, aggs_t)
    hj = jcycle.build_hierarchy(jsparse.CSR.from_scipy(A, dtype=jnp.float64), alpha=alpha,
                                width=5)
    ht = cycle.build_hierarchy(CSR.from_scipy(A, dtype=F64, device="cpu"), alpha=alpha, width=5)
    assert len(aggs_t) == len(aggs_j) == 2 and len(ht.As) == len(hj.As) == 2
    for a, b in zip(aggs_t, aggs_j):
        np.testing.assert_array_equal(a, b)
    assert abs(ht.As[0].to_scipy() - A).max() == 0
    np.testing.assert_allclose(ht.As[1].numpy(), np.asarray(hj.As[1]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ht.coarse.lu.numpy(), np.asarray(hj.coarse.lu), rtol=0,
                               atol=1e-10)
    for Pt, Pj, Dt, Dj in zip(ht.Ps, hj.Ps, ht.Dinvs, hj.Dinvs):
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=1e-12, atol=0)
    if pin:
        b, x0 = rng.randn(1024), rng.randn(1024)
        np.testing.assert_allclose(cycle.vcycle(ht, t(b), t(x0)).numpy(),
                                   np.asarray(jcycle.vcycle(hj, jnp.asarray(b), jnp.asarray(x0))),
                                   rtol=0, atol=1e-10)
    # the first coarse level kept sparse (rap_fused) equals JAX's too
    hj = jcycle.build_hierarchy(jsparse.CSR.from_scipy(A, dtype=jnp.float64), alpha=alpha,
                                width=5, sparse_levels=1)
    ht = cycle.build_hierarchy(CSR.from_scipy(A, dtype=F64, device="cpu"), alpha=alpha, width=5,
                               sparse_levels=1)
    assert isinstance(ht.As[1], CSR) and isinstance(ht.Ps[0], CSR) and len(ht.As) == len(hj.As)
    for name in ("row", "col", "indptr"):
        np.testing.assert_array_equal(getattr(ht.As[1], name).numpy(),
                                      np.asarray(getattr(hj.As[1], name)))
    np.testing.assert_allclose(ht.As[1].data.numpy(), np.asarray(hj.As[1].data), rtol=0,
                               atol=1e-12 * float(np.abs(np.asarray(hj.As[1].data)).max()))
    # level 1's duplicates add in each package's sort order, and the
    # coarsest LU (singular without the pin) carries that rounding
    lu_j = np.asarray(hj.coarse.lu)
    np.testing.assert_allclose(ht.coarse.lu.numpy(), lu_j, rtol=0,
                               atol=1e-10 * np.abs(lu_j).max())


def coarsening_cases():
    Ap = lid_driven_cavity(n=12, Re=100.0).Ap
    return {"cavity": Ap, "pinned": pinned(Ap), "cylinder": cylinder_flow_system(h=0.08).Ap}


@pytest.mark.parametrize("case", ["cavity", "pinned", "cylinder"])
@pytest.mark.parametrize("theta", [0.56, 0.6])
def test_greedy_coarsenings_match_jax(case, theta):
    A = coarsening_cases()[case]
    nf, F, C = coarsening.greedy_coarsening(A, theta)
    jnf, jF, jC = jcoarse.greedy_coarsening(A, theta)
    assert nf == jnf and np.array_equal(F, jF) and np.array_equal(C, jC) and len(C) > 0
    np.testing.assert_array_equal(coarsening.diag_dominance(A), jcoarse.diag_dominance(A))
    state = coarsening.greedy_coarsening_parallel(CSR.from_scipy(A, dtype=F64, device="cpu"), theta)
    jstate = jcoarse.greedy_coarsening_parallel(jsparse.CSR.from_scipy(A, dtype=jnp.float64), theta)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    assert (state == 2).any() and set(state.unique().tolist()) <= {1, 2}
