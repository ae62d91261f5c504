"""The distributed solves: ``mlamg_torch.parallel.pcycle`` against
``mlamg_tpu.parallel.pcycle`` and against the port's serial solves
(CPU, float64, the JAX tests' sizes in ``tests/test_pcycle.py``; the JAX
side on the conftest's 8 virtual CPU devices, the port's on 8 virtual CPU
shards): equal iterations, conv within 1e-10 of JAX's and of the serial
port's, the solution within 1e-8 of JAX's.  A solve to 1e-10 |b| from a
random right-hand side reaches the rounding floor, where the conv factor
is rounding: there the bound is ``FLOOR_CONV_ATOL``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu import parallel as jpar
from mlamg_tpu.mg.interp import sa_interpolation_dense as j_sa
from mlamg_tpu.ops import CSR as JCSR
from mlamg_tpu.ops import matmul as jmatmul

from mlamg_torch import parallel as par
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.cycle import Hierarchy, twolevel_solve, vcycle_solve
from mlamg_torch.ops.sparse import CSR

F64 = torch.float64
CONV_ATOL = 1e-10
X_ATOL = 1e-8
# the random right-hand side's last residuals are ~1e-10 |b|, where the
# residual's rounding is ~1e-7 of it: JAX's own distributed and serial
# solves read conv factors 1.6e-8 apart there (the port's 4.0e-8 from
# JAX's distributed one, 4.4e-9 from its own serial one)
FLOOR_CONV_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def poisson2d(nx):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return sp.csr_matrix(sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


def box_agg(nx):
    i = np.arange(nx * nx)
    return (i // nx // 2) * (nx // 2) + (i % nx) // 2


def sa_p(A, agg):
    """The JAX tests' Jacobi-SA prolongator (omega 0.65), as numpy."""
    return np.asarray(j_sa(JCSR.from_scipy(A, dtype=jnp.float64), jnp.asarray(agg),
                           int(agg.max()) + 1, omega=0.65))


def t(a):
    return torch.from_numpy(np.array(a))


def meshes():
    return jpar.make_mesh(pop=1, row=8), par.make_mesh(pop=1, row=8, devices=["cpu"] * 8)


def check(got, want, serial, n, conv_atol=CONV_ATOL):
    """Equal iterations; conv within ``conv_atol`` of JAX's and the serial
    port's; the solution within X_ATOL of JAX's."""
    xs, conv, err, it = got
    xj, conv_j, _, it_j = want
    assert it == int(it_j) == serial[3]
    assert abs(conv - float(conv_j)) <= conv_atol and abs(conv - serial[1]) <= conv_atol
    x = par.gather_global(xs).ravel()[:n]
    np.testing.assert_allclose(x, np.asarray(xj).ravel()[:n], rtol=0, atol=X_ATOL)
    assert err.shape[0] >= it and float(err[it - 1]) > 0
    return x


@pytest.mark.parametrize("rhs", ["zero", "random"])
def test_ptwolevel_matches_jax_and_serial(rng, rhs):
    nx = 16 if rhs == "zero" else 12
    A = poisson2d(nx)
    n = A.shape[0]
    P = sa_p(A, box_agg(nx))
    if rhs == "zero":
        b, x0 = np.zeros(n), rng.randn(n)
        x0 /= np.linalg.norm(x0)
        tol, max_iter = 1e-8, 300
    else:
        b, x0 = rng.randn(n), np.zeros(n)
        tol, max_iter = 1e-10 * np.linalg.norm(b), 400
    jm, m = meshes()
    Jp = jpar.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=jnp.float64)
    Tp = par.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=F64, device="cpu")
    got = par.ptwolevel_solve(Tp, P, b, x0, m, res_tol=tol, max_iter=max_iter)
    want = jpar.ptwolevel_solve(Jp, P, b, x0, jm, res_tol=tol, max_iter=max_iter)
    serial = twolevel_solve(CSR.from_scipy(A, dtype=F64, device="cpu"), t(P), t(b), t(x0),
                            res_tol=tol, max_iter=max_iter)
    x = check(got, want, serial, n, CONV_ATOL if rhs == "zero" else FLOOR_CONV_ATOL)
    if rhs == "zero":
        assert np.linalg.norm(A @ x) < 1e-7
    else:
        np.testing.assert_allclose(x, sp.linalg.spsolve(A, b), rtol=0, atol=1e-8)


def test_ptwolevel_inputs_in_every_layout(rng):
    """P as an (n, k) tensor, as (S, n_loc, k) rows, b and x0 as sharded
    arrays, and a row axis of two device blocks: the same bits."""
    nx = 10  # n = 100: the last shard is padded
    A = poisson2d(nx)
    n = A.shape[0]
    P = sa_p(A, box_agg(nx))
    x0 = rng.randn(n)
    _, m = meshes()
    Tp = par.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=F64, device="cpu")
    ref = par.ptwolevel_solve(Tp, P, np.zeros(n), x0, m, max_iter=30)
    rows = np.zeros((8 * Tp.n_loc, P.shape[1]))
    rows[:n] = P
    two = par.make_mesh(pop=1, row=8, devices=["cpu"] * 5 + ["cpu:0"] * 3)
    for P_in, mesh, x_in in ((t(P), m, Tp.shard_x(x0, m)),
                             (rows.reshape(8, Tp.n_loc, -1), m, Tp.shard_x(x0)),
                             (P, two, x0)):
        got = par.ptwolevel_solve(Tp, P_in, np.zeros(n), x_in, mesh, max_iter=30)
        np.testing.assert_array_equal(par.gather_global(got[0]), par.gather_global(ref[0]))
        assert (got[1], got[3]) == (ref[1], ref[3]) and torch.equal(got[2], ref[2])


def test_pvcycle_multilevel_matches_jax_and_serial(rng):
    """Level 0 row-partitioned, a replicated V-cycle over the coarse chain
    (A_1 dense, one more level, LU at the bottom)."""
    nx = 24
    A = poisson2d(nx)
    n = A.shape[0]
    P0 = sa_p(A, box_agg(nx))
    k1 = P0.shape[1]
    A1 = np.asarray(jmatmul.rap_dense(JCSR.from_scipy(A, dtype=jnp.float64), jnp.asarray(P0)))
    mm = nx // 2
    agg1 = (np.arange(k1) // mm // 2) * (mm // 2) + (np.arange(k1) % mm) // 2
    d1 = np.diag(A1)
    Dinv1 = 1.0 / np.where(d1 != 0, d1, 1.0)
    T1 = np.zeros((k1, agg1.max() + 1))
    T1[np.arange(k1), agg1] = 1.0
    P1 = T1 - 0.65 * Dinv1[:, None] * (A1 @ T1)
    A2 = P1.T @ A1 @ P1
    from mlamg_tpu.mg.coarse import CoarseSolver as JCoarse
    from mlamg_tpu.mg.cycle import Hierarchy as JHierarchy

    j_coarse = JHierarchy(As=(jnp.asarray(A1),), Ps=(jnp.asarray(P1),),
                          Dinvs=(jnp.asarray(Dinv1),), coarse=JCoarse.factor(jnp.asarray(A2)))
    coarse = CoarseSolver.factor(t(A2))
    h_coarse = Hierarchy((t(A1),), (t(P1),), (t(Dinv1),), coarse)
    h_full = Hierarchy((CSR.from_scipy(A, dtype=F64, device="cpu"), t(A1)), (t(P0), t(P1)),
                       (t(1.0 / A.diagonal()), t(Dinv1)), coarse)
    x0 = rng.randn(n)
    x0 /= np.linalg.norm(x0)
    b = np.zeros(n)
    jm, m = meshes()
    Jp = jpar.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=jnp.float64)
    Tp = par.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=F64, device="cpu")
    got = par.pvcycle_solve(Tp, P0, h_coarse, b, x0, m, res_tol=1e-8, max_iter=200)
    want = jpar.pvcycle_solve(Jp, P0, j_coarse, b, x0, jm, res_tol=1e-8, max_iter=200)
    serial = vcycle_solve(h_full, t(b), t(x0), res_tol=1e-8, max_iter=200)
    x = check(got, want, serial, n)
    assert np.linalg.norm(A @ x) < 1e-7


def test_pvcycle_two_level_mode_matches_jax_and_serial(rng):
    """coarse_hierarchy None: the distributed RAP and the replicated LU."""
    nx = 16
    A = poisson2d(nx)
    n = A.shape[0]
    P = sa_p(A, box_agg(nx))
    x0 = rng.randn(n)
    x0 /= np.linalg.norm(x0)
    jm, m = meshes()
    Jp = jpar.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=jnp.float64)
    Tp = par.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=F64, device="cpu")
    got = par.pvcycle_solve(Tp, P, None, np.zeros(n), x0, m, res_tol=1e-8, max_iter=300)
    want = jpar.pvcycle_solve(Jp, P, None, np.zeros(n), x0, jm, res_tol=1e-8, max_iter=300)
    serial = twolevel_solve(CSR.from_scipy(A, dtype=F64, device="cpu"), t(P),
                            torch.zeros(n, dtype=F64), t(x0), res_tol=1e-8, max_iter=300)
    x = check(got, want, serial, n)
    assert got[1] < 0.8 and np.linalg.norm(A @ x) < 1e-7


def test_singular_mean_removal_matches_jax(rng):
    """``singular``: the mean is taken out of every iterate, as JAX does,
    on the Neumann Laplacian (its LU pinned by the bordering)."""
    nx = 8
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx)).tolil()
    T[0, 0] = T[-1, -1] = 1.0
    A = sp.csr_matrix(sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx)))
    n = A.shape[0]
    P = sa_p(A, box_agg(nx))
    x0 = rng.randn(n)
    jm, m = meshes()
    Jp = jpar.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=jnp.float64)
    Tp = par.PartitionedELL.from_scipy(A, 8, halo=nx, dtype=F64, device="cpu")
    got = par.ptwolevel_solve(Tp, P, np.zeros(n), x0, m, max_iter=12, singular=True)
    want = jpar.ptwolevel_solve(Jp, P, np.zeros(n), x0, jm, max_iter=12, singular=True)
    assert got[3] == int(want[3]) == 12
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-9, atol=0)
    np.testing.assert_allclose(par.gather_global(got[0]).ravel()[:n],
                               np.asarray(want[0]).ravel()[:n], rtol=0, atol=X_ATOL)
