"""The port's last three native bindings and ``cli.common.load_dataset``
against the JAX package's.

``required_halo``, ``bellman_ford`` and ``fem_p1_assemble`` run on the same
inputs in both packages, once with the C++ library and once with each
package's ``_load`` patched to ``None`` (the numpy fallbacks).  Integers
are equal.  The fallbacks are the same numpy code, so their floats are
equal bit for bit; so are ``bellman_ford``'s float32 sums from the two
builds of the C++ source.  The JAX package builds it with
``-march=native`` (``native/Makefile``), which lets g++ contract the
stiffness products into fused multiply-adds, and the port without it, so
``fem_p1_assemble``'s library values are held to 1e-14 of their largest.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu import native as jnative
from mlamg_torch import native as tnative

REPO = Path(__file__).resolve().parents[1]
FEM_LIB_RTOL = 1e-14
LOAD_DATASET_ATOL = 1e-12


def poisson2d(nx):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return sp.csr_matrix(sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx)), dtype=np.float64)


@pytest.fixture(params=["library", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    else:
        assert jnative.available() and tnative.available()
    return request.param


def random_graph(seed: int, n: int = 50):
    A = sp.random(n, n, density=0.1, format="csr", random_state=np.random.RandomState(seed))
    A.data = np.abs(A.data) + 0.1
    return sp.csr_matrix(A + A.T)


def tie_graph(nx: int = 9):
    """A grid graph with every weight 1.0: many nodes lie at equal distance
    from two centers, so the nearest center is set by the tie rule."""
    A = poisson2d(nx)
    A.setdiag(0)
    A.eliminate_zeros()
    A.data[:] = 1.0
    return A


@pytest.mark.parametrize("case", ["tridiag_8", "poisson_16", "poisson_5", "random_7", "empty"])
def test_required_halo_matches_jax(path, case):
    A, n_loc = {
        "tridiag_8": (sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64)).tocsr(), 8),
        "poisson_16": (poisson2d(8), 16),
        "poisson_5": (poisson2d(8), 5),
        "random_7": (random_graph(3), 7),
        "empty": (sp.csr_matrix((12, 12)), 4),
    }[case]
    got = tnative.required_halo(A, n_loc)
    assert isinstance(got, int) and got == jnative.required_halo(A, n_loc)
    if case == "tridiag_8":
        assert got == 1
    if case == "poisson_16":
        assert got == 8


@pytest.mark.parametrize("case", ["random", "ties", "unreachable"])
def test_bellman_ford_matches_jax(path, case, monkeypatch):
    if case == "random":
        A, centers = random_graph(0), np.array([1, 20, 40])
    elif case == "ties":
        A, centers = tie_graph(), np.array([0, 8, 40, 72, 80])
    else:
        A = sp.block_diag([tie_graph(4), tie_graph(3)]).tocsr()
        centers = np.array([0, 5])
    dist, near = tnative.bellman_ford(A, centers)
    # the JAX package's fallback relaxes with A's float64 weights and never
    # ends on weights float32 does not hold; it is held on the float32
    # matrix, which the port's fallback and both libraries relax with
    jdist, jnear = jnative.bellman_ford(A.astype(np.float32), centers)
    assert dist.dtype == np.float32 and near.dtype == np.int32
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(near, jnear)
    if path == "numpy":
        monkeypatch.undo()
        np.testing.assert_array_equal(dist, tnative.bellman_ford(A, centers)[0])
        np.testing.assert_array_equal(near, tnative.bellman_ford(A, centers)[1])
    if case == "unreachable":
        assert np.isinf(dist[16:]).all() and (near[16:] == -1).all()
    if case == "random":
        import scipy.sparse.csgraph as csgraph

        ref = csgraph.dijkstra(sp.csr_matrix(A, dtype=np.float32), indices=centers,
                               min_only=True)
        np.testing.assert_allclose(dist, ref, rtol=1e-5)


@pytest.mark.parametrize("kappa", ["identity", "anisotropic", "per_triangle"])
def test_fem_p1_assemble_matches_jax(path, kappa):
    from mlamg_torch.data import fem

    v, e = fem.regular_triangle_mesh(6, 6)
    m = len(e)
    if kappa == "identity":
        K = np.tile(np.eye(2), (m, 1, 1))
    elif kappa == "anisotropic":
        K = np.tile(fem.anisotropic_kappa(0.1, 0.3)(0.0, 0.0), (m, 1, 1))
    else:
        rng = np.random.RandomState(4)
        L = rng.randn(m, 2, 2)
        K = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(2)
    rows, cols, vals = tnative.fem_p1_assemble(v, e, K)
    jrows, jcols, jvals = jnative.fem_p1_assemble(v, e, K)
    assert rows.dtype == cols.dtype == np.int64 and vals.dtype == np.float64
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)
    if path == "numpy":
        np.testing.assert_array_equal(vals, jvals)
    else:
        assert np.abs(vals - jvals).max() <= FEM_LIB_RTOL * np.abs(jvals).max()
    if kappa == "identity":
        A = sp.coo_matrix((vals, (rows, cols)), shape=(len(v),) * 2).tocsr()
        assert abs(A - fem.gradgradform(v, e)).max() < 1e-10


def test_load_dataset_matches_jax(tmp_path):
    from mlamg_tpu.cli.common import load_dataset as jload
    from mlamg_torch.cli.common import load_dataset

    import jax.numpy as jnp

    src = REPO / "data_out" / "2d_iso"
    for split, names in (("train", ["isotropic_0000.grid", "isotropic_0003.grid"]),
                         ("test", sorted(p.name for p in (src / "test").glob("*.grid"))[:2])):
        (tmp_path / split).mkdir()
        for name in names:
            shutil.copy(src / split / name, tmp_path / split / name)
    train, test = load_dataset(str(tmp_path), 0.1, torch.float64, device="cpu")
    jtrain, jtest = jload(str(tmp_path), 0.1, jnp.float64)
    assert (len(train), len(test)) == (len(jtrain), len(jtest)) == (2, 2)
    for b, jb in zip(train + test, jtrain + jtest):
        assert b.k == jb.k and b.A.shape == jb.A.shape and b.A.device.type == "cpu"
        assert b.A.dtype == b.x0.dtype == torch.float64
        np.testing.assert_allclose(b.A.todense().numpy(), np.asarray(jb.A.todense()),
                                   rtol=0, atol=LOAD_DATASET_ATOL)
        np.testing.assert_allclose(b.x0.numpy(), np.asarray(jb.x0), rtol=0,
                                   atol=LOAD_DATASET_ATOL)
        assert b.num_colors == jb.num_colors
        np.testing.assert_array_equal(b.colors.numpy(), np.asarray(jb.colors))


def test_load_dataset_defaults_to_cuda(monkeypatch):
    from mlamg_torch.cli.common import load_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_dataset(str(REPO / "data_out" / "2d_iso"), 0.1, torch.float64)
