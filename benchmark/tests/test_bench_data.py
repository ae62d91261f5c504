"""The benchmark's data makers and references against the measured
package and against the plain definitions, at small sizes on the CPU."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from reference import hull_fem, poisson2d, sa_aggregation


def poisson_scipy(ny, nx):
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    Tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(sp.eye(ny), Tx) + sp.kron(Ty, sp.eye(nx))).tocsr()


@pytest.mark.parametrize("n, seed", [(500, 7), (3000, 3)])
def test_frozen_hull_is_the_packages_bit_for_bit(n, seed):
    from mlamg_torch.data import Grid

    want = Grid.random_2d_unstructured(n, seed=seed).A.tocsr()
    got = hull_fem.random_hull_fem(n, seed)
    assert got.shape == want.shape and got.nnz == want.nnz
    assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data, want.data)


def test_hull_cache_round_trip(tmp_path):
    A = hull_fem.load_or_make(400, 5, str(tmp_path))
    B = hull_fem.load_or_make(400, 5, str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["hull_400_5.npz"]
    assert (A != B).nnz == 0


def test_poisson_diagonals_are_the_packages_dia_of_the_scipy_matrix():
    from mlamg_torch.ops.dia import DIA

    ny, nx = 12, 16
    want = DIA.from_scipy(poisson_scipy(ny, nx).astype(np.float32), device="cpu")
    assert want.offsets == poisson2d.offsets(nx)
    assert torch.equal(poisson2d.diagonals(ny, nx, "cpu"), want.data)
    x = torch.randn(ny * nx, dtype=torch.float64)
    ref = torch.from_numpy(poisson_scipy(ny, nx) @ x.numpy())
    assert torch.allclose(poisson2d.apply(x, ny, nx), ref, rtol=0, atol=1e-13)


def test_bilinear_coarse_operator_is_the_dense_galerkin_product():
    ny, nx, scale = 12, 16, 1.7
    A = poisson_scipy(ny, nx).toarray() * scale

    def p1(n):
        P = np.zeros((n, n // 2))
        j = np.arange(n // 2)
        P[2 * j + 1, j], P[2 * j, j], P[2 * j[:-1] + 2, j[:-1]] = 1.0, 0.5, 0.5
        return P

    P = np.kron(p1(ny), p1(nx))
    AH = P.T @ A @ P
    offsets, data = poisson2d.coarse_dia(ny, nx, scale, "cpu", torch.float64)
    k = AH.shape[0]
    for d, off in enumerate(offsets):
        i = np.arange(max(0, -off), min(k, k - off))
        assert np.allclose(data[d].numpy()[i], AH[i, i + off], rtol=0, atol=1e-14)
    band = np.zeros_like(AH)
    for off in offsets:
        band += np.diag(np.diag(AH, off), off)
    assert np.array_equal(band, AH)  # nothing outside the nine diagonals


def test_sa_reference_matches_the_dense_product():
    A = hull_fem.random_hull_fem(300, 1)
    n = A.shape[0]
    agg = np.arange(n) % 40
    d = A.diagonal()
    omega = (4.0 / 3.0) / np.max(np.asarray(abs(A).sum(1)).ravel() / d)
    T = np.zeros((n, 40))
    T[np.arange(n), agg] = 1.0
    P = (np.eye(n) - omega * np.diag(1 / d) @ A.toarray()) @ T
    want = P.T @ A.toarray() @ P
    got = hull_fem.galerkin(A, agg, 40).toarray()
    assert np.allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    low = hull_fem.galerkin(A, agg, 40, low=True).toarray()
    assert 1e-4 < np.abs(low - want).max() / np.abs(want).max() < 1e-1


def test_rcm_breaks_ties_by_index():
    # node 0 tied to all, 1-2, 2-3 and 3-4 tied; degrees (stored entries)
    # 5, 3, 4, 4, 3
    A = sp.csr_matrix(np.array([[1, 1, 1, 1, 1],
                                [1, 1, 1, 0, 0],
                                [1, 1, 1, 1, 0],
                                [1, 0, 1, 1, 1],
                                [1, 0, 0, 1, 1]], float))
    # from node 1 (the lowest index of degree 3): 1, then 0 and 2 by degree
    # (2 before 0), then 3 and 4
    assert sa_aggregation.rcm(A).tolist() == [4, 3, 0, 2, 1]


@pytest.mark.parametrize("n, seed", [(3000, 7), (8000, 7), (5000, 2)])
def test_reference_aggregation_is_the_packages(n, seed):
    from mlamg_torch.mg.amg_unstructured import build_unstructured_hierarchy

    A = sp.csr_matrix(hull_fem.random_hull_fem(n, seed), dtype=np.float32)
    perm, agg, k = sa_aggregation.aggregate(A, 0.2, 5)
    h, perm0 = build_unstructured_hierarchy(A, device="cpu", alpha=0.2, max_levels=3,
                                            min_coarse=100, lloyd_maxiter=5)
    assert np.array_equal(perm, perm0) and k == h.levels[0].k
    mine, ref = np.empty(A.shape[0], np.int64), np.empty(A.shape[0], np.int64)
    mine[perm0], ref[perm] = h.levels[0].agg.numpy(), agg
    assert sa_aggregation.nodes_apart(mine, ref) == 0


def test_partitions_compare_whatever_their_labels():
    a = np.array([2, 2, 0, 1, 0, 3])
    assert sa_aggregation.nodes_apart(a, a * 7 + 3) == 0
    # nodes 3 and 5 merged: the two aggregates they left and the one they
    # form are apart, the others stay matched
    b = np.array([2, 2, 0, 1, 0, 1])
    assert sa_aggregation.nodes_apart(b, a) == 2
    c = np.array([2, 2, 2, 1, 0, 3])  # node 2 moved: its old and new aggregate
    assert sa_aggregation.nodes_apart(c, a) == 4
