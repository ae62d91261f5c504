"""The sliced pack of ``WindowedELL`` (SELL-32-sigma) and the plain version
of the CUDA kernel that reads it, ``sliced_spmv_reference`` (CPU).

The pack must hold exactly the matrix, in the layout the kernel indexes;
the plain version must compute what ``well_spmv_reference`` and JAX's
``well_spmv_pallas`` (in the Pallas interpreter) compute.  The kernel
itself is held against it on the card by ``tests/test_torch_kernels.py``
and ``chip_smoke.py``.
"""

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp
import pytest
import torch

from mlamg_tpu import native as jnative
from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.ops.unstructured import WindowedELL as JWELL
from mlamg_tpu.ops.unstructured import well_spmv_pallas

from mlamg_torch.ops.unstructured import (
    LANE_THREADS, LANES, SIGMA, SLICE, WindowedELL, choose_lanes,
    sliced_spmv_reference, well_spmv_reference,
)

CPU = "cpu"
SIGMAS = (1, 32, 256)


def hull(n, seed=3):
    A = sp.csr_matrix(JGrid.random_2d_unstructured(n, seed=seed).A).astype(np.float32)
    perm = jnative.rcm_ordering(A)
    return A[perm][:, perm].tocsr()


def banded(n=700, band=60, seed=0):
    rng = np.random.RandomState(seed)
    A = sp.random(n, n, density=0.01, format="lil", random_state=rng)
    A.setdiag(1.0)
    coo = sp.csr_matrix(A).tocoo()
    keep = np.abs(coo.row - coo.col) <= band
    return sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n)
    ).astype(np.float32)


def empty_rows(n=1000):
    """The first 64 rows (two whole slices) and every 7th row empty."""
    A = banded(n).tolil()
    for r in [*range(64), *range(64, n, 7)]:
        A.rows[r], A.data[r] = [], []
    return sp.csr_matrix(A)


MATRICES = {
    "hull800": lambda: hull(800),
    "hull2000": lambda: hull(2000, seed=5),
    "banded": banded,
    "empty_rows": empty_rows,
    "n_below_32": lambda: banded(n=20, band=6),
    "n_32k_plus_5": lambda: banded(n=32 * 40 + 5, band=90),
}
SPMV_MATRICES = ("hull800", "banded", "empty_rows", "n_32k_plus_5")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def pack(W):
    return {name: getattr(W, name).numpy()
            for name in ("row_perm", "slice_ptr", "slice_w", "sdata", "scol")}


def lane_slots(P, s):
    """(values, columns) of slice s, one row of slots per lane."""
    lo, hi = P["slice_ptr"][s], P["slice_ptr"][s + 1]
    w = P["slice_w"][s]
    return P["sdata"][lo:hi].reshape(w, SLICE).T, P["scol"][lo:hi].reshape(w, SLICE).T


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_pack_unpacks_to_the_matrix(name, sigma):
    A = MATRICES[name]()
    A.sort_indices()
    n = A.shape[0]
    W = WindowedELL.from_scipy(A, device=CPU, sigma=sigma)
    P = pack(W)
    rows, cols, vals = [], [], []
    for s in range(W.n_slices):
        v, k = lane_slots(P, s)
        for lane in range(SLICE):
            r = int(P["row_perm"][s * SLICE + lane])
            if r >= n:  # dummy lane: value 0, column 0
                assert not v[lane].any() and not k[lane].any()
                continue
            lo, hi = A.indptr[r], A.indptr[r + 1]
            d = hi - lo
            np.testing.assert_array_equal(k[lane, :d], A.indices[lo:hi])
            np.testing.assert_array_equal(v[lane, :d], A.data[lo:hi])
            # padding: value 0 and the row's first column (its own row if empty)
            assert not v[lane, d:].any()
            assert (k[lane, d:] == (A.indices[lo] if d else r)).all()
            rows += [r] * d
            cols += list(k[lane, :d])
            vals += list(v[lane, :d])
    B = sp.csr_matrix((vals, (rows, cols)), shape=A.shape)
    assert B.nnz == A.nnz == W.nnz
    assert (B != A).nnz == 0
    assert W.sdata.dtype == torch.float32 and W.scol.dtype == torch.int32
    assert W.row_perm.dtype == W.slice_ptr.dtype == W.slice_w.dtype == torch.int32


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_pack_structure(name, sigma):
    A = MATRICES[name]()
    n = A.shape[0]
    deg = np.diff(A.indptr)
    W = WindowedELL.from_scipy(A, device=CPU, sigma=sigma)
    P = pack(W)
    S = W.n_slices
    perm = P["row_perm"]
    assert S == -(-n // SLICE) and perm.shape == (S * SLICE,)
    # a permutation inside each sigma window; dummy lanes at the end
    np.testing.assert_array_equal(np.sort(perm[:n]), np.arange(n))
    assert (perm[:n] // sigma == np.arange(n) // sigma).all()
    assert (perm[n:] >= n).all()
    # inside a window: degree descending, then row id ascending
    for lo in range(0, n, sigma):
        rows = perm[lo:min(lo + sigma, n)]
        key = list(zip(-deg[rows], rows))
        assert key == sorted(key)
    # each slice is as wide as its widest row, and slots follow the widths
    lane_deg = np.zeros(S * SLICE, np.int64)
    lane_deg[:n] = deg[perm[:n]]
    np.testing.assert_array_equal(P["slice_w"], lane_deg.reshape(S, SLICE).max(1, initial=0))
    np.testing.assert_array_equal(np.diff(P["slice_ptr"]), SLICE * P["slice_w"])
    assert P["slice_ptr"][0] == 0 and P["slice_ptr"][-1] == W.slots
    assert W.slots <= W.width * W.n_pad
    assert W.sigma == sigma and W.lanes == choose_lanes(n)


def test_sorting_window_cuts_the_padding():
    A = hull(2000, seed=5)
    slots = {s: WindowedELL.from_scipy(A, device=CPU, sigma=s).slots for s in SIGMAS}
    ell = WindowedELL.from_scipy(A, device=CPU)
    assert A.nnz <= slots[256] < slots[32] == slots[1] < ell.width * ell.n_pad
    assert SIGMA == 256


def test_sigma_must_be_positive():
    with pytest.raises(ValueError, match="sigma"):
        WindowedELL.from_scipy(banded(), device=CPU, sigma=0)


def inputs(name, affine, seed=1):
    A = MATRICES[name]()
    rng = np.random.RandomState(seed)
    x = rng.randn(A.shape[0]).astype(np.float32)
    c = rng.randn(A.shape[0]).astype(np.float32) if affine else None
    return A, x, c, (-1.0 if affine else 1.0)


def assert_rel(y, ref, rtol):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    assert np.abs(y - ref).max() <= rtol * np.abs(ref).max()


FORMS = [pytest.param(False, id="plain"), pytest.param(True, id="affine")]


@pytest.mark.parametrize("affine", FORMS)
@pytest.mark.parametrize("sigma", (1, 256))
@pytest.mark.parametrize("name", SPMV_MATRICES)
def test_lanes_1_equals_ell_reference_bit_for_bit(name, sigma, affine):
    A, x, c, alpha = inputs(name, affine)
    W = WindowedELL.from_scipy(A, device=CPU, sigma=sigma)
    cc = None if c is None else t(c)
    y = sliced_spmv_reference(W, t(x), cc, alpha, lanes=1)
    assert torch.equal(y, well_spmv_reference(W, t(x), cc, alpha))


@pytest.mark.parametrize("affine", FORMS)
@pytest.mark.parametrize("lanes", (2, 4, 8))
@pytest.mark.parametrize("name", SPMV_MATRICES)
def test_lanes_change_only_the_summation_order(name, lanes, affine):
    A, x, c, alpha = inputs(name, affine)
    W = WindowedELL.from_scipy(A, device=CPU)
    cc = None if c is None else t(c)
    y = sliced_spmv_reference(W, t(x), cc, alpha, lanes=lanes)
    assert_rel(y, well_spmv_reference(W, t(x), cc, alpha), 1e-6)


@pytest.mark.parametrize("affine", FORMS)
@pytest.mark.parametrize("name", SPMV_MATRICES)
def test_sliced_reference_matches_pallas(name, affine):
    A, x, c, alpha = inputs(name, affine)
    yj = np.asarray(well_spmv_pallas(JWELL.from_scipy(A), jnp.asarray(x),
                                     c=None if c is None else jnp.asarray(c),
                                     alpha=alpha, interpret=True))
    W = WindowedELL.from_scipy(A, device=CPU)
    for lanes in LANES:
        y = sliced_spmv_reference(W, t(x), None if c is None else t(c), alpha, lanes=lanes)
        assert_rel(y.numpy(), yj, 1e-6)


@pytest.mark.parametrize("affine", FORMS)
@pytest.mark.parametrize("name", SPMV_MATRICES)
def test_sliced_reference_matches_scipy_f64(name, affine):
    A, x, c, alpha = inputs(name, affine)
    A64, x64 = A.astype(np.float64), x.astype(np.float64)
    ref = alpha * (A64 @ x64) + (0.0 if c is None else c.astype(np.float64))
    W = WindowedELL.from_scipy(A64, device=CPU, dtype=torch.float64)
    assert W.sdata.dtype == torch.float64
    for lanes in LANES:
        y = sliced_spmv_reference(W, t(x64), None if c is None else t(c.astype(np.float64)),
                                  alpha, lanes=lanes)
        assert_rel(y.numpy(), ref, 1e-12)


@pytest.mark.parametrize("name", ("hull800", "empty_rows"))
def test_sliced_reference_sums_slots_in_order(name):
    """At lanes 1 each row adds its slots one after another from zero, the
    order the kernel keeps; dummy lanes write nothing."""
    A, x, _, _ = inputs(name, False)
    W = WindowedELL.from_scipy(A, device=CPU)
    P = pack(W)
    y = np.full(len(x), np.nan, np.float32)
    for s in range(W.n_slices):
        v, k = lane_slots(P, s)
        acc = np.zeros(SLICE, np.float32)
        for j in range(v.shape[1]):
            acc = acc + v[:, j] * x[k[:, j]]
        rows = P["row_perm"][s * SLICE:(s + 1) * SLICE]
        y[rows[rows < len(x)]] = acc[rows < len(x)]
    assert not np.isnan(y).any()
    np.testing.assert_array_equal(sliced_spmv_reference(W, t(x), lanes=1).numpy(), y)


@pytest.mark.parametrize("n,lanes", [(600_000, 1), (120_000, 4), (24_000, 8), (4_800, 8),
                                     (LANE_THREADS, 1), (LANE_THREADS - 1, 2),
                                     (LANE_THREADS // 2, 2), (LANE_THREADS // 4, 4)])
def test_lanes_rule(n, lanes):
    """The fewest warps per slice that give LANE_THREADS threads, at most 8
    (the 600k hierarchy's levels: 1, 4, 8, 8)."""
    assert choose_lanes(n) == lanes
    assert LANES == (1, 2, 4, 8) and LANE_THREADS == 2**18
