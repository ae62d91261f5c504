"""Port parity, the sparse core: the containers' construction and
conversion methods, ``coalesce``, ``spgemm``, ``rap``, ``rap_fused`` (and
its gradient), the chunked ``spgemm_masked``, ``auto_format`` and the
native ELL packing and colouring, ``mlamg_torch`` against ``mlamg_tpu`` on
the same numpy inputs (CPU, float64 unless a test says otherwise).

Duplicates in ``coalesce`` add in the order of each package's unstable
sort, so float64 values agree to rounding (1e-12 relative); patterns,
overflow flags and truncation agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu.ops import matmul as jmm
from mlamg_tpu.ops.dia import DIA as JDIA
from mlamg_tpu.ops.dia import auto_format as j_auto_format
from mlamg_tpu.ops.sparse import COO as JCOO
from mlamg_tpu.ops.sparse import CSR as JCSR
from mlamg_tpu.ops.sparse import ELL as JELL

from mlamg_torch import native
from mlamg_torch.mg.smoothers import greedy_coloring, greedy_coloring_py
from mlamg_torch.ops import matmul
from mlamg_torch.ops.dia import DIA, auto_format
from mlamg_torch.ops.sparse import COO, CSR, ELL

CPU = "cpu"
F64 = torch.float64
RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's products here are thousands of small tensor ops: under
    pytest's parallel workers, torch's default of one thread per core
    oversubscribes the CPU and slows them several times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_csr(rng, m, n, density=0.1):
    A = sp.random(m, n, density=density, format="csr", random_state=rng)
    A.data = rng.randn(A.nnz)
    A.eliminate_zeros()
    A.sort_indices()
    return A


def pair(A, dtype=np.float64, nnz_pad=None):
    """(JAX CSR, port CSR) of one scipy matrix."""
    tdt = F64 if dtype == np.float64 else torch.float32
    return (JCSR.from_scipy(A, nnz_pad=nnz_pad, dtype=jnp.dtype(dtype)),
            CSR.from_scipy(A, nnz_pad=nnz_pad, dtype=tdt, device=CPU))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def assert_csr_equal(Ct, Cj, rtol=RTOL):
    """Same pattern, padding and indptr; values within ``rtol`` of the
    largest."""
    for name in ("row", "col", "indptr"):
        np.testing.assert_array_equal(getattr(Ct, name).numpy(), np.asarray(getattr(Cj, name)),
                                      err_msg=name)
    assert Ct.shape == tuple(Cj.shape) and Ct.nnz == Cj.nnz
    dj = np.asarray(Cj.data)
    np.testing.assert_allclose(Ct.data.detach().numpy(), dj, rtol=0,
                               atol=rtol * max(np.abs(dj).max(initial=0), 1e-300))


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


def test_coo_from_scipy_todense_to_scipy_match_jax(rng):
    A = random_csr(rng, 37, 53).tocoo()
    Aj = JCOO.from_scipy(A, dtype=jnp.float64)
    At = COO.from_scipy(A, dtype=F64, device=CPU)
    assert At.nnz_pad == Aj.nnz_pad == 256 and At.nnz == Aj.nnz == 196 and At.dtype == F64
    for name in ("data", "row", "col"):
        np.testing.assert_array_equal(getattr(At, name).numpy(), np.asarray(getattr(Aj, name)))
    np.testing.assert_array_equal(At.mask.numpy(), np.asarray(Aj.mask))
    np.testing.assert_array_equal(At.todense().numpy(), np.asarray(Aj.todense()))
    assert abs(At.to_scipy() - Aj.to_scipy()).max() == 0
    # duplicates sum in both directions
    D = COO(t([1.0, 2.0, 3.0, 0.0]), t([0, 1, 0, 2]), t([1, 2, 1, 0]), (2, 3), 4)
    np.testing.assert_array_equal(D.todense().numpy(), [[0, 4.0, 0], [0, 0, 2.0]])
    assert D.to_scipy()[0, 1] == 4.0 and D.to_scipy().nnz == 2


def test_csr_from_dense_and_as_coo_match_jax(rng):
    M = random_csr(rng, 19, 23, density=0.2).toarray()
    for nnz_pad in (int((M != 0).sum()) + 9, int((M != 0).sum()) - 5):
        Cj = JCSR.from_dense(jnp.asarray(M), nnz_pad)
        Ct = CSR.from_dense(t(M), nnz_pad)
        assert_csr_equal(Ct, Cj, rtol=0)
        Oj, Ot = Cj.as_coo(), Ct.as_coo()
        assert isinstance(Ot, COO) and Ot.nnz == Oj.nnz and Ot.shape == Oj.shape
        np.testing.assert_array_equal(Ot.todense().numpy(), np.asarray(Oj.todense()))


def test_csr_triangles_scalings_and_degrees_match_jax(rng):
    A = random_csr(rng, 25, 25, density=0.3)
    Aj, At = pair(A)
    for k in (-2, 0, 3):
        assert_csr_equal(At.triu(k), Aj.triu(k), rtol=0)
        assert_csr_equal(At.tril(k), Aj.tril(k), rtol=0)
    s = rng.randn(25)
    assert_csr_equal(At.scale_rows(t(s)), Aj.scale_rows(jnp.asarray(s)), rtol=0)
    assert_csr_equal(At.scale_cols(t(s)), Aj.scale_cols(jnp.asarray(s)), rtol=0)
    np.testing.assert_array_equal(At.row_degrees().numpy(), np.asarray(Aj.row_degrees()))
    assert abs(At.triu(1).to_scipy() - sp.triu(A, 1)).max() == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ell_from_scipy_and_to_scipy_match_jax(rng, dtype):
    A = random_csr(rng, 29, 31, density=0.2).astype(dtype)
    tdt = F64 if dtype == np.float64 else torch.float32
    for width in (None, int(np.diff(A.indptr).max()) + 3):
        Ej = JELL.from_scipy(A, width=width, dtype=jnp.dtype(dtype))
        Et = ELL.from_scipy(A, width=width, dtype=tdt, device=CPU)
        assert Et.dtype == tdt and Et.width == Ej.width
        np.testing.assert_array_equal(Et.data.numpy(), np.asarray(Ej.data))
        np.testing.assert_array_equal(Et.col.numpy(), np.asarray(Ej.col))
        assert abs(Et.to_scipy() - Ej.to_scipy()).max() == 0
        assert abs(Et.to_scipy() - A).max() == 0
    with pytest.raises(ValueError, match="width"):
        ELL.from_scipy(A, width=1, dtype=tdt, device=CPU)


def test_auto_format_matches_jax(rng):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(12, 12))
    stencil = (sp.kron(sp.eye(12), T) + sp.kron(T, sp.eye(12))).tocsr()
    scattered = random_csr(rng, 60, 60, density=0.3)
    for A, kind in ((stencil, DIA), (scattered, ELL), (random_csr(rng, 20, 30), ELL)):
        got = auto_format(A, device=CPU)
        want = j_auto_format(A)
        assert isinstance(got, kind) and type(want) is (JDIA if kind is DIA else JELL)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert isinstance(auto_format(stencil, max_diagonals=4, device=CPU), ELL)


def test_native_ell_packing_and_colouring_match_their_numpy_paths(rng):
    A = random_csr(rng, 300, 300, density=0.03) + sp.eye(300)
    A = (A + A.T).tocsr()
    assert native.available()
    data, cols = native.csr_to_ell(A, 40)
    data_np, cols_np = native.csr_to_ell_numpy(A, 40)
    np.testing.assert_array_equal(data, data_np)
    np.testing.assert_array_equal(cols, cols_np)
    with pytest.raises(ValueError, match="exceeds width"):
        native.csr_to_ell(A, 2)
    colors, nc = native.greedy_coloring(A)
    py = greedy_coloring_py(A)
    np.testing.assert_array_equal(colors, py)
    np.testing.assert_array_equal(greedy_coloring(A), colors)
    assert nc == int(py.max()) + 1
    coo = A.tocoo()
    off = coo.row != coo.col
    assert (colors[coo.row[off]] != colors[coo.col[off]]).all()


# ---------------------------------------------------------------------------
# the sort-based core
# ---------------------------------------------------------------------------


def triplets(rng, m, n, E):
    """Random (data, row, col) with repeated coordinates and padding."""
    row = rng.randint(0, m, E)
    col = rng.randint(0, n, E)
    row[rng.rand(E) < 0.1] = m  # padding slots anywhere
    half = E // 2
    row[half:] = row[:E - half]  # every coordinate of the tail repeats
    col[half:] = col[:E - half]
    return rng.randn(E), row.astype(np.int32), col.astype(np.int32)


@pytest.mark.parametrize("shape", [(13, 17), (70_000, 40_000)])
def test_coalesce_matches_jax_including_overflow(rng, shape):
    """Both key paths of the JAX package (packed int32 and two keys) give
    the port's one int64 order; too small a capacity keeps the smallest
    coordinates and raises the flag in both."""
    m, n = shape
    d, r, c = triplets(rng, m, n, 300)
    true_nnz = len({(a, b) for a, b in zip(r, c) if a < m})
    for nnz_out in (true_nnz + 20, true_nnz, true_nnz - 7):
        Cj, ovj = jmm.coalesce(jnp.asarray(d), jnp.asarray(r), jnp.asarray(c), shape, nnz_out,
                               return_overflow=True)
        Ct, ovt = matmul.coalesce(t(d), t(r).long(), t(c).long(), shape, nnz_out,
                                  return_overflow=True)
        assert bool(ovt) == bool(ovj) == (nnz_out < true_nnz)
        assert_csr_equal(Ct, Cj)
    ref = sp.coo_matrix((d[r < m], (r[r < m], c[r < m])), shape=shape).tocsr()
    full = matmul.coalesce(t(d), t(r).long(), t(c).long(), shape, true_nnz)
    assert abs(full.to_scipy() - ref).max() <= RTOL * abs(ref).max()


def test_spgemm_matches_jax_with_stored_zeros_and_overflow(rng):
    A = random_csr(rng, 25, 30, density=0.3)
    B = random_csr(rng, 30, 20, density=0.3)
    B.data[::5] = 0.0  # stored zeros make no pattern entry (JAX's live rule)
    wb = int(np.diff(B.indptr).max())
    true_nnz = (A @ B).tocsr()
    true_nnz.eliminate_zeros()
    Aj, At = pair(A)
    Bj, Bt = pair(B)
    nnz_live = None
    for nnz_out in (true_nnz.nnz + 40, 16):
        Cj, ovj = jmm.spgemm(Aj, Bj, nnz_out=nnz_out, b_width=wb, return_overflow=True)
        Ct, ovt = matmul.spgemm(At, Bt, nnz_out=nnz_out, b_width=wb, return_overflow=True)
        assert bool(ovt) == bool(ovj)
        assert_csr_equal(Ct, Cj)
        if nnz_live is None:
            nnz_live = int(Ct.mask.sum())
            assert not bool(ovt)
            assert abs(Ct.to_scipy() - A @ B).max() <= RTOL * abs(A @ B).max()
    assert bool(ovt) and nnz_live > 16
    # the live rule: the pattern holds no coordinate that only a stored zero makes
    Bnz = B.copy()
    Bnz.eliminate_zeros()
    assert nnz_live == (sp.csr_matrix(abs(A)) @ sp.csr_matrix(abs(Bnz))).nnz


@pytest.mark.parametrize("nnz_out", [512, 8])
def test_rap_matches_jax(rng, nnz_out):
    n, k = 64, 16
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    P = random_csr(rng, n, k, density=0.15) + sp.csr_matrix(
        (np.ones(n), (np.arange(n), np.arange(n) // 4)), shape=(n, k))
    P = P.tocsr()
    wp = int(np.diff(P.indptr).max())
    Aj, At = pair(A)
    Pj, Pt = pair(P)
    kw = dict(nnz_ap=512, nnz_out=nnz_out, a_width=3, p_width=wp)
    Hj, ovj = jmm.rap(Aj, Pj, return_overflow=True, **kw)
    Ht, ovt = matmul.rap(At, Pt, return_overflow=True, **kw)
    assert bool(ovt) == bool(ovj) == (nnz_out == 8)
    assert_csr_equal(Ht, Hj)
    assert_csr_equal(matmul.rap(At, Pt, **kw), Hj)
    if nnz_out == 512:
        ref = (P.T @ A @ P).toarray()
        np.testing.assert_allclose(Ht.todense().numpy(), ref, rtol=0, atol=RTOL * abs(ref).max())


@pytest.mark.parametrize("slack", [8, -10])
def test_rap_fused_matches_jax(rng, slack):
    n, k = 60, 12
    A = random_csr(rng, n, n, density=0.15)
    P = random_csr(rng, n, k, density=0.3)
    wp = int(np.diff(P.indptr).max())
    true = (P.T @ A @ P).tocsr()
    Aj, At = pair(A)
    Pj, Pt = pair(P)
    kw = dict(k=k, nnz_out=int(true.nnz) + slack, p_width=wp)
    Hj, ovj = jmm.rap_fused(Aj, Pj, return_overflow=True, **kw)
    Ht, ovt = matmul.rap_fused(At, Pt, return_overflow=True, **kw)
    assert bool(ovt) == bool(ovj) == (slack < 0)
    assert_csr_equal(Ht, Hj)
    if slack > 0:
        np.testing.assert_allclose(Ht.todense().numpy(), true.toarray(), rtol=0,
                                   atol=RTOL * abs(true).max())


def test_rap_fused_gradient_matches_jax_grad(rng):
    """d sum(A_H.data^2) / d P.data and / d A.data through autograd
    against jax.grad (float64, 1e-10 relative)."""
    n, k = 20, 5
    A = random_csr(rng, n, n, density=0.2)
    P = random_csr(rng, n, k, density=0.4)
    wp = int(np.diff(P.indptr).max())
    Aj, At = pair(A)
    Pj, Pt = pair(P)

    def fj(adata, pdata):
        H = jmm.rap_fused(Aj.with_data(adata), Pj.with_data(pdata), k=k, nnz_out=64, p_width=wp)
        return jnp.sum(H.data ** 2)

    ga, gp = jax.grad(fj, argnums=(0, 1))(Aj.data, Pj.data)
    adata = At.data.clone().requires_grad_(True)
    pdata = Pt.data.clone().requires_grad_(True)
    H = matmul.rap_fused(At.with_data(adata), Pt.with_data(pdata), k=k, nnz_out=64, p_width=wp)
    (H.data ** 2).sum().backward()
    for got, want in ((adata.grad, ga), (pdata.grad, gp)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the pattern-masked product
# ---------------------------------------------------------------------------


def test_spgemm_masked_chunks_equal_whole_and_sum_duplicates(rng):
    """Chunked equals unchunked bit for bit; duplicate coordinates in B's
    rows all add (scipy's sum), and the whole equals JAX's."""
    n, k = 90, 30
    A = random_csr(rng, n, n, density=0.08) + sp.eye(n)
    A = A.tocsr()
    agg = rng.randint(0, k, n)
    coo = A.tocoo()
    # B on A's coordinates with aggregate-mapped columns: duplicates per row
    vals = rng.randn(A.nnz)
    Aj, At = pair(A)
    B_t = CSR(t(np.concatenate([vals, np.zeros(At.nnz_pad - A.nnz)])), At.row,
              t(agg)[At.col], At.indptr, (n, k), At.nnz)
    B_j = JCSR(jnp.asarray(B_t.data.numpy()), Aj.row, jnp.asarray(agg)[Aj.col].astype(jnp.int32),
               Aj.indptr, (n, k), Aj.nnz)
    B_sp = sp.csr_matrix((vals, (coo.row, agg[coo.col])), shape=(n, k))
    pat = (abs(A) @ abs(B_sp)).tocsr()
    pat.data[:] = 1.0
    pat.sort_indices()
    w = int(np.diff(A.indptr).max())
    pj, pt = pair(pat)
    kw = dict(a_width=w, b_width=w)
    whole = matmul.spgemm_masked(At, B_t, pt, **kw)
    for chunk in (7, 64, 10_000):
        part = matmul.spgemm_masked(At, B_t, pt, chunk=chunk, **kw)
        np.testing.assert_array_equal(part.data.numpy(), whole.data.numpy())
    ref = (A @ B_sp).tocsr()
    assert abs(whole.to_scipy() - ref).max() <= RTOL * abs(ref).max()
    want = jmm.spgemm_masked(Aj, B_j, pj, chunk=64, **kw)
    assert_csr_equal(whole, want)
