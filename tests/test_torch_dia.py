"""Port parity, DIA container and SpMV: ``mlamg_torch`` against
``mlamg_tpu`` on the same numpy inputs (CPU).

The JAX side runs as its own tests run it: ``dia_spmv_pallas`` in the
Pallas interpreter, everything else on the CPU backend.  On the CPU the
port's ``dia_spmv`` is its plain version ``dia_spmv_reference``; the CUDA
kernel is held against that version on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from mlamg_tpu import native as jnative
from mlamg_tpu.ops import matmul as jmatmul
from mlamg_tpu.ops.dia import DIA as JDIA
from mlamg_tpu.ops.dia import dia_jacobi_operator as j_dia_jacobi_operator
from mlamg_tpu.ops.dia import dia_spmm as j_dia_spmm
from mlamg_tpu.ops.dia import dia_spmv as j_dia_spmv
from mlamg_tpu.ops.dia import dia_spmv_t as j_dia_spmv_t
from mlamg_tpu.ops.pallas_kernels import dia_spmv_pallas

from mlamg_torch import native
from mlamg_torch.ops import matmul
from mlamg_torch.ops.dia import (
    DIA, dia_jacobi_operator, dia_spmm, dia_spmv, dia_spmv_reference, dia_spmv_t,
)
from mlamg_torch.utils.profiler import LAUNCHES

CPU = "cpu"


def poisson2d(nx, dtype=np.float64):
    I = sp.eye(nx, format="csr", dtype=dtype)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx), dtype=dtype)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def random_banded(rng, n, offsets):
    diags = [rng.randn(n - abs(o)) for o in offsets]
    return sp.diags(diags, offsets, shape=(n, n)).tocsr()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["native", "fallback"])
def test_from_scipy_f32_matches_jax(rng, route, monkeypatch):
    if route == "fallback":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif not native.available():
        pytest.skip("needs g++ for the native DIA extraction")
    A = random_banded(rng, 300, [-37, -7, -1, 0, 2, 11, 150]).astype(np.float32)
    A = A + sp.csr_matrix(([0.0], ([5], [1])), shape=A.shape)  # explicit zero, new offset
    Aj = JDIA.from_scipy(A, dtype=jnp.float32)
    At = DIA.from_scipy(A, device=CPU)
    assert At.offsets == Aj.offsets
    assert At.data.dtype == torch.float32 and At.shape == Aj.shape
    np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))


def test_from_scipy_f64_numpy_path_matches_jax(rng):
    A = random_banded(rng, 200, [-20, -1, 0, 1, 3, 20])
    Aj = JDIA.from_scipy(A, dtype=jnp.float64)
    At = DIA.from_scipy(A, dtype=torch.float64, device=CPU)
    assert At.offsets == Aj.offsets and At.data.dtype == torch.float64
    np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))


@pytest.mark.parametrize("route", ["native", "fallback"])
def test_native_dia_extraction_matches_jax_native(rng, route, monkeypatch):
    if route == "fallback":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif not native.available():
        pytest.skip("needs g++ for the native DIA extraction")
    A = poisson2d(12, np.float32) + random_banded(rng, 144, [-30, 5]).astype(np.float32)
    offs, data = native.csr_to_dia(A)
    j_offs, j_data = jnative.csr_to_dia(A)
    np.testing.assert_array_equal(offs, j_offs)
    np.testing.assert_array_equal(data, j_data)
    assert native.count_diagonals(A) == jnative.count_diagonals(A) == len(offs) == 7
    assert DIA.num_diagonals(A) == 7


def test_to_scipy_roundtrip_and_todense(rng):
    A = random_banded(rng, 50, [-7, -1, 0, 2, 11])
    Ad = DIA.from_scipy(A, dtype=torch.float64, device=CPU)
    assert abs(Ad.to_scipy() - A).max() < 1e-12
    np.testing.assert_array_equal(Ad.todense().numpy(), A.toarray())
    assert Ad.data2d is Ad.data and Ad.device == torch.device(CPU)


@pytest.mark.parametrize("offsets", [[-1, 0, 1], [-2, 3]])
def test_diagonal_matches_jax(rng, offsets):
    A = random_banded(rng, 20, offsets)
    Aj = JDIA.from_scipy(A, dtype=jnp.float64)
    At = DIA.from_scipy(A, dtype=torch.float64, device=CPU)
    np.testing.assert_array_equal(At.diagonal().numpy(), np.asarray(Aj.diagonal()))


def test_from_scipy_rejects_rectangular():
    with pytest.raises(ValueError, match="square"):
        DIA.from_scipy(sp.eye(4, 5, format="csr"), device=CPU)


# ---------------------------------------------------------------------------
# The plain version against the TPU kernel (Pallas interpreter) and XLA
# ---------------------------------------------------------------------------


def _pallas_case(rng, case):
    if case == "poisson16":
        return poisson2d(16, np.float32), None, 1.0, 256
    if case == "poisson32_multiblock":
        return poisson2d(32, np.float32), None, 1.0, 256
    if case == "clamped_window":
        n = 128 * 64
        A = random_banded(rng, n, [-130, -128, -1, 0, 1, 127, 256]).astype(np.float32)
        return A, None, 1.0, 2048
    A = poisson2d(16, np.float32)  # affine: alpha = -1 with c
    return A, rng.randn(A.shape[0]).astype(np.float32), -1.0, 256


@pytest.mark.parametrize(
    "case", ["poisson16", "poisson32_multiblock", "clamped_window", "affine"]
)
def test_reference_matches_pallas_kernel(rng, case):
    A, c, alpha, block_rows = _pallas_case(rng, case)
    n = A.shape[0]
    x = rng.randn(n).astype(np.float32)
    Aj = JDIA.from_scipy(A, dtype=jnp.float32)
    y_j = np.asarray(dia_spmv_pallas(
        Aj, jnp.asarray(x), c=None if c is None else jnp.asarray(c), alpha=alpha,
        block_rows=block_rows, interpret=True))
    At = DIA.from_scipy(A, device=CPU)
    y_t = dia_spmv_reference(At, t(x), None if c is None else t(c), alpha).numpy()
    assert y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5 * np.abs(y_j).max())


def test_reference_matches_xla_dia_spmv_f64_ragged_n(rng):
    n = 128 * 3 + 37  # not a multiple of 128: the port has no such requirement
    A = random_banded(rng, n, [-130, -1, 0, 1, 2, 127])
    x = rng.randn(n)
    c = rng.randn(n)
    Aj = JDIA.from_scipy(A, dtype=jnp.float64)
    At = DIA.from_scipy(A, dtype=torch.float64, device=CPU)
    np.testing.assert_allclose(dia_spmv_reference(At, t(x)).numpy(),
                               np.asarray(j_dia_spmv(Aj, jnp.asarray(x))), rtol=0, atol=1e-12)
    y_j = np.asarray(jmatmul.spmv_affine(Aj, jnp.asarray(x), c=jnp.asarray(c), alpha=-1.0))
    np.testing.assert_allclose(dia_spmv_reference(At, t(x), t(c), -1.0).numpy(), y_j,
                               rtol=0, atol=1e-12)


def test_reference_with_no_diagonals():
    A = DIA(torch.zeros((0, 6), dtype=torch.float64), (), (6, 6))
    x = torch.arange(6.0, dtype=torch.float64)
    assert torch.equal(dia_spmv_reference(A, x), torch.zeros(6, dtype=torch.float64))
    assert torch.equal(dia_spmv_reference(A, x, x, -1.0), x)


@pytest.mark.parametrize("op", ["spmv_t", "spmm", "jacobi_operator"])
def test_xla_side_ops_match_jax_f64(rng, op):
    A = random_banded(rng, 150, [-12, -1, 0, 3, 40])
    Aj = JDIA.from_scipy(A, dtype=jnp.float64)
    At = DIA.from_scipy(A, dtype=torch.float64, device=CPU)
    if op == "spmv_t":
        x = rng.randn(150)
        got, want = dia_spmv_t(At, t(x)), j_dia_spmv_t(Aj, jnp.asarray(x))
    elif op == "spmm":
        X = rng.randn(150, 4)
        got, want = dia_spmm(At, t(X)), j_dia_spmm(Aj, jnp.asarray(X))
    else:
        Dinv = 1.0 / A.diagonal()
        M = dia_jacobi_operator(At, t(Dinv), 0.666)
        Mj = j_dia_jacobi_operator(Aj, jnp.asarray(Dinv), 0.666)
        assert M.offsets == Mj.offsets
        got, want = M.data, Mj.data
        assert dia_jacobi_operator(
            DIA.from_scipy(random_banded(rng, 10, [-1, 1]), torch.float64, CPU),
            torch.ones(10, dtype=torch.float64), 0.5) is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_dia_spmv_dispatch_by_device(rng):
    A = DIA.from_scipy(poisson2d(8, np.float32), device=CPU)
    x = t(rng.randn(64).astype(np.float32))
    before = LAUNCHES["dia_spmv"]
    assert torch.equal(dia_spmv(A, x), dia_spmv_reference(A, x))
    assert torch.equal(dia_spmv(A, x, x, -1.0), dia_spmv_reference(A, x, x, -1.0))
    assert LAUNCHES["dia_spmv"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        dia_spmv(A, x.to("meta"))


def test_dia_spmv_checks_vectors_on_every_device(rng):
    A = DIA.from_scipy(poisson2d(8, np.float32), device=CPU)
    x = t(rng.randn(64).astype(np.float32))
    strided = torch.stack([x, x], 1)[:, 0]
    for bad_x, bad_c in ((x[:-1], None), (strided, None), (x, x[:-1])):
        with pytest.raises(ValueError, match="contiguous"):
            dia_spmv(A, bad_x, bad_c)


def test_matmul_dispatch_matches_jax(rng):
    A = poisson2d(8)
    Aj = JDIA.from_scipy(A, dtype=jnp.float64)
    At = DIA.from_scipy(A, dtype=torch.float64, device=CPU)
    Ad = torch.from_numpy(A.toarray())
    x, c, X = rng.randn(64), rng.randn(64), rng.randn(64, 3)
    xj, cj, Xj = jnp.asarray(x), jnp.asarray(c), jnp.asarray(X)
    pairs = [
        (matmul.spmv(At, t(x)), jmatmul.spmv(Aj, xj)),
        (matmul.spmv_affine(At, t(x), t(c), -1.0), jmatmul.spmv_affine(Aj, xj, cj, -1.0)),
        (matmul.spmv_t(At, t(x)), jmatmul.spmv_t(Aj, xj)),
        (matmul.spmm(At, t(X)), jmatmul.spmm(Aj, Xj)),
        (matmul.spmv_t(Ad, t(x)), A.T @ x),
        (matmul.spmm(Ad, t(X)), A @ X),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    with pytest.raises(TypeError):
        matmul.spmv_t(object(), t(x))
