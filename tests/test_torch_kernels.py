"""The port's kernel plumbing: the native build helper, the ``well_spmv``
wrapper's dispatch, and (on the card) the CUDA kernels ``well_spmv`` and
``dia_spmv`` against their plain versions.

This file imports neither JAX nor ``mlamg_tpu``, so where JAX is not
installed it runs without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_torch import native
from mlamg_torch.data import Grid
from mlamg_torch.ops import _build
from mlamg_torch.ops.dia import DIA, DIA_MAX_D, dia_spmv, dia_spmv_reference
from mlamg_torch.ops.unstructured import (
    LANES, LAUNCHES, WindowedELL, sliced_spmv_reference, well_spmv, well_spmv_reference,
)


def hull(n=800, seed=5):
    A = Grid.random_2d_unstructured(n, seed=seed).A.astype(np.float32)
    perm = native.rcm_ordering(A)
    return A[perm][:, perm].tocsr()


def banded(rng, n=700, band=60):
    A = sp.random(n, n, density=0.01, format="lil", random_state=rng)
    A.setdiag(1.0)
    coo = sp.csr_matrix(A).tocoo()
    keep = np.abs(coo.row - coo.col) <= band
    return sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n)
    ).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def cxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("needs g++")
    return path


def test_compile_libraries_builds_and_loads(tmp_path, monkeypatch, cxx):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "twice.cpp"
    src.write_text('extern "C" int twice(int x) { return 2 * x; }\n')
    command = (cxx, "-O2", "-fPIC", "-shared")
    out = _build.library_path("twice", src, command)
    assert out.parent == tmp_path / "build"
    _build.compile_library(command, src, out)
    lib = ctypes.CDLL(str(out))
    lib.twice.argtypes, lib.twice.restype = [ctypes.c_int], ctypes.c_int
    assert lib.twice(21) == 42
    # an edited source gets a new library name
    src.write_text('extern "C" int twice(int x) { return x + x; }\n')
    assert _build.library_path("twice", src, command) != out


def test_compile_libraries_reports_errors_and_cleans_up(tmp_path, monkeypatch, cxx):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    command = (cxx, "-fPIC", "-shared")
    out = _build.library_path("broken", src, command)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        _build.compile_library(command, src, out)
    assert list((tmp_path / "build").iterdir()) == []


def test_well_spmv_dispatch_by_device(rng):
    W = WindowedELL.from_scipy(banded(rng), device="cpu")
    x = torch.from_numpy(rng.randn(W.shape[0]).astype(np.float32))
    before = LAUNCHES["well_spmv"]
    assert torch.equal(well_spmv(W, x), well_spmv_reference(W, x))
    assert LAUNCHES["well_spmv"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        well_spmv(W, x.to("meta"))


def empty_rows(rng, n=1000):
    """Banded matrix whose first 64 rows (two whole slices) and every 7th
    row are empty."""
    A = banded(rng, n).tolil()
    for r in [*range(64), *range(64, n, 7)]:
        A.rows[r], A.data[r] = [], []
    return sp.csr_matrix(A)


@pytest.mark.cuda
def test_well_spmv_cuda_kernel_matches_plain_version(rng):
    """On the card: the hand-written kernel at every LANES and sigma 1 and
    256 against its plain versions (bit for bit on the sliced pack, 1e-5
    relative on the ELL arrays), plain and affine; the launch counter; and
    the wrapper's input checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for A in (hull(), banded(rng), empty_rows(rng), banded(rng, n=32 * 40 + 5)):
        n = A.shape[0]
        x = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        c = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        for sigma in (1, 256):
            W = WindowedELL.from_scipy(A, device="cuda", sigma=sigma)
            for lanes in LANES:
                Wl = dataclasses.replace(W, lanes=lanes)
                for cc, alpha in ((None, 1.0), (c, -1.0)):
                    before = LAUNCHES["well_spmv"]
                    y = well_spmv(Wl, x, cc, alpha)
                    torch.cuda.synchronize()
                    assert LAUNCHES["well_spmv"] == before + 1
                    assert torch.equal(y, sliced_spmv_reference(Wl, x, cc, alpha))
                    ref = well_spmv_reference(W, x, cc, alpha)
                    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        strided = torch.stack([x, x], 1)[:, 0]
        for bad_x, bad_c in ((x.double(), None), (x[:-1], None), (strided, None),
                             (x, c.double())):
            with pytest.raises(ValueError):
                well_spmv(W, bad_x, bad_c)
        with pytest.raises(ValueError, match="lanes"):
            well_spmv(dataclasses.replace(W, lanes=3), x)


def test_kernel_sources_are_registered():
    assert _build.KERNEL_SOURCES == {"well_spmv": "well_spmv.cu", "dia_spmv": "dia_spmv.cu"}
    for src in _build.KERNEL_SOURCES.values():
        assert (_build.CSRC / src).is_file()
    text = (_build.CSRC / "dia_spmv.cu").read_text()
    assert f"#define DIA_MAX_D {DIA_MAX_D}" in text and DIA_MAX_D >= 64


@pytest.mark.cuda
def test_dia_spmv_cuda_kernel_matches_plain_version(rng):
    """On the card: the hand-written DIA kernel against its plain version,
    plain and affine, the launch counter, and the wrapper's input checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    n_ragged = 128 * 64 + 37  # no multiple-of-128 requirement
    offsets = [-130, -128, -1, 0, 1, 127, 256]
    banded_dia = sp.diags([rng.randn(n_ragged - abs(o)) for o in offsets], offsets,
                          shape=(n_ragged, n_ragged)).tocsr().astype(np.float32)
    Tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64))
    poisson = (sp.kron(sp.eye(64), Tx) + sp.kron(Tx, sp.eye(64))).tocsr().astype(np.float32)
    for A in (poisson, banded_dia):
        Ad = DIA.from_scipy(A, device="cuda")
        n = A.shape[0]
        x = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        c = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        for cc, alpha in ((None, 1.0), (c, -1.0)):
            before = LAUNCHES["dia_spmv"]
            y = dia_spmv(Ad, x, cc, alpha)
            torch.cuda.synchronize()
            assert LAUNCHES["dia_spmv"] == before + 1
            ref = dia_spmv_reference(Ad, x, cc, alpha)
            assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        strided = torch.stack([x, x], 1)[:, 0]
        for bad_x, bad_c in ((x.double(), None), (x[:-1], None), (strided, None),
                             (x, c.double()), (x.cpu(), None)):
            with pytest.raises(ValueError):
                dia_spmv(Ad, bad_x, bad_c)
        too_many = DIA(torch.zeros((DIA_MAX_D + 1, n), device="cuda"),
                       tuple(range(DIA_MAX_D + 1)), (n, n))
        with pytest.raises(ValueError, match="at most"):
            dia_spmv(too_many, x)
