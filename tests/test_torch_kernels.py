"""The port's kernel plumbing: the native build helper, the ``well_spmv``
wrapper's dispatch, and (on the card) the CUDA kernel against its plain
version.

This file imports neither JAX nor ``mlamg_tpu``, so where JAX is not
installed it runs without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import ctypes
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_torch import native
from mlamg_torch.data import Grid
from mlamg_torch.ops import _build
from mlamg_torch.ops.unstructured import (
    LAUNCHES, WindowedELL, well_spmv, well_spmv_reference,
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


@pytest.mark.cuda
def test_well_spmv_cuda_kernel_matches_plain_version(rng):
    """On the card: the hand-written kernel against its plain version,
    plain and affine, and the wrapper's input checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for A in (hull(), banded(rng)):
        W = WindowedELL.from_scipy(A, device="cuda")
        n = A.shape[0]
        x = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        c = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        for cc, alpha in ((None, 1.0), (c, -1.0)):
            before = LAUNCHES["well_spmv"]
            y = well_spmv(W, x, cc, alpha)
            torch.cuda.synchronize()
            assert LAUNCHES["well_spmv"] == before + 1
            ref = well_spmv_reference(W, x, cc, alpha)
            assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        strided = torch.stack([x, x], 1)[:, 0]
        for bad_x, bad_c in ((x.double(), None), (x[:-1], None), (strided, None),
                             (x, c.double())):
            with pytest.raises(ValueError):
                well_spmv(W, bad_x, bad_c)
