"""The port's kernel plumbing: the native build helper, the ``well_spmv``
wrapper's dispatch, the ordered sums' CPU path and launch arguments, and
(on the card) the CUDA kernels ``well_spmv``, ``dia_spmv`` and
``ordered_sum`` against their plain versions.

This file imports neither JAX nor ``mlamg_tpu``, so where JAX is not
installed it runs without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import ctypes
import dataclasses
import math
import os
import shutil
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_torch import native
from mlamg_torch.data import Grid
from mlamg_torch.ops import _build
from mlamg_torch.ops import segment
from mlamg_torch.ops.dia import DIA, DIA_MAX_D, dia_spmv, dia_spmv_reference
from mlamg_torch.ops.segment import (
    ordered_sum, ordered_sum_reference, slot_sum, slot_sum_reference, tree_sum,
)
from mlamg_torch.ops.sparse import segment_slots
from mlamg_torch.ops.unstructured import (
    LANES, WindowedELL, sliced_spmv_reference, well_spmv, well_spmv_reference,
)
from mlamg_torch.utils.profiler import LAUNCHES


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
    assert _build.KERNEL_SOURCES == {"well_spmv": "well_spmv.cu", "dia_spmv": "dia_spmv.cu",
                                     "ordered_sum": "ordered_sum.cu"}
    for src in _build.KERNEL_SOURCES.values():
        assert (_build.CSRC / src).is_file()
    text = (_build.CSRC / "dia_spmv.cu").read_text()
    assert f"#define DIA_MAX_D {DIA_MAX_D}" in text and DIA_MAX_D >= 64
    text = (_build.CSRC / "ordered_sum.cu").read_text()
    assert f"#define ORDERED_SUM_MAX_DIMS {segment.MAX_DIMS}" in text


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


# --- the ordered sums (ops/segment.py, ops/csrc/ordered_sum.cu) ---

WIDTHS = (1, 2, 31, 32, 33, 257)


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns as integers (NaN payloads and signed
    zeros included)."""
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def special(x: torch.Tensor, rng) -> torch.Tensor:
    """x with +-0.0, +-inf and NaN written at random places."""
    flat = x.reshape(-1).clone()
    picks = rng.choice(flat.numel(), size=min(flat.numel(), 12), replace=False)
    for i, v in zip(picks, [0.0, -0.0, math.inf, -math.inf, math.nan, -0.0] * 2):
        flat[int(i)] = v
    return flat.view(x.shape)


def sum_inputs(rng, dtype, device, width):
    """(x, dim) pairs with ``width`` along dim: contiguous, sliced and
    transposed, at dims 0, 1 and -1, some holding +-0.0, +-inf and NaN."""
    out = []
    for dim in (0, 1, -1):
        shape = [5, 6, 4]
        shape[dim] = width
        x = torch.from_numpy(rng.randn(*shape)).to(dtype=dtype, device=device)
        wide = torch.from_numpy(rng.randn(*[2 * s + 1 for s in shape])).to(dtype=dtype,
                                                                             device=device)
        out += [(x, dim), (special(x, rng), dim),
                (wide[1::2, 1::2, 1::2], dim),  # sliced: every stride 2, an offset
                (x.transpose(0, 2).contiguous().transpose(0, 2), dim),  # transposed layout
                (x.permute(2, 0, 1), dim)]
    return out


def slot_inputs(rng, dtype, device):
    """(values, slots) pairs: scalar and (E, 3) values, contiguous and
    strided, with pad slots and empty segments, some holding +-0.0, +-inf
    and NaN."""
    out = []
    for E, segments in ((1628, 250), (300, 40), (7, 12)):
        ids = torch.from_numpy(rng.randint(0, segments - 2, E))  # the last two empty
        slots = segment_slots(ids.to(device), segments)
        for inner in ((), (3,)):
            v = torch.from_numpy(rng.randn(E, *inner)).to(dtype=dtype, device=device)
            strided = torch.from_numpy(rng.randn(*inner, 2 * E)).to(
                dtype=dtype, device=device).movedim(-1, 0)[::2]
            out += [(v, slots), (special(v, rng), slots), (strided, slots),
                    (v, slots.t().contiguous().t())]
    return out


def test_ordered_sums_on_the_cpu_are_the_plain_chain(monkeypatch):
    """On the CPU ordered_sum and slot_sum are the chain of adds (its bits
    written out here), count no launch and build nothing."""
    def fail(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "kernel_library", fail)
    rng = np.random.RandomState(1)
    before = LAUNCHES["ordered_sum"]
    for dtype in (torch.float32, torch.float64):
        for width in (1, 2, 33):
            for x, dim in sum_inputs(rng, dtype, "cpu", width):
                want = x.select(dim, 0)
                for k in range(1, x.shape[dim]):
                    want = want + x.select(dim, k)
                assert same_bits(ordered_sum(x, dim), want)
                assert same_bits(ordered_sum_reference(x, dim), want)
        for v, slots in slot_inputs(rng, dtype, "cpu"):
            padded = torch.cat([v, torch.zeros_like(v[:1])])
            assert same_bits(slot_sum(v, slots), ordered_sum_reference(padded[slots], 1))
    assert ordered_sum(torch.zeros(3, 0, 2), 1).equal(torch.zeros(3, 2))
    assert slot_sum(torch.ones(4), torch.zeros(3, 0, dtype=torch.int64)).equal(torch.zeros(3))
    assert LAUNCHES["ordered_sum"] == before


def emulate_launch(name, entry, t, double, *args):
    """The kernel's loops in Python on the launch's arguments, reading the
    tensors' storage as the kernel reads device memory."""
    assert name == "ordered_sum" and double == (t.dtype == torch.float64)
    plan = list(args[-1])
    if entry == "ordered_sum":  # x, out, plan
        out_ptr = args[1]
        n_out, w, stride_w, geom = plan[0], plan[1], plan[2], plan[3:]
        inner, slots = 1, None
    else:  # slot_sum: values, slots, out, plan
        out_ptr = args[2]
        m, inner, E, stride_e, w, slot_row, slot_col = plan[:7]
        geom = plan[7:]
        n_out, slots = m * inner, emulate_launch.slots
    nd = geom[0]
    size, stride = list(geom[1:1 + nd]), list(geom[1 + nd:1 + 2 * nd])
    flat = torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)
    start = t.storage_offset()
    out = torch.empty(n_out, dtype=t.dtype)
    for o in range(n_out):
        i, j = divmod(o, inner)
        off, rest = start, (o if slots is None else j)
        for d in reversed(range(nd)):
            off += (rest % size[d]) * stride[d]
            rest //= size[d]
        if slots is None:
            terms = [flat[off + k * stride_w] for k in range(w)]
        else:
            flat_slots, base = slots
            ids = [int(flat_slots[base + i * slot_row + k * slot_col]) for k in range(w)]
            terms = [flat[off + e * stride_e] if 0 <= e < E else torch.zeros((), dtype=t.dtype)
                     for e in ids]
        acc = terms[0].clone()
        for term in terms[1:]:
            acc = acc + term
        out[o] = acc
    ctypes.memmove(out_ptr, out.data_ptr(), n_out * t.element_size())


@pytest.mark.parametrize("form", ["ordered_sum", "slot_sum"])
def test_ordered_sum_launch_arguments_give_the_chain(monkeypatch, form):
    """The wrapper's launch arguments (merged geometry, strides, slot
    strides) run through the kernel's loops in Python give the plain
    chain's bits, on contiguous, sliced and transposed inputs."""
    monkeypatch.setattr(_build, "launch", emulate_launch)
    rng = np.random.RandomState(2)
    for dtype in (torch.float32, torch.float64):
        if form == "ordered_sum":
            for width in (1, 5):
                for x, dim in sum_inputs(rng, dtype, "cpu", width):
                    got = segment._ordered_sum_cuda(x, dim % x.ndim)
                    assert same_bits(got, ordered_sum_reference(x, dim))
        else:
            for v, slots in slot_inputs(rng, dtype, "cpu")[-8:]:
                emulate_launch.slots = (torch.as_strided(
                    slots, (slots.untyped_storage().nbytes() // 8,), (1,), 0),
                    slots.storage_offset())
                assert same_bits(segment._slot_sum_cuda(v, slots), slot_sum_reference(v, slots))


def test_ordered_sum_geometry_merges_dimensions():
    geom = segment._geometry
    assert geom((250, 8), (64, 1)) == [2, 250, 8, 64, 1]  # a Dense's (n, d_in, d_out), dim 1
    assert geom((4, 5, 6), (30, 6, 1)) == [1, 120, 1]
    assert geom((1, 7, 1), (99, 3, 5)) == [1, 7, 3]
    assert geom((), ()) == [0]
    with pytest.raises(ValueError, match="at most"):
        segment._geometry((2,) * 9, tuple(3 ** i for i in range(9)))


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_ordered_sum_cuda_kernel_matches_plain_chain(monkeypatch):
    """On the card: ordered_sum equals the plain chain bit for bit at dims
    0, 1, -1, widths 1-257, contiguous, sliced and transposed, float32 and
    float64, with +-0.0, +-inf and NaN; one launch a call; tree_sum of a
    600k vector as with the plain chain."""
    needs_cuda()
    rng = np.random.RandomState(3)
    for dtype in (torch.float32, torch.float64):
        for width in WIDTHS:
            for x, dim in sum_inputs(rng, dtype, "cuda", width):
                before = LAUNCHES["ordered_sum"]
                got = ordered_sum(x, dim)
                torch.cuda.synchronize()
                assert LAUNCHES["ordered_sum"] == before + 1
                assert same_bits(got, ordered_sum_reference(x, dim)), (dtype, width, dim)
    x = torch.randn(600_000, device="cuda")
    fused = tree_sum(x[:, None])
    monkeypatch.setattr(segment, "ordered_sum", ordered_sum_reference)
    assert same_bits(fused, tree_sum(x[:, None]))
    assert ordered_sum(torch.zeros(3, 0, 2, device="cuda"), 1).equal(
        torch.zeros(3, 2, device="cuda"))
    with pytest.raises(ValueError, match="float32 or float64"):
        ordered_sum(torch.ones(4, 3, device="cuda", dtype=torch.float16), 1)


@pytest.mark.cuda
def test_slot_sum_cuda_kernel_matches_plain_chain():
    """On the card: slot_sum equals the plain gather and chain bit for bit,
    with pad slots, empty segments, strided values and slots, +-0.0,
    +-inf and NaN; one launch a call."""
    needs_cuda()
    rng = np.random.RandomState(4)
    for dtype in (torch.float32, torch.float64):
        for v, slots in slot_inputs(rng, dtype, "cuda"):
            before = LAUNCHES["ordered_sum"]
            got = slot_sum(v, slots)
            torch.cuda.synchronize()
            assert LAUNCHES["ordered_sum"] == before + 1
            assert same_bits(got, slot_sum_reference(v, slots))
    v = torch.randn(5, device="cuda")
    assert slot_sum(v, torch.zeros(3, 0, dtype=torch.int64, device="cuda")).equal(
        torch.zeros(3, device="cuda"))
    with pytest.raises(ValueError, match="int64"):
        slot_sum(v, torch.zeros(3, 2, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
def test_ordered_sum_cuda_gradients_match_plain_chain():
    """On the card under autograd: the kernel's gradients equal the plain
    chain's bit for bit, for ordered_sum and slot_sum, float32 and
    float64; without grad no autograd node is made."""
    needs_cuda()
    rng = np.random.RandomState(5)
    for dtype in (torch.float32, torch.float64):
        for x, dim in sum_inputs(rng, dtype, "cuda", 33)[:5]:
            g = torch.from_numpy(rng.randn(*ordered_sum_reference(x, dim).shape)).to(x)
            grads = []
            for fn in (ordered_sum, ordered_sum_reference):
                leaf = x.detach().clone().requires_grad_(True)
                y = fn(leaf * 1.5, dim)
                (y * g).sum().backward()
                grads.append(leaf.grad)
            assert same_bits(*grads)
        for v, slots in slot_inputs(rng, dtype, "cuda")[:4]:
            g = torch.from_numpy(rng.randn(slots.shape[0], *v.shape[1:])).to(v)
            grads = []
            for fn in (slot_sum, slot_sum_reference):
                leaf = v.detach().clone().requires_grad_(True)
                (fn(leaf, slots) * g).sum().backward()
                grads.append(leaf.grad)
            assert same_bits(*grads)
    x = torch.randn(4, 3, device="cuda", requires_grad=True)
    with torch.no_grad():
        assert ordered_sum(x, 1).grad_fn is None
    assert ordered_sum(x, 1).grad_fn is not None


def plain_sums(monkeypatch):
    """Every module of the port that bound ordered_sum or slot_sum gets the
    plain version instead."""
    plain = {ordered_sum: ordered_sum_reference, slot_sum: slot_sum_reference}
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("mlamg_torch"):
            continue
        for name in ("ordered_sum", "slot_sum"):
            fn = getattr(mod, name, None)
            if fn in plain:
                monkeypatch.setattr(mod, name, plain[fn])


@pytest.mark.cuda
def test_learned_build_and_solve_equal_the_plain_sums_on_the_card(monkeypatch):
    """On the card: the learned build and a 3-cycle learned_solve on a test
    grid through the kernel equal, bit for bit, the same run with every
    ordered and slot sum the plain chain: masks, scores, centers, C, agg_id,
    P-hat, P, A_H and x."""
    needs_cuda()
    from mlamg_torch.cli.evaluate_dataset import load_model
    from mlamg_torch.mg.learned import build_learned_twolevel, learned_solve
    from mlamg_torch.ops.sparse import CSR

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    grids = Grid.load_dir(os.path.join(repo, "data_out", "2d_iso", "test"))
    grid = grids[0]
    net, _ = load_model(os.path.join(repo, "runs_iso_r5", "grad_best.ckpt"), grids,
                        device="cuda")
    A = CSR.from_scipy(grid.A, device="cuda")
    n = A.shape[0]
    b = torch.from_numpy(np.random.RandomState(6).randn(n).astype(np.float32)).cuda()

    def run():
        h = build_learned_twolevel(net, A, math.ceil(0.1 * n))
        x, _, _, iters = learned_solve(h, b, res_tol=0.0, max_iter=3)
        torch.cuda.synchronize()
        p = h.parts
        return [*p.masks, *p.scores, p.centers, p.C.data, p.agg_id, p.p_hat, p.P.data,
                p.P.col, h.A_H, x], iters

    before = LAUNCHES["ordered_sum"]
    fused, iters = run()
    launches = LAUNCHES["ordered_sum"] - before
    plain_sums(monkeypatch)
    before = LAUNCHES["ordered_sum"]
    plain, plain_iters = run()
    assert LAUNCHES["ordered_sum"] == before and launches > 0
    assert iters == plain_iters == 3
    for i, (a, b_) in enumerate(zip(fused, plain)):
        assert same_bits(a, b_) if a.is_floating_point() else torch.equal(a, b_), i
