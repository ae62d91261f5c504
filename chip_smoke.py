#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mlamg_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases (each prints one JSON line; any failure exits non-zero):

1. device: the card's name and power limit from nvidia-smi.
2. kernels: build every CUDA kernel from ``mlamg_torch/ops/csrc`` with nvcc,
   then hold ``well_spmv`` against its plain PyTorch version
   (``well_spmv_reference``) to 1e-5 * max|y|, plain and affine
   (alpha=-1, c), on the RCM-ordered random-hull FEM matrix and on a small
   banded matrix with uneven row degrees; time kernel, plain version and
   the torch.sparse CSR matvec with CUDA events.
3. path: the unstructured multilevel SA-AMG solve, as bench.py drives the
   JAX package: ``build_unstructured_hierarchy(alpha=0.2, max_levels=5,
   min_coarse=1200, lloyd_maxiter=5, fmt="well")`` on the 600k-dof hull
   (seed 7), then ``uvcycle_solve`` W(4,4) Chebyshev from a seed-0 random
   x0 with b = 0.  Checks the conv factor against the JAX package's
   0.4811 (+-0.03) and <= 20 W-cycles to 1e-6, that the solve launched the
   kernel exactly as often as the cycle's structure says, that the kernel
   agrees with the plain version on every level operator, that the
   permuted system solves the original one (relative residual < 1e-4 in
   float64 scipy), and that a small hierarchy's cycle on the card matches
   the same cycle on the CPU.  Times a W-cycle with CUDA events and reads
   a torch.profiler trace of three W-cycles for the device's busy time and
   idle share.

Then one line ``{"kernels": [...]}`` with each kernel's launches on the
main path, its largest error against the plain version over every check,
its time, the plain version's and the library call's time, and its bound
(from the stored nonzeros; ``bound_ell_ms`` adds the ELL padding slots);
the nvidia-smi line;
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
N_DOFS = 600_000  # interior dofs of the random-hull FEM matrix (bench.py hull600k)
SEED = 7
REF_CONV = 0.4811  # JAX package, same configuration (BENCH_r05.json)
CONV_TOL = 0.03
MAX_CYCLES = 20
KERNEL_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` warmed calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_error(W, x, c, alpha):
    """(max |kernel - plain|, max |plain|) of one call."""
    import torch
    from mlamg_torch.ops.unstructured import well_spmv, well_spmv_reference

    y = well_spmv(W, x, c, alpha)
    torch.cuda.synchronize()
    ref = well_spmv_reference(W, x, c, alpha)
    check(bool(torch.isfinite(y).all()), "well_spmv returned non-finite values")
    return float((y - ref).abs().max()), float(ref.abs().max())


def check_kernel(W, rng, label: str) -> tuple[float, float]:
    """Hold well_spmv against its plain version, plain and affine.
    Returns the largest (absolute, relative) error of the two calls."""
    import torch

    n = W.shape[0]
    x = torch.from_numpy(rng.randn(n).astype(np.float32)).to(W.device)
    c = torch.from_numpy(rng.randn(n).astype(np.float32)).to(W.device)
    abs_err = rel_err = 0.0
    for form, cc, alpha in (("plain", None, 1.0), ("affine", c, -1.0)):
        err, scale = kernel_error(W, x, cc, alpha)
        check(err <= KERNEL_RTOL * scale,
              f"well_spmv {form} on {label}: max err {err} > {KERNEL_RTOL} * {scale}")
        abs_err, rel_err = max(abs_err, err), max(rel_err, err / scale)
    return abs_err, rel_err


def banded_matrix(rng, n: int = 700, band: int = 60):
    """Non-FEM banded matrix with uneven row degrees (tests/test_unstructured.py)."""
    import scipy.sparse as sp

    A = sp.random(n, n, density=0.01, format="lil", random_state=rng)
    A.setdiag(1.0)
    coo = sp.csr_matrix(A).tocoo()
    keep = np.abs(coo.row - coo.col) <= band
    return sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n)
    ).astype(np.float32)


def kernel_phase(Ap, rng) -> dict:
    """Build the kernels, check well_spmv, time it (plain form, L2-cold
    operator: its 8 B per slot exceed the 50 MB L2 at the main path's
    fine level)."""
    import torch
    from mlamg_torch.ops import _build
    from mlamg_torch.ops.unstructured import WindowedELL, well_spmv, well_spmv_reference

    t0 = time.time()
    libs = _build.build_kernels()
    build_s = time.time() - t0

    W = WindowedELL.from_scipy(Ap, device="cuda")
    errs = [check_kernel(W, rng, "hull"),
            check_kernel(WindowedELL.from_scipy(banded_matrix(rng), device="cuda"),
                         rng, "banded")]

    n, w, n_pad = W.shape[0], W.width, W.n_pad
    x = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(Ap.indptr.astype(np.int64)),
        torch.from_numpy(Ap.indices.astype(np.int64)),
        torch.from_numpy(Ap.data.astype(np.float32)),
        size=Ap.shape, check_invariants=True,
    ).cuda()
    y_lib = torch.mv(A_csr, x)
    y_ref = well_spmv_reference(W, x)
    check(float((y_lib - y_ref).abs().max()) <= KERNEL_RTOL * float(y_ref.abs().max()),
          "torch.sparse CSR matvec disagrees with the plain version")

    ms = cuda_ms(lambda: well_spmv(W, x))
    plain_ms = cuda_ms(lambda: well_spmv_reference(W, x))
    library_ms = cuda_ms(lambda: torch.mv(A_csr, x))
    affine_ms = cuda_ms(lambda: well_spmv(W, x, c, -1.0))
    affine_plain_ms = cuda_ms(lambda: well_spmv_reference(W, x, c, -1.0))
    # least bytes of the function: each stored nonzero (value and column)
    # read once, x read, y written (c read in the affine form).  The ELL
    # layout also moves its padding slots: bound_ell_ms counts w * n_pad.
    nnz = int(Ap.nnz)
    bound_ms = max((nnz * 8 + 2 * n * 4) / HBM_BYTES_PER_S,
                   2 * nnz / F32_FLOPS) * 1e3
    bound_ell_ms = max((w * n_pad * 8 + 2 * n * 4) / HBM_BYTES_PER_S,
                       2 * w * n_pad / F32_FLOPS) * 1e3
    affine_bound_ms = max((nnz * 8 + 3 * n * 4) / HBM_BYTES_PER_S,
                          (2 * nnz + 2 * n) / F32_FLOPS) * 1e3
    return {
        "name": "well_spmv",
        "route": "cuda",
        "source": "mlamg_torch/ops/csrc/well_spmv.cu",
        "replaces": "mlamg_tpu/ops/unstructured.py:141",
        "max_abs_err": max(e[0] for e in errs),
        "max_rel_err": max(e[1] for e in errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "bound_ell_ms": bound_ell_ms,
        "affine_ms": affine_ms,
        "affine_plain_ms": affine_plain_ms,
        "affine_bound_ms": affine_bound_ms,
        "n": n,
        "nnz": nnz,
        "w": w,
        "n_pad": n_pad,
        "build_s": build_s,
        "libraries": sorted(p.name for p in libs.values()),
    }


def launches_per_cycle(h, nu: int, gamma: int) -> int:
    """well_spmv launches of one uvcycle: per level visit 2*(nu+1)
    Chebyshev residuals, one residual, and one SpMV per omega each in
    restriction and interpolation; level l is visited gamma**l times."""
    return sum(
        gamma ** l * (2 * (nu + 1) + 1 + 2 * len(lev.omegas))
        for l, lev in enumerate(h.levels)
    )


def device_trace(fn, iters: int) -> dict:
    """Profile ``iters`` calls of ``fn`` with torch.profiler and read the
    device's timeline: busy time (union of kernel, copy and set intervals)
    against the span from the first to the last device activity, and
    well_spmv's own kernel time.  All times in ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    )
    busy_us, end = 0.0, -np.inf
    for lo, hi, _ in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    span_us = spans[-1][1] - spans[0][0] if spans else 0.0
    spmv = [hi - lo for lo, hi, name in spans if "well_spmv" in name]
    return {
        "device_ops": len(spans) / iters,
        "busy_ms": busy_us / iters / 1e3,
        "span_ms": span_us / iters / 1e3,
        "idle_share": (1.0 - busy_us / span_us) if span_us > 0 else None,
        "well_spmv_kernels": len(spmv) / iters,
        "well_spmv_ms": sum(spmv) / iters / 1e3,
    }


def path_phase(A, rng) -> tuple[dict, int, list]:
    import torch
    from mlamg_torch.mg.amg_unstructured import (
        build_unstructured_hierarchy, uvcycle, uvcycle_solve,
    )
    from mlamg_torch.ops.unstructured import LAUNCHES

    dev = "cuda"
    n = A.shape[0]
    cycle = dict(nu=4, lmin_frac=1 / 15, gamma=2)
    prof: dict = {}

    # --- the main path: counts set to 0 just before, read just after ---
    LAUNCHES.clear()
    t0 = time.time()
    h, perm = build_unstructured_hierarchy(
        A, alpha=0.2, max_levels=5, min_coarse=1200, lloyd_maxiter=5,
        fmt="well", device=dev, profile_out=prof,
    )
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    x0 = torch.from_numpy(np.random.RandomState(0).randn(n).astype(np.float32)).to(dev)
    b = torch.zeros(n, dtype=torch.float32, device=dev)
    t0 = time.time()
    x, conv, err, iters = uvcycle_solve(h, b, x0, res_tol=1e-6, max_iter=40, **cycle)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    launches = LAUNCHES["well_spmv"]
    # ---------------------------------------------------------------------

    hist = err[:iters].cpu().numpy()
    expected = iters * (launches_per_cycle(h, cycle["nu"], cycle["gamma"]) + 1)
    check(launches == expected,
          f"well_spmv launched {launches} times in the solve, expected {expected}")
    check(bool(np.isfinite(hist).all()) and bool(torch.isfinite(x).all()),
          "solve produced non-finite values")
    check(abs(conv - REF_CONV) <= CONV_TOL,
          f"conv factor {conv} not within {CONV_TOL} of {REF_CONV}")
    check(iters <= MAX_CYCLES and hist[-1] <= 1e-6,
          f"{iters} W-cycles, final residual {hist[-1]} (want <= {MAX_CYCLES} to 1e-6)")

    level_errs = [check_kernel(lev.A, rng, f"level {l}")
                  for l, lev in enumerate(h.levels)]

    cycle_ms = cuda_ms(lambda: uvcycle(h, b, x0, **cycle), iters=5, warmup=1)
    t0 = time.time()
    for _ in range(5):
        uvcycle(h, b, x0, **cycle)
    torch.cuda.synchronize()
    cycle_wall_ms = (time.time() - t0) / 5 * 1e3
    trace = device_trace(lambda: uvcycle(h, b, x0, **cycle), iters=3)

    # permuted system with a random right-hand side, checked in the
    # original ordering in float64
    rhs = np.random.RandomState(1).randn(n).astype(np.float32)
    xs, _, _, iters_rhs = uvcycle_solve(
        h, torch.from_numpy(rhs[perm]).to(dev), torch.zeros_like(b),
        res_tol=1e-6 * float(np.linalg.norm(rhs)), max_iter=40, **cycle,
    )
    sol = np.empty(n, np.float64)
    sol[perm] = xs.cpu().numpy()
    rel_res = float(np.linalg.norm(A.astype(np.float64) @ sol - rhs) / np.linalg.norm(rhs))
    check(rel_res < 1e-4, f"permuted-system relative residual {rel_res} >= 1e-4")

    return {
        "phase": "path",
        "n": n,
        "nnz": int(A.nnz),
        "num_levels": h.num_levels,
        "levels": [
            {"n": lev.A.shape[0], "nnz": lev.A.nnz, "k": lev.k, "w": lev.A.width}
            for lev in h.levels
        ],
        "coarse_k": int(h.coarse.lu.shape[0]),
        "setup_s": setup_s,
        "setup_profile_s": prof,
        "conv": conv,
        "iters": iters,
        "residual_history": [float(v) for v in hist],
        "solve_s": solve_s,
        "ms_per_wcycle": cycle_ms,
        "wall_ms_per_wcycle": cycle_wall_ms,
        "wcycle_trace": trace,
        "well_spmv_launches": launches,
        "well_spmv_launches_per_wcycle": launches_per_cycle(h, cycle["nu"], cycle["gamma"]),
        "level_kernel_rel_err": [e[1] for e in level_errs],
        "rhs_iters": iters_rhs,
        "rhs_rel_residual": rel_res,
    }, launches, level_errs


def small_cycle_phase() -> dict:
    """One W-cycle of a small hierarchy on the card against the same
    cycle on the CPU (where well_spmv is the plain version)."""
    import torch
    from mlamg_torch.data import Grid
    from mlamg_torch.mg.amg_unstructured import build_unstructured_hierarchy, uvcycle

    A = Grid.random_2d_unstructured(1500, seed=3).A.astype(np.float32)
    kw = dict(alpha=0.2, max_levels=4, min_coarse=60, lloyd_maxiter=5, fmt="well")
    x0 = np.random.RandomState(0).randn(A.shape[0]).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        h, _ = build_unstructured_hierarchy(A, device=dev, **kw)
        x = torch.from_numpy(x0).to(dev)
        out[dev] = uvcycle(h, torch.zeros_like(x), x, nu=3, lmin_frac=1 / 15,
                           gamma=2).cpu().numpy()
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    scale = float(np.abs(out["cpu"]).max())
    check(err <= 1e-4 * scale, f"small W-cycle cuda vs cpu: {err} > 1e-4 * {scale}")
    return {"phase": "small_cycle", "n": A.shape[0], "max_abs_err": err, "scale": scale}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: torch.cuda.is_available() is false")
    import mlamg_torch  # noqa: F401  (fails outside the repository)
    from mlamg_torch.data import Grid
    from mlamg_torch import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.time()
    A = Grid.random_2d_unstructured(N_DOFS, seed=SEED).A.astype(np.float32)
    perm = native.rcm_ordering(A)
    Ap = A[perm][:, perm].tocsr()
    emit({"phase": "matrix", "n": A.shape[0], "nnz": int(A.nnz),
          "seconds": time.time() - t0, "native_rcm": native.available()})

    rng = np.random.RandomState(0)
    kernel = kernel_phase(Ap, rng)
    emit({"phase": "kernels", **{k: kernel[k] for k in ("build_s", "max_rel_err", "ms")}})
    path, launches, level_errs = path_phase(A, rng)
    emit(path)
    emit(small_cycle_phase())

    kernel["launches"] = launches
    kernel["max_abs_err"] = max(kernel["max_abs_err"], *(e[0] for e in level_errs))
    kernel["max_rel_err"] = max(kernel["max_rel_err"], *(e[1] for e in level_errs))
    emit({"kernels": [kernel]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
