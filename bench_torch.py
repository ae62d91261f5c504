#!/usr/bin/env python3
"""bench.py's seven measurements through the PyTorch/CUDA port on one NVIDIA card.

    python3 bench_torch.py [--seed S] [--cells NAME ...] [--samples N] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (the port's device rule,
``mlamg_torch/device.py``).  Earlier lines: the card's ``nvidia-smi
--query-gpu=name,power.limit`` line and one JSON line per cell.  The last
line is one JSON object shaped like bench.py's: the headline ``metric``,
``value`` and ``unit``, and ``detail.extra_metrics`` with the other cells
under bench.py's metric names.  A cell that raises or fails its check makes
the run exit non-zero with no last line; nothing falls back to a plain
version or to the CPU.

Cells, with bench.py's function, metric, unit and sizes:

1. ``spmv`` (``main``): ``spmv_hbm_roofline_fraction``: ``dia_spmv``
   (``mlamg_torch/ops/csrc/dia_spmv.cu``) on the 4096^2 five-point Poisson
   in the flat (D, n) DIA; bytes 4 (D n + 2 n) per product over the
   L2-cold time, over the card's HBM rate.
2. ``unstructured``: ``unstructured_spmv_gnnz_per_s``: ``well_spmv``
   (``ops/csrc/well_spmv.cu``) on the RCM-ordered 600k-dof random hull
   (seed 7), stored nonzeros over the L2-cold time.
3. ``twolevel``: ``twolevel_cycle_ms``: ``twolevel_solve`` on the 512^2
   Poisson, factored SA over 16x16 boxes (omega 0.65), inverse coarse
   solve; a sample is one solve of ``iters`` iterations, over ``iters``.
4. ``vcycle_16m``: ``vcycle_16m_ms``: the all-DIA bilinear hierarchy of
   the 4096^2 Poisson (sides 2, min_coarse 900), Chebyshev V(2,2); first
   the 6-cycle convergence factor, which must be finite and below 1.
5. ``unstructured_multilevel``: ``vcycle_unstructured_600k_ms``: the
   600k hull's SA hierarchy (alpha 0.2, 5 levels, min_coarse 1200, Lloyd 5
   iterations, ``fmt="well"``) with ``setup_s``; ``uvcycle_solve`` W(4,4)
   Chebyshev to 1e-6 for ``conv_factor`` and ``iters_to_1e6``; then one
   W-cycle timed.
6. ``rap``: ``rap_spgemm_mnnz_per_s``: P^T A P on the 256^2 Poisson with
   3x3 aggregates and SA's P: ``rap_masked`` over host patterns (the
   value) and ``rap_fused`` (the ``fused_*`` fields), each against scipy's
   float64 product (1e-5 and 2e-5 of max |A_H|).
7. ``model_forward``: ``fullaggnet_forward_ms``: FullAggNet (dim 8, 2
   convs, 2 iterations) on the 64^2 structured Poisson, k = ceil(0.1 n),
   flax's initial weights from PRNGKey(0) (``init_flax_``).

Timing (bench.py's jitted ``fori_loop`` and tunnel slope do not apply):

- Kernels (cells 1-2): the L2-cold time of one launch is the median over
  20 launches, each between its own CUDA events after a 256 MB buffer
  is written and read (over 5x the 50 MB L2); the warm time is bench.py's
  ``slope`` between chains of launches, each chain timed with CUDA events
  behind a spin kernel so that the host's enqueueing does not count.
  Every share of the HBM rate uses the cold time (a warm time can read
  from L2).  Beside each: ``torch.mv`` on the same operator as a
  torch.sparse CSR, cold and warm (mean of 100 calls back to back).
- Cycles and products (cells 3-7): ``value`` is the wall time a Python
  caller pays per iteration, ``time.perf_counter`` around each call with a
  ``torch.cuda.synchronize()`` at its end after warm-up: the median, and
  the highest whole percentile with at least ten samples beyond it, with
  the sample count.  ``device_ms`` beside it: CUDA events around one call
  queued behind a spin kernel that outlasts the host's enqueueing (cell 4;
  checked, since a full launch queue blocks the host: between 1,000 and
  2,000 launches on an H100, ``scripts/launch_queue_probe.py``), or
  the busy time (union of device intervals) of a ``torch.profiler`` trace
  where the call reads the host (cells 3, 6, 7) or holds more launches
  than the queue (cell 5's W-cycle).  ``main`` takes the traces after
  every cell's wall time, since a profiler session makes later launches
  of its process cost the host more.  ``idle`` = 1 - device / wall.

bench.py's tricks that only defeat XLA's loop-invariant hoisting
(``s * 1e-30`` added to A in cells 6-7) are dropped: eager torch runs
every call.  Its ``w * 1e-6`` rescale of the chained SpMV (which keeps the
iterate finite) is the kernels' own ``alpha``, so the chain times the
kernel alone.  Cycles start each sample from the same x0 (bench.py chains
the iterate, whose values then only shrink).  No TPU number is a baseline.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np

# the card's HBM rate by torch.cuda.get_device_name; an unknown card raises
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM5, NVIDIA H100 Tensor Core GPU data sheet
}
KERNEL_RTOL = 1e-5
# A_H against scipy's float64 P^T A P, relative to max |A_H|: rap_masked adds
# in a fixed order (1.86e-7 on the card and the CPU); rap_fused sums ~124
# terms an entry with atomic adds, 7.8e-6 to 9.4e-6 over 50 runs on an H100
# (scripts/rap_fused_spread.py), so its bound is twice the largest
RAP_RTOL, RAP_FUSED_RTOL = 1e-5, 2e-5
FLUSH_BYTES = 256 << 20  # written between L2-cold launches: over 5x the 50 MB L2
FLUSH_BYTES_CPU = 8 << 20  # the CPU runs the cells only as tests
HEAT_FLUSHES = 50  # buffer writes before a cold timing bring the clocks up
COLD_ITERS, WARM_ITERS = 20, 100
QUEUED_REPEATS = 5
WARMUP = 3
SAMPLES = 100
HULL_DOFS, HULL_SEED = 600_000, 7

# cell -> (bench.py's metric, unit)
METRICS = {
    "spmv": ("spmv_hbm_roofline_fraction", "fraction_of_peak_hbm_bw"),
    "unstructured": ("unstructured_spmv_gnnz_per_s", "Gnnz/s"),
    "twolevel": ("twolevel_cycle_ms", "ms/iteration"),
    "vcycle_16m": ("vcycle_16m_ms", "ms/V-cycle"),
    "unstructured_multilevel": ("vcycle_unstructured_600k_ms", "ms/W-cycle"),
    "rap": ("rap_spgemm_mnnz_per_s", "Mnnz(A)/s"),
    "model_forward": ("fullaggnet_forward_ms", "ms/forward"),
}
CELLS = tuple(METRICS)


def hbm_bytes_per_s(name: str) -> float:
    """The card's HBM rate in bytes/s; raises for a card not in the table."""
    if name not in HBM_BYTES_PER_S:
        raise ValueError(f"no HBM rate for device {name!r}; known: {sorted(HBM_BYTES_PER_S)}")
    return HBM_BYTES_PER_S[name]


def dia_bytes(D: int, n: int) -> int:
    """Least bytes of one float32 DIA product: D diagonals and x read, y
    written (bench.py's headline count)."""
    return 4 * (D * n + 2 * n)


def slope(timed, lo: int, hi: int, tries: int = 4) -> float:
    """Per-iteration time from two chained iteration counts: the median of
    the positive slopes (timed(hi) - timed(lo)) / (hi - lo), retried up to
    ``tries`` times and ended early once three agree within 5% (bench.py's
    rule)."""
    samples: list[float] = []
    for _ in range(tries):
        dt = (timed(hi) - timed(lo)) / (hi - lo)
        if dt > 0:
            samples.append(dt)
        if len(samples) >= 3:
            s = sorted(samples)
            if s[-1] - s[0] <= 0.05 * s[0]:
                break
    if not samples:
        raise RuntimeError("timing slope stayed non-positive")
    return float(np.median(samples))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def poisson2d(nx: int):
    """nx^2 five-point Poisson in float32 (bench.py's construction)."""
    import scipy.sparse as sp

    I = sp.eye(nx, format="csr", dtype=np.float32)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx), dtype=np.float32)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


_HULL600K = {}


def hull600k():
    """The 600k-dof random-hull FEM matrix, meshed once per process (two
    cells use it; the host meshing takes minutes)."""
    if "A" not in _HULL600K:
        from mlamg_torch.data import Grid

        _HULL600K["A"] = Grid.random_2d_unstructured(HULL_DOFS, seed=HULL_SEED).A.astype(np.float32)
    return _HULL600K["A"]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_SPIN = {}


def _spin(ms: float):
    """Launch a spin kernel of about ``ms`` and return an event recorded
    after it (the cycles per ms are measured once per process)."""
    import torch

    if "cycles_per_ms" not in _SPIN:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        stop.record()
        torch.cuda.synchronize()
        _SPIN["cycles_per_ms"] = 20_000_000 / start.elapsed_time(stop)
    torch.cuda._sleep(int(ms * _SPIN["cycles_per_ms"]))
    done = torch.cuda.Event()
    done.record()
    return done


def flush_buffer(dev):
    """The buffer whose writes evict the cache before a cold timing."""
    import torch

    size = FLUSH_BYTES if dev.type == "cuda" else FLUSH_BYTES_CPU
    return torch.empty(size // 4, dtype=torch.float32, device=dev)


def queued_ms(fn, dev, *, iters: int, flush=None, cover_ms: float = 20.0) -> float:
    """Device time of one ``fn()`` in ms, after one warm call.  Without
    ``flush``: the mean over ``iters`` calls back to back.  With it (cold):
    before each call the buffer is written, then read (so L2 holds clean
    lines), each call sits between its own events, and the median is
    returned.  On CUDA the calls queue behind a spin of ``cover_ms`` and
    the spin must still run when the host has enqueued them all, or this
    raises (a host read in ``fn``, or more launches than the queue holds).
    On the CPU, ``time.perf_counter`` around the calls."""
    import torch

    fn()
    if flush is not None and dev.type == "cuda":
        for _ in range(HEAT_FLUSHES):
            flush.fill_(0.0)
            flush.sum()
    _sync(dev)
    if dev.type != "cuda":
        if flush is None:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters * 1e3
        times = []
        for i in range(iters):
            flush.fill_(float(i))
            flush.sum()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    spin_done = _spin(cover_ms)
    if flush is None:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        pairs = [(start, stop)]
    else:
        pairs = []
        for i in range(iters):
            flush.fill_(float(i))
            flush.sum()
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
            fn()
            pair[1].record()
            pairs.append(pair)
    covered = not spin_done.query()
    torch.cuda.synchronize()
    if not covered:
        raise RuntimeError(f"the host's enqueueing outlasted the {cover_ms:.1f} ms spin: "
                           "the timed calls read the host or overflow the launch queue")
    if flush is None:
        return start.elapsed_time(stop) / iters
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def trace_busy_ms(fn) -> tuple[float, float]:
    """(busy ms, device operations) of one ``fn()`` from a torch.profiler
    trace of the card: the union of its kernel, copy and set intervals."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler trace holds no device activity")
    busy, end = 0, -1
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e6, float(len(spans))


def tail_percentile(n: int) -> int:
    """The highest whole percentile with at least ten of ``n`` samples
    beyond it."""
    if n < 20:
        raise ValueError(f"{n} samples leave no percentile above the median with ten beyond it")
    return int(math.floor(100 - 1000 / n))


def wall_samples(fn, dev, samples: int) -> list:
    """ms of each of ``samples`` calls of ``fn``, each ended by a
    synchronize, after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    _sync(dev)
    out = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def time_calls(res: dict, fn, dev, *, samples: int, per: int = 1, method: str,
               traces: list | None, prefix: str = "") -> None:
    """Fill ``res`` with ``fn``'s wall time per iteration (``per``
    iterations a call): ``wall_ms`` (median), ``wall_tail_ms`` at
    ``tail_pct``, ``samples``; then ``device_ms`` and ``idle`` by
    ``method``, "queued" (CUDA events behind a spin) or "trace" (profiler
    busy time), the trace put on ``traces`` when one is given.  The CPU
    has no device time (None)."""
    wall = np.asarray(wall_samples(fn, dev, samples)) / per
    pct = tail_percentile(samples)
    res.update({f"{prefix}wall_ms": float(np.median(wall)),
                f"{prefix}wall_tail_ms": float(np.percentile(wall, pct)),
                f"{prefix}tail_pct": pct, f"{prefix}samples": samples,
                f"{prefix}device_ms": None, f"{prefix}idle": None,
                f"{prefix}device_method": method if dev.type == "cuda" else None})
    if dev.type != "cuda":
        return

    def device():
        if method == "queued":
            cover = 2.0 * float(np.max(wall)) * per + 10.0
            ms = float(np.median([queued_ms(fn, dev, iters=1, cover_ms=cover)
                                  for _ in range(QUEUED_REPEATS)]))
        else:
            ms, ops = trace_busy_ms(fn)
            res[f"{prefix}device_ops"] = ops / per
        res[f"{prefix}device_ms"] = ms / per
        res[f"{prefix}idle"] = 1.0 - (ms / per) / res[f"{prefix}wall_ms"]

    if traces is None or method == "queued":
        device()
    else:
        traces.append(device)


def kernel_times(step, x, dev, flush, lo: int, hi: int) -> tuple[float, float]:
    """(L2-cold, warm) ms of one ``step(x)``: the cold median of COLD_ITERS
    launches after flushes, the warm slope between chains v = step(v) of
    ``lo`` and ``hi`` launches."""
    def timed(k):
        def chain():
            v = x
            for _ in range(k):
                v = step(v)

        return queued_ms(chain, dev, iters=1) / 1e3

    warm = slope(timed, lo, hi) * 1e3
    return queued_ms(lambda: step(x), dev, iters=COLD_ITERS, flush=flush), warm


def library_times(A_sp, x, dev, flush) -> tuple[float, float]:
    """(L2-cold, warm) ms of ``torch.mv`` on A as a torch.sparse CSR (the
    library's product; it is timed here and used nowhere in the port)."""
    import torch

    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(A_sp.indptr.astype(np.int64)),
        torch.from_numpy(A_sp.indices.astype(np.int64)),
        torch.from_numpy(A_sp.data.astype(np.float32)),
        size=A_sp.shape, check_invariants=False,
    ).to(dev)
    return (queued_ms(lambda: torch.mv(A_csr, x), dev, iters=COLD_ITERS, flush=flush),
            queued_ms(lambda: torch.mv(A_csr, x), dev, iters=WARM_ITERS))


def _launches():
    from mlamg_torch.utils.profiler import LAUNCHES

    return {k: LAUNCHES[k] for k in ("dia_spmv", "well_spmv")}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _rel_err(y, ref) -> float:
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def _x(n: int, seed: int, dev):
    import torch

    return torch.from_numpy(np.random.RandomState(seed).randn(n).astype(np.float32)).to(dev)


def _cell(name: str, value, timed: dict | None = None, **fields) -> dict:
    """The cell's result: bench.py's metric, a finite positive value, its
    unit, ``fields`` and ``timed`` (:func:`time_calls`'s fields).  It is
    built in ``timed`` itself, so that a trace taken later fills it."""
    metric, unit = METRICS[name]
    if not (value is not None and np.isfinite(value) and value > 0):
        raise RuntimeError(f"{metric}: value {value} is not finite and positive")
    out = {"metric": metric, "value": float(value), "unit": unit, **fields, **(timed or {})}
    if timed is None:
        return out
    timed.clear()
    timed.update(out)
    return timed


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def bench_spmv(nx: int = 4096, *, device=None, seed: int = 0, A=None,
               peak_bytes_per_s: float | None = None) -> dict:
    """Cell 1, the headline: ``dia_spmv`` on the nx^2 Poisson as a share of
    the card's HBM rate (``peak_bytes_per_s``; None reads the table)."""
    import torch
    from mlamg_torch.device import resolve_device
    from mlamg_torch.ops.dia import DIA, dia_spmv, dia_spmv_reference

    dev = resolve_device(device)
    peak = hbm_bytes_per_s(_device_name(dev)) if peak_bytes_per_s is None else peak_bytes_per_s
    before = _launches()
    A = poisson2d(nx) if A is None else A
    Ad = DIA.from_scipy(A, device=dev)
    n, D = Ad.shape[0], len(Ad.offsets)
    x = _x(n, seed, dev)
    err = _rel_err(dia_spmv(Ad, x), dia_spmv_reference(Ad, x))
    if not err <= KERNEL_RTOL:
        raise RuntimeError(f"dia_spmv differs from dia_spmv_reference by {err} > {KERNEL_RTOL}")
    flush = flush_buffer(dev)
    cold, warm = kernel_times(lambda v: dia_spmv(Ad, v, alpha=1e-6), x, dev, flush, 10, 60)
    lib_cold, lib_warm = library_times(A, x, dev, flush)
    launches = _delta(before)
    _require_kernel(dev, launches, "dia_spmv")
    nbytes = dia_bytes(D, n)
    frac = nbytes / (cold * 1e-3) / peak
    if frac > 1.0:
        raise RuntimeError(f"dia_spmv reads {frac} of the HBM rate: the time or the byte count is wrong")
    return _cell("spmv", frac, kernel="dia_spmv (mlamg_torch/ops/csrc/dia_spmv.cu)",
                 format="DIA(5-pt Poisson)", n=n, nnz=int(A.nnz), D=D, bytes=nbytes,
                 spmv_us=cold * 1e3, warm_us=warm * 1e3,
                 warm_fraction=nbytes / (warm * 1e-3) / peak,
                 gnnz_per_s=A.nnz / (cold * 1e-3) / 1e9,
                 achieved_gbps=nbytes / (cold * 1e-3) / 1e9, peak_gbps=peak / 1e9,
                 bound_us=nbytes / peak * 1e6,
                 library_us=lib_cold * 1e3, library_warm_us=lib_warm * 1e3,
                 library="torch.mv on torch.sparse CSR", launches=launches,
                 check={"rel_err": err, "rtol": KERNEL_RTOL})


def bench_unstructured(A=None, *, device=None, seed: int = 0,
                       peak_bytes_per_s: float | None = None) -> dict:
    """Cell 2: ``well_spmv`` on the RCM-ordered hull (``A``; None: the 600k
    hull), Gnnz/s from the L2-cold time."""
    from mlamg_torch.device import resolve_device
    from mlamg_torch.ops.unstructured import rcm_spmv_setup, well_spmv, well_spmv_reference

    dev = resolve_device(device)
    peak = hbm_bytes_per_s(_device_name(dev)) if peak_bytes_per_s is None else peak_bytes_per_s
    A = hull600k() if A is None else A
    before = _launches()
    perm, W = rcm_spmv_setup(A, device=dev)
    n, nnz = W.shape[0], int(W.nnz)
    x = _x(n, seed, dev)
    err = _rel_err(well_spmv(W, x), well_spmv_reference(W, x))
    if not err <= KERNEL_RTOL:
        raise RuntimeError(f"well_spmv differs from well_spmv_reference by {err} > {KERNEL_RTOL}")
    flush = flush_buffer(dev)
    cold, warm = kernel_times(lambda v: well_spmv(W, v, alpha=1e-6), x, dev, flush, 10, 30)
    lib_cold, lib_warm = library_times(A[perm][:, perm].tocsr(), x, dev, flush)
    launches = _delta(before)
    _require_kernel(dev, launches, "well_spmv")
    nbytes = nnz * 8 + 2 * n * 4  # values and columns, x read, y written
    return _cell("unstructured", nnz / (cold * 1e-3) / 1e9,
                 kernel="well_spmv (mlamg_torch/ops/csrc/well_spmv.cu)",
                 format="WindowedELL sliced pack (RCM random-hull FEM)", n=n, nnz=nnz,
                 sigma=W.sigma, lanes=W.lanes, spmv_us=cold * 1e3, warm_us=warm * 1e3,
                 warm_gnnz_per_s=nnz / (warm * 1e-3) / 1e9,
                 hbm_fraction=nbytes / (cold * 1e-3) / peak, bound_us=nbytes / peak * 1e6,
                 library_us=lib_cold * 1e3, library_warm_us=lib_warm * 1e3,
                 library="torch.mv on torch.sparse CSR", launches=launches,
                 check={"rel_err": err, "rtol": KERNEL_RTOL})


def bench_twolevel(nx: int = 512, side: int = 16, iters: int = 24, *, samples: int = SAMPLES,
                   device=None, seed: int = 0, traces: list | None = None) -> dict:
    """Cell 3: ms per iteration of the two-level solve (a host read per
    iteration, so its device time comes from a trace)."""
    import torch
    from mlamg_torch.device import resolve_device
    from mlamg_torch.mg.coarse import CoarseSolver
    from mlamg_torch.mg.cycle import coarse_operator, twolevel_solve
    from mlamg_torch.mg.factored import BoxAgg2D, factored_sa
    from mlamg_torch.ops.dia import DIA

    dev = resolve_device(device)
    before = _launches()
    A = poisson2d(nx)
    n = A.shape[0]
    Ad = DIA.from_scipy(A, device=dev)
    P = factored_sa(Ad, BoxAgg2D(ny=nx, nx=nx, sy=side, sx=side), omega=0.65)
    coarse = CoarseSolver.factor(coarse_operator(Ad, P), method="inverse")
    x0 = _x(n, seed, dev)
    b = torch.zeros_like(x0)

    def solve():
        return twolevel_solve(Ad, P, b, x0, res_tol=0.0, max_iter=iters, coarse=coarse)

    _, conv, _, it = solve()
    if not (it == iters and np.isfinite(conv) and conv < 1.0):
        raise RuntimeError(f"two-level solve: conv factor {conv} after {it} iterations")
    res = {}
    time_calls(res, solve, dev, samples=samples, per=iters, method="trace", traces=traces)
    launches = _delta(before)
    _require_kernel(dev, launches, "dia_spmv")
    return _cell("twolevel", res["wall_ms"], res, n=n, nnz=int(A.nnz), k=P.shape[1], iters=iters,
                 conv_factor=conv, scheme="factored P=S*T + inverse coarse",
                 gnnz_per_s_fine_sweeps=3 * A.nnz / (res["wall_ms"] * 1e-3) / 1e9,
                 launches=launches, check={"conv_factor": conv, "below": 1.0})


def vcycle_conv(h, b, x0, cycles: int = 6, **cycle) -> tuple[float, list]:
    """bench.py's convergence check: ||x|| after each of ``cycles``
    V-cycles from x0 with b = 0 (the error norm), and the factor
    (norms[-1] / norms[1]) ** (1 / (cycles - 2))."""
    import torch
    from mlamg_torch.mg.cycle import vcycle

    x, norms = x0, []
    for _ in range(cycles):
        x = vcycle(h, b, x, **cycle)
        norms.append(float(torch.linalg.vector_norm(x)))
    return float((norms[-1] / norms[1]) ** (1.0 / (len(norms) - 2))), norms


VCYCLE = dict(nu=2, smoother="chebyshev")


def bench_vcycle_16m(nx: int = 4096, *, sides=(2,) * 7, min_coarse: int = 900,
                     samples: int = SAMPLES, device=None, seed: int = 0, A=None,
                     traces: list | None = None) -> dict:
    """Cell 4: ms per Chebyshev V-cycle of the all-DIA bilinear hierarchy,
    after its convergence check."""
    import torch
    from mlamg_torch.device import resolve_device
    from mlamg_torch.mg.cycle import vcycle
    from mlamg_torch.mg.structured import build_structured_hierarchy
    from mlamg_torch.ops.dia import DIA

    dev = resolve_device(device)
    before = _launches()
    A = poisson2d(nx) if A is None else A
    n = A.shape[0]
    Ad = DIA.from_scipy(A, device=dev)
    t0 = time.perf_counter()
    h = build_structured_hierarchy(Ad, nx, nx, sides=sides, min_coarse=min_coarse,
                                   kind="bilinear")
    _sync(dev)
    setup_s = time.perf_counter() - t0
    x0 = _x(n, seed, dev)
    b = torch.zeros_like(x0)
    conv, norms = vcycle_conv(h, b, x0, **VCYCLE)
    if not (np.all(np.isfinite(norms)) and conv < 1.0):
        raise RuntimeError(f"V-cycle does not converge: factor {conv}")
    res = {}
    time_calls(res, lambda: vcycle(h, b, x0, **VCYCLE), dev, samples=samples,
               method="queued", traces=traces)
    launches = _delta(before)
    _require_kernel(dev, launches, "dia_spmv")
    return _cell("vcycle_16m", res["wall_ms"], res, n=n, nnz=int(A.nnz), levels=h.num_levels + 1,
                 conv_factor=conv, setup_s=setup_s,
                 scheme="all-DIA bilinear(side-2) probed-Galerkin hierarchy, deg-3 Chebyshev",
                 gnnz_per_s_fine_sweeps=4 * A.nnz / (res["wall_ms"] * 1e-3) / 1e9,
                 launches=launches, check={"conv_factor": conv, "below": 1.0})


WCYCLE = dict(nu=4, lmin_frac=1 / 15, gamma=2)


def bench_unstructured_multilevel(A=None, *, alpha: float = 0.2, max_levels: int = 5,
                                  min_coarse: int = 1200, lloyd_maxiter: int = 5,
                                  samples: int = SAMPLES, device=None, seed: int = 0,
                                  traces: list | None = None) -> dict:
    """Cell 5: ms per W(4,4) cycle of the hull's SA hierarchy (``A``;
    None: the 600k hull), after a solve to 1e-6 for its convergence."""
    import torch
    from mlamg_torch.device import resolve_device
    from mlamg_torch.mg.amg_unstructured import (
        build_unstructured_hierarchy, uvcycle, uvcycle_solve,
    )

    dev = resolve_device(device)
    A = hull600k() if A is None else A
    n = A.shape[0]
    before = _launches()
    t0 = time.perf_counter()
    h, _ = build_unstructured_hierarchy(A, alpha=alpha, max_levels=max_levels,
                                        min_coarse=min_coarse, lloyd_maxiter=lloyd_maxiter,
                                        fmt="well", device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    x0 = _x(n, seed, dev)
    b = torch.zeros_like(x0)
    _, conv, _, iters = uvcycle_solve(h, b, x0, res_tol=1e-6, max_iter=40, **WCYCLE)
    if not (np.isfinite(conv) and conv < 1.0):
        raise RuntimeError(f"W-cycle solve: conv factor {conv} after {iters} cycles")
    res = {}
    time_calls(res, lambda: uvcycle(h, b, x0, **WCYCLE), dev, samples=samples,
               method="trace", traces=traces)
    launches = _delta(before)
    _require_kernel(dev, launches, "well_spmv")
    return _cell("unstructured_multilevel", res["wall_ms"], res, n=n, nnz=int(A.nnz),
                 levels=h.num_levels, conv_factor=conv, iters_to_1e6=int(iters),
                 setup_s=setup_s,
                 scheme="host Galerkin setup, factored-P W(4,4) Chebyshev",
                 launches=launches, check={"conv_factor": conv, "below": 1.0})


def rap_operands(nx: int = 256, *, device=None, dtype=None) -> dict:
    """bench.py's RAP problem: the nx^2 Poisson, 3x3 aggregates, SA's P
    (A's pattern with aggregate-mapped columns), and the host patterns and
    widths of the masked product."""
    import torch
    from mlamg_torch.device import resolve_device
    from mlamg_torch.mg.amg_unstructured import galerkin_patterns
    from mlamg_torch.mg.interp import smoothed_aggregation
    from mlamg_torch.ops.sparse import CSR

    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    A = poisson2d(nx)
    n = A.shape[0]
    ii, jj = np.arange(n) // nx, np.arange(n) % nx
    agg = (ii // 3) * (nx // 3 + 1) + (jj // 3)
    k = int(agg.max()) + 1
    Ac = CSR.from_scipy(A, dtype=dtype, device=dev)
    P = smoothed_aggregation(Ac, torch.from_numpy(agg).to(dev), k)
    _, APpat, AHpat = galerkin_patterns(A, agg, k)
    widths = dict(a_width=int(np.diff(A.indptr).max()),
                  pt_width=int(np.bincount(agg[A.tocoo().col], minlength=k).max()),
                  ap_width=int(np.diff(APpat.indptr).max()))
    widths["p_width"] = widths["a_width"]  # P's rows hold A's duplicate-counted entries
    return dict(A=A, agg=agg, k=k, Ac=Ac, P=P, widths=widths, nnz_out=4 * Ac.nnz_pad,
                APp=CSR.from_scipy(APpat, dtype=dtype, device=dev),
                AHp=CSR.from_scipy(AHpat, dtype=dtype, device=dev))


def rap_products(ops: dict) -> dict:
    """The two device products of :func:`rap_operands`, as callables:
    ``fused`` (``rap_fused``, P as a width-5 ELL) and ``masked``."""
    from mlamg_torch.mg.amg_unstructured import rap_masked
    from mlamg_torch.ops import matmul

    return {
        "fused": lambda: matmul.rap_fused(ops["Ac"], ops["P"], k=ops["k"], nnz_out=ops["nnz_out"],
                                          p_width=5, return_overflow=True),
        "masked": lambda: (rap_masked(ops["Ac"], ops["P"], ops["APp"], ops["AHp"],
                                      **ops["widths"]), None),
    }


def bench_rap(nx: int = 256, *, samples: int = SAMPLES, device=None,
              traces: list | None = None) -> dict:
    """Cell 6: the sparse Galerkin product in Mnnz(A)/s, masked (the value)
    and fused, each held against scipy's P^T A P."""
    from mlamg_torch.device import resolve_device

    dev = resolve_device(device)
    before = _launches()
    ops = rap_operands(nx, device=dev)
    A = ops["A"]
    Psp = ops["P"].to_scipy().astype(np.float64)  # duplicates summed
    want = (Psp.T @ A.astype(np.float64) @ Psp).tocsr()
    scale = abs(want).max()
    res, errs = {}, {}
    rtol = {"masked": RAP_RTOL, "fused": RAP_FUSED_RTOL}
    for name, product in rap_products(ops).items():
        AH, overflow = product()
        if overflow is not None and bool(overflow):
            raise RuntimeError(f"rap_fused overflowed nnz_out={ops['nnz_out']}")
        errs[name] = float(abs(AH.to_scipy().astype(np.float64) - want).max() / scale)
        if not errs[name] <= rtol[name]:
            raise RuntimeError(f"rap {name}: A_H differs from scipy's by {errs[name]} > {rtol[name]}")
        time_calls(res, product, dev, samples=samples, method="trace", traces=traces,
                   prefix="" if name == "masked" else "fused_")
    launches = _delta(before)
    return _cell("rap", A.nnz / (res["wall_ms"] * 1e-3) / 1e6, res, n=A.shape[0], nnz=int(A.nnz),
                 k=ops["k"], rap_ms=res["wall_ms"],
                 scheme="pattern-masked numeric RAP (host boolean pattern, device masked SpGEMM x2)",
                 fused_mnnz_per_s=A.nnz / (res["fused_wall_ms"] * 1e-3) / 1e6,
                 fused_rap_ms=res["fused_wall_ms"], launches=launches,
                 check={"rel_err_masked": errs["masked"], "rtol_masked": RAP_RTOL,
                        "rel_err_fused": errs["fused"], "rtol_fused": RAP_FUSED_RTOL})


def forward_model(nx: int = 64, *, device=None, dtype=None):
    """bench.py's forward problem: (net, A, k) for the nx^2 structured
    Poisson and FullAggNet(dim 8, 2 convs, 2 iterations, bf_width the
    largest row degree) with flax's initial weights from PRNGKey(0)."""
    import torch
    from mlamg_torch.data import Grid
    from mlamg_torch.device import resolve_device
    from mlamg_torch.models import FullAggNet
    from mlamg_torch.models.gnn import init_flax_
    from mlamg_torch.ops.sparse import CSR
    from mlamg_torch.utils import prng

    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    g = Grid.structured_2d_poisson_dirichlet(nx, nx)
    A_sp = g.A.tocsr()
    n = A_sp.shape[0]
    width = int(np.max(np.diff(A_sp.indptr)))
    net = init_flax_(FullAggNet(dim=8, num_conv=2, iterations=2, bf_width=width),
                     prng.PRNGKey(0)).to(device=dev, dtype=dtype).eval()
    return net, CSR.from_scipy(A_sp, dtype=dtype, device=dev), int(np.ceil(0.1 * n))


def check_forward(out, A, k: int) -> dict:
    """Exactly k distinct centers, agg_id in [0, k), P finite with A's
    pattern and each entry's column agg_id of A's column, so that row i
    holds column agg_id[i].  Raises otherwise."""
    import torch

    agg_id, P, _, centers, _ = out
    n = A.shape[0]
    diag_rows = torch.sort(A.row[A.mask & (A.row == A.col)]).values
    checks = {
        "k_centers": centers.numel() == k and torch.unique(centers).numel() == k,
        "agg_id_in_range": bool(((agg_id >= 0) & (agg_id < k)).all()),
        "P_finite": bool(torch.isfinite(P.data).all()),
        "P_columns_from_agg_id": bool(torch.equal(P.col[A.mask], agg_id[A.col[A.mask]])),
        "P_row_holds_its_aggregate": bool(torch.equal(diag_rows.cpu(), torch.arange(n))),
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"FullAggNet forward fails {bad}")
    return checks


def bench_model_forward(nx: int = 64, *, samples: int = SAMPLES, device=None,
                        traces: list | None = None) -> dict:
    """Cell 7: ms per FullAggNet forward (scores -> Bellman-Ford -> P)."""
    import torch
    from mlamg_torch.device import resolve_device

    dev = resolve_device(device)
    before = _launches()
    net, A, k = forward_model(nx, device=dev)

    def forward():
        with torch.no_grad():
            return net(A, k)

    checks = check_forward(forward(), A, k)
    res = {}
    time_calls(res, forward, dev, samples=samples, method="trace", traces=traces)
    return _cell("model_forward", res["wall_ms"], res, n=A.shape[0], k=k,
                 launches=_delta(before), check=checks)


# ---------------------------------------------------------------------------
# running the cells
# ---------------------------------------------------------------------------


def _device_name(dev) -> str:
    import torch

    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev)


def _require_kernel(dev, launches: dict, kernel: str) -> None:
    """On the card, the cell's path must have launched its CUDA kernel."""
    if dev.type == "cuda" and launches[kernel] <= 0:
        raise RuntimeError(f"{kernel} never launched on its cell")


def run_cells(names=CELLS, *, device=None, samples: int = SAMPLES, seed: int = 0,
              hull=None, poisson=None, log=None) -> tuple[dict, dict]:
    """Run the named cells; returns ({cell: result}, {cell: traceback}).  The
    600k hull (``hull``) and the 4096^2 Poisson (``poisson``) are built once
    when not given.  The profiler traces of the cells that need one run
    after every cell's wall time."""
    from mlamg_torch.device import resolve_device

    dev = resolve_device(device)
    traces: list = []
    shared = {"hull": hull, "poisson": poisson}

    def operator(key):
        if shared[key] is None:
            shared[key] = hull600k() if key == "hull" else poisson2d(4096)
        return shared[key]

    calls = {
        "spmv": lambda: bench_spmv(device=dev, seed=seed, A=operator("poisson")),
        "unstructured": lambda: bench_unstructured(operator("hull"), device=dev, seed=seed),
        "twolevel": lambda: bench_twolevel(samples=samples, device=dev, seed=seed,
                                           traces=traces),
        "vcycle_16m": lambda: bench_vcycle_16m(samples=samples, device=dev, seed=seed,
                                               A=operator("poisson"), traces=traces),
        "unstructured_multilevel": lambda: bench_unstructured_multilevel(
            operator("hull"), samples=samples, device=dev, seed=seed, traces=traces),
        "rap": lambda: bench_rap(samples=samples, device=dev, traces=traces),
        "model_forward": lambda: bench_model_forward(samples=samples, device=dev, traces=traces),
    }
    results, errors = {}, {}
    for name in names:
        t0 = time.perf_counter()
        try:
            results[name] = calls[name]()
        except Exception:  # every failure is reported and fails the run
            errors[name] = traceback.format_exc()
        if log is not None:
            log(f"bench_torch: {name} {'failed' if name in errors else 'done'} "
                f"in {time.perf_counter() - t0:.1f} s")
    for trace in traces:
        try:
            trace()
        except Exception:
            errors["device traces"] = traceback.format_exc()
    return results, errors


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0, help="seed of the random vectors")
    p.add_argument("--cells", nargs="+", choices=CELLS, default=list(CELLS))
    p.add_argument("--samples", type=int, default=SAMPLES,
                   help="wall-time samples per cycle or product (at least 20)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the cells, print their lines and the last line; exits non-zero
    (SystemExit) if any cell or check failed."""
    import torch
    from mlamg_torch.device import resolve_device
    from mlamg_torch.ops import _build

    args = parse_args(argv)
    tail_percentile(args.samples)
    dev = resolve_device(args.device)
    detail = {"device": _device_name(dev), "torch": torch.__version__, "seed": args.seed,
              "samples": args.samples}
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        detail["nvidia_smi"] = nvidia_smi_line()
        detail["cuda"] = torch.version.cuda
        print(detail["nvidia_smi"], flush=True)
        _build.build_kernels()

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    results, errors = run_cells(args.cells, device=dev, samples=args.samples, seed=args.seed,
                                log=log)
    for name in args.cells:
        error = errors.get(name, "").strip().splitlines()[-1:]
        print(json.dumps({"cell": name, **(results.get(name) or {"error": error})}), flush=True)
    if errors:
        for name, e in errors.items():
            log(f"bench_torch: FAILED: {name}: {e}")
        raise SystemExit(1)
    first, *rest = (results[name] for name in args.cells)
    out = {"metric": first["metric"], "value": first["value"], "unit": first["unit"],
           "detail": {**detail, **{k: v for k, v in first.items()
                                   if k not in ("metric", "value", "unit")},
                      "extra_metrics": rest}}
    if dev.type == "cuda":
        print(detail["nvidia_smi"], flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
