"""Large-scale unstructured multilevel SA-AMG with a factored prolongator
(counterpart of ``mlamg_tpu/mg/amg_unstructured.py``).

Setup per level: RCM order -> strength -> Lloyd aggregation -> SA omega
from a Gershgorin bound -> Galerkin product A_H = P^T A P -> truncation.
Level operators are stored RCM-ordered as :class:`WindowedELL`
(``fmt="well"``, the CUDA kernel's layout) or :class:`CSR`.

The Galerkin product runs in scipy on the host, or on the device as two
pattern-masked products (``rap_mode="device"``): for smoothed aggregation
the coarse pattern is known before the numbers,

    P = S T,  S = I - omega D^-1 A  (A's pattern),  T = aggregation
    pattern(P)   = A's pattern with columns mapped through agg
    pattern(AP)  = pattern(A) @ pattern(P)            (host boolean product)
    pattern(A_H) = pattern(P)^T @ pattern(AP)

so :func:`rap_masked` contracts each known output entry from fixed-width
rows (``ops.matmul.spgemm_masked``) with no sort, in chunks that bound its
memory.  :func:`rap_learned` does the same for a learned P on A's
coordinates.

The cycle never materializes P: interpolation and restriction apply the
factors directly,

    P e   = u - omega * Dinv * (A @ u),   u = e[agg]          (one SpMV)
    P^T r = segment_sum(r - omega * A @ (Dinv * r), agg)      (one SpMV)

(valid for symmetric A, checked at setup), so every level's work is
SpMV-class streaming through the level operator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.ops import matmul
from mlamg_torch.ops.segment import segment_sum
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng
from mlamg_torch.utils.profiler import GRAPHS, LAUNCHES, Profiler

# ---------------------------------------------------------------------------
# Pattern computation and truncation (host, scipy)
# ---------------------------------------------------------------------------


def galerkin_patterns(A_sp, agg: np.ndarray, k: int, smooth_steps: int = 1):
    """(P_pat, AP_pat, AH_pat) scipy boolean patterns for P = S^s T."""
    import scipy.sparse as sp

    A_sp = sp.csr_matrix(A_sp)
    n = A_sp.shape[0]
    Bpat = sp.csr_matrix(
        (np.ones(A_sp.nnz, np.float64), A_sp.indices, A_sp.indptr), shape=(n, n)
    )
    coo = A_sp.tocoo()
    Ppat = sp.csr_matrix(
        (np.ones(A_sp.nnz, np.float64), (coo.row, agg[coo.col])), shape=(n, k)
    )
    Ppat.sum_duplicates()
    Ppat.data[:] = 1.0
    for _ in range(smooth_steps - 1):
        Ppat = (Bpat @ Ppat).tocsr()
        Ppat.data[:] = 1.0
    Ppat.sort_indices()
    APpat = (Bpat @ Ppat).tocsr()
    APpat.data[:] = 1.0
    AHpat = (Ppat.T.tocsr() @ APpat).tocsr()
    AHpat.data[:] = 1.0
    AHpat.sort_indices()
    APpat.sort_indices()
    return Ppat, APpat, AHpat


def truncate_lump(A_sp, theta: float, mode: str = "lump_clip"):
    """Drop coarse-operator entries with |a_ij| < theta*sqrt(|a_ii a_jj|).

    The keep criterion is symmetric, so the pattern stays symmetric, as the
    factored restriction requires.  ``mode="drop"`` removes small entries;
    ``"lump_clip"`` also lumps the dropped mass onto the diagonal, clipped
    so no diagonal loses more than half its value.
    """
    import scipy.sparse as sp

    if theta <= 0:
        return A_sp
    A_sp = sp.csr_matrix(A_sp)
    n = A_sp.shape[0]
    coo = A_sp.tocoo()
    d = np.asarray(A_sp.diagonal(), np.float64)
    scale = np.sqrt(np.abs(d[coo.row] * d[coo.col])) + 1e-30
    diag = coo.row == coo.col
    keep = diag | (np.abs(coo.data) >= theta * scale)
    A2 = sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A_sp.shape
    ).tocsr()
    if mode == "lump_clip":
        dropped = np.bincount(
            coo.row, weights=np.where(keep, 0.0, coo.data), minlength=n
        )
        lump = np.maximum(dropped, -0.5 * np.abs(d))
        A2 = (A2 + sp.diags(lump.astype(A_sp.dtype))).tocsr()
    A2.sort_indices()
    return A2


# Bytes of one step's (chunk, b_width) gather in spgemm_masked, counted at 8
# bytes an element: the JAX package's 16 MB per buffer (2^22 four-byte
# elements of its (chunk, a_width, b_width) expansion).
CHUNK_BYTES = 1 << 24
# Above this many (pt_width * ap_width) expansion slots per coarse entry a
# level's Galerkin product runs in scipy on the host, as in the JAX package.
WIDE_SLOTS = 32768


def _auto_chunk(wb: int, budget: int = CHUNK_BYTES) -> int:
    """Pattern entries per chunk of a masked product, keeping each step's
    (chunk, wb) gather near ``budget`` bytes at 8 bytes an element."""
    return max(256, budget // (8 * max(wb, 1)))


def rap_masked(A_dev: CSR, P_dev: CSR, AP_pat: CSR, AH_pat: CSR, *, a_width: int,
               p_width: int, pt_width: int, ap_width: int) -> CSR:
    """A_H = P^T A P over host-computed patterns, on the operands' device,
    with no sort.  The widths are host-known row widths: A's rows
    (``a_width``), P's rows (``p_width``), P's columns (``pt_width``,
    duplicates counted) and AP's rows (``ap_width``)."""
    AP = matmul.spgemm_masked(A_dev, P_dev, AP_pat, a_width=a_width, b_width=p_width,
                              chunk=_auto_chunk(p_width))
    return matmul.spgemm_masked(matmul.transpose(P_dev), AP, AH_pat, a_width=pt_width,
                                b_width=ap_width, chunk=_auto_chunk(ap_width))


def host_prolongator(A_sp, agg: np.ndarray, k: int, Dinv: np.ndarray, omegas):
    """SA's P = prod_i (I - w_i D^-1 A) T in scipy (float32), the host
    branch's prolongator: T the (n, k) aggregation of ``agg``."""
    import scipy.sparse as sp

    n = A_sp.shape[0]
    P = sp.csr_matrix((np.ones(n, np.float32), (np.arange(n), agg)), shape=(n, k))
    DinvA = (sp.diags(Dinv) @ A_sp).tocsr()
    for w in np.asarray(omegas, np.float64):
        P = (P - np.float32(w) * (DinvA @ P)).tocsr()
    return P


def _pattern_csr(pat, device) -> CSR:
    return CSR.from_scipy(pat, dtype=torch.float32, device=device)


def rap_learned(A_dev: CSR, P_dev: CSR, A_sp, agg: np.ndarray, k: int) -> CSR:
    """A_H = P^T A P for a learned P on A's coordinates with columns mapped
    through ``agg`` (FullAggNet's P = P-hat Agg keeps A's indptr).  Its
    pattern is known from ``A_sp`` and ``agg`` without its values, so the
    product is :func:`rap_masked`; duplicate (row, agg[col]) coordinates of
    P sum, as scipy sums them."""
    import scipy.sparse as sp

    A_sp = sp.csr_matrix(A_sp)
    _, APpat, AHpat = galerkin_patterns(A_sp, agg, k, smooth_steps=1)
    a_width = int(np.diff(A_sp.indptr).max())
    return rap_masked(
        A_dev, P_dev, _pattern_csr(APpat, A_dev.device), _pattern_csr(AHpat, A_dev.device),
        a_width=a_width, p_width=a_width,
        pt_width=int(np.bincount(agg[A_sp.tocoo().col], minlength=k).max()),
        ap_width=int(np.diff(APpat.indptr).max()),
    )


# ---------------------------------------------------------------------------
# Hierarchy containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ULevel:
    """One level: operator + factored-P ingredients.

    ``omegas`` and ``lmax`` are host floats (f32 values) so the cycle's
    scalar arithmetic never waits on the device.
    """

    A: Any  # WindowedELL or CSR
    Dinv: torch.Tensor  # (n,) f32
    agg: torch.Tensor  # (n,) int64 aggregate ids in [0, k)
    omegas: Tuple[float, ...]  # SA prolongator smoothing weights
    lmax: float  # Gershgorin bound of D^-1 A (Chebyshev smoothing)
    k: int


@dataclasses.dataclass(frozen=True)
class UHierarchy:
    levels: Tuple[ULevel, ...]
    coarse: CoarseSolver
    # uvcycle_solve's CUDA graphs of one cycle (:class:`CycleGraph`), by
    # cycle setting and b's shape, dtype and device; freed with the hierarchy
    graphs: dict = dataclasses.field(default_factory=dict, init=False, compare=False,
                                     repr=False)

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1


def _level_operator(A_sp, fmt: str, block_rows: int, device):
    if fmt == "well":
        from mlamg_torch.ops.unstructured import WindowedELL

        return WindowedELL.from_scipy(A_sp, block_rows=block_rows, device=device)
    if fmt == "csr":
        return CSR.from_scipy(A_sp, dtype=torch.float32, device=device)
    raise ValueError(f"unknown level operator format: {fmt}")


def _make_level(lev: Mapping, fmt: str, block_rows: int, device) -> ULevel:
    """ULevel from host data: scipy ``A``, ``Dinv``, ``agg``, ``omegas``,
    ``lmax``, ``k``."""
    return ULevel(
        _level_operator(lev["A"], fmt, block_rows, device),
        torch.tensor(np.asarray(lev["Dinv"], np.float32), device=device),
        torch.tensor(np.asarray(lev["agg"], np.int64), device=device),
        tuple(float(w) for w in np.asarray(lev["omegas"], np.float32).reshape(-1)),
        float(np.float32(lev["lmax"])),
        int(lev["k"]),
    )


# ---------------------------------------------------------------------------
# Cycle
# ---------------------------------------------------------------------------


def interp_factored(lev: ULevel, e_H: torch.Tensor) -> torch.Tensor:
    """P e_H = prod_i (I - w_i D^-1 A) (e_H injected through the
    aggregation); the factors commute, so application order is free."""
    u = e_H[lev.agg]
    for w in lev.omegas:
        u = u - w * lev.Dinv * matmul.spmv(lev.A, u)
    return u


def restrict_factored(lev: ULevel, r: torch.Tensor) -> torch.Tensor:
    """P^T r for symmetric A: segment-sum of prod_i (I - w_i A D^-1) r."""
    for w in lev.omegas:
        r = r - w * matmul.spmv(lev.A, lev.Dinv * r)
    return segment_sum(r, lev.agg, lev.k)


def uvcycle(h: UHierarchy, b: torch.Tensor, x: torch.Tensor, *,
            omega_jac: float = 0.666, nu: int = 1, smoother: str = "chebyshev",
            lmin_frac: float = 1.0 / 30.0, gamma: int = 1) -> torch.Tensor:
    """One multigrid cycle; all levels SpMV-class work.

    ``smoother="chebyshev"`` runs a degree-``nu+1`` Chebyshev polynomial per
    pre/post smooth, ``"jacobi"`` ``nu`` weighted-Jacobi sweeps.
    ``gamma=1`` is a V-cycle, ``gamma=2`` a W-cycle.  Its spans are
    :func:`mlamg_torch.mg.cycle.vcycle`'s, its ``cycle`` span with
    ``graph="eager"`` (:func:`uvcycle_solve` replays graphs of it).
    """
    with Profiler("cycle", graph="eager"):
        return _cycle(h, b, x, omega_jac=omega_jac, nu=nu, smoother=smoother,
                      lmin_frac=lmin_frac, gamma=gamma)


def _cycle(h: UHierarchy, b: torch.Tensor, x: torch.Tensor, *, omega_jac: float,
           nu: int, smoother: str, lmin_frac: float, gamma: int) -> torch.Tensor:
    """:func:`uvcycle` without its ``cycle`` span."""
    from mlamg_torch.mg.smoothers import chebyshev

    if smoother not in ("chebyshev", "jacobi"):
        raise ValueError(f"unknown smoother: {smoother}")

    def smooth(lev, b, x):
        if smoother == "chebyshev":
            return chebyshev(lev.A, b, x, 1.1 * lev.lmax, lmin_frac=lmin_frac,
                             degree=nu + 1, Dinv=lev.Dinv)
        for _ in range(nu):
            r = matmul.spmv_affine(lev.A, x, c=b, alpha=-1.0)
            x = x + omega_jac * lev.Dinv * r
        return x

    def descend(l, b, x):
        lev = h.levels[l]
        with Profiler("level", level=l):
            with Profiler("pre_smooth"):
                x = smooth(lev, b, x)
            with Profiler("restrict"):
                r = matmul.spmv_affine(lev.A, x, c=b, alpha=-1.0)
                r_H = restrict_factored(lev, r)
            if l + 1 == len(h.levels):
                with Profiler("coarse_solve"):
                    e_H = h.coarse.solve(r_H)
            else:
                e_H = descend(l + 1, r_H, torch.zeros_like(r_H))
                for _ in range(gamma - 1):
                    e_H = descend(l + 1, r_H, e_H)
            with Profiler("interp"):
                x = x + interp_factored(lev, e_H)
            with Profiler("post_smooth"):
                return smooth(lev, b, x)

    return descend(0, b, x)


class CycleGraph:
    """One cycle of :func:`uvcycle_solve` captured as a CUDA graph: its
    static ``b`` and ``x``, and the graph, which reads the hierarchy's
    tensors by address and holds its temporaries in a memory pool of its
    own.  A replay runs the cycle on ``b`` and ``x`` and leaves the result
    in ``x``; the cycle's host floats (``lmax``, ``omegas``, the Chebyshev
    recurrence's scalars) are baked in, and the hierarchy's are frozen.

    It is captured on a side stream with ``capture_begin``/``capture_end``
    (``torch.cuda.graph`` would run a garbage collection and empty the
    allocator's cache first), from inputs the caller has warmed with one
    eager cycle.  Capturing runs nothing: the caller replays after it.
    ``launches`` is what the kernels' wrappers counted into ``LAUNCHES``
    while they were captured, the hand-written kernels' launches of one
    replay: taken back out at capture and added at each replay, so
    ``LAUNCHES`` counts launches on the device."""

    def __init__(self, h: UHierarchy, b: torch.Tensor, x: torch.Tensor, settings: dict):
        self.b, self.x = b.clone(), x.clone()
        self.graph = torch.cuda.CUDAGraph()
        counted = LAUNCHES.copy()
        stream = torch.cuda.Stream(b.device)
        stream.wait_stream(torch.cuda.current_stream(b.device))
        with torch.cuda.stream(stream):
            self.graph.capture_begin()  # without a pool: a private one
            try:
                self.x.copy_(_cycle(h, self.b, self.x, **settings))
            finally:
                self.graph.capture_end()
        self.launches = LAUNCHES - counted
        LAUNCHES.subtract(self.launches)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        LAUNCHES.update(self.launches)
        return self.x


def uvcycle_solve(h: UHierarchy, b: torch.Tensor, x0: torch.Tensor, *,
                  res_tol: float = 1e-10, max_iter: int = 100,
                  omega_jac: float = 0.666, nu: int = 1,
                  smoother: str = "chebyshev", lmin_frac: float = 1.0 / 30.0,
                  gamma: int = 1):
    """Iterated cycles until ||b - A x|| <= res_tol or ``max_iter``, with
    the conv-factor readout.  Returns (x, conv, err, iters).

    On a CUDA ``b`` the cycle is a :class:`CycleGraph`, one per cycle
    setting and b's shape, dtype and device, kept in ``h.graphs``: the
    hierarchy's first solve runs its first cycle eagerly, captures the
    second and replays it from then on; a later solve copies b and x0 into
    the graph's buffers and replays every cycle.  The residual norm and its
    host read stay outside the graph.  On the CPU every cycle is eager.
    ``GRAPHS`` counts each cycle under ``uvcycle.eager``, ``.capture`` or
    ``.replay``, as does the ``graph`` attribute of its ``cycle`` span."""
    from mlamg_torch.mg.cycle import _conv_factor

    settings = dict(omega_jac=omega_jac, nu=nu, smoother=smoother, lmin_frac=lmin_frac,
                    gamma=gamma)
    A = h.levels[0].A
    err = torch.zeros(max_iter, dtype=x0.dtype, device=x0.device)
    graphed = b.device.type == "cuda"
    key = (omega_jac, nu, smoother, lmin_frac, gamma, tuple(b.shape), b.dtype, b.device)
    g = h.graphs.get(key) if graphed else None
    if g is not None:
        g.b.copy_(b)
        g.x.copy_(x0)
    x = x0
    iters = 0
    with Profiler("solve"):
        while iters < max_iter:
            if g is None and (not graphed or iters == 0):
                mode = "eager"
                x = uvcycle(h, b, x, **settings)
            else:
                mode = "capture" if g is None else "replay"
                with Profiler("cycle", graph=mode):
                    if g is None:
                        g = h.graphs[key] = CycleGraph(h, b, x, settings)
                    x = g.replay()
            GRAPHS["uvcycle." + mode] += 1
            with Profiler("residual_norm"):
                e = torch.linalg.vector_norm(matmul.spmv_affine(A, x, c=b, alpha=-1.0))
                err[iters] = e
                done = float(e) <= res_tol
            iters += 1
            if done:
                break
    if g is not None:
        x = x.clone()  # never the graph's own buffer
    return x, _conv_factor(err, iters), err, iters


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def build_unstructured_hierarchy(
    A_sp,
    *,
    alpha: float = 0.1,
    max_levels: int = 4,
    min_coarse: int = 800,
    strength_kind: str = "abs",
    lloyd_maxiter: int = 3,
    seed_mode: str = "stride",
    smooth_steps: int = 1,
    trunc_theta: float = 0.02,
    seed: int = 0,
    coarse_method: str = "inverse",
    fmt: str | None = None,
    block_rows: int = 8,
    verbose: bool = False,
    profile_out: dict | None = None,
    rap_mode: str = "auto",
    setup_device: str = "auto",
    device=None,
):
    """SA multilevel setup for a symmetric scipy operator.

    Per level: RCM order -> strength -> Lloyd aggregation -> SA omegas from
    a Gershgorin bound -> Galerkin product -> truncation.  ``fmt`` is
    ``"well"`` (default on CUDA) or ``"csr"`` (default on the CPU).

    ``rap_mode`` picks the Galerkin product: ``"host"`` forms P and
    P^T A P in scipy; ``"device"`` forms P on the hierarchy's device and
    the product there by :func:`rap_masked`, except on a level whose
    pt_width * ap_width exceeds ``WIDE_SLOTS``, where P is read back and
    the product runs in scipy, as in the JAX package; ``"auto"`` is the
    host product at every size (the JAX package's 30M-nnz crossover was
    measured on a TPU, where each masked-product program cost tens of
    seconds of compile).  ``setup_device`` places strength and Lloyd:
    ``"cpu"`` on the CPU (the operator is then copied to the hierarchy's
    device for a device product), ``"default"`` and ``"auto"`` on the
    hierarchy's device (the JAX package's CPU rule for ``"auto"`` exists
    for a remote TPU's compile cost).  With ``seed_mode="random"``, each
    level splits a key chain that starts at ``PRNGKey(seed)`` and draws its
    Lloyd seeds from the split-off key, as the JAX package does.

    The build records spans (``utils/profiler.py``): ``build``, holding
    the stage ``symmetry_check``, a ``level`` (``level=l``) per level with
    the stages ``rcm_reorder``, ``strength_lloyd``, ``sa_omegas``,
    (``patterns_host`` on the device branch), ``p_smooth``, ``galerkin``
    (the product P^T A P) and ``truncate``, then ``repack`` and
    ``coarse_factor``.  Every one is fenced: it synchronises the device
    before it ends.  ``profile_out``, when given, receives seconds per
    stage read from the spans (the ``galerkin`` spans under the key
    ``rap``), ``rap_branch`` (per level: ``"host"``, ``"masked"`` or
    ``"wide"``) and ``rap_levels`` (per level: ``pt_width``, ``ap_width``
    (-1 on the host branch) and ``rap_s``, the level's ``galerkin`` span).
    ``verbose`` prints a line per level and the profile.  Either turns
    recording on for the build.

    Returns (hierarchy, perm): solve in permuted space, i.e. x =
    unpermute(solution of (P A P^T) y = b[perm]).
    """
    import scipy.sparse as sp
    from mlamg_torch import native
    from mlamg_torch.graph.lloyd import lloyd_aggregation
    from mlamg_torch.graph.strength import strength_measure

    dev = resolve_device(device)
    if fmt is None:
        fmt = "well" if dev.type == "cuda" else "csr"
    # each "auto" names one of the other two choices: the host product, and
    # the hierarchy's device
    rap_on_device = {"host": False, "auto": False, "device": True}.get(rap_mode)
    if rap_on_device is None:
        raise ValueError(f"unknown rap_mode: {rap_mode}")
    setup_on_cpu = {"default": False, "auto": False, "cpu": True}.get(setup_device)
    if setup_on_cpu is None:
        raise ValueError(f"unknown setup_device: {setup_device}")
    if seed_mode not in ("stride", "random"):
        raise ValueError(f"unknown seed_mode: {seed_mode}")
    setup_dev = torch.device("cpu") if setup_on_cpu else dev

    profiling = profile_out is not None or verbose
    stages: list = []  # the stage spans, in order (level spans left out)
    rap_widths: list = []

    def stage(name: str):
        span = Profiler(name, fence=True)
        stages.append(span)
        return span

    key = prng.PRNGKey(seed)
    levels: list[dict] = []
    perm0 = None
    with Profiler.recording(profiling), Profiler("build", fence=True):
        with stage("symmetry_check"):
            A_sp = sp.csr_matrix(A_sp).astype(np.float32)
            if (abs(A_sp - A_sp.T) > 1e-6 * abs(A_sp).max()).nnz:
                raise ValueError(
                    "build_unstructured_hierarchy requires a symmetric operator "
                    "(the factored restriction applies A in place of A^T)"
                )
        level_A = A_sp
        for lvl in range(max_levels - 1):
            with Profiler("level", level=lvl, fence=True):
                n = level_A.shape[0]
                with stage("rcm_reorder"):
                    # RCM-order this level (fine level: banded columns for the
                    # SpMV; coarse levels: keeps aggregate numbering banded for
                    # the next one)
                    perm = np.asarray(native.rcm_ordering(level_A))
                    level_A = level_A[perm][:, perm].tocsr()
                    level_A.sort_indices()
                    if lvl == 0:
                        perm0 = perm
                    else:
                        # the parent's aggregate ids follow the relabeling
                        inv = np.empty_like(perm)
                        inv[perm] = np.arange(len(perm))
                        levels[-1]["agg"] = inv[levels[-1]["agg"]]
                    d = np.asarray(level_A.diagonal())
                    Dinv = (1.0 / np.where(d != 0, d, 1.0)).astype(np.float32)
                if n <= min_coarse:
                    break

                with stage("strength_lloyd"):
                    k = int(np.ceil(alpha * n))
                    a_width = int(np.diff(level_A.indptr).max())
                    A_setup = CSR.from_scipy(level_A, dtype=torch.float32, device=setup_dev)
                    C = strength_measure(A_setup, strength_kind, width=a_width)
                    key, sub = prng.split(key)
                    if seed_mode == "stride":
                        # the level is RCM-ordered, so an index stride is a
                        # spatially stratified seeding
                        seeds = np.unique(np.linspace(0, n - 1, k).round().astype(np.int32))
                        k = int(seeds.shape[0])
                        agg_id, _, _ = lloyd_aggregation(C, maxiter=lloyd_maxiter, seeds=seeds)
                    else:
                        agg_id, _, _ = lloyd_aggregation(
                            C, ratio=alpha, maxiter=lloyd_maxiter, key=sub
                        )
                    agg = agg_id.cpu().numpy().copy()
                    if not rap_on_device:
                        A_dev = None
                    elif setup_dev != dev:
                        A_dev = CSR.from_scipy(level_A, dtype=torch.float32, device=dev)
                    else:
                        A_dev = A_setup

                with stage("sa_omegas"):
                    un = agg >= k
                    if un.any():
                        # nodes unreachable from every seed: singleton aggregates
                        agg[un] = k + np.arange(int(un.sum()))
                        k += int(un.sum())
                    # drop empty aggregates (they would give zero coarse rows)
                    used = np.unique(agg)
                    if used.shape[0] < k:
                        remap = np.zeros(k, np.int64)
                        remap[used] = np.arange(used.shape[0])
                        agg = remap[agg]
                        k = int(used.shape[0])
                    # rigorous Gershgorin bound of D^-1 A (a power iteration's
                    # underestimate puts the true lmax outside the Chebyshev
                    # interval)
                    coo = level_A.tocoo()
                    absrow = np.bincount(coo.row, weights=np.abs(coo.data), minlength=n)
                    lmax = np.float32(np.max(absrow / np.abs(np.where(d != 0, d, 1.0))))
                    lmax_s = lmax if lmax > 0 else np.float32(1.0)
                    if smooth_steps == 1:
                        omegas = np.array([np.float32(4.0 / 3.0) / lmax_s], np.float32)
                    else:
                        # inverse Chebyshev roots over [lmax/15, lmax]
                        a_b = lmax_s / np.float32(15.0)
                        b_b = lmax_s
                        ang = ((2.0 * np.arange(1, smooth_steps + 1) - 1)
                               / (2.0 * smooth_steps) * np.pi)
                        roots = ((a_b + b_b) / np.float32(2.0)
                                 + (b_b - a_b) / np.float32(2.0) * np.cos(ang).astype(np.float32))
                        omegas = (np.float32(1.0) / roots).astype(np.float32)

                if A_dev is None:
                    with stage("p_smooth"):
                        Psp = host_prolongator(level_A, agg, k, Dinv, omegas)
                    with stage("galerkin"):
                        AH_sp = (Psp.T @ (level_A @ Psp)).tocsr()
                    branch, pt_width, ap_width = "host", -1, -1
                else:
                    AH_sp, branch, pt_width, ap_width = _device_rap_level(
                        level_A, A_dev, agg, k, a_width, omegas, Dinv, smooth_steps, stage)
                rap_widths.append((branch, pt_width, ap_width))
                with stage("truncate"):
                    AH_sp.sum_duplicates()
                    AH_sp.eliminate_zeros()
                    AH_sp = truncate_lump(AH_sp, trunc_theta)

                levels.append(dict(A=level_A, Dinv=Dinv, agg=agg, omegas=omegas,
                                   lmax=lmax, k=k))
                if verbose:
                    print(f"level {lvl}: n={n} nnz={level_A.nnz} -> k={k} nnz(A_H)={AH_sp.nnz} "
                          f"(widths a={a_width} pt={pt_width} ap={ap_width}) [{branch} rap]",
                          flush=True)
                level_A = AH_sp

        with stage("repack"):
            ulevels = tuple(_make_level(lev, fmt, block_rows, dev) for lev in levels)
        with stage("coarse_factor"):
            coarse = CoarseSolver.factor(
                torch.from_numpy(level_A.toarray().astype(np.float32)).to(dev),
                method=coarse_method,
            )
    if profiling:
        # the stage seconds, read from the spans; the product stage's key
        # is "rap"
        prof: dict = {}
        for span in stages:
            key_s = "rap" if span.name == "galerkin" else span.name
            prof[key_s] = prof.get(key_s, 0.0) + span.duration_s
        rap_s = [span.duration_s for span in stages if span.name == "galerkin"]
        if verbose:
            print(f"setup profile (s): {dict(sorted(prof.items(), key=lambda kv: -kv[1]))}",
                  flush=True)
        if profile_out is not None:
            profile_out.update(
                prof, rap_branch=[br for br, _, _ in rap_widths],
                rap_levels=[{"pt_width": pt, "ap_width": ap, "rap_s": t}
                            for (_, pt, ap), t in zip(rap_widths, rap_s)])
    return UHierarchy(ulevels, coarse), perm0


def _device_rap_level(level_A, A_dev: CSR, agg, k: int, a_width: int, omegas, Dinv,
                      smooth_steps: int, stage):
    """One level of the ``rap_mode="device"`` path: P on the device, then
    its Galerkin product by :func:`rap_masked`, or in scipy on a wide
    level, in the stage spans ``stage(name)`` opens.  Returns (AH_sp,
    branch, pt_width, ap_width)."""
    import scipy.sparse as sp
    from mlamg_torch.mg.interp import smoothed_aggregation

    n = level_A.shape[0]
    dev = A_dev.device
    with stage("patterns_host"):
        Ppat, APpat, AHpat = galerkin_patterns(level_A, agg, k, smooth_steps=smooth_steps)

    with stage("p_smooth"):
        P_dev = smoothed_aggregation(A_dev, torch.from_numpy(agg).to(dev), k,
                                     omega=float(omegas[0]))
        p_width = a_width
        if smooth_steps > 1:
            # widen P step by step, P_{j+1} = P_j - w_{j+1} D^-1 A P_j, on the
            # host-known patterns B^j P1pat; P_j's entries are added in at
            # their positions in the wider pattern (found by searchsorted on
            # the host)
            coo0 = level_A.tocoo()
            pat_j = sp.csr_matrix(
                (np.ones(level_A.nnz, np.float64), (coo0.row, agg[coo0.col])), shape=(n, k))
            pat_j.sum_duplicates()
            pat_j.data[:] = 1.0
            pat_j.sort_indices()
            Bpat = sp.csr_matrix(
                (np.ones(level_A.nnz, np.float64), level_A.indices, level_A.indptr),
                shape=(n, n))
            Dinv_dev = torch.from_numpy(Dinv).to(dev)
            # P1 lives on A's (row, agg[col]) coordinates, duplicates included
            keys_j = coo0.row.astype(np.int64) * (k + 1) + agg[coo0.col].astype(np.int64)
            for j in range(1, smooth_steps):
                pat_next = (Bpat @ pat_j).tocsr()
                pat_next.data[:] = 1.0
                pat_next.sort_indices()
                nxt = pat_next.tocoo()
                keys_next = nxt.row.astype(np.int64) * (k + 1) + nxt.col.astype(np.int64)
                pj_width = int(np.diff(pat_j.indptr).max()) if j > 1 else a_width
                APj = matmul.spgemm_masked(A_dev, P_dev, _pattern_csr(pat_next, dev),
                                           a_width=a_width, b_width=pj_width,
                                           chunk=_auto_chunk(pj_width))
                rows = APj.row.clamp(max=n - 1)
                base = torch.where(APj.mask, -float(omegas[j]) * Dinv_dev[rows] * APj.data,
                                   torch.zeros_like(APj.data))
                # P_j's padded tail slots go to a dump slot past the end
                pos = np.full(P_dev.nnz_pad, base.shape[0], np.int64)
                pos[:keys_j.shape[0]] = np.searchsorted(keys_next, keys_j)
                data = torch.cat([base, base.new_zeros(1)]).index_add(
                    0, torch.from_numpy(pos).to(dev), P_dev.data)[:-1]
                P_dev = APj.with_data(data)
                pat_j, keys_j = pat_next, keys_next
            p_width = int(np.diff(pat_j.indptr).max())

    with stage("galerkin"):
        if smooth_steps == 1:
            pt_width = int(np.bincount(agg[level_A.tocoo().col], minlength=k).max())
        else:
            pt_width = int(np.diff(Ppat.tocsc().indptr).max())
        ap_width = int(np.diff(APpat.indptr).max())
        if pt_width * ap_width <= WIDE_SLOTS:
            AH = rap_masked(A_dev, P_dev, _pattern_csr(APpat, dev), _pattern_csr(AHpat, dev),
                            a_width=a_width, p_width=p_width, pt_width=pt_width,
                            ap_width=ap_width)
            AH_sp, branch = AH.to_scipy(), "masked"
        else:
            # deep levels grow wide aggregate supports: most of the masked
            # product's pt x ap slots per coarse entry would be padding, and
            # the level is small enough for scipy
            Psp = P_dev.to_scipy()
            Psp.sum_duplicates()
            AH_sp, branch = (Psp.T @ level_A @ Psp).tocsr(), "wide"
    return AH_sp, branch, pt_width, ap_width
