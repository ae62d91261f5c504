"""Two-level solve, multilevel V-cycle and the convergence-factor readout
(counterpart of ``mlamg_tpu/mg/cycle.py``), and the cycle layer every
solver of the port shares.

The JAX package runs each solve as one ``lax.while_loop``; here the loop
is Python on the host and every SpMV goes through ``ops/matmul.py``, so a
DIA operator on the card launches the ``dia_spmv`` kernel.  The stopping
test reads each iteration's norm on the host.

One recursion, :func:`_cycle`, runs the V/W-cycle of :func:`vcycle` and of
``mg/amg_unstructured.py``'s ``uvcycle``; one loop, :func:`_solve`, runs
``vcycle_solve``, ``twolevel_solve`` and ``uvcycle_solve`` (with its
:class:`CycleGraph`, where the caller passes a dict of graphs); ``vcycle``
replays a :class:`CycleGraph` of its own on an all-DIA hierarchy on the
card.  This module imports none of the solvers built on it.

Ported: ``twolevel_solve`` with weighted Jacobi (fused or not),
Chebyshev (``lmax`` by power iteration unless given) and multicolor
Gauss-Seidel, ``Hierarchy``, ``build_hierarchy`` (dense coarse levels, and
sparse ones by ``rap_fused``), ``vcycle`` and ``vcycle_solve``, for dense,
sparse (CSR/ELL) and factored prolongators.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from typing import Tuple

import torch

from mlamg_torch.graph.lloyd import lloyd_aggregation
from mlamg_torch.graph.strength import power_iteration_lmax, strength_measure
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.factored import BilinearP2D, FactoredSA, coarse_operator_factored
from mlamg_torch.mg.interp import sa_interpolation_dense, smoothed_aggregation
from mlamg_torch.mg.smoothers import _dinv, chebyshev, jacobi, multicolor_gauss_seidel
from mlamg_torch.ops import matmul
from mlamg_torch.ops.dia import DIA, dia_jacobi_operator
from mlamg_torch.ops.sparse import CSR, ELL
from mlamg_torch.utils import prng
from mlamg_torch.utils.profiler import GRAPHS, LAUNCHES, SYNCS, Profiler


def _is_factored(P) -> bool:
    return isinstance(P, (FactoredSA, BilinearP2D))


def _interp(P, v: torch.Tensor) -> torch.Tensor:
    """P @ v for a dense, sparse (CSR/ELL) or factored P."""
    if _is_factored(P):
        return P.interp(v)
    if isinstance(P, (torch.Tensor, CSR, ELL)):
        return matmul.spmv(P, v)
    raise TypeError(f"_interp: unsupported prolongator {type(P).__name__}")


def _restrict(P, v: torch.Tensor) -> torch.Tensor:
    """P.T @ v for a dense, sparse (CSR/ELL) or factored P."""
    if _is_factored(P):
        return P.restrict(v)
    if isinstance(P, (torch.Tensor, CSR, ELL)):
        return matmul.spmv_t(P, v)
    raise TypeError(f"_restrict: unsupported prolongator {type(P).__name__}")


def coarse_operator(A, P) -> torch.Tensor:
    """Dense Galerkin coarse operator P^T A P."""
    if _is_factored(P):
        return coarse_operator_factored(A, P)
    if isinstance(P, (torch.Tensor, CSR, ELL)):
        return matmul.rap_dense(A, P)
    raise TypeError(f"coarse_operator: unsupported prolongator {type(P).__name__}")


def twolevel_solve(
    A,
    P,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    pre_smoothing_steps: int = 1,
    post_smoothing_steps: int = 1,
    jacobi_weight: float = 0.666,
    res_tol: float | None = None,
    error_tol: float | None = None,
    max_iter: int = 500,
    singular: bool = False,
    smoother: str = "jacobi",
    smoother_args: dict | None = None,
    coarse: CoarseSolver | None = None,
    fused_jacobi: bool | None = None,
    Dinv: torch.Tensor | None = None,
):
    """Two-level AMG solve; returns (x, conv_factor, err_history, iters).

    ``err_history`` is a (max_iter,) buffer, zero past ``iters``.
    ``coarse`` (the factored P^T A P) and ``Dinv`` (A's inverse diagonal)
    are formed here unless a build gives them.
    ``fused_jacobi`` rewrites each Jacobi sweep as the affine map
    x' = (I - w D^-1 A) x + w D^-1 b, one ``dia_spmv`` pass; ``None`` means
    on exactly for a DIA operator on CUDA (the JAX package's "blocked DIA
    on a TPU").  Mathematically identical; rounding differs slightly.

    Spans (``utils/profiler.py``, while recording): ``solve`` holding, per
    iteration, ``cycle`` with one ``level`` (``level=0``) of
    ``pre_smooth``, ``restrict``, ``coarse_solve``, ``interp`` and
    ``post_smooth``, then ``residual_norm`` (the stopping test, a host
    read counted in ``SYNCS["twolevel.residual"]``).
    """
    if res_tol is None and error_tol is None:
        raise RuntimeError("One of res_tol or error_tol must be set!")
    tol = res_tol if res_tol is not None else error_tol
    use_res = res_tol is not None
    smoother_args = dict(smoother_args or {})
    if smoother not in ("jacobi", "chebyshev", "multicolor_gs"):
        raise ValueError(f"unknown smoother {smoother}")

    if Dinv is None:
        Dinv = _dinv(A)
    if coarse is None:
        coarse = CoarseSolver.factor(coarse_operator(A, P), singular=singular)
    if smoother == "chebyshev" and "lmax" not in smoother_args:
        # the spectrum bound of D^-1 A by power iteration
        smoother_args["lmax"] = float(power_iteration_lmax(A, Dinv).abs())

    if fused_jacobi is None:
        fused_jacobi = isinstance(A, DIA) and A.device.type == "cuda"
    M_fused = None
    if fused_jacobi and smoother == "jacobi" and isinstance(A, DIA):
        M_fused = dia_jacobi_operator(A, Dinv, jacobi_weight)
        c_fused = jacobi_weight * Dinv * b

    def smooth(b, x, nu):
        if nu == 0:
            return x
        if M_fused is not None:
            for _ in range(nu):  # c_fused is formed once, from the solve's b
                x = matmul.spmv_affine(M_fused, x, c=c_fused)
            return x
        if smoother == "jacobi":
            return jacobi(A, b, x, Dinv, omega=jacobi_weight, nu=nu)
        if smoother == "multicolor_gs":
            return multicolor_gauss_seidel(A, b, x, smoother_args["colors"],
                                           smoother_args["num_colors"], nu=nu, Dinv=Dinv)
        return chebyshev(A, b, x, smoother_args["lmax"], degree=nu + 1, Dinv=Dinv)

    def cycle(b, x):
        with Profiler("level", level=0):
            with Profiler("pre_smooth"):
                x = smooth(b, x, pre_smoothing_steps)
            with Profiler("restrict"):
                r_H = _restrict(P, matmul.spmv_affine(A, x, c=b, alpha=-1.0))  # b - A x
            with Profiler("coarse_solve"):
                e_H = coarse.solve(r_H)
            with Profiler("interp"):
                x = x + _interp(P, e_H)
            with Profiler("post_smooth"):
                x = smooth(b, x, post_smoothing_steps)
                return x - x.mean() if singular else x

    return _solve(cycle, A, b, x0, tol=tol, max_iter=max_iter, residual=use_res,
                  sync="twolevel.residual")


def _conv_factor(err: torch.Tensor, iters: int) -> float:
    """Geometric-mean convergence factor over the last ``min(iters//3, 10)``
    residual norms of ``err[:iters]``; 0.0 below 6 iterations (or with a
    zero base), 1.0 for a non-finite history (the failure convention of
    the JAX package).  The ratio is taken in ``err``'s dtype and the root
    in double precision.  Indices are clamped to the buffer, as JAX clamps
    them (below 3 iterations err_n is 0 and the base index is ``iters``)."""
    iters = int(iters)
    err_n = min(iters // 3, 10)
    top = err.shape[0] - 1
    last = err[min(max(iters - 1, 0), top)]
    base = err[min(max(iters - err_n, 0), top)]
    SYNCS["conv_factor"] += 2
    last_f, base_f = float(last), float(base)
    if not (math.isfinite(last_f) and math.isfinite(base_f)):
        return 1.0
    if iters < 6 or base_f <= 0:
        return 0.0
    SYNCS["conv_factor"] += 1
    conv = float(last / base) ** (1.0 / max(err_n - 1, 1))
    return conv if math.isfinite(conv) else 1.0


# ---------------------------------------------------------------------------
# Multilevel hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Static-depth multilevel hierarchy (level 0 = finest).

    ``As[l]`` level operator, ``Ps[l]`` prolongator level l+1 -> l,
    ``Dinvs[l]`` inverse diagonal, ``coarse`` the factored coarsest
    operator.  ``lmaxs[l]`` (host floats, optional) bounds the spectrum of
    D^-1 A at level l for the Chebyshev smoother of :func:`vcycle`.
    """

    As: tuple
    Ps: tuple
    Dinvs: tuple
    coarse: CoarseSolver
    lmaxs: Tuple[float, ...] = ()
    # vcycle's CUDA graphs of one cycle (CycleGraph), by cycle setting and b's
    # shape, dtype and device (None after a key's first, eager, cycle); freed
    # with the hierarchy
    graphs: dict = dataclasses.field(default_factory=dict, init=False, compare=False,
                                     repr=False)

    @property
    def num_levels(self) -> int:
        return len(self.As)


def build_hierarchy(A: CSR, *, alpha: float = 0.1, max_levels: int = 3, min_coarse: int = 64,
                    strength_kind: str = "abs", width: int | None = None, key=None,
                    sparse_levels: int = 0) -> Hierarchy:
    """Aggregation setup: strength -> Lloyd -> Jacobi-SA P -> Galerkin
    RAP, level by level while a level has more than ``min_coarse`` rows;
    the coarsest operator is LU-factored (densified first if sparse).

    The first ``sparse_levels`` coarsenings of a CSR level keep the coarse
    operator a CSR: P is the sparse ``smoothed_aggregation`` and
    ``rap_fused`` forms P^T A P with capacity min(4 nnz_pad, k^2),
    doubled and formed again while it overflows.  The other levels use a
    dense P and a dense coarse operator.  Lloyd's keys come from ``key``
    (default ``PRNGKey(0)``), split once per level, as the JAX package
    splits them.  A dense level's strength is taken on its CSR (``width``
    is its row-degree bound for the measures that need one).
    """
    import scipy.sparse as sp

    key = prng.PRNGKey(0) if key is None else key
    As: list = [A]
    Ps: list = []
    Dinvs: list = []
    level_A = A
    for lvl in range(max_levels - 1):
        n = level_A.shape[0]
        if n <= min_coarse:
            break
        k = int(math.ceil(alpha * n))
        if isinstance(level_A, CSR):
            lvl_width = int((level_A.indptr[1:] - level_A.indptr[:-1]).max())
            C = strength_measure(level_A, strength_kind, width=lvl_width)
        else:
            dense = sp.csr_matrix(level_A.cpu().numpy())
            C = strength_measure(CSR.from_scipy(dense, dtype=level_A.dtype, device=level_A.device),
                                 strength_kind, width=width)
        d = level_A.diagonal()
        key, sub = prng.split(key)
        agg_id, _, _ = lloyd_aggregation(C, ratio=alpha, key=sub)
        Dinvs.append(1.0 / torch.where(d != 0, d, torch.ones_like(d)))
        if lvl < sparse_levels and isinstance(level_A, CSR):
            P = smoothed_aggregation(level_A, agg_id, k)
            nnz_out = min(4 * level_A.nnz_pad, k * k)
            while True:  # capacity from a heuristic: never truncate silently
                A_next, overflow = matmul.rap_fused(level_A, P, k=k, nnz_out=nnz_out,
                                                    p_width=lvl_width, return_overflow=True)
                if not bool(overflow):
                    break
                nnz_out *= 2
        else:
            P = sa_interpolation_dense(level_A, agg_id, k)
            A_next = matmul.rap_dense(level_A, P)
        Ps.append(P)
        As.append(A_next)
        level_A = A_next

    A_c = As[-1]
    coarse = CoarseSolver.factor(A_c if isinstance(A_c, torch.Tensor) else A_c.todense())
    return Hierarchy(tuple(As[:-1]), tuple(Ps), tuple(Dinvs), coarse)


def _cycle(levels, coarse: CoarseSolver, interp, restrict, b: torch.Tensor, x: torch.Tensor,
           *, smoother: str, omega: float, nu, lmin_frac: float, gamma: int) -> torch.Tensor:
    """The V/W recursion of :func:`vcycle` and ``uvcycle``, without their
    ``cycle`` span.  ``levels[l]`` is level l's (A, Dinv, lmax, P):
    ``restrict(P, r)`` and ``interp(P, e)`` apply its P^T and P, ``coarse``
    solves below the last level.  Every residual b - A x is one
    ``spmv_affine`` (one kernel pass on a DIA or WindowedELL level)."""
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother}")

    def descend(l, b, x):
        A, Dinv, lmax, P = levels[l]
        nu_l = int(nu) if isinstance(nu, numbers.Integral) else int(nu[min(l, len(nu) - 1)])

        def smooth(x):
            if smoother == "chebyshev":
                return chebyshev(A, b, x, 1.1 * lmax, lmin_frac=lmin_frac, degree=nu_l + 1,
                                 Dinv=Dinv)
            for _ in range(nu_l):
                x = x + omega * Dinv * matmul.spmv_affine(A, x, c=b, alpha=-1.0)
            return x

        with Profiler("level", level=l):
            with Profiler("pre_smooth"):
                x = smooth(x)
            with Profiler("restrict"):
                r_H = restrict(P, matmul.spmv_affine(A, x, c=b, alpha=-1.0))
            if l + 1 == len(levels):
                with Profiler("coarse_solve"):
                    e_H = coarse.solve(r_H)
            else:
                e_H = descend(l + 1, r_H, torch.zeros_like(r_H))
                for _ in range(gamma - 1):
                    e_H = descend(l + 1, r_H, e_H)
            with Profiler("interp"):
                x = x + interp(P, e_H)
            with Profiler("post_smooth"):
                return smooth(x)

    return descend(0, b, x)


def _levels(h: Hierarchy, smoother: str) -> list:
    """:func:`_cycle`'s levels of ``h`` (``lmaxs`` read for Chebyshev only)."""
    cheb = smoother == "chebyshev"
    return [(h.As[l], h.Dinvs[l], h.lmaxs[l] if cheb else None, h.Ps[l])
            for l in range(h.num_levels)]


def vcycle(h: Hierarchy, b: torch.Tensor, x: torch.Tensor, *, omega: float = 0.666,
           nu=1, smoother: str = "jacobi", lmin_frac: float = 1.0 / 15.0,
           gamma: int = 1) -> torch.Tensor:
    """One cycle through the hierarchy.

    ``smoother="chebyshev"`` (needs ``h.lmaxs``) runs a degree-``nu+1``
    Chebyshev polynomial per pre/post smooth, ``"jacobi"`` ``nu`` weighted
    Jacobi sweeps.  ``nu`` is any integer (numpy's too) or a per-level
    sequence whose last entry covers the deeper levels.  ``gamma=1`` is a
    V-cycle, ``gamma=2`` a W-cycle.

    On a CUDA ``b`` over an all-DIA hierarchy (``build_structured_hierarchy``'s)
    the cycle is a :class:`CycleGraph`, one per cycle setting and b's shape,
    dtype and device, kept in ``h.graphs``: a key's first call runs eagerly
    (it warms the kernels, cuBLAS and the allocator), its second captures the
    cycle and replays it, and every later call copies b and x into the
    graph's buffers and replays.  The x returned is never the graph's own
    buffer.  ``GRAPHS`` counts each such call under ``vcycle.eager``,
    ``.capture`` or ``.replay``.  Other hierarchies, and every hierarchy on
    the CPU, run the cycle eagerly and count nothing.

    Every such graph on a device keeps its temporaries in one memory pool
    (:func:`_vcycle_pool`), so a hierarchy built per request reuses the
    memory of the graphs freed before it: a private pool each would stay
    in the allocator's cache after its graph is freed, and the cache is
    not emptied during a capture, so the captures would run out of
    memory.  A graph holds nothing in the pool between replays, so any
    graphs may share it as long as their replays do not overlap: replay
    them on one stream.

    Spans (``utils/profiler.py``, while recording): ``cycle`` (with
    ``graph=`` ``eager``, ``capture`` or ``replay`` where graphed); a
    ``level`` (``level=l``) per visit of a level, holding ``pre_smooth``,
    ``restrict`` (the residual and its restriction), the next level's
    visits or, on the deepest, ``coarse_solve``, then ``interp`` (the
    interpolation and the correction) and ``post_smooth``.  A replayed
    cycle has no spans inside it."""
    levels = _levels(h, smoother)

    def cycle(b, x):
        return _cycle(levels, h.coarse, _interp, _restrict, b, x, smoother=smoother,
                      omega=omega, nu=nu, lmin_frac=lmin_frac, gamma=gamma)

    if b.device.type != "cuda" or not all(isinstance(A, DIA) for A in h.As):
        with Profiler("cycle"):
            return cycle(b, x)
    nus = (int(nu),) if isinstance(nu, numbers.Integral) else tuple(int(v) for v in nu)
    key = (smoother, omega, nus, lmin_frac, gamma, tuple(b.shape), b.dtype, b.device)
    g = h.graphs.get(key)
    mode = "eager" if key not in h.graphs else "capture" if g is None else "replay"
    with Profiler("cycle", graph=mode):
        if mode == "eager":
            x = cycle(b, x)
            h.graphs[key] = None
        else:
            if g is None:
                g = h.graphs[key] = CycleGraph(cycle, b, x, pool=_vcycle_pool(b.device))
            else:
                g.b.copy_(b)
                g.x.copy_(x)
            x = g.replay().clone()
    GRAPHS[f"vcycle.{mode}"] += 1
    return x


_VCYCLE_POOLS: dict = {}


def _vcycle_pool(device: torch.device):
    """The memory pool that ``vcycle``'s graphs on ``device`` share: that of
    a one-add graph captured at the first capture there and kept for the
    process, since a pool is torn down once no graph that uses it is left."""
    anchor = _VCYCLE_POOLS.get(device)
    if anchor is None:
        t = torch.zeros(1, device=device)
        anchor = _VCYCLE_POOLS[device] = CycleGraph(lambda b, x: b + x, t, t)
    return anchor.graph.pool()


def vcycle_solve(h: Hierarchy, b: torch.Tensor, x0: torch.Tensor, *,
                 res_tol: float = 1e-10, max_iter: int = 200,
                 omega: float = 0.666, nu: int = 1):
    """Iterated Jacobi V-cycles with the same convergence-factor readout as
    :func:`twolevel_solve`.  Returns (x, conv_factor, err, iters)."""
    levels = _levels(h, "jacobi")

    def cycle(b, x):
        return _cycle(levels, h.coarse, _interp, _restrict, b, x, smoother="jacobi",
                      omega=omega, nu=nu, lmin_frac=1.0 / 15.0, gamma=1)

    return _solve(cycle, h.As[0], b, x0, tol=res_tol, max_iter=max_iter)


# ---------------------------------------------------------------------------
# The solve loop and its CUDA graph
# ---------------------------------------------------------------------------


_CAPTURE_STREAMS: dict = {}


class CycleGraph:
    """One cycle captured as a CUDA graph: its static ``b`` and ``x``, and
    the graph, which reads the operators' tensors by address and holds its
    temporaries in a memory pool of its own, or in ``pool`` (a graph's
    ``pool()``) shared with other graphs whose replays never overlap its
    own.  A replay runs the cycle on ``b`` and ``x`` and leaves the result
    in ``x``; the cycle's host floats (``lmax``, ``omegas``, the Chebyshev
    recurrence's scalars) are baked in, and the tensors it reads are
    frozen.

    It is captured on a side stream, one per device for every graph (the
    allocator hands a freed block only to allocations on the stream that
    freed it, so graphs captured on one stream reuse a shared pool's
    blocks), with ``capture_begin``/``capture_end``
    (``torch.cuda.graph`` would run a garbage collection and empty the
    allocator's cache first), from inputs the caller has warmed with one
    eager cycle.  Capturing runs nothing: the caller replays after it.
    ``launches`` is what the kernels' launcher counted into ``LAUNCHES``
    while they were captured, the hand-written kernels' launches of one
    replay: taken back out at capture and added at each replay, so
    ``LAUNCHES`` counts launches on the device.  The graph keeps no
    reference to ``cycle``, so it is freed with whatever owns it."""

    def __init__(self, cycle, b: torch.Tensor, x: torch.Tensor, pool=None):
        self.b, self.x = b.clone(), x.clone()
        self.graph = torch.cuda.CUDAGraph()
        counted = LAUNCHES.copy()
        stream = _CAPTURE_STREAMS.get(b.device)
        if stream is None:
            stream = _CAPTURE_STREAMS[b.device] = torch.cuda.Stream(b.device)
        stream.wait_stream(torch.cuda.current_stream(b.device))
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool)  # None: a private pool
            try:
                self.x.copy_(cycle(self.b, self.x))
            finally:
                self.graph.capture_end()
        self.launches = LAUNCHES - counted
        LAUNCHES.subtract(self.launches)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        LAUNCHES.update(self.launches)
        return self.x


def _solve(cycle, A, b: torch.Tensor, x0: torch.Tensor, *, tol: float, max_iter: int,
           residual: bool = True, sync: str | None = None, graphs: dict | None = None,
           name: str = "", key: tuple = ()):
    """Iterate ``x = cycle(b, x)`` from ``x0`` until the stopping norm is at
    most ``tol`` or ``max_iter`` cycles; returns (x, conv_factor, err,
    iters), ``err`` a (max_iter,) buffer of the norms, zero past ``iters``.

    The stopping norm is ||b - A x|| (||x|| unless ``residual``), read on
    the host each cycle and counted in ``SYNCS[sync]`` where ``sync`` is
    given.  Spans: ``solve``, holding per cycle ``cycle`` (the cycle's own
    spans inside it) and ``residual_norm``.

    With a dict ``graphs`` (its owner's), ``GRAPHS`` counts each cycle
    under ``name`` + ``.eager``, ``.capture`` or ``.replay``, as does the
    ``graph`` attribute of its ``cycle`` span.  On a CUDA ``b`` the cycle
    is then a :class:`CycleGraph` kept in ``graphs`` under ``key`` and b's
    shape, dtype and device: the first solve runs its first cycle eagerly,
    captures the second and replays it from then on; a later solve copies
    b and x0 into the graph's buffers and replays every cycle.  The norm
    and its host read stay outside the graph; the x returned is never the
    graph's own buffer."""
    err = torch.zeros(max_iter, dtype=x0.dtype, device=x0.device)
    graphed = graphs is not None and b.device.type == "cuda"
    key = (*key, tuple(b.shape), b.dtype, b.device)
    g = graphs.get(key) if graphed else None
    if g is not None:
        g.b.copy_(b)
        g.x.copy_(x0)
    x = x0
    iters = 0
    with Profiler("solve"):
        while iters < max_iter:
            if graphs is None:
                with Profiler("cycle"):
                    x = cycle(b, x)
            else:
                mode = "eager" if g is None and (not graphed or iters == 0) else (
                    "capture" if g is None else "replay")
                with Profiler("cycle", graph=mode):
                    if mode == "eager":
                        x = cycle(b, x)
                    else:
                        if g is None:
                            g = graphs[key] = CycleGraph(cycle, b, x)
                        x = g.replay()
                GRAPHS[f"{name}.{mode}"] += 1
            with Profiler("residual_norm"):
                e = torch.linalg.vector_norm(
                    matmul.spmv_affine(A, x, c=b, alpha=-1.0) if residual else x)
                err[iters] = e
                if sync is not None:
                    SYNCS[sync] += 1
                done = float(e) <= tol
            iters += 1
            if done:
                break
    if g is not None:
        x = x.clone()
    return x, _conv_factor(err, iters), err, iters
