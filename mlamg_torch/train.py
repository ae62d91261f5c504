"""Evaluation of learned and classical two-level AMG, and the shape
buckets of training (counterpart of ``mlamg_tpu/train.py``).

Every method reports the convergence factor of one two-level solve
(:func:`measured_conv`): b = 0 from a fixed unit-norm x0, multicolor
Gauss-Seidel by default, a dense LU of the Galerkin operator, NaN counted
as 1.0.  The baselines are Lloyd aggregation on the olson strength
(:func:`lloyd_reference_conv`) and Bellman-Ford from random centers
(:func:`random_reference_conv`), both with a Jacobi-smoothed prolongator;
the learned method is a :class:`~mlamg_torch.models.agg_interp.FullAggNet`
(:func:`evaluate_model_on_bundles`).  The random draws are the JAX
package's bit for bit (:mod:`mlamg_torch.utils.prng`).

Training groups its grids into shape buckets (:func:`make_buckets`): each
grid padded with an identity block to its bucket's size, as the JAX
package pads them, because padding changes the soft loss (its ridge and
test vectors) and the order of the model's sums.  The JAX package
evaluates a bucket as one vmapped program; here a bucket is a loop over
its grids (:func:`make_population_fitness_bucketed`), and a mesh splits
the population over its pop axis.  The GA's fitness
without buckets (:func:`make_population_fitness`) loops over the grids
unpadded.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mlamg_torch.data.grid import Grid
from mlamg_torch.device import resolve_device
from mlamg_torch.ga.codec import assign_flat, flatten_params
from mlamg_torch.graph.bellman_ford import bellman_ford, nearest_center_to_agg
from mlamg_torch.graph.lloyd import _lloyd_core
from mlamg_torch.graph.strength import strength_measure
from mlamg_torch.mg.cycle import twolevel_solve
from mlamg_torch.mg.interp import sa_interpolation_dense
from mlamg_torch.mg.smoothers import greedy_coloring
from mlamg_torch.models.loss import numpy_dtype
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng


@dataclasses.dataclass
class SolveOptions:
    res_tol: float = 1e-6
    max_iter: int = 300
    pre_smooth: int = 1
    post_smooth: int = 1
    jacobi_weight: float = 0.666
    singular: bool = False
    # "jacobi" | "multicolor_gs" | "chebyshev"
    smoother: str = "jacobi"
    # stop on ||x|| (b = 0) instead of the residual norm
    use_error_norm: bool = False


def _host_parts(g: Grid, alpha: float):
    """(scipy A, k, x0, colours) of a grid, on the host."""
    A = g.A.tocsr()
    n = A.shape[0]
    x0 = np.random.RandomState(0).randn(n)
    x0 /= np.linalg.norm(x0)
    return A, max(1, int(np.ceil(alpha * n))), x0, greedy_coloring(A).astype(np.int64)


@dataclasses.dataclass
class GridBundle:
    """A grid's system on the device, ready for evaluation: ``k =
    ceil(alpha n)`` aggregates, x0 (``RandomState(0)`` normal, unit norm),
    the largest row degree, the greedy colouring and the Lloyd reference
    conv (set by ``compute_reference_convs``)."""

    A: CSR
    k: int
    x0: torch.Tensor
    width: int
    colors: torch.Tensor
    num_colors: int
    ref_conv: float = 1.0

    @staticmethod
    def from_grid(g: Grid, alpha: float, dtype=torch.float32, device=None) -> "GridBundle":
        return GridBundle._from_host(_host_parts(g, alpha), dtype, resolve_device(device))

    @staticmethod
    def _from_host(parts, dtype, device) -> "GridBundle":
        A, k, x0, colors = parts
        return GridBundle(
            CSR.from_scipy(A, dtype=dtype, device=device), k,
            torch.from_numpy(x0).to(device=device, dtype=dtype),
            int(np.diff(A.indptr).max()),
            torch.from_numpy(colors).to(device),
            int(colors.max()) + 1,
        )


def measured_conv(A: CSR, P, x0: torch.Tensor, opts: SolveOptions, colors=None,
                  num_colors: int = 0, coarse=None, Dinv=None) -> float:
    """Convergence factor of the two-level cycle with b = 0 (NaN -> 1.0);
    ``coarse`` and ``Dinv`` as a build made them, else formed here."""
    smoother_args = None
    if opts.smoother == "multicolor_gs":
        if colors is None:
            raise ValueError("multicolor_gs smoother needs a graph coloring")
        smoother_args = {"colors": colors, "num_colors": num_colors}
    use_res = (not opts.singular) and (not opts.use_error_norm)
    _, conv, _, _ = twolevel_solve(
        A, P, torch.zeros_like(x0), x0,
        pre_smoothing_steps=opts.pre_smooth,
        post_smoothing_steps=opts.post_smooth,
        jacobi_weight=opts.jacobi_weight,
        res_tol=opts.res_tol if use_res else None,
        error_tol=None if use_res else opts.res_tol,
        max_iter=opts.max_iter,
        singular=opts.singular,
        smoother=opts.smoother,
        smoother_args=smoother_args,
        coarse=coarse,
        Dinv=Dinv,
    )
    return 1.0 if math.isnan(conv) else conv


def bundle_conv(b: GridBundle, P, opts: SolveOptions) -> float:
    """:func:`measured_conv` of ``P`` on a bundle's system."""
    return measured_conv(b.A, P, b.x0, opts, colors=b.colors, num_colors=b.num_colors)


def learned_conv(net, b: GridBundle, opts: SolveOptions) -> float:
    """:func:`measured_conv` of a FullAggNet on a bundle's system, through
    :func:`~mlamg_torch.mg.learned.build_learned_twolevel` with the
    bundle's colouring."""
    from mlamg_torch.mg.learned import build_learned_twolevel

    h = build_learned_twolevel(net, b.A, b.k, colors=b.colors, num_colors=b.num_colors,
                               singular=opts.singular)
    return measured_conv(b.A, h.P, b.x0, opts, colors=b.colors, num_colors=b.num_colors,
                         coarse=h.coarse, Dinv=h.Dinv)


def _first_k(b: GridBundle, key) -> torch.Tensor:
    """The first k of ``permutation(key, n)``: seeds or centers."""
    return torch.from_numpy(prng.permutation(key, b.A.shape[0])[: b.k]).to(b.A.device)


def lloyd_aggregation_of(b: GridBundle, strength_kind: str = "abs", key=None,
                         maxiter: int = 10) -> torch.Tensor:
    """agg_id of Lloyd on the strength matrix from the first k of
    ``permutation(key, n)`` (``key`` = PRNGKey(0) unless given)."""
    C = strength_measure(b.A, strength_kind, width=b.width)
    agg_id, _ = _lloyd_core(C, _first_k(b, prng.PRNGKey(0) if key is None else key), maxiter)
    return agg_id


def lloyd_reference_conv(b: GridBundle, strength_kind: str = "abs",
                         opts: SolveOptions | None = None, key=None,
                         maxiter: int = 10) -> float:
    """Lloyd + Jacobi-SA baseline: one seeded Lloyd draw per grid,
    ``maxiter`` Lloyd iterations."""
    agg_id = lloyd_aggregation_of(b, strength_kind, key, maxiter)
    return bundle_conv(b, sa_interpolation_dense(b.A, agg_id, b.k), opts or SolveOptions())


def random_reference_conv(b: GridBundle, key=None, opts: SolveOptions | None = None,
                          strength_kind: str = "olson") -> float:
    """Random-centers baseline: the first k of ``permutation(key, n)``
    (``key`` = PRNGKey(42) unless given), Bellman-Ford on the strength
    matrix, Jacobi-SA."""
    opts = opts or SolveOptions()
    C = strength_measure(b.A, strength_kind, width=b.width)
    centers = _first_k(b, prng.PRNGKey(42) if key is None else key)
    _, nearest = bellman_ford(C, centers)
    agg_id = nearest_center_to_agg(centers, nearest)
    return bundle_conv(b, sa_interpolation_dense(b.A, agg_id, b.k), opts)


@torch.no_grad()
def evaluate_model_on_bundles(net, bundles, opts: SolveOptions | None = None) -> np.ndarray:
    """Per-grid conv factors of a FullAggNet's prolongator."""
    opts = opts or SolveOptions()
    return np.asarray([learned_conv(net, b, opts) for b in bundles])


@dataclasses.dataclass
class BucketStack:
    """The grids of one shape bucket, each padded to (n_pad, nnz_pad) with
    identity rows.  The padding block is disconnected, so a padded grid's
    real nodes give the unpadded results; ``n_real``/``k_real`` are host
    ints, so padding costs no host sync."""

    As: tuple  # per grid: CSR (n_pad, n_pad) with nnz_pad entries
    x0: torch.Tensor  # (B, n_pad), zero on padding rows
    n_real: tuple  # (B,) ints
    k_real: tuple  # (B,) ints
    k: int  # the bucket's aggregate count
    idx: np.ndarray  # (B,) indices into the flat bundle list
    colors: torch.Tensor  # (B, n_pad) greedy colouring (padding rows 0)
    num_colors: int  # the bucket's largest colour count

    def pad(self, j: int) -> tuple:
        return self.n_real[j], self.k_real[j]


def make_buckets(grids, alpha: float, dtype=torch.float32, step: int = 64, device=None):
    """(flat GridBundles, [BucketStack]) from Grids.

    Grids are grouped by n rounded up to ``step``; every grid of a bucket
    is padded to one ``nnz_pad`` (the largest padded nnz, at least 128 and
    a multiple of 128), and the bucket has ``k = ceil(alpha n_pad)``
    aggregates, ``k - k_real`` of them pinned to padding nodes.  Padding is
    built in numpy, one transfer per field and bucket.
    """
    import scipy.sparse as sp

    dev = resolve_device(device)
    host = [_host_parts(g, alpha) for g in grids]
    bundles = [GridBundle._from_host(parts, dtype, dev) for parts in host]
    groups: dict[int, list[int]] = {}
    for i, (A, *_) in enumerate(host):
        groups.setdefault(-(-A.shape[0] // step) * step, []).append(i)

    buckets = []
    for nb, idxs in sorted(groups.items()):
        nnz_pad = max(max(int(host[i][0].nnz) + nb - host[i][0].shape[0] for i in idxs), 128)
        nnz_pad = ((nnz_pad + 127) // 128) * 128
        k_bucket = max(1, int(np.ceil(alpha * nb)))
        B = len(idxs)
        datas = np.zeros((B, nnz_pad), np.float64)
        rows = np.full((B, nnz_pad), nb, np.int64)
        cols = np.zeros((B, nnz_pad), np.int64)
        indptrs = np.zeros((B, nb + 1), np.int64)
        x0s = np.zeros((B, nb), np.float64)
        colorss = np.zeros((B, nb), np.int64)
        for j, i in enumerate(idxs):
            A, k, x0, colors = host[i]
            n = A.shape[0]
            Ap = sp.block_diag([A, sp.eye(nb - n, format="csr")], format="csr") if nb > n else A.copy()
            Ap.sort_indices()
            nnz = int(Ap.nnz)
            datas[j, :nnz] = Ap.data
            cols[j, :nnz] = Ap.indices
            rows[j, :nnz] = np.repeat(np.arange(nb), np.diff(Ap.indptr))
            indptrs[j] = Ap.indptr
            x0s[j, :n] = x0
            colorss[j, :n] = colors
            if not 0 <= k_bucket - k <= nb - n:
                raise ValueError(f"make_buckets: the {k_bucket - k} padding centers of a grid "
                                 f"with n {n} do not fit its bucket of {nb} (alpha {alpha})")
        data_t = torch.from_numpy(datas).to(device=dev, dtype=dtype)
        row_t, col_t, ptr_t = (torch.from_numpy(a).to(dev) for a in (rows, cols, indptrs))
        buckets.append(BucketStack(
            tuple(CSR(data_t[j], row_t[j], col_t[j], ptr_t[j], (nb, nb), nnz_pad) for j in range(B)),
            torch.from_numpy(x0s).to(device=dev, dtype=dtype),
            tuple(host[i][0].shape[0] for i in idxs), tuple(host[i][1] for i in idxs),
            k_bucket, np.asarray(idxs),
            torch.from_numpy(colorss).to(dev),
            max(bundles[i].num_colors for i in idxs),
        ))
    return bundles, buckets


@torch.no_grad()
def bucketed_convs(net, buckets, opts: SolveOptions | None = None) -> np.ndarray:
    """Per-grid conv factors of a FullAggNet's prolongator on the padded
    grids, in bucket order (NaN counted as 1.0)."""
    opts = opts or SolveOptions()
    out = []
    for b in buckets:
        for j, A in enumerate(b.As):
            _, P, _, _, _ = net(A, b.k, pad=b.pad(j))
            out.append(measured_conv(A, P, b.x0[j], opts, colors=b.colors[j],
                                     num_colors=b.num_colors))
    return np.asarray(out)


def population_convs(net, population, convs_of) -> np.ndarray:
    """(M, G) conv factors: ``convs_of(net)`` with each row of
    ``population`` (flat weight vectors in
    :func:`mlamg_torch.ga.codec.flatten_params` order, numpy or torch)
    written into ``net``; the module's own weights are restored
    afterwards."""
    keep = flatten_params(net)[0]
    try:
        rows = []
        for vec in population:
            assign_flat(net, torch.as_tensor(vec))
            rows.append(convs_of(net))
    finally:
        assign_flat(net, keep)
    return np.asarray(rows)


def fitness_from_convs(convs, ref, dtype, loss_relative: bool = True,
                       fitness_metric: str = "mean_ratio") -> np.ndarray:
    """(M,) fitness of (M, G) conv factors against the grids' reference
    convs, in ``dtype`` (the bundles'), as the JAX package computes it:
    NaN counted as 1.0; "mean_ratio" is 1 / mean_i(conv_i / ref_i) (the
    reference trainer's), "ratio_of_means" mean(ref) / mean(conv) (the
    published tables' protocol); without ``loss_relative`` the reference
    is 1; each capped at 1e9."""
    t = np.dtype(dtype).type
    convs = np.asarray(convs, t)
    convs = np.where(np.isnan(convs), t(1.0), convs)
    ref = np.asarray(ref, t)
    if fitness_metric == "ratio_of_means":
        rel = convs.mean(axis=1) / (ref.mean() if loss_relative else t(1.0))
    else:
        rel = (convs / ref[None, :] if loss_relative else convs).mean(axis=1)
    return t(1.0) / np.maximum(rel, t(1e-9))


def _population_convs_fn(net, data, mesh):
    """convs(population, convs_of) -> (M, G): :func:`population_convs` of
    ``convs_of(module, data)``.  With a ``mesh``, the population is split
    over its pop axis (:func:`mlamg_torch.parallel.shard_population_eval`)
    and each block of shards evaluated on its device, with the module and
    ``data`` copied there once where they live elsewhere; each row's convs
    are the unsharded ones."""
    if mesh is None:
        return lambda population, convs_of: population_convs(
            net, population, lambda m: convs_of(m, data))
    from mlamg_torch.parallel import shard_population_eval
    from mlamg_torch.parallel._comm import to_device

    replicas: dict = {}

    def convs(population, convs_of):
        def per_shard(rows):
            if rows.device not in replicas:
                replicas[rows.device] = (to_device(net, rows.device), to_device(data, rows.device))
            m, d = replicas[rows.device]
            return population_convs(m, rows, lambda mm: convs_of(mm, d))

        return shard_population_eval(per_shard, mesh)(population).numpy()

    return convs


def make_population_fitness_bucketed(net, bundles, buckets, opts: SolveOptions | None = None,
                                     loss_relative: bool = True,
                                     fitness_metric: str = "mean_ratio", mesh=None):
    """fitness_func(population (M, W), generation) -> (M,) fitness of flat
    weight vectors on the padded grids (:func:`population_convs`,
    :func:`fitness_from_convs`); ``fitness_func.last_convs`` holds the
    (M, G) convs of its last call, the grids in bucket order.  The JAX
    package maps the population and the grids with ``vmap``; here both
    are loops, with a ``mesh`` split over its pop axis."""
    opts = opts or SolveOptions()
    order = np.concatenate([b.idx for b in buckets])
    ref = [bundles[i].ref_conv for i in order]
    dtype = numpy_dtype(buckets[0].x0.dtype)
    convs_fn = _population_convs_fn(net, buckets, mesh)

    def fitness_func(population, generation=0) -> np.ndarray:
        convs = convs_fn(population, lambda m, bs: bucketed_convs(m, bs, opts))
        fitness_func.last_convs = convs
        return fitness_from_convs(convs, ref, dtype, loss_relative, fitness_metric)

    return fitness_func


def make_population_fitness(net, bundles, opts: SolveOptions | None = None,
                            loss_relative: bool = True, batch_size: int | None = None,
                            mesh=None):
    """fitness_func(population (M, W), generation) -> (M,) fitness
    1 / mean over grids of conv / ref (:func:`fitness_from_convs`), each
    grid unpadded.  With ``batch_size`` below the number of grids, each
    call takes the minibatch ``RandomState(generation).choice(G,
    batch_size, replace=False)``, as the JAX package does; with a ``mesh``
    the population is split over its pop axis;
    ``fitness_func.last_convs`` holds the convs of its last call."""
    opts = opts or SolveOptions()
    ref = np.asarray([b.ref_conv for b in bundles])
    dtype = numpy_dtype(bundles[0].x0.dtype)
    convs_fn = _population_convs_fn(net, bundles, mesh)

    def fitness_func(population, generation=0) -> np.ndarray:
        if batch_size is not None and batch_size < len(bundles):
            batch = np.random.RandomState(generation).choice(len(bundles), size=batch_size,
                                                             replace=False)
        else:
            batch = np.arange(len(bundles))
        convs = convs_fn(population, lambda m, bs: evaluate_model_on_bundles(
            m, [bs[i] for i in batch], opts))
        fitness_func.last_convs = convs
        return fitness_from_convs(convs, ref[batch], dtype, loss_relative)

    return fitness_func
