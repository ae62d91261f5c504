"""Shared CLI helpers (counterpart of ``mlamg_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import scipy.sparse as sp

from mlamg_torch.data.grid import Grid
from mlamg_torch.graph.strength import STRENGTH_MEASURES
from mlamg_torch.train import GridBundle, lloyd_reference_conv


def parse_bool_str(v: str) -> bool:
    return str(v).lower() in ("t", "true", "1", "yes")


def dataset_bf_width(grids) -> int:
    """Largest row or column degree over a dataset's matrices: the width of
    the pull-mode Bellman-Ford and of the graphs' ``in_ell``.  Both assume
    a symmetric sparsity pattern, which is checked here so an unsuitable
    dataset fails at setup instead of dropping edges later."""
    w = 1
    for i, g in enumerate(grids):
        A = sp.csr_matrix(g.A)
        pat = A.copy()
        pat.data = np.ones_like(pat.data)
        if (pat != pat.T).nnz != 0:
            name = (g.extra or {}).get("filename", f"grid {i}")
            raise ValueError(
                f"{name}: sparsity pattern is not symmetric; the pull-mode "
                "Bellman-Ford and the in_ell message sums need a symmetric "
                "pattern (symmetrize it, or use bf_width=None)"
            )
        w = max(w, int(np.diff(A.indptr).max()), int(np.diff(A.tocsc().indptr).max()))
    return w


def load_dataset_grids(system: str):
    """(train, test) Grids of ``system/train`` and ``system/test``, or of
    ``system`` itself for both when those do not exist."""
    train_dir = os.path.join(system, "train")
    test_dir = os.path.join(system, "test")
    if not (os.path.exists(train_dir) and os.path.exists(test_dir)):
        train_dir = test_dir = system
    return Grid.load_dir(train_dir), Grid.load_dir(test_dir)


def load_dataset(system: str, alpha: float, dtype, device=None):
    """(train, test) GridBundles of :func:`load_dataset_grids`' grids, on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    train, test = load_dataset_grids(system)
    return ([GridBundle.from_grid(g, alpha, dtype, device=device) for g in train],
            [GridBundle.from_grid(g, alpha, dtype, device=device) for g in test])


def reference_settings(strength_measure: str, opts) -> dict:
    """The measurement settings a reference-conv cache is keyed by."""
    return {
        "strength": strength_measure,
        "res_tol": opts.res_tol,
        "max_iter": opts.max_iter,
        "pre": opts.pre_smooth,
        "post": opts.post_smooth,
        "smoother": opts.smoother,
        "error_norm": opts.use_error_norm,
        "singular": opts.singular,
    }


def compute_reference_convs(bundles, strength_measure: str, opts, grids=None,
                            cache_path: str | None = None,
                            write_path: str | None = None) -> np.ndarray:
    """Lloyd reference conv of each bundle (``lloyd_reference_conv``, at
    least 1e-6), set as its ``ref_conv``.

    ``cache_path`` names a cache to read (the JAX package's
    ``.ref_convs_<strength>.json`` beside each split): a grid whose file
    name it holds under the same settings is not measured again.  The
    convs measured here, with the cached ones, are written only to
    ``write_path`` (a temporary file renamed into place), never to
    ``cache_path``.  ``grids`` supplies the file names.
    """
    settings = reference_settings(strength_measure, opts)
    cache = {}
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                payload = json.load(f)
            if payload.get("settings") == settings:
                cache = dict(payload.get("convs", {}))
        except (OSError, ValueError):
            cache = {}

    def grid_key(i):
        fname = (grids[i].extra or {}).get("filename", "") if grids is not None else ""
        return os.path.basename(fname) if fname else None

    measured = False
    for i, b in enumerate(bundles):
        key = grid_key(i)
        if key is not None and key in cache:
            b.ref_conv = float(cache[key])
            continue
        b.ref_conv = max(lloyd_reference_conv(b, strength_measure, opts), 1e-6)
        measured = True
        if key is not None:
            cache[key] = b.ref_conv
    if write_path and measured:
        os.makedirs(os.path.dirname(write_path) or ".", exist_ok=True)
        tmp = write_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"settings": settings, "convs": cache}, f)
        os.replace(tmp, write_path)
    return np.asarray([b.ref_conv for b in bundles])


def add_training_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The GA trainer's flags, with the JAX package's names and defaults;
    ``--device`` takes the place of ``--platform``, and the JAX-only
    ``--compile-cache`` (XLA's compilation cache) has no counterpart."""
    parser.add_argument("system", type=str, help="Problem folder with .grid files")
    parser.add_argument("--max-generations", type=int, default=500)
    parser.add_argument("--population-size", type=int, default=20)
    parser.add_argument("--alpha", type=float, default=0.1, help="coarsening ratio")
    parser.add_argument("--start-generation", type=int, default=0)
    parser.add_argument("--start-model", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint to restore the whole GA state from "
                             "(population, fitness, key, sigma, generation); "
                             "--start-model only seeds the population around best_params")
    parser.add_argument("--benchmark-only", action="store_true",
                        help="measure the Lloyd reference convs, write them beside the "
                             "checkpoints, then exit")
    parser.add_argument("--strength-measure", default="olson", choices=STRENGTH_MEASURES,
                        help="strength for the Lloyd benchmark; the reference's published "
                             "baselines use 'olson'")
    parser.add_argument("--greedy", default=False, type=parse_bool_str)
    parser.add_argument("--batched", default=False, type=parse_bool_str)
    parser.add_argument("--compute-test-loss", default=True, type=parse_bool_str)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--loss-relative-measure", type=parse_bool_str, default=True)
    parser.add_argument("--fitness-metric", default="mean_ratio",
                        choices=["mean_ratio", "ratio_of_means"],
                        help="mean_ratio = the reference trainer's fitness "
                             "(1/mean(conv/ref)); ratio_of_means = the published tables' "
                             "protocol mean(conv)/mean(ref)")
    parser.add_argument("--adaptive-sigma", type=parse_bool_str, default=False,
                        help="mutation scale follows the 1/5-success rule")
    parser.add_argument("--mutate-subnets", type=str, default=None,
                        help="comma-separated regexes of fold names; only matching "
                             "subnets' weights mutate (e.g. 'AggNet,CNet')")
    parser.add_argument("--mutation-sparsity", type=float, default=None,
                        help="per-weight mutation probability instead of fold-wise masks")
    parser.add_argument("--evaluate-bench-loss", type=parse_bool_str, default=True)
    parser.add_argument("--pre-smooth", type=int, default=1)
    parser.add_argument("--post-smooth", type=int, default=1)
    parser.add_argument("--res-tol", type=float, default=1e-6)
    parser.add_argument("--max-iter", type=int, default=300)
    parser.add_argument("--smoother", default="multicolor_gs",
                        choices=["jacobi", "multicolor_gs", "chebyshev"],
                        help="two-level smoother inside the fitness measure")
    parser.add_argument("--error-norm", type=parse_bool_str, default=True,
                        help="stop on ||x|| (error norm, b = 0) like the reference trainer")
    parser.add_argument("--dim", type=int, default=8, help="model hidden dim")
    parser.add_argument("--num-conv", type=int, default=2)
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--rel-strength", type=parse_bool_str, default=False,
                        help="row-normalized strength edge feature for AggNet/CNet "
                             "(changes parameter shapes)")
    parser.add_argument("--bucketed", type=parse_bool_str, default=True,
                        help="pad the grids to shape buckets (the JAX package's one "
                             "program per bucket) instead of evaluating each unpadded")
    parser.add_argument("--bucket-step", type=int, default=64,
                        help="grids are padded to n rounded up to this step")
    parser.add_argument("--mesh-pop", type=int, default=0,
                        help="split the population fitness over this many pop shards "
                             "on the run's device (0 = none)")
    parser.add_argument("--init-perturb", type=float, default=0.5,
                        help="uniform perturbation when seeding the population")
    parser.add_argument("--mutation-prob", type=float, default=1.0,
                        help="per-fold mutation probability")
    parser.add_argument("--fold-depth", type=int, default=2,
                        help="parameter-path depth defining GA folds (2 = per subnet)")
    parser.add_argument("--mutation-perturb", type=float, default=0.5,
                        help="uniform mutation magnitude")
    parser.add_argument("--crossover-prob", type=float, default=0.0)
    parser.add_argument("--checkpoint-dir", type=str, default="models_chkpt")
    parser.add_argument("--float64", default=False, type=parse_bool_str)
    parser.add_argument("--test-loss-every", type=int, default=10,
                        help="evaluate the test set every N generations")
    parser.add_argument("--checkpoint-every", type=int, default=10,
                        help="write a checkpoint every N generations")
    parser.add_argument("--metrics-dir", type=str, default="runs")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser
