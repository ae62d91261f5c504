"""Dataset-level evaluation: learned AMG against the Lloyd and random
baselines (counterpart of ``mlamg_tpu/cli/evaluate_dataset.py``).

    python -m mlamg_torch.cli.evaluate_dataset data_out/2d_iso/test \\
        --model runs_iso_r5/grad_best.ckpt [--ablations true] [--device cuda|cpu]

Writes ``eval_<name>_alpha<alpha>.pkl`` (per-grid conv factors) and a
``.json`` of their means into ``--out``.  Runs on CUDA unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from mlamg_torch.cli.common import dataset_bf_width, parse_bool_str
from mlamg_torch.convert import fullaggnet_from_params
from mlamg_torch.data.grid import Grid
from mlamg_torch.device import resolve_device
from mlamg_torch.graph.strength import STRENGTH_MEASURES
from mlamg_torch.mg.interp import sa_interpolation_dense
from mlamg_torch.train import (
    GridBundle, SolveOptions, bundle_conv, learned_conv, lloyd_aggregation_of,
    lloyd_reference_conv, random_reference_conv,
)
from mlamg_torch.utils.checkpoint import load_checkpoint


def load_model(path: str, grids, device=None, dtype=torch.float32, dim: int = 8,
               num_conv: int = 2, iterations: int = 2):
    """(FullAggNet, net_config) from a checkpoint.  The Bellman-Ford width
    is the checkpoint's, raised to cover the grids' degrees."""
    ck = load_checkpoint(path)
    nc = dict((ck.get("extra") or {}).get("net_config") or {})
    config = {
        "dim": int(nc.get("dim", dim)),
        "num_conv": int(nc.get("num_conv", num_conv)),
        "iterations": int(nc.get("iterations", iterations)),
        "bf_width": max(int(nc.get("bf_width", 0)), dataset_bf_width(grids)),
        "rel_strength": bool(nc.get("rel_strength", False)),
    }
    return fullaggnet_from_params(ck["best_params"], config, device=device, dtype=dtype), config


@torch.no_grad()
def evaluate(grids, net=None, *, alpha: float = 0.1, strength: str = "olson",
             opts: SolveOptions | None = None, ablations: bool = False,
             device=None, dtype=torch.float32, log=print) -> tuple[dict, dict]:
    """Per-grid conv factors of every method, and seconds per method.

    ``lloyd``: Lloyd on ``strength`` from the seeds of PRNGKey(0);
    ``random``: Bellman-Ford from the centers of PRNGKey(42); ``ml``: the
    FullAggNet ``net``'s two-level hierarchy, built by
    :func:`~mlamg_torch.mg.learned.build_learned_twolevel`.  With
    ``ablations``, ``ml_agg_only`` (learned aggregates, Jacobi-SA) and
    ``ml_int_only`` (Lloyd aggregates, learned interpolation).
    """
    opts = opts or SolveOptions(smoother="multicolor_gs")
    dev = resolve_device(device)
    bundles = [GridBundle.from_grid(g, alpha, dtype, device=dev) for g in grids]

    runs = {
        "lloyd": lambda b: lloyd_reference_conv(b, strength, opts),
        "random": lambda b: random_reference_conv(b, opts=opts, strength_kind=strength),
    }
    if net is not None:
        runs["ml"] = lambda b: learned_conv(net, b, opts)
        if ablations:
            runs["ml_agg_only"] = lambda b: bundle_conv(
                b, sa_interpolation_dense(b.A, net.agg_only(b.A, b.k), b.k), opts)
            runs["ml_int_only"] = lambda b: bundle_conv(
                b, net.int_only(b.A, lloyd_aggregation_of(b, strength), b.k), opts)
    results, seconds = {}, {}
    for name, run in runs.items():
        t = time.time()
        results[name] = np.asarray([run(b) for b in bundles])
        seconds[name] = time.time() - t
        log(f"{name}: mean conv {results[name].mean():.4f} ({seconds[name]:.1f}s)")
    return results, seconds


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate ML/Lloyd/random AMG on a dataset")
    p.add_argument("system", type=str)
    p.add_argument("--model", type=str, default=None, help="checkpoint file")
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--strength-measure", default="olson", choices=STRENGTH_MEASURES)
    p.add_argument("--res-tol", type=float, default=1e-6)
    p.add_argument("--max-iter", type=int, default=300)
    p.add_argument("--smoother", default="multicolor_gs",
                   choices=["jacobi", "multicolor_gs", "chebyshev"])
    p.add_argument("--float64", type=parse_bool_str, default=False)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--num-conv", type=int, default=2)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--out", type=str, default="data_out")
    p.add_argument("--ablations", type=parse_bool_str, default=False,
                   help="also evaluate ML-aggregation-only and ML-interpolation-only")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = torch.float64 if args.float64 else torch.float32
    opts = SolveOptions(res_tol=args.res_tol, max_iter=args.max_iter, smoother=args.smoother)
    grids = Grid.load_dir(args.system)
    print(f"{len(grids)} grids")
    net = None
    if args.model:
        net, config = load_model(args.model, grids, device=dev, dtype=dtype, dim=args.dim,
                                 num_conv=args.num_conv, iterations=args.iterations)
        print(f"net config: {config}")
    results, _ = evaluate(grids, net, alpha=args.alpha, strength=args.strength_measure,
                          opts=opts, ablations=args.ablations, device=dev, dtype=dtype)
    results = {"alpha": args.alpha, "system": args.system, **results}

    os.makedirs(args.out, exist_ok=True)
    name = os.path.basename(os.path.normpath(args.system))
    out_path = os.path.join(args.out, f"eval_{name}_alpha{args.alpha}.pkl")
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    summary = {k: float(np.mean(v)) for k, v in results.items() if isinstance(v, np.ndarray)}
    summary.update({"n_grids": len(grids), "system": args.system,
                    "alpha": args.alpha, "model": args.model or ""})
    json_path = out_path.replace(".pkl", ".json")
    with open(json_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"saved {out_path} and {json_path}")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
