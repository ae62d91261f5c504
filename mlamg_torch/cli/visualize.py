"""Figures of grids, aggregates, datasets and results (counterpart of
``mlamg_tpu/cli/visualize.py``).

    python -m mlamg_torch.cli.visualize grid path/to/g.grid --out g.png
    python -m mlamg_torch.cli.visualize aggregates g.grid --model ckpt --out agg.png
    python -m mlamg_torch.cli.visualize dataset-stats data_dir --out hist.png
    python -m mlamg_torch.cli.visualize eval-results eval.pkl --out scatter.png
    python -m mlamg_torch.cli.visualize model-error g.grid --model ckpt --out err.png
    python -m mlamg_torch.cli.visualize model-passes g.grid --model ckpt --out passes.png

The model runs on ``--device`` (default CUDA); the drawing needs
matplotlib, which only the drawing functions import.  The numbers behind
``model-error`` and ``model-passes`` come from :func:`model_error` and
:func:`model_passes`.  A checkpoint's ``net_config`` sets the model's
widths (:func:`load_net`); without ``--model`` the model has flax's
initial weights (``PRNGKey(0)``), ``--dim`` wide.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from mlamg_torch.device import resolve_device


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_net(model: str | None, g, device, dim: int = 8, dtype=torch.float32):
    """FullAggNet for grid ``g`` on ``device``: a checkpoint's, as
    ``evaluate_dataset`` loads it, else flax's initial weights of
    ``FullAggNet(dim, num_conv=2, iterations=2)``."""
    from mlamg_torch.cli.evaluate_dataset import load_model
    from mlamg_torch.models.agg_interp import FullAggNet
    from mlamg_torch.models.gnn import init_flax_
    from mlamg_torch.utils import prng

    if model is None:
        return init_flax_(FullAggNet(dim=dim, num_conv=2, iterations=2),
                          prng.PRNGKey(0)).to(device=device, dtype=dtype)
    return load_model(model, [g], device=device, dtype=dtype, dim=dim)[0]


@torch.no_grad()
def model_error(net, b, cycles: int) -> tuple[np.ndarray, float]:
    """The error left after ``cycles`` two-level cycles (b = 0, Jacobi,
    from the bundle's x0) with the model's P, and the cycles' conv."""
    from mlamg_torch.mg.cycle import twolevel_solve

    _, P, *_ = net(b.A, b.k)
    x, conv, _, _ = twolevel_solve(b.A, P, torch.zeros_like(b.x0), b.x0, res_tol=0.0,
                                   max_iter=cycles)
    return x.cpu().numpy(), conv


@torch.no_grad()
def model_passes(net, b) -> list:
    """Each AggNet layer's 0/1 top-k mask on the model's own input graph."""
    from mlamg_torch.models.graphdata import graph_from_matrix_basic

    g = graph_from_matrix_basic(b.A, ell_width=net.bf_width, rel_strength=net.rel_strength)
    return [m.cpu().numpy() for m in net.AggNetM(g, b.k, return_intermediate=True)]


def _bundle(args, g):
    from mlamg_torch.train import GridBundle

    return GridBundle.from_grid(g, args.alpha, device=resolve_device(args.device))


def cmd_grid(args, log=print):
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.viz import plot_grid

    plt = _plt()
    g = Grid.load(args.path)
    plt.figure(figsize=(7, 7))
    plot_grid(g)
    plt.savefig(args.out, dpi=130, bbox_inches="tight")
    plt.close("all")
    log(f"wrote {args.out}")


def cmd_aggregates(args, log=print):
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.viz import plot_agg, plot_agg_3d, plot_spider_agg

    plt = _plt()
    g = Grid.load(args.path)
    b = _bundle(args, g)
    net = load_net(args.model, g, b.x0.device, args.dim)
    with torch.no_grad():
        agg_id, P, *_ = net(b.A, b.k)
    agg = agg_id.cpu().numpy()
    plt.figure(figsize=(7, 7))
    if g.x is not None and g.x.shape[1] >= 3 and np.ptp(g.x[:, 2]) > 0:
        plot_agg_3d(g, agg)
    else:
        plot_agg(g, agg)
        plot_spider_agg(g, agg, P.todense().cpu().numpy())
    plt.savefig(args.out, dpi=130, bbox_inches="tight")
    plt.close("all")
    log(f"wrote {args.out}")


def cmd_dataset_stats(args, log=print):
    from mlamg_torch.data.grid import Grid

    plt = _plt()
    grids = Grid.load_dir(args.path)
    sizes = [g.n for g in grids]
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(sizes, bins=30)
    axes[0].set_xlabel("n (dofs)")
    axes[1].hist([g.A.nnz for g in grids], bins=30)
    axes[1].set_xlabel("nnz")
    fig.suptitle(f"{len(grids)} grids")
    plt.savefig(args.out, dpi=130, bbox_inches="tight")
    plt.close("all")
    log(f"wrote {args.out}: n in [{min(sizes)}, {max(sizes)}]")


def cmd_eval_results(args, log=print):
    plt = _plt()
    with open(args.path, "rb") as f:
        res = pickle.load(f)
    fig, ax = plt.subplots(figsize=(6, 6))
    base = res.get("lloyd")
    for name in ("ml", "random"):
        if name in res:
            ax.scatter(base, res[name], s=14, label=f"{name} vs lloyd")
    lim = [0, max(1.0, float(np.max(base)))]
    ax.plot(lim, lim, "k--", lw=1)
    ax.set_xlabel("lloyd conv factor")
    ax.set_ylabel("other conv factor")
    ax.legend()
    means = {k: float(np.mean(v)) for k, v in res.items() if isinstance(v, np.ndarray)}
    ax.set_title(" ".join(f"{k}={v:.3f}" for k, v in means.items()))
    plt.savefig(args.out, dpi=130, bbox_inches="tight")
    plt.close("all")
    log(f"wrote {args.out}; means: {means}")


def cmd_model_error(args, log=print):
    from mlamg_torch.data.grid import Grid

    g = Grid.load(args.path)
    b = _bundle(args, g)
    e, conv = model_error(load_net(args.model, g, b.x0.device, args.dim), b, args.cycles)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(g.x[:, 0], g.x[:, 1], c=e, cmap="RdBu", s=25)
    fig.colorbar(sc)
    ax.set_title(f"error after {args.cycles} cycles (conv={conv:.3f})")
    plt.savefig(args.out, dpi=130, bbox_inches="tight")
    plt.close("all")
    log(f"wrote {args.out}")


def cmd_model_passes(args, log=print):
    from mlamg_torch.data.grid import Grid

    g = Grid.load(args.path)
    b = _bundle(args, g)
    masks = model_passes(load_net(args.model, g, b.x0.device, args.dim), b)
    plt = _plt()
    fig, axes = plt.subplots(1, len(masks), figsize=(6 * len(masks), 6), squeeze=False)
    for ax, m in zip(axes[0], masks):
        ax.scatter(g.x[:, 0], g.x[:, 1], c="0.8", s=15)
        sel = m > 0.5
        ax.scatter(g.x[sel, 0], g.x[sel, 1], c="r", s=35)
    plt.savefig(args.out, dpi=130, bbox_inches="tight")
    plt.close("all")
    log(f"wrote {args.out}")


COMMANDS = {
    "grid": cmd_grid,
    "aggregates": cmd_aggregates,
    "dataset-stats": cmd_dataset_stats,
    "eval-results": cmd_eval_results,
    "model-error": cmd_model_error,
    "model-passes": cmd_model_passes,
}


def main(argv=None, log=print) -> None:
    p = argparse.ArgumentParser(description="Visualization utilities")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in COMMANDS.items():
        sp = sub.add_parser(name)
        sp.add_argument("path")
        sp.add_argument("--out", default=f"{name}.png")
        sp.add_argument("--model", default=None)
        sp.add_argument("--alpha", type=float, default=0.1)
        sp.add_argument("--dim", type=int, default=8)
        sp.add_argument("--cycles", type=int, default=10)
        sp.add_argument("--device", type=str, default=None,
                        help="torch device for the model (default cuda; cpu runs on the host)")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    args.fn(args, log=log)


if __name__ == "__main__":
    main()
