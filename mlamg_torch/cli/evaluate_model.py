"""One grid, three aggregations (counterpart of
``mlamg_tpu/cli/evaluate_model.py``): the two-level convergence factors of
Lloyd aggregation (key ``PRNGKey(0)``, abs strength), of Bellman-Ford from
random centers, and, with ``--model``, of a FullAggNet checkpoint (its
``net_config``), with whether the learned aggregates are connected and
their sizes.

    python -m mlamg_torch.cli.evaluate_model grid.grid --model ckpt.ckpt [--device cpu]

``--plot out.png`` draws Lloyd's aggregates beside the learned ones
(``--spider``: P-weighted spider plots); it needs matplotlib.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mlamg_torch.device import resolve_device

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate one grid: ML vs Lloyd vs random")
    p.add_argument("grid", type=str)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--num-conv", type=int, default=2)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--res-tol", type=float, default=1e-6)
    p.add_argument("--plot", type=str, default=None,
                   help="write a Lloyd-vs-ML aggregate comparison figure here")
    p.add_argument("--spider", action="store_true",
                   help="spider plots (P-weighted) instead of blob plots")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


def main(argv=None, log=print) -> dict:
    """Print the JAX CLI's lines; returns n, nnz, k, ``lloyd_conv`` and
    ``random_conv``, and with a model ``ml_conv``, ``connected`` and
    ``sizes``."""
    from mlamg_torch.convert import fullaggnet_from_params
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.graph.components import check_aggregates_connected
    from mlamg_torch.train import (GridBundle, SolveOptions, lloyd_aggregation_of,
                                   lloyd_reference_conv, measured_conv, random_reference_conv)
    from mlamg_torch.utils.checkpoint import load_checkpoint

    args = parse_args(argv)
    dev = resolve_device(args.device)
    g = Grid.load(args.grid)
    opts = SolveOptions(res_tol=args.res_tol)
    b = GridBundle.from_grid(g, args.alpha, device=dev)
    log(f"n={g.n} nnz={g.A.nnz} k={b.k}")

    out = {"n": g.n, "nnz": int(g.A.nnz), "k": b.k,
           "lloyd_conv": lloyd_reference_conv(b, "abs", opts),
           "random_conv": random_reference_conv(b, opts=opts)}
    log(f"lloyd conv:  {out['lloyd_conv']:.4f}")
    log(f"random conv: {out['random_conv']:.4f}")

    ml = None
    if args.model:
        ck = load_checkpoint(args.model)
        nc = (ck.get("extra") or {}).get("net_config") or {}
        config = dict(dim=int(nc.get("dim", args.dim)),
                      num_conv=int(nc.get("num_conv", args.num_conv)),
                      iterations=int(nc.get("iterations", args.iterations)),
                      rel_strength=bool(nc.get("rel_strength", False)),
                      bf_width=max(int(nc["bf_width"]), b.width) if nc.get("bf_width") else None)
        net = fullaggnet_from_params(ck["best_params"], config, device=dev)
        with torch.no_grad():
            agg_id, P, _, _, _ = net(b.A, b.k)
        conv = measured_conv(b.A, P, b.x0, opts)
        connected = check_aggregates_connected(b.A, agg_id, b.k)
        sizes = np.bincount(agg_id.cpu().numpy(), minlength=b.k)
        log(f"ml conv:     {conv:.4f}")
        log(f"aggregates connected: {connected}; sizes min/mean/max = "
            f"{sizes.min()}/{sizes.mean():.1f}/{sizes.max()}")
        out.update(ml_conv=conv, connected=connected, sizes=sizes)
        ml = (agg_id, P, conv)
    if args.plot:
        _plot(args, g, lloyd_aggregation_of(b, "abs").cpu().numpy(), out["lloyd_conv"], ml)
        log(f"wrote {args.plot}")
    return out


def _plot(args, g, lloyd_agg, lloyd_conv: float, ml) -> None:
    """Lloyd's aggregates, and beside them the model's (agg_id, P, conv)
    where there is one."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from mlamg_torch.viz.aggplot import plot_agg, plot_spider_agg

    ncols = 2 if ml is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 5.5), squeeze=False)
    draw = plot_spider_agg if args.spider else plot_agg
    draw(g, lloyd_agg, ax=axes[0, 0])
    axes[0, 0].set_title(f"Lloyd + SA  (conv {lloyd_conv:.4f})")
    if ml is not None:
        agg_id, P, conv = ml
        agg_id = agg_id.cpu().numpy()
        if args.spider:
            draw(g, agg_id, P=P.todense().cpu().numpy(), ax=axes[0, 1])
        else:
            draw(g, agg_id, ax=axes[0, 1])
        axes[0, 1].set_title(f"ML (FullAggNet)  (conv {conv:.4f})")
    fig.tight_layout()
    fig.savefig(args.plot, dpi=130)
    plt.close(fig)


if __name__ == "__main__":
    main()
