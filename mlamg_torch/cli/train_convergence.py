"""Train and evaluate the convergence-factor predictor (counterpart of
``mlamg_tpu/cli/train_convergence.py``).

Labels are first-party: for every grid, ``--per-grid`` splittings are
built in three quality regimes (Lloyd aggregation; Bellman-Ford from
random roots; Lloyd corrupted by moving a random share of the nodes to a
neighbour's aggregate), their two-level convergence factors measured, and
a :class:`~mlamg_torch.models.convergence.ConvergencePredictor` regressed
on them with eight node features.  The draws are the JAX CLI's: the keys
from ``PRNGKey(seed)`` split once per sample (:mod:`mlamg_torch.utils.prng`)
and the ratios and corruptions from ``RandomState(seed + 1)``.

    python -m mlamg_torch.cli.train_convergence data_out/2d_iso/train --epochs 40 [--device cpu]

``--cache-samples`` keeps the labelled samples in an npz that either
package reads.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from mlamg_torch.cli.common import parse_bool_str
from mlamg_torch.device import resolve_device

ALPHAS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3)


def _logit(y, eps=1e-4):
    y = np.clip(y, eps, 1.0 - eps)
    return float(np.log(y / (1.0 - y)))


def build_samples(grids, alpha: float, per_grid: int, seed: int = 0, vary_alpha: bool = True,
                  device=None, aggs: list | None = None):
    """[(A as CSR, node features (n, 8) float32, conv label)] of labelled
    splittings, ``per_grid`` per grid, the regime cycling Lloyd, random
    roots, corrupted Lloyd (corruption share p ~ U(0.05, 0.8)).  With
    ``vary_alpha`` each splitting draws its coarsening ratio from
    ``ALPHAS``.  The features: 1/n, k/n, center indicator, distance to
    the center, aggregate size, diagonal, degree (each over its mean) and
    the share of a node's edges that cross aggregates.  ``aggs``, if
    given, receives each sample's aggregate ids (numpy)."""
    from mlamg_torch.graph.bellman_ford import bellman_ford, nearest_center_to_agg
    from mlamg_torch.graph.lloyd import lloyd_aggregation
    from mlamg_torch.graph.strength import strength_measure
    from mlamg_torch.mg.interp import sa_interpolation_dense
    from mlamg_torch.train import GridBundle, SolveOptions, measured_conv
    from mlamg_torch.utils import prng

    dev = resolve_device(device)
    opts = SolveOptions()
    samples = []
    key = prng.PRNGKey(seed)
    rng = np.random.RandomState(seed + 1)
    for g in grids:
        b0 = GridBundle.from_grid(g, alpha, device=dev)
        n = b0.A.shape[0]
        A_sp = g.A.tocsr()
        C = strength_measure(b0.A, "abs", width=b0.width)
        deg = np.diff(A_sp.indptr).astype(np.float32)
        diag = b0.A.diagonal().cpu().numpy().astype(np.float32)
        diag_f = diag / max(np.abs(diag).mean(), 1e-30)
        deg_f = deg / max(deg.mean(), 1e-30)
        coo = A_sp.tocoo()
        for j in range(per_grid):
            a_j = rng.choice(ALPHAS) if vary_alpha else alpha
            b = GridBundle.from_grid(g, a_j, device=dev) if vary_alpha else b0
            key, sub = prng.split(key)
            if j % 3 == 1:
                roots = torch.from_numpy(prng.permutation(sub, n)[: b.k]).to(dev)
                dist, nearest = bellman_ford(C, roots)
                agg_id = nearest_center_to_agg(roots, nearest)
            else:
                agg_id, roots, _ = lloyd_aggregation(C, ratio=a_j, key=sub)
                dist, _ = bellman_ford(C, roots)
            agg = agg_id.cpu().numpy().copy()
            if j % 3 == 2:
                # corrupt: each selected node adopts a random neighbour's
                # aggregate, so conv degrades continuously with p
                p = rng.uniform(0.05, 0.8)
                hit = rng.rand(n) < p
                for i in np.nonzero(hit)[0]:
                    nbrs = A_sp.indices[A_sp.indptr[i]:A_sp.indptr[i + 1]]
                    nbrs = nbrs[nbrs != i]
                    if nbrs.size:
                        agg[i] = agg[rng.choice(nbrs)]
                agg_id = torch.from_numpy(agg).to(dev)
            roots = roots.cpu().numpy()
            k_j = max(int(roots.shape[0]) if j % 3 == 1 else b.k, int(agg.max()) + 1)
            P = sa_interpolation_dense(b.A, agg_id, k_j)
            conv = float(measured_conv(b.A, P, b.x0, opts))
            is_center = np.zeros(n, np.float32)
            is_center[roots] = 1.0
            sizes = np.bincount(agg, minlength=k_j).astype(np.float32)
            size_f = sizes[agg] / max(sizes.mean(), 1e-30)
            d = dist.cpu().numpy().astype(np.float32)
            d = np.where(np.isfinite(d), d, 0.0)
            dist_f = d / max(d.mean(), 1e-30)
            # share of a node's edges that cross aggregate boundaries
            cross = (agg[coo.row] != agg[coo.col]).astype(np.float32)
            cross_f = (np.bincount(coo.row, weights=cross, minlength=n)
                       / np.maximum(deg, 1.0)).astype(np.float32)
            feats = np.stack([np.full(n, 1.0 / n, np.float32),
                              np.full(n, k_j / n, np.float32),  # coarsening ratio
                              is_center, dist_f, size_f, diag_f, deg_f, cross_f], axis=1)
            samples.append((b.A, torch.from_numpy(feats).to(dev), conv))
            if aggs is not None:
                aggs.append(agg)
    return samples


def save_samples(path: str, samples) -> None:
    """The npz cache: an (N, 3) object array of (scipy CSR, features,
    label), the JAX CLI's layout."""
    raw = np.empty((len(samples), 3), dtype=object)
    for i, (A, f, label) in enumerate(samples):
        raw[i, 0] = A.to_scipy().tocsr()
        raw[i, 1] = f.cpu().numpy()
        raw[i, 2] = float(label)
    np.savez(path, samples=raw)


def load_samples(path: str, device) -> list:
    """The samples of an npz cache written by either package.  Unpickling
    runs code, so load only caches this project wrote."""
    import scipy.sparse as sp

    from mlamg_torch.ops.sparse import CSR

    raw = np.load(path, allow_pickle=True)["samples"]
    return [(CSR.from_scipy(sp.csr_matrix(A), device=device),
             torch.from_numpy(np.asarray(f, np.float32)).to(device), float(label))
            for A, f, label in raw]


def huber_loss(pred: torch.Tensor, target: float, delta: float = 1.0) -> torch.Tensor:
    """optax.huber_loss."""
    abs_err = (pred - target).abs()
    quadratic = abs_err.clamp(max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_err - quadratic)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the convergence predictor")
    p.add_argument("system", type=str, help="folder with .grid files")
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--per-grid", type=int, default=4)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dims", type=int, nargs="+", default=[16, 32, 16])
    p.add_argument("--K", type=int, default=10)
    p.add_argument("--test-frac", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None, help="write metrics JSON")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--logit-space", type=parse_bool_str, default=True,
                   help="regress logit(conv) with a linear head instead of "
                        "conv with a sigmoid head (avoids saturation at "
                        "conv ~ 1)")
    p.add_argument("--vary-alpha", type=parse_bool_str, default=True,
                   help="draw each splitting's coarsening ratio from "
                        "U(0.05, 0.3) and expose k/n as a node feature")
    p.add_argument("--scatter-png", type=str, default=None,
                   help="write a measured-vs-predicted scatter plot here")
    p.add_argument("--cache-samples", type=str, default=None,
                   help="npz path: reuse previously built labeled splittings "
                        "(building them, hundreds of measured two-level "
                        "solves, dominates a training run)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


def main(argv=None, log=print, record: dict | None = None) -> dict:
    """Build (or load) the samples, train, report; returns the JAX CLI's
    metrics record.  A ``record`` dict receives the seconds of the sample
    build and of each epoch, each epoch's train mse, and the samples' node
    features, labels and (when built here) aggregate ids."""
    from mlamg_torch.cli.optim import Adam
    from mlamg_torch.convert import params_from_module
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.models.convergence import ConvergencePredictor
    from mlamg_torch.models.gnn import init_flax_
    from mlamg_torch.models.graphdata import graph_from_matrix_node_vals
    from mlamg_torch.utils import prng
    from mlamg_torch.utils.checkpoint import save_checkpoint

    args = parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    aggs: list = []
    if args.cache_samples and os.path.exists(args.cache_samples):
        samples = load_samples(args.cache_samples, dev)
    else:
        samples = build_samples(Grid.load_dir(args.system), args.alpha, args.per_grid, args.seed,
                                vary_alpha=args.vary_alpha, device=dev, aggs=aggs)
        if args.cache_samples:
            save_samples(args.cache_samples, samples)
    seconds_samples = time.perf_counter() - t0
    rng = np.random.RandomState(args.seed)
    order = rng.permutation(len(samples))
    n_test = max(1, int(len(samples) * args.test_frac))
    # validation carved out of the training indices selects the checkpoint;
    # the test split is read only by the final report
    n_val = max(1, int(len(samples) * args.test_frac))
    test_idx = order[:n_test]
    val_idx = order[n_test:n_test + n_val]
    train_idx = order[n_test + n_val:]
    log(f"{len(train_idx)} train / {len(val_idx)} val / {len(test_idx)} test samples")

    net = ConvergencePredictor(in_dim=int(samples[0][1].shape[1]), dims=tuple(args.dims),
                               K=args.K, logit_head=args.logit_space)
    init_flax_(net, prng.PRNGKey(args.seed))
    net.to(dev)
    params = list(net.parameters())
    opt = Adam(params, args.lr)

    def target(label):
        return _logit(label) if args.logit_space else label

    def predict(A, feats) -> float:
        with torch.no_grad():
            z = net(graph_from_matrix_node_vals(A, feats))
            return float(torch.sigmoid(z) if args.logit_space else z)

    def evaluate(idx):
        preds = np.asarray([predict(*samples[i][:2]) for i in idx])
        labels = np.asarray([samples[i][2] for i in idx])
        mse = float(np.mean((preds - labels) ** 2))
        if len(idx) > 2 and np.std(preds) > 0 and np.std(labels) > 0:
            corr = float(np.corrcoef(preds, labels)[0, 1])
        else:
            corr = float("nan")
        return mse, corr, preds, labels

    best = (-np.inf, None)  # (val corr, weights): early-stopping selection
    epoch_s, train_mse = [], []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        rng.shuffle(train_idx)
        tot = 0.0
        for i in train_idx:
            A, feats, label = samples[i]
            loss = huber_loss(net(graph_from_matrix_node_vals(A, feats)), target(label))
            opt.step(torch.autograd.grad(loss, params))
            tot += float(loss.detach())
        sync()
        epoch_s.append(time.perf_counter() - t0)
        train_mse.append(tot / len(train_idx))
        if (epoch + 1) % 5 == 0 or epoch == args.epochs - 1:
            mse, corr, _, _ = evaluate(val_idx)
            if np.isfinite(corr) and corr > best[0]:
                best = (corr, copy.deepcopy(net.state_dict()))
            log(f"epoch {epoch + 1}: train mse {train_mse[-1]:.5f}  "
                f"val mse {mse:.5f}  val corr {corr:.3f}")

    if best[1] is not None:
        net.load_state_dict(best[1])
    mse, corr, preds, labels = evaluate(test_idx)
    val_mse, val_corr, _, _ = evaluate(val_idx)
    result = {"test_mse": mse, "test_corr": corr, "val_mse": val_mse, "val_corr": val_corr,
              "n_train": len(train_idx), "n_val": len(val_idx), "n_test": len(test_idx),
              "scatter": {"pred": np.round(preds, 5).tolist(),
                          "label": np.round(labels, 5).tolist()}}
    if record is not None:
        record.update(seconds_samples=seconds_samples, seconds_per_epoch=epoch_s,
                      train_mse=train_mse, aggs=aggs,
                      features=[f.cpu().numpy() for _, f, _ in samples],
                      labels=[label for _, _, label in samples])
    if args.scatter_png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(labels, preds, s=12, alpha=0.7)
        lim = [min(labels.min(), preds.min()), max(labels.max(), preds.max())]
        ax.plot(lim, lim, "k--", lw=1)
        ax.set_xlabel("measured conv factor")
        ax.set_ylabel("predicted conv factor")
        ax.set_title(f"test r = {corr:.3f} (n = {len(labels)})")
        fig.tight_layout()
        fig.savefig(args.scatter_png, dpi=120)
        log(f"scatter plot -> {args.scatter_png}")
    log(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, generation=args.epochs,
                        best_params=params_from_module(net))
    return result


if __name__ == "__main__":
    main()
