"""Imitation pretraining of FullAggNet (counterpart of
``mlamg_tpu/cli/pretrain_dataset.py``).

Each sub-network learns what the classical pipeline does, with losses that
never cross a discrete step:

- AggNet scores: weighted BCE against Lloyd's centers (top-k of the scores
  then picks Lloyd's seeds);
- CNet edges: MSE against the normalised log of the strength measure Lloyd
  aggregates on;
- PNet edges: MSE against the Jacobi-SA smoother I - w D^-1 A on A's
  pattern, with the Lloyd aggregation as PNet's input feature.

    python -m mlamg_torch.cli.pretrain_dataset data_out/2d_iso --epochs 60 \\
        --rel-strength true --out runs/pretrain.ckpt [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from mlamg_torch.cli.common import dataset_bf_width, load_dataset_grids, parse_bool_str
from mlamg_torch.cli.optim import Adam
from mlamg_torch.convert import params_from_fullaggnet
from mlamg_torch.device import resolve_device
from mlamg_torch.graph.lloyd import lloyd_aggregation
from mlamg_torch.graph.strength import strength_measure
from mlamg_torch.graph.topk import topk_indices
from mlamg_torch.models.agg_interp import FullAggNet
from mlamg_torch.models.gnn import init_flax_
from mlamg_torch.models.graphdata import graph_from_matrix, graph_from_matrix_basic
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng
from mlamg_torch.utils.checkpoint import save_checkpoint


def build_targets(grids, alpha: float, strength_kind: str, omega: float = 2.0 / 3.0,
                  device=None, dtype=torch.float32):
    """Per grid (A, k, center indicator, C targets, P targets, Lloyd agg_id).

    As in the JAX package the targets are made in float32 (Lloyd on the
    strength measure from ``split(PRNGKey(0))``, one split per grid) and
    then cast to ``dtype``; A is in ``dtype``."""
    dev = resolve_device(device)
    out = []
    key = prng.PRNGKey(0)
    for g in grids:
        A = g.A.tocsr()
        n = A.shape[0]
        k = max(1, int(np.ceil(alpha * n)))
        A32 = CSR.from_scipy(A, dtype=torch.float32, device=dev)
        C = strength_measure(A32, strength_kind, width=int(np.diff(A.indptr).max()))
        key, sub = prng.split(key)
        agg_id, roots, _ = lloyd_aggregation(C, ratio=alpha, key=sub)
        is_center = np.zeros(n, np.float32)
        is_center[roots.cpu().numpy()] = 1.0
        # log-space target: strength values span decades, and the small
        # (near) ones decide every Bellman-Ford assignment
        logc = np.log(np.maximum(C.data.cpu().numpy().astype(np.float32), np.float32(1e-12)))
        cvals = ((logc - logc.min()) / max(logc.max() - logc.min(), 1e-12)).astype(np.float32)
        # SA smoother on A's pattern: delta_ij - w a_ij / d_i
        d = np.asarray(A.diagonal())
        row, col = A32.row.cpu().numpy(), A32.col.cpu().numpy()
        mask = row < n
        rsafe = np.minimum(row, n - 1)
        pvals = -omega * A32.data.cpu().numpy() / np.where(d[rsafe] != 0, d[rsafe], 1.0)
        pvals = np.where((row == col) & mask, 1.0 + pvals, pvals)
        pvals = np.where(mask, pvals, 0.0).astype(np.float32)
        on = lambda a: torch.from_numpy(a).to(device=dev, dtype=dtype)  # noqa: E731
        out.append((CSR.from_scipy(A, dtype=dtype, device=dev), k, on(is_center), on(cvals),
                    on(pvals), agg_id))
    return out


def heads(net, A: CSR, k: int, agg_id: torch.Tensor):
    """(scores, CNet edge head, PNet edge head) on the graphs without ELL
    width, PNet reading the given aggregation."""
    g = graph_from_matrix_basic(A, rel_strength=net.rel_strength)
    _, scores = net.AggNetM(g, k)
    _, bf_edges = net.CNet(g)
    _, p_edges = net.PNet(graph_from_matrix(A, agg_id))
    return scores, bf_edges[:, 0], p_edges[:, 0]


def pretrain_loss(net, A: CSR, k: int, is_center, cvals, pvals, agg_id):
    """(loss, (bce, mse_c, mse_p)): the center BCE weighted (n - k) / k on
    the positives, plus 10 MSE on C and 10 MSE on P over A's entries."""
    scores, c_out, p_out = heads(net, A, k, agg_id)
    n = is_center.shape[0]
    pos_w = (n - k) / max(k, 1)
    bce = -(pos_w * is_center * F.logsigmoid(scores)
            + (1 - is_center) * F.logsigmoid(-scores)).mean()
    mask = A.mask
    zero = torch.zeros_like(c_out)
    cnt = mask.sum()
    mse_c = torch.where(mask, (c_out - cvals) ** 2, zero).sum() / cnt
    mse_p = torch.where(mask, (p_out - pvals) ** 2, zero).sum() / cnt
    return bce + 10.0 * mse_c + 10.0 * mse_p, (bce, mse_c, mse_p)


@torch.no_grad()
def center_accuracy(net, A: CSR, k: int, is_center, agg_id) -> float:
    """Share of the k top-scored nodes that are Lloyd centers."""
    scores, _, _ = heads(net, A, k, agg_id)
    picked = torch.zeros_like(is_center)
    picked[topk_indices(scores, k)] = 1.0
    return float((picked * is_center).sum() / k)


def train_epoch(net, opt, data, order) -> np.ndarray:
    """One pass over ``data`` in ``order``, an Adam step per grid; the mean
    (loss, bce, mse_c, mse_p)."""
    tot = np.zeros(4)
    for i in order:
        A, k, is_center, cvals, pvals, agg_id = data[i]
        net.zero_grad(set_to_none=True)
        loss, parts = pretrain_loss(net, A, k, is_center, cvals, pvals, agg_id)
        loss.backward()
        opt.step([torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params])
        tot += [float(loss.detach()), *(float(v.detach()) for v in parts)]
    return tot / len(data)


def main(argv=None, dtype=torch.float32):
    """The CLI in float32; ``dtype`` float64 serves comparisons across
    devices.  Returns the trained module and the last epoch's mean (loss,
    bce, mse_c, mse_p)."""
    p = argparse.ArgumentParser(description="Imitation pretraining of FullAggNet")
    p.add_argument("system", type=str, help="dataset folder (train/ used if present)")
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--num-conv", type=int, default=2)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--rel-strength", default=False, type=parse_bool_str)
    p.add_argument("--strength-measure", default="olson")
    p.add_argument("--out", type=str, default="pretrain.ckpt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=None,
                   help="use only the first N training grids")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    train_grids, _ = load_dataset_grids(args.system)
    if args.limit is not None:
        train_grids = train_grids[: args.limit]
    data = build_targets(train_grids, args.alpha, args.strength_measure, device=dev, dtype=dtype)
    print(f"{len(data)} training grids")

    bf_width = dataset_bf_width(train_grids)
    net_config = dict(dim=args.dim, num_conv=args.num_conv, iterations=args.iterations,
                      bf_width=bf_width, rel_strength=args.rel_strength)
    net = FullAggNet(**net_config)
    init_flax_(net, prng.PRNGKey(args.seed))
    net.to(device=dev, dtype=dtype)
    opt = Adam(list(net.parameters()), args.lr)

    rng = np.random.RandomState(args.seed)
    order = np.arange(len(data))
    for epoch in range(args.epochs):
        rng.shuffle(order)
        tot = train_epoch(net, opt, data, order)
        if (epoch + 1) % 10 == 0 or epoch == args.epochs - 1:
            acc = np.mean([center_accuracy(net, d[0], d[1], d[2], d[5]) for d in data[:16]])
            print(f"epoch {epoch + 1}: loss {tot[0]:.4f} "
                  f"(bce {tot[1]:.4f} c {tot[2]:.5f} p {tot[3]:.5f}) "
                  f"center-recall@k {acc:.3f}", flush=True)

    save_checkpoint(args.out, generation=0, best_params=params_from_fullaggnet(net),
                    extra=dict(net_config=net_config))
    print(f"saved {args.out}")
    return net, tot


if __name__ == "__main__":
    main()
