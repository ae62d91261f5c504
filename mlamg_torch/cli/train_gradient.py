"""Gradient (Adam) training of FullAggNet through the soft pipeline
(counterpart of ``mlamg_tpu/cli/train_gradient.py``).

Each step takes the gradient of the bucket-weighted mean of conv / ref
(:func:`~mlamg_torch.models.soft_pipeline.soft_conv_loss` over the
training grids, padded to shape buckets as the JAX package pads them, with
fixed test vectors per bucket), optionally at weights perturbed by
Gaussian noise, and one Adam step on the flat weight vector.  Every
``--eval-every`` steps the discrete pipeline (the measured two-level conv)
is evaluated on train and test; the best-by-discrete-train weights are
checkpointed in the JAX package's format.

    python -m mlamg_torch.cli.train_gradient data_out/2d_iso --steps 600 \\
        --bucket-step 128 --eval-every 20 --checkpoint-every 40 \\
        --rel-strength true --weight-noise 0.01 --tau-final 0.015 \\
        --start-model runs/pretrain.ckpt --out runs/grad [--device cuda|cpu]

The JAX package runs a bucket as one jitted, vmapped program; here a
bucket is a loop over its grids, each grid's loss backpropagated on its
own.  ``--grid-chunk c`` splits every bucket into chunks of c grids that
then act as buckets, each with its own test vectors, noise draw and
weight, as in the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from mlamg_torch.cli.common import (
    compute_reference_convs, dataset_bf_width, load_dataset_grids, parse_bool_str,
)
from mlamg_torch.cli.optim import Adam, cosine_decay_schedule
from mlamg_torch.convert import fullaggnet_from_params
from mlamg_torch.device import resolve_device
from mlamg_torch.ga.codec import assign_flat, flat_grad, flatten_params
from mlamg_torch.models.agg_interp import FullAggNet
from mlamg_torch.models.gnn import init_flax_
from mlamg_torch.models.loss import numpy_dtype
from mlamg_torch.models.soft_pipeline import SoftConfig, soft_conv_loss
from mlamg_torch.train import SolveOptions, make_buckets, make_population_fitness_bucketed
from mlamg_torch.utils import prng
from mlamg_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from mlamg_torch.utils.metrics import MetricsWriter

NOISE_KEY_SEED = (31, 17)  # noise key = PRNGKey(seed * 31 + 17)
TEST_VECTOR_SALT = 9973  # bucket b's test vectors: PRNGKey(seed * 9973 + b)


def bucket_vecs(b, seed: int, salt: int, num: int, dtype=torch.float32) -> torch.Tensor:
    """(B, n_pad, num) test vectors of a bucket: ``normal(PRNGKey(seed *
    9973 + salt))`` at the bucket's shape, zero on padding rows, each
    column unit norm."""
    B, n_pad = b.x0.shape
    tv = torch.from_numpy(prng.normal(prng.PRNGKey(seed * TEST_VECTOR_SALT + salt),
                                      (B, n_pad, num), numpy_dtype(dtype))).to(b.x0.device)
    real = torch.arange(n_pad, device=tv.device)[None, :] < torch.tensor(
        b.n_real, device=tv.device)[:, None]
    tv = torch.where(real[:, :, None], tv, torch.zeros_like(tv))
    return tv / torch.linalg.vector_norm(tv, dim=1, keepdim=True).clamp(min=1e-30)


def split_bucket(b, chunk: int) -> list:
    """A bucket as consecutive chunks of ``chunk`` grids (the last one
    shorter), each a BucketStack of its own."""
    return [dataclasses.replace(b, As=b.As[s:s + chunk], x0=b.x0[s:s + chunk],
                                n_real=b.n_real[s:s + chunk], k_real=b.k_real[s:s + chunk],
                                colors=b.colors[s:s + chunk], idx=b.idx[s:s + chunk])
            for s in range(0, len(b.idx), chunk)]


def tau_at(step: int, steps: int, tau_assign: float, tau_final: float | None) -> float:
    """The assignment temperature at ``step``: exponential from
    ``tau_assign`` to ``tau_final`` over the run (constant without it)."""
    if tau_final is None:
        return tau_assign
    f = step / max(steps - 1, 1)
    return float(tau_assign * (tau_final / tau_assign) ** f)


def bucket_loss_and_grad(net, b, tvs: torch.Tensor, refs, cfg):
    """(mean over the bucket of conv / ref as a 0-d tensor, its gradient as
    a flat vector), each grid backpropagated on its own."""
    net.zero_grad(set_to_none=True)
    total = 0.0
    B = len(b.As)
    for j, A in enumerate(b.As):
        conv, _ = soft_conv_loss(net, A, b.k, tvs[j], cfg, pad=b.pad(j), colors=b.colors[j],
                                 num_colors=b.num_colors)
        loss = conv / refs[j] / B
        loss.backward()
        total = total + loss.detach()
    return total, flat_grad(net)


def soft_step(net, vec: torch.Tensor, buckets, tvs, refs, weights, cfg, wn_scale: float = 0.0,
              noise_key=None, step: int = 0):
    """(bucket-weighted soft loss, its gradient) at ``vec``.  With
    ``wn_scale`` bucket bi is evaluated at ``vec + wn_scale *
    normal(fold_in(noise_key, step * 131 + bi), (W,))``.  Leaves the
    evaluated weights in ``net``."""
    loss_tot, g_tot = 0.0, None
    for bi, b in enumerate(buckets):
        v = vec
        if wn_scale:
            key = prng.fold_in(noise_key, step * 131 + bi)
            noise = torch.from_numpy(prng.normal(key, tuple(vec.shape), numpy_dtype(vec.dtype)))
            v = vec + wn_scale * noise.to(vec.device)
        assign_flat(net, v)
        loss, g = bucket_loss_and_grad(net, b, tvs[bi], refs[bi], cfg)
        w = float(weights[bi])
        loss_tot += w * float(loss)
        g_tot = g * w if g_tot is None else g_tot + g * w
    return loss_tot, g_tot


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Differentiable (Adam) training of FullAggNet")
    p.add_argument("system", type=str)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--num-conv", type=int, default=2)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--rel-strength", default=False, type=parse_bool_str,
                   help="row-normalized strength edge feature")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--lr-decay", type=float, default=0.3,
                   help="final lr = lr * lr_decay (cosine schedule)")
    p.add_argument("--bucket-step", type=int, default=512)
    p.add_argument("--grid-chunk", type=int, default=None,
                   help="split every bucket into chunks of this many grids, each with "
                        "its own test vectors, weight noise and weight")
    p.add_argument("--bf-iters", type=int, default=24)
    p.add_argument("--tau-assign", type=float, default=0.08)
    p.add_argument("--tau-final", type=float, default=None,
                   help="anneal the assignment temperature to this value "
                        "(exponential in step; default: no annealing)")
    p.add_argument("--topk-sigma", type=float, default=0.5)
    p.add_argument("--weight-noise", type=float, default=0.0,
                   help="relative Gaussian weight noise per step (e.g. 0.01)")
    p.add_argument("--ridge", type=float, default=1e-4)
    p.add_argument("--test-vectors", type=int, default=16)
    p.add_argument("--num-loops", type=int, default=5)
    p.add_argument("--eval-every", type=int, default=25)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--max-iter", type=int, default=75)
    p.add_argument("--smoother", default="multicolor_gs")
    p.add_argument("--strength-measure", default="olson")
    p.add_argument("--start-model", type=str, default=None)
    p.add_argument("--out", type=str, default="runs_grad")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


@dataclasses.dataclass
class GradientRun:
    """The state of a run: the module, its flat weight vector (stepped in
    place), the buckets with their test vectors and reference convs, the
    optimiser and the discrete fitness of both splits."""

    args: argparse.Namespace
    net: object
    vec: torch.Tensor
    unravel: object
    net_config: dict
    buckets: list
    tvs: list
    refs: list
    weights: np.ndarray
    cfg: object
    opt: object
    wn_scale: float
    noise_key: np.ndarray
    train_fit: object
    test_fit: object
    train_ref: np.ndarray
    test_ref: np.ndarray

    def grad(self, it: int):
        """(soft loss, gradient) of step ``it`` (0-based) at the current
        weights, at the step's temperature and weight noise."""
        a = self.args
        tau = tau_at(it, a.steps, a.tau_assign, a.tau_final)
        return soft_step(self.net, self.vec, self.buckets, self.tvs, self.refs, self.weights,
                         dataclasses.replace(self.cfg, tau_assign=tau), self.wn_scale,
                         self.noise_key, it)

    def step(self, it: int):
        """Step ``it``: :meth:`grad`, then the Adam update of ``vec``."""
        loss, g = self.grad(it)
        self.opt.step([g])
        return loss, g

    def discrete_losses(self, vec: torch.Tensor | None = None):
        """(train, test) mean conv / ref of the discrete pipeline."""
        v = self.vec if vec is None else vec
        return (1.0 / float(self.train_fit(v[None, :])[0]),
                1.0 / float(self.test_fit(v[None, :])[0]))


def prepare(args: argparse.Namespace, log=print, dtype=torch.float32) -> GradientRun:
    """Load the data into buckets, measure (or read) the reference convs,
    build the module (from ``--start-model``, whose net_config sets
    ``bf_width`` and ``rel_strength``, or as flax's ``init(PRNGKey(seed))`` draws it),
    the test vectors, the optimiser and the fitness functions, in ``dtype``
    (the CLI's float32; float64 for comparisons across devices)."""
    dev = resolve_device(args.device)
    opts = SolveOptions(max_iter=args.max_iter, smoother=args.smoother)
    train_grids, test_grids = load_dataset_grids(args.system)
    if args.limit:
        train_grids = train_grids[: args.limit]
        test_grids = test_grids[: max(1, args.limit // 4)]
    train, train_buckets = make_buckets(train_grids, args.alpha, dtype, step=args.bucket_step,
                                        device=dev)
    test, test_buckets = make_buckets(test_grids, args.alpha, dtype, step=args.bucket_step,
                                      device=dev)
    log(f"loaded {len(train)} train / {len(test)} test grids "
        f"({len(train_buckets)} train buckets)")

    def cache(sub):
        d = os.path.join(args.system, sub)
        return os.path.join(d, f".ref_convs_{args.strength_measure}.json") if os.path.isdir(d) else None

    def written(sub):
        return os.path.join(args.out, f".ref_convs_{sub}_{args.strength_measure}.json")

    tr_ref = compute_reference_convs(train, args.strength_measure, opts, grids=train_grids,
                                     cache_path=cache("train"), write_path=written("train"))
    te_ref = compute_reference_convs(test, args.strength_measure, opts, grids=test_grids,
                                     cache_path=cache("test"), write_path=written("test"))
    log(f"train Lloyd benchmark conv: {tr_ref.mean():.4f}")
    log(f"test Lloyd benchmark conv: {te_ref.mean():.4f}")
    if args.grid_chunk:
        train_buckets = [c for b in train_buckets for c in split_bucket(b, args.grid_chunk)]

    bf_width = dataset_bf_width(train_grids)
    start_ck = load_checkpoint(args.start_model) if args.start_model else None
    if start_ck:
        nc0 = (start_ck.get("extra") or {}).get("net_config") or {}
        bf_width = max(bf_width, int(nc0.get("bf_width", 0)))
        args.rel_strength = bool(nc0.get("rel_strength", args.rel_strength))
    # the checkpoint carries the Bellman-Ford width, so an evaluator builds
    # the trained architecture rather than a width derived from its split
    net_config = dict(dim=args.dim, num_conv=args.num_conv, iterations=args.iterations,
                      bf_width=bf_width, rel_strength=args.rel_strength)
    if start_ck:
        net = fullaggnet_from_params(start_ck["best_params"], net_config, device=dev, dtype=dtype)
    else:
        net = init_flax_(FullAggNet(**net_config), prng.PRNGKey(args.seed))
        net.to(device=dev, dtype=dtype)
    vec, unravel = flatten_params(net)
    log(f"{vec.shape[0]} weights")

    cfg = SoftConfig(bf_iters=args.bf_iters, tau_assign=args.tau_assign,
                     topk_sigma=args.topk_sigma, num_loops=args.num_loops,
                     test_vectors=args.test_vectors, ridge=args.ridge)
    weights = np.asarray([len(b.idx) for b in train_buckets], np.float32)
    wn_scale = (float(torch.sqrt(torch.mean(vec ** 2))) * args.weight_noise
                if args.weight_noise else 0.0)
    return GradientRun(
        args=args, net=net, vec=vec, unravel=unravel, net_config=net_config,
        buckets=train_buckets,
        tvs=[bucket_vecs(b, args.seed, s, cfg.test_vectors, dtype)
             for s, b in enumerate(train_buckets)],
        refs=[[train[i].ref_conv for i in b.idx] for b in train_buckets],
        weights=weights / weights.sum(), cfg=cfg,
        opt=Adam([vec], cosine_decay_schedule(args.lr, args.steps, alpha=args.lr_decay),
                 clip=100.0),
        wn_scale=wn_scale,
        noise_key=prng.PRNGKey(args.seed * NOISE_KEY_SEED[0] + NOISE_KEY_SEED[1]),
        train_fit=make_population_fitness_bucketed(net, train, train_buckets, opts),
        test_fit=make_population_fitness_bucketed(net, test, test_buckets, opts),
        train_ref=tr_ref, test_ref=te_ref,
    )


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    run = prepare(args, log=lambda line: print(line, flush=True))

    os.makedirs(args.out, exist_ok=True)
    writer = MetricsWriter(os.path.join(args.out, "runs"))
    best = (np.inf, None)  # (discrete train loss, vec)
    t0 = time.time()
    for it in range(args.steps):
        loss_tot, _ = run.step(it)
        if (it + 1) % args.eval_every == 0 or it == args.steps - 1:
            tau = tau_at(it, args.steps, args.tau_assign, args.tau_final)
            tr, te = run.discrete_losses()
            if tr < best[0]:
                best = (tr, run.vec.clone())
            print(f"step {it + 1}: soft {loss_tot:.4f} "
                  f"discrete train {tr:.4f} test {te:.4f} "
                  f"(best {best[0]:.4f}, tau {tau:.3f}, "
                  f"{(time.time() - t0) / (it + 1):.2f}s/step)", flush=True)
            writer.add_scalars("Loss/Train", {"ML-soft": loss_tot, "ML-discrete": tr,
                                              "Lloyd": 1.0}, it + 1)
            writer.add_scalars("Loss/Test", {"ML-discrete": te, "Lloyd": 1.0}, it + 1)
        if (it + 1) % args.checkpoint_every == 0 or it == args.steps - 1:
            bvec = best[1] if best[1] is not None else run.vec
            save_checkpoint(os.path.join(args.out, "grad_best.ckpt"), generation=it + 1,
                            best_params=run.unravel(bvec),
                            extra=dict(net_config=run.net_config))

    tr, te = run.discrete_losses(best[1] if best[1] is not None else run.vec)
    summary = dict(
        steps=args.steps,
        best_discrete_train=float(best[0]),
        final_discrete_train=float(tr),
        final_discrete_test=float(te),
        train_lloyd_conv=float(run.train_ref.mean()),
        test_lloyd_conv=float(run.test_ref.mean()),
    )
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    writer.close()
    return summary


if __name__ == "__main__":
    main()
