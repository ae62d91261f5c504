"""GA training of FullAggNet on a .grid dataset (counterpart of
``mlamg_tpu/cli/train_dataset.py``).

    python -m mlamg_torch.cli.train_dataset data_out/2d_iso --max-generations 50 \\
        --population-size 16 --bucket-step 128 [--device cuda|cpu]

A :class:`~mlamg_torch.ga.ParallelGA` evolves flat weight vectors; an
individual's fitness is 1 / mean over the training grids of its two-level
conv over the Lloyd reference conv.  The JAX package evaluates the whole
population on a shape bucket as one vmapped program; here the population
and the grids are loops (:func:`mlamg_torch.train.make_population_fitness_bucketed`,
or unpadded with ``--bucketed false``); ``--mesh-pop N`` splits the
population over N pop shards of the run's device.  The reference convs come from the
``.ref_convs_<measure>.json`` cache beside each split where it holds them;
the ones measured here are written beside the checkpoints.  The report
lines, metrics and checkpoints are the JAX CLI's; either package resumes
the other's checkpoint (``--resume``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import time

import numpy as np
import torch

from mlamg_torch.cli.common import (
    add_training_args, compute_reference_convs, dataset_bf_width, load_dataset_grids,
)
from mlamg_torch.convert import fullaggnet_from_params
from mlamg_torch.device import resolve_device
from mlamg_torch.ga import GAConfig, ParallelGA, flatten_params, fold_ids, init_population
from mlamg_torch.models.agg_interp import FullAggNet
from mlamg_torch.models.gnn import init_flax_
from mlamg_torch.parallel import make_mesh
from mlamg_torch.train import (
    GridBundle, SolveOptions, make_buckets, make_population_fitness,
    make_population_fitness_bucketed,
)
from mlamg_torch.utils import prng
from mlamg_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from mlamg_torch.utils.metrics import MetricsWriter
from mlamg_torch.utils.profiler import Profiler

def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="GA training of FullAggNet on a .grid dataset",
        epilog="The JAX CLI's --platform is --device here; its --compile-cache "
               "(XLA's compilation cache) has no counterpart.")
    add_training_args(parser)
    return parser.parse_args(argv)


@dataclasses.dataclass
class GARun:
    """A GA run: the GA, the module its fitness writes weights into, the
    flat codec, the fold names, the solve options, the data and the
    fitness functions."""

    args: argparse.Namespace
    ga: ParallelGA
    net: object
    unravel: object
    net_config: dict
    fold_names: list
    opts: SolveOptions
    train: list
    train_buckets: list | None
    test_buckets: list | None
    fitness: object
    test_fitness: object | None
    writer: MetricsWriter


def prepare(args: argparse.Namespace, log=print) -> GARun:
    """Load the data (padded to buckets unless ``--bucketed false``), read
    or measure the reference convs, build the module (from
    ``--start-model``, whose net_config sets ``bf_width`` and
    ``rel_strength``, else as flax's ``init(PRNGKey(0))`` draws it), the
    folds, the fitness functions and the GA (population from
    ``init_population(PRNGKey(1), ...)``, or ``--resume``'s).  The
    population is float32, the JAX model's parameter type, also with
    ``--float64``, where the module and the solves run in float64."""
    dev = resolve_device(args.device)
    dtype = torch.float64 if args.float64 else torch.float32
    Profiler.enabled = True

    opts = SolveOptions(res_tol=args.res_tol, max_iter=args.max_iter,
                        pre_smooth=args.pre_smooth, post_smooth=args.post_smooth,
                        smoother=args.smoother, use_error_norm=args.error_norm)
    train_grids, test_grids = load_dataset_grids(args.system)
    train_buckets = test_buckets = None
    if args.bucketed:
        train, train_buckets = make_buckets(train_grids, args.alpha, dtype,
                                            step=args.bucket_step, device=dev)
        test, test_buckets = make_buckets(test_grids, args.alpha, dtype,
                                          step=args.bucket_step, device=dev)
    else:
        train = [GridBundle.from_grid(g, args.alpha, dtype, device=dev) for g in train_grids]
        test = [GridBundle.from_grid(g, args.alpha, dtype, device=dev) for g in test_grids]
    log(f"loaded {len(train)} train / {len(test)} test grids")

    if args.evaluate_bench_loss:
        with Profiler("lloyd benchmark"):
            def cache(sub):
                d = os.path.join(args.system, sub)
                return (os.path.join(d, f".ref_convs_{args.strength_measure}.json")
                        if os.path.isdir(d) else None)

            def written(sub):
                return os.path.join(args.checkpoint_dir,
                                    f".ref_convs_{sub}_{args.strength_measure}.json")

            tb = compute_reference_convs(train, args.strength_measure, opts, grids=train_grids,
                                         cache_path=cache("train"), write_path=written("train"))
            log(f"train Lloyd benchmark conv: {tb.mean():.4f}")
            if args.compute_test_loss:
                teb = compute_reference_convs(test, args.strength_measure, opts,
                                              grids=test_grids, cache_path=cache("test"),
                                              write_path=written("test"))
                log(f"test Lloyd benchmark conv: {teb.mean():.4f}")
    if args.benchmark_only:
        log("benchmark-only: reference convs written, exiting")
        return None

    bf_width = dataset_bf_width(train_grids)
    start_ck = load_checkpoint(args.start_model) if args.start_model else None
    if start_ck:
        nc0 = (start_ck.get("extra") or {}).get("net_config") or {}
        bf_width = max(bf_width, int(nc0.get("bf_width", 0)))
        args.rel_strength = bool(nc0.get("rel_strength", args.rel_strength))
    net_config = dict(dim=args.dim, num_conv=args.num_conv, iterations=args.iterations,
                      bf_width=bf_width, rel_strength=args.rel_strength)
    if start_ck:
        net = fullaggnet_from_params(start_ck["best_params"], net_config, device=dev,
                                     dtype=dtype)
    else:
        net = init_flax_(FullAggNet(**net_config), prng.PRNGKey(0)).to(device=dev, dtype=dtype)
    vec, unravel = flatten_params(net)
    vec = vec.to(torch.float32)
    fids, fold_names = fold_ids(net, fold_depth=args.fold_depth)
    log(f"{vec.shape[0]} weights in {len(fold_names)} folds")

    mesh = None
    if args.mesh_pop:  # N pop shards on the run's device
        mesh = make_mesh(pop=args.mesh_pop, row=1, devices=[dev] * args.mesh_pop)
    if args.bucketed:
        fitness = make_population_fitness_bucketed(
            net, train, train_buckets, opts, loss_relative=args.loss_relative_measure,
            fitness_metric=args.fitness_metric, mesh=mesh)
    else:
        fitness = make_population_fitness(
            net, train, opts, loss_relative=args.loss_relative_measure,
            batch_size=args.batch_size if args.batched else None, mesh=mesh)

    pop0 = init_population(prng.PRNGKey(1), vec, args.population_size,
                           perturb=args.init_perturb)
    cfg = GAConfig(
        crossover_probability=args.crossover_prob,
        mutation_probability=args.mutation_prob,
        mutation_min_perturb=-args.mutation_perturb,
        mutation_max_perturb=args.mutation_perturb,
        steady_state_top_use=0.5,
        steady_state_bottom_discard=0.5,
        selection="greedy" if args.greedy else "steady_state",
        adaptive_sigma=args.adaptive_sigma,
        mutation_sparsity=args.mutation_sparsity,
    )
    ga = ParallelGA(pop0, fitness, cfg, fold_ids=fids)
    if args.mutate_subnets:
        pats = [re.compile(p) for p in args.mutate_subnets.split(",")]
        scope = np.zeros(vec.shape[0], bool)
        for fi, name in enumerate(fold_names):
            if any(p.search(name) for p in pats):
                scope |= fids == fi
        cfg.mutation_scope = scope
        log(f"mutation scope: {int(scope.sum())}/{len(scope)} weights ({args.mutate_subnets})")
    ga.num_generation = args.start_generation
    if args.resume:
        ck = load_checkpoint(args.resume)
        ga.population = np.asarray(ck["population"]).copy()
        ga.fitness = np.asarray(ck["fitness"]).copy()
        ga.computed[:] = True
        ga.key = ga._coerce_key(np.asarray(ck["key"]))
        ga.num_generation = ck["generation"]
        if "sigma" in ck:
            ga.sigma = float(ck["sigma"])
        log(f"resumed full GA state at generation {ga.num_generation}")

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    if not args.compute_test_loss:
        test_fitness = None
    elif args.bucketed:
        test_fitness = make_population_fitness_bucketed(
            net, test, test_buckets, opts, loss_relative=args.loss_relative_measure,
            fitness_metric=args.fitness_metric)
    else:
        test_fitness = make_population_fitness(net, test, opts,
                                               loss_relative=args.loss_relative_measure)
    return GARun(args=args, ga=ga, net=net, unravel=unravel, net_config=net_config,
                 fold_names=fold_names, opts=opts, train=train,
                 train_buckets=train_buckets, test_buckets=test_buckets, fitness=fitness,
                 test_fitness=test_fitness, writer=MetricsWriter(args.metrics_dir))


def report(run: GARun, final: bool = False, log=print) -> dict:
    """The JAX CLI's report of the current generation: its line (train
    loss 1 / best fitness, the test loss every ``--test-loss-every``
    generations and at the end, the offspring diagnostics), the metrics,
    and a checkpoint every ``--checkpoint-every`` generations and at the
    end.  Returns what it reported."""
    args, ga, writer = run.args, run.ga, run.writer
    best, fit, _ = ga.best_solution()
    gen = ga.num_generation
    train_loss = 1.0 / fit
    do_test = run.test_fitness is not None and (final or gen % args.test_loss_every == 0)
    do_ckpt = final or gen % args.checkpoint_every == 0
    st = ga.last_stats
    diag = (f"  [sigma {st['sigma']:.4g} accept {st['accept_rate']:.2f} "
            f"off {st['offspring_mean']:.4f}+-{st['offspring_std']:.4f} "
            f"best {st['offspring_best']:.4f}]" if st else "")
    out = {"generation": gen, "train_loss": train_loss}
    if do_test:
        t_fit = float(run.test_fitness(best[None, :], gen)[0])
        out["test_loss"] = test_loss = 1.0 / t_fit
        writer.add_scalars("Loss/Test", {"ML": test_loss, "Lloyd": 1.0}, gen)
        log(f"Generation = {gen}  Train Loss = {train_loss:.6f}  "
            f"Test Loss = {test_loss:.6f}{diag}")
    else:
        log(f"Generation = {gen}  Train Loss = {train_loss:.6f}{diag}")
    if st:
        writer.add_scalars("GA/Offspring", {k: float(v) for k, v in st.items()}, gen)
    writer.add_scalars("Loss/Train", {"ML": train_loss, "Lloyd": 1.0}, gen)
    writer.add_scalars("PopulationFitness",
                       {str(i): float(f) for i, f in enumerate(np.sort(np.asarray(ga.fitness)))},
                       gen)
    if do_ckpt:
        out["checkpoint"] = os.path.join(args.checkpoint_dir, f"model_{gen:03}.ckpt")
        save_checkpoint(out["checkpoint"], generation=gen, best_params=run.unravel(best),
                        population=ga.population, fitness=ga.fitness, key=ga.key,
                        sigma=ga.sigma, extra=dict(net_config=run.net_config))
    return out


def train(run: GARun, log=print) -> dict:
    """The JAX CLI's loop: report the start, then ``--max-generations``
    generations (``stochastic_iteration`` with ``--batched``), each
    reported, and the profiler's tree.  Returns the reports and the
    seconds of each generation."""
    args, ga = run.args, run.ga
    reports, seconds = [report(run, log=log)], []
    for i in range(args.max_generations):
        t0 = time.perf_counter()
        with Profiler("generation"):
            if args.batched:
                ga.stochastic_iteration()
            else:
                ga.iteration()
        seconds.append(time.perf_counter() - t0)
        reports.append(report(run, final=i == args.max_generations - 1, log=log))
    return {"reports": reports, "seconds_per_generation": seconds}


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    log = lambda line: print(line, flush=True)  # noqa: E731
    run = prepare(args, log=log)
    if run is None:
        return None
    out = train(run, log=log)
    Profiler.print_tree()
    run.writer.close()
    return out


if __name__ == "__main__":
    main()
