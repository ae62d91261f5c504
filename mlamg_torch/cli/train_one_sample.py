"""GA training on a single problem (counterpart of
``mlamg_tpu/cli/train_one_sample.py``).

    python -m mlamg_torch.cli.train_one_sample --problem 2d --n 10 \\
        --max-generations 20 [--device cuda|cpu]

Writes ``one_sample.ckpt`` (best weights and the whole GA state) into
``--checkpoint-dir`` after every generation.
"""

from __future__ import annotations

import argparse
import os

from mlamg_torch.data.grid import Grid
from mlamg_torch.device import resolve_device
from mlamg_torch.ga import GAConfig, ParallelGA, flatten_params, fold_ids, init_population
from mlamg_torch.models.agg_interp import FullAggNet
from mlamg_torch.models.gnn import init_flax_
from mlamg_torch.train import (
    GridBundle, SolveOptions, lloyd_reference_conv, make_population_fitness,
)
from mlamg_torch.utils import prng
from mlamg_torch.utils.checkpoint import save_checkpoint


def build_problem(args) -> Grid:
    if args.problem == "1d":
        return Grid.structured_1d_poisson_dirichlet(args.n)
    if args.problem == "2d":
        return Grid.structured_2d_poisson_dirichlet(args.n, args.n)
    if args.problem == "2d-aniso":
        return Grid.structured_2d_poisson_dirichlet(args.n, args.n, args.epsilon, args.theta)
    if args.problem == "file":
        return Grid.load(args.file)
    raise ValueError(args.problem)


def main(argv=None):
    p = argparse.ArgumentParser(description="GA training on one problem")
    p.add_argument("--problem", default="2d", choices=["1d", "2d", "2d-aniso", "file"])
    p.add_argument("--n", type=int, default=12)
    p.add_argument("--epsilon", type=float, default=1.0)
    p.add_argument("--theta", type=float, default=0.0)
    p.add_argument("--file", type=str, default=None)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--max-generations", type=int, default=100)
    p.add_argument("--population-size", type=int, default=16)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--res-tol", type=float, default=1e-6)
    p.add_argument("--checkpoint-dir", type=str, default="models_chkpt")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    g = build_problem(args)
    opts = SolveOptions(res_tol=args.res_tol)
    bundle = GridBundle.from_grid(g, args.alpha, device=dev)
    bundle.ref_conv = max(lloyd_reference_conv(bundle, "abs", opts), 1e-6)
    print(f"n={g.n} k={bundle.k} lloyd benchmark conv={bundle.ref_conv:.4f}")

    net = init_flax_(FullAggNet(dim=args.dim, num_conv=2, iterations=2), prng.PRNGKey(0)).to(dev)
    vec, unravel = flatten_params(net)
    fids, _ = fold_ids(net)
    fitness = make_population_fitness(net, [bundle], opts)
    pop0 = init_population(prng.PRNGKey(1), vec, args.population_size, perturb=0.5)
    ga = ParallelGA(
        pop0, fitness,
        GAConfig(mutation_probability=1.0, mutation_min_perturb=-0.5,
                 mutation_max_perturb=0.5, steady_state_top_use=0.5,
                 steady_state_bottom_discard=0.5),
        fold_ids=fids,
    )
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    for _ in range(args.max_generations):
        ga.iteration()
        best, fit, _ = ga.best_solution()
        print(f"gen {ga.num_generation}: train conv ratio {1.0 / fit:.4f} "
              f"(abs conv ~{bundle.ref_conv / fit:.4f})", flush=True)
        save_checkpoint(
            os.path.join(args.checkpoint_dir, "one_sample.ckpt"),
            generation=ga.num_generation, best_params=unravel(best),
            population=ga.population, fitness=ga.fitness, key=ga.key,
        )
    return ga


if __name__ == "__main__":
    main()
