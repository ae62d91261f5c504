"""Aggregation by scored edge union (counterpart of
``examples/edge_removal_aggregation.py``): a GA optimizes per-edge scores;
aggregates form by union-find over the highest-scored edges; fitness is the
measured two-level convergence factor.

    python examples_torch/edge_removal_aggregation.py [--device cpu] [--dtype float64]

The grid and the solves are float32, as in the JAX script; ``--dtype``
(JAX's default float type) is the type of the population and its fitness.
"""

import argparse

import numpy as np
import torch

from mlamg_torch import resolve_device
from mlamg_torch.data import Grid
from mlamg_torch.ga import GAConfig, ParallelGA, init_population
from mlamg_torch.graph.disjoint_sets import DisjointSets
from mlamg_torch.mg import sa_interpolation_dense
from mlamg_torch.models.loss import numpy_dtype
from mlamg_torch.train import GridBundle, SolveOptions, measured_conv
from mlamg_torch.utils import prng


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                   help="the default float type (float64: JAX_ENABLE_X64)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device, dtype = resolve_device(args.device), numpy_dtype(getattr(torch, args.dtype))

    g = Grid.structured_2d_poisson_dirichlet(8, 8)
    A = g.A
    n = g.n
    bundle = GridBundle.from_grid(g, alpha=0.2, device=device)
    opts = SolveOptions(max_iter=60)

    coo = A.tocoo()
    upper = coo.row < coo.col
    edges = np.column_stack([coo.row[upper], coo.col[upper]])
    E = len(edges)
    target_aggs = bundle.k

    def aggregate_from_scores(scores):
        order = np.argsort(-scores)
        ds = DisjointSets(n)
        for e in order:
            if ds.num_sets <= target_aggs:
                break
            ds.union(int(edges[e, 0]), int(edges[e, 1]))
        labels = ds.labels()
        _, agg_id = np.unique(labels, return_inverse=True)
        return agg_id, ds.num_sets

    def fitness(pop, gen):
        out = np.zeros(pop.shape[0])
        for i, scores in enumerate(np.asarray(pop)):
            agg_id, k = aggregate_from_scores(scores)
            P = sa_interpolation_dense(bundle.A, torch.from_numpy(agg_id).to(device), k)
            conv = float(measured_conv(bundle.A, P, bundle.x0, opts))
            out[i] = 1.0 / max(conv, 1e-3)
        return out.astype(dtype)

    pop0 = init_population(prng.PRNGKey(0), np.zeros(E, dtype), 12, perturb=1.0)
    ga = ParallelGA(
        pop0, fitness,
        GAConfig(mutation_probability=0.3, mutation_min_perturb=-0.5,
                 mutation_max_perturb=0.5, steady_state_top_use=0.5,
                 steady_state_bottom_discard=0.5),
    )
    for gen in range(10):
        ga.iteration()
        best, fit, _ = ga.best_solution()
        print(f"gen {ga.num_generation}: best conv {1.0 / fit:.4f}")


if __name__ == "__main__":
    main()
