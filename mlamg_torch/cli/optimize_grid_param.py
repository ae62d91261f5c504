"""GA directly over the aggregate assignment (counterpart of
``mlamg_tpu/cli/optimize_grid_param.py``): the chromosome is the per-node
aggregate id; mutation moves random nodes to a graph-adjacent node's
aggregate; no network in the loop.  The population starts from Lloyd
aggregations with keys ``PRNGKey(0..P-1)`` and the fitness is 1 / conv of
the Jacobi-SA two-level cycle, one individual after the other.

    python -m mlamg_torch.cli.optimize_grid_param --n 10 --alpha 0.15 --generations 30 [--device cpu]

The population stays a numpy array throughout; the JAX CLI's mutation
stores a JAX array in its place, on which the GA's elitism then fails at
the first generation.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mlamg_torch.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--alpha", type=float, default=0.15)
    p.add_argument("--generations", type=int, default=30)
    p.add_argument("--population", type=int, default=16)
    p.add_argument("--epsilon", type=float, default=1.0)
    p.add_argument("--theta", type=float, default=0.0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


def main(argv=None, log=print) -> dict:
    """Run the GA; returns the Lloyd seeds' convs (``seed_convs``), the
    best conv after each generation (``convs``, generation 0 first), the
    seconds of each generation and the improvement over Lloyd."""
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.ga import GAConfig, ParallelGA
    from mlamg_torch.graph.lloyd import lloyd_aggregation
    from mlamg_torch.graph.strength import strength_measure
    from mlamg_torch.mg.interp import sa_interpolation_dense
    from mlamg_torch.train import GridBundle, SolveOptions, measured_conv
    from mlamg_torch.utils import prng

    args = parse_args(argv)
    dev = resolve_device(args.device)
    g = Grid.structured_2d_poisson_dirichlet(args.n, args.n, args.epsilon, args.theta)
    bundle = GridBundle.from_grid(g, args.alpha, device=dev)
    A, k, n = bundle.A, bundle.k, g.n
    opts = SolveOptions(max_iter=80)
    A_sp = g.A.tocsr()

    # seed population from Lloyd with different keys (float32, as the JAX
    # CLI's population is)
    C = strength_measure(A, "abs")
    seeds = [lloyd_aggregation(C, ratio=args.alpha, key=prng.PRNGKey(i))[0].cpu().numpy()
             for i in range(args.population)]
    pop0 = np.stack(seeds).astype(np.float32)

    def conv_of(assign: np.ndarray) -> float:
        agg = torch.from_numpy(assign.astype(np.int64)).to(dev)
        return measured_conv(A, sa_interpolation_dense(A, agg, k), bundle.x0, opts)

    evaluated: list = []

    def fitness(pop, gen):
        convs = np.asarray([conv_of(a) for a in pop], np.float32)
        evaluated.append(convs)
        return 1.0 / np.maximum(convs, np.float32(1e-3))

    rng = np.random.RandomState(0)

    class AssignmentGA(ParallelGA):
        """Graph-aware mutation on integer assignment chromosomes
        (reference optimize_grid_param.py:166-240)."""

        def _mutation(self):
            new = np.where(~self.computed)[0]
            if len(new) == 0:
                return
            pop = self.population
            for i in new:
                assign = pop[i].astype(np.int64)
                for _ in range(rng.randint(1, max(2, n // 10))):
                    v = rng.randint(n)
                    nbrs = A_sp.indices[A_sp.indptr[v]:A_sp.indptr[v + 1]]
                    nbrs = nbrs[nbrs != v]
                    if len(nbrs):
                        assign[v] = assign[rng.choice(nbrs)]
                pop[i] = assign
            self.computed[new] = False

    ga = AssignmentGA(pop0, fitness,
                      GAConfig(crossover_probability=0.0, mutation_probability=1.0,
                               steady_state_top_use=0.5, steady_state_bottom_discard=0.5))
    t0 = time.perf_counter()
    lloyd_conv = 1.0 / ga.best_solution()[1]
    seconds = [time.perf_counter() - t0]
    convs = [lloyd_conv]
    log(f"best Lloyd seed conv: {lloyd_conv:.4f}")
    for _ in range(args.generations):
        t0 = time.perf_counter()
        ga.iteration()
        _, fit, _ = ga.best_solution()
        seconds.append(time.perf_counter() - t0)
        convs.append(1.0 / fit)
        log(f"gen {ga.num_generation}: conv {1.0 / fit:.4f}")
    log(f"improvement over Lloyd: {lloyd_conv - convs[-1]:.4f}")
    return {"seed_convs": evaluated[0], "seed_population": pop0, "convs": convs,
            "seconds_per_generation": seconds, "improvement": lloyd_conv - convs[-1],
            "best": ga.best_solution()[0]}


if __name__ == "__main__":
    main()
