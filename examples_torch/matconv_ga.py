"""Minimal A-polynomial graph net trained by GA (counterpart of
``examples/matconv_ga.py``): a tiny TAGConv scores aggregate centers; the
GA optimizes its flattened weights against the measured conv factor.

    python examples_torch/matconv_ga.py [--device cpu] [--dtype float64]

The grid, the network's weights (flax's ``init(PRNGKey(0))``, through
``init_flax_``) and the solves are float32, as in the JAX script, whose
fitness ``jit(vmap(...))``s over the population; here each individual's
weights are written into the network in turn.  ``--dtype`` (JAX's default
float type) is the type of the unit-weight Bellman-Ford graph.
"""

import argparse

import numpy as np
import torch
from torch import nn

from mlamg_torch import resolve_device
from mlamg_torch.data import Grid
from mlamg_torch.ga import GAConfig, ParallelGA, flatten_params, fold_ids, init_population
from mlamg_torch.ga.codec import assign_flat
from mlamg_torch.graph.bellman_ford import bellman_ford, nearest_center_to_agg
from mlamg_torch.graph.topk import topk_indices
from mlamg_torch.mg import sa_interpolation_dense
from mlamg_torch.models import TAGConv, graph_from_matrix_basic
from mlamg_torch.models.gnn import init_flax_
from mlamg_torch.train import GridBundle, SolveOptions, measured_conv
from mlamg_torch.utils import prng


class MatConvNet(nn.Module):
    def __init__(self, in_dim: int = 1, dim: int = 4, K: int = 3):
        super().__init__()
        self.TAGConv_0 = TAGConv(in_dim, dim, K=K)
        self.TAGConv_1 = TAGConv(dim, 1, K=K)

    def forward(self, g):
        ew = g.edge_attr[:, 0]
        x = torch.relu(self.TAGConv_0(g, g.x, ew))
        x = self.TAGConv_1(g, x, ew)
        return x[:, 0]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                   help="the default float type (float64: JAX_ENABLE_X64)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device, dtype = resolve_device(args.device), getattr(torch, args.dtype)

    g = Grid.structured_2d_poisson_dirichlet(9, 9)
    bundle = GridBundle.from_grid(g, alpha=0.15, device=device)
    A, k, n = bundle.A, bundle.k, g.n
    opts = SolveOptions(max_iter=60)
    gd = graph_from_matrix_basic(A)
    unit = A.with_data(A.mask.to(dtype))

    net = init_flax_(MatConvNet(), prng.PRNGKey(0)).to(device)
    vec, _ = flatten_params(net)
    ids, _ = fold_ids(net)

    @torch.no_grad()
    def conv_of(v):
        assign_flat(net, torch.as_tensor(v))
        scores = net(gd)
        centers = topk_indices(scores, k)
        _, nearest = bellman_ford(unit, centers)
        agg_id = nearest_center_to_agg(centers, nearest)
        P = sa_interpolation_dense(A, agg_id, k)
        return measured_conv(A, P, bundle.x0, opts)

    def fitness(pop, gen):
        convs = np.array([conv_of(v) for v in pop], np.float32)
        return np.float32(1.0) / np.maximum(convs, np.float32(1e-3))

    pop0 = init_population(prng.PRNGKey(1), vec, 16, perturb=0.5)
    ga = ParallelGA(pop0, fitness,
                    GAConfig(mutation_probability=0.8,
                             mutation_min_perturb=-0.3, mutation_max_perturb=0.3,
                             steady_state_top_use=0.5, steady_state_bottom_discard=0.5),
                    fold_ids=ids)
    for _ in range(15):
        ga.iteration()
        _, fit, _ = ga.best_solution()
        print(f"gen {ga.num_generation}: conv {1.0 / fit:.4f}")


if __name__ == "__main__":
    main()
