"""GA smoke tests (counterpart of ``examples/ga_smoke.py``): fit a
quadratic, then train a tiny MLP regression, both with the population GA.

    python examples_torch/ga_smoke.py [--device cpu] [--dtype float64]

The MLP's initial weights are flax's ``init(PRNGKey(0), X)`` of the JAX
script's module (``init_flax_``), float32 as flax keeps them; ``--dtype``
is the type of X, Y and the loss (JAX's default float type: float32, or
float64 under ``JAX_ENABLE_X64``).  The population's losses are computed
in one batch, as the JAX script's ``vmap`` does.
"""

import argparse

import numpy as np
import torch
from torch import nn

from mlamg_torch import resolve_device
from mlamg_torch.convert import param_leaves
from mlamg_torch.ga import GAConfig, ParallelGA, flatten_params, fold_ids, init_population
from mlamg_torch.models.gnn import Dense, init_flax_
from mlamg_torch.ops.segment import ordered_sum
from mlamg_torch.utils import prng


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                   help="the default float type (float64: JAX_ENABLE_X64)")
    return p.parse_args(argv)


def quadratic(device, dtype):
    target = torch.tensor([4.0, -2.0, 3.5], dtype=dtype, device=device)

    def fitness(pop, gen):
        d = torch.as_tensor(pop, device=device) - target
        return (1.0 / (ordered_sum(d ** 2, 1) + 1e-6)).cpu().numpy()

    vec = np.zeros(3, np.dtype(str(dtype).split(".")[-1]))
    pop0 = init_population(prng.PRNGKey(0), vec, 32, perturb=2.0)
    ga = ParallelGA(pop0, fitness,
                    GAConfig(mutation_probability=0.6,
                             mutation_min_perturb=-0.3, mutation_max_perturb=0.3,
                             steady_state_top_use=0.5, steady_state_bottom_discard=0.5))
    gen = 0
    while ga.best_solution()[1] < 10.0 and gen < 200:
        ga.iteration()
        gen += 1
    best, fit, _ = ga.best_solution()
    print(f"quadratic: fitness {fit:.2f} after {gen} generations, x = {best}")
    assert fit > 10.0


class M(nn.Module):
    """The JAX script's ``Dense(1)(tanh(Dense(8)(x)))``.  flax names the
    outer Dense first (Python builds it before its argument): ``Dense_0``
    is the output layer, ``Dense_1`` the hidden one."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(8, 1)
        self.Dense_1 = Dense(1, 8)

    def forward(self, x):
        return self.Dense_0(torch.tanh(self.Dense_1(x)))


def batched_apply(net, pop: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(P, N, 1) outputs of ``net`` with each row of ``pop`` (flat weights in
    :func:`flatten_params`' order) as its weights: the rows are cut into
    flax's leaves, promoted to X's type, and both Dense layers run for the
    whole population at once, their products added in input order."""
    weights, pos = {}, 0
    for path, p, is_kernel in param_leaves(net):
        shape = tuple(p.shape[::-1]) if is_kernel else tuple(p.shape)
        size = int(np.prod(shape))
        weights[path[1:]] = pop[:, pos:pos + size].reshape(-1, *shape).to(X.dtype)
        pos += size

    def dense(name, x):  # x (P, N, d_in), kernel (P, d_in, d_out)
        kernel, bias = weights[(name, "kernel")], weights[(name, "bias")]
        return ordered_sum(x[..., None] * kernel[:, None], 2) + bias[:, None]

    h = torch.tanh(dense("Dense_1", X.expand(pop.shape[0], *X.shape)))
    return dense("Dense_0", h)


def tiny_mlp(device, dtype):
    m = init_flax_(M(), prng.PRNGKey(0)).to(device)
    X = torch.linspace(-1, 1, 32, dtype=dtype)[:, None]  # the data, made on the host
    X, Y = X.to(device), torch.sin(3 * X).to(device)
    vec, _ = flatten_params(m)
    ids, _ = fold_ids(m)

    def fitness(pop, gen):
        out = batched_apply(m, torch.as_tensor(pop, device=device), X)
        loss = ordered_sum(((out - Y) ** 2)[..., 0], 1) / X.shape[0]
        return (1.0 / (loss + 1e-9)).cpu().numpy()

    pop0 = init_population(prng.PRNGKey(1), vec, 32, perturb=1.0)
    ga = ParallelGA(pop0, fitness,
                    GAConfig(mutation_probability=0.8,
                             mutation_min_perturb=-0.2, mutation_max_perturb=0.2,
                             steady_state_top_use=0.5, steady_state_bottom_discard=0.5),
                    fold_ids=ids)
    gen = 0
    while 1.0 / ga.best_solution()[1] > 1e-2 and gen < 300:
        ga.iteration()
        gen += 1
    print(f"mlp: loss {1.0 / ga.best_solution()[1]:.5f} after {gen} generations")


def main(argv=None):
    args = parse_args(argv)
    device, dtype = resolve_device(args.device), getattr(torch, args.dtype)
    quadratic(device, dtype)
    tiny_mlp(device, dtype)


if __name__ == "__main__":
    main()
