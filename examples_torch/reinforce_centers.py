"""REINFORCE over aggregate-center picks (counterpart of
``examples/reinforce_centers.py``): node logits parameterize center picks
(Gumbel top-k); the score-function gradient of the measured convergence
factor trains them, with no differentiation through the discrete pipeline.

    python examples_torch/reinforce_centers.py [--device cpu] [--dtype float64]

Each step splits the key as the JAX script does and draws each rollout's
uniform noise with ``prng.uniform``, JAX's bits.  The grid and the solves
are float32, as in the JAX script; ``--dtype`` (JAX's default float type)
is the type of the logits, the noise and the unit-weight graph.  The JAX
script differentiates a surrogate whose rollouts it recomputes under
``stop_gradient``; its only path to the logits is
``log_softmax(logits)[centers]``, which is what autograd follows here.
"""

import argparse

import torch

from mlamg_torch import resolve_device
from mlamg_torch.cli.optim import Adam
from mlamg_torch.data import Grid
from mlamg_torch.graph.bellman_ford import bellman_ford, nearest_center_to_agg
from mlamg_torch.graph.topk import topk_indices
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
    device, dtype = resolve_device(args.device), getattr(torch, args.dtype)

    g = Grid.structured_2d_poisson_dirichlet(10, 10)
    bundle = GridBundle.from_grid(g, alpha=0.12, device=device)
    A = bundle.A
    n = g.n
    k = bundle.k
    opts = SolveOptions(max_iter=80)
    unit = A.with_data(A.mask.to(dtype))

    def rollout(logits, key):
        """Sample center scores with Gumbel noise -> top-k centers; return
        (conv, centers)."""
        u = torch.from_numpy(prng.uniform(key, (n,), numpy_dtype(dtype))).to(device)
        gumbel = -torch.log(-torch.log(u + 1e-9) + 1e-9)
        centers = topk_indices(logits + gumbel, k)
        _, nearest = bellman_ford(unit, centers)
        agg_id = nearest_center_to_agg(centers, nearest)
        P = sa_interpolation_dense(A, agg_id, k)
        return measured_conv(A, P, bundle.x0, opts), centers

    logits = torch.zeros(n, dtype=dtype, device=device)
    opt = Adam([logits], 5e-2)
    key = prng.PRNGKey(0)
    baseline = None
    batch = 8

    for step in range(30):
        key, sub = prng.split(key)
        keys = prng.split(sub, batch)
        with torch.no_grad():
            runs = [rollout(logits, kk) for kk in keys]
        convs = torch.tensor([c for c, _ in runs], dtype=torch.float32, device=device)
        reward = -convs
        b = reward.mean() if baseline is None else baseline
        baseline = 0.9 * b + 0.1 * reward.mean()

        # the surrogate -mean(stop_gradient(reward - baseline) * logp)
        lg = logits.detach().requires_grad_(True)
        logps = torch.stack([torch.log_softmax(lg, 0)[c].sum() for _, c in runs])
        surrogate = -((reward - baseline).to(logps.dtype) * logps).mean()
        surrogate.backward()
        opt.step([lg.grad])
        if step % 5 == 0:
            print(f"step {step}: mean conv {float(convs.mean()):.4f} "
                  f"best {float(convs.min()):.4f}")


if __name__ == "__main__":
    main()
