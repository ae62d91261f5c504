"""Differentiable top-k aggregation training (counterpart of
``examples/diff_topk_training.py``): learn node scores end-to-end through a
soft top-k relaxation, unit-BF aggregation held fixed per step, SA
smoothing and the AMG loss.

    python examples_torch/diff_topk_training.py [--device cpu] [--dtype float64]

A, D^-1, omega, the tentative prolongator and the test vectors are
float32, as the JAX script makes them; ``--dtype`` (JAX's default float
type) is the type of the scores, the unit-weight graph and so of P and the
loss.  The loss does not change when P's columns are rescaled, so the soft
scores' gradient is zero up to rounding, and Adam, which divides by the
gradient's size, steps along that rounding.
"""

import argparse

import torch

from mlamg_torch import CSR, resolve_device
from mlamg_torch.cli.optim import Adam
from mlamg_torch.data import Grid
from mlamg_torch.graph.bellman_ford import bellman_ford, nearest_center_to_agg
from mlamg_torch.graph.topk import soft_topk_mask, topk_indices
from mlamg_torch.mg.interp import sa_omega, tentative_dense
from mlamg_torch.models import amg_loss, make_test_vectors
from mlamg_torch.models.loss import numpy_dtype
from mlamg_torch.ops.matmul import spmm
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
    A = CSR.from_scipy(g.A, device=device)
    n = g.n
    k = max(4, n // 10)
    tv = make_test_vectors(n, 6, device=device)
    unit = A.with_data(A.mask.to(dtype))
    d = A.diagonal()
    Dinv = 1.0 / torch.where(d != 0, d, torch.ones_like(d))
    omega = sa_omega(A, Dinv)

    def soft_P(scores):
        """Soft assignment: hard BF aggregation from the current top-k, but
        P columns weighted by the soft scores so gradients reach them."""
        centers = topk_indices(scores.detach(), k)
        _, nearest = bellman_ford(unit, centers)
        agg_id = nearest_center_to_agg(centers, nearest)
        T = tentative_dense(agg_id, k, dtype=torch.float32)
        soft = soft_topk_mask(scores, k, sigma=0.3)
        T = T * (0.5 + 0.5 * soft[centers])[None, :]
        return T - omega * Dinv[:, None] * spmm(A, T)

    def loss_fn(scores):
        return amg_loss(soft_P(scores), A, tv)

    key = prng.PRNGKey(0)
    scores = 0.01 * torch.from_numpy(prng.normal(key, (n,), numpy_dtype(dtype))).to(device)
    opt = Adam([scores], 5e-2)
    for i in range(100):
        s = scores.detach().requires_grad_(True)
        val = loss_fn(s)
        val.backward()
        opt.step([s.grad])
        if i % 20 == 0:
            print(f"step {i}: loss {float(val.detach()):.4f}")
    with torch.no_grad():
        print(f"final loss: {float(loss_fn(scores)):.4f}")


if __name__ == "__main__":
    main()
