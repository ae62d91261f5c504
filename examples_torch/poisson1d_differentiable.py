"""Differentiable interpolation training on 1D Poisson (counterpart of
``examples/poisson1d_differentiable.py``): optimize the values of P with
Adam against the softmax-weighted AMG convergence loss, then compare the
measured two-level convergence factor against Jacobi smoothed aggregation.

    python examples_torch/poisson1d_differentiable.py [--n 32] [--steps 200] [--device cpu]

A and P are float32, as the JAX script's ``CSR.from_scipy`` makes them,
and so are the test vectors (``make_test_vectors``' type); ``--dtype``
(JAX's default float type) is the type of the final two-level solves,
whose right-hand side is the JAX script's default-typed ``zeros(n)``.
Under ``JAX_ENABLE_X64`` the JAX script stops there: its ``jnp.zeros(n)``
is float64 while x0 is float32, and ``twolevel_solve``'s loop refuses the
carry's change of type.  This script solves in the promoted type.
"""

import argparse

import numpy as np
import torch

from mlamg_torch import CSR, resolve_device
from mlamg_torch.cli.optim import Adam
from mlamg_torch.data import Grid
from mlamg_torch.mg import sa_interpolation_dense, twolevel_solve
from mlamg_torch.models import amg_loss, make_test_vectors
from mlamg_torch.utils import prng


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--agg-size", type=int, default=4)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                   help="the default float type (float64: JAX_ENABLE_X64)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device, dtype = resolve_device(args.device), getattr(torch, args.dtype)

    g = Grid.structured_1d_poisson_dirichlet(args.n)
    A = CSR.from_scipy(g.A, device=device)
    n = g.n
    k = n // args.agg_size
    agg = torch.arange(n, device=device) // args.agg_size

    P_sa = sa_interpolation_dense(A, agg, k)

    # resample test vectors each step (stochastic loss): optimizing a fixed
    # small batch overfits the transient and hurts the asymptotic factor
    def loss_and_grad(P, key):
        tv = make_test_vectors(n, 16, key=key, device=device)
        P = P.detach().requires_grad_(True)
        val = amg_loss(P, A, tv, tot_num_loop=8)
        val.backward()
        return val.detach(), P.grad

    P = P_sa.clone()
    opt = Adam([P], args.lr)
    key = prng.PRNGKey(0)
    for i in range(args.steps):
        key, sub = prng.split(key)
        val, grads = loss_and_grad(P, sub)
        opt.step([grads])
        if i == 0 or (i + 1) % 50 == 0:
            print(f"step {i + 1}: loss {float(val):.4f}")

    x0 = np.random.RandomState(0).randn(n)
    x0 /= np.linalg.norm(x0)
    work = torch.promote_types(dtype, P.dtype)
    A_w = A.with_data(A.data.to(work))
    x0 = torch.from_numpy(x0).to(device=device, dtype=P.dtype).to(work)
    for name, Pm in [("SA", P_sa), ("learned", P)]:
        _, conv, _, iters = twolevel_solve(
            A_w, Pm.to(work), torch.zeros(n, dtype=work, device=device), x0,
            res_tol=1e-6, max_iter=200
        )
        print(f"{name:8s} conv factor: {float(conv):.4f} ({int(iters)} iters)")


if __name__ == "__main__":
    main()
