"""Learn prolongation and restriction separately (counterpart of
``examples/learn_p_r.py``): P and R values on fixed sparsity patterns
optimized by Adam against the energy-norm two-level error
||R_s (I - P (R A P)^-1 R A) R_s||_F.

    python examples_torch/learn_p_r.py [--device cpu] [--dtype float64]

A, P, R and R_s are float32, as the JAX script makes them; ``--dtype``
(JAX's default float type) is the type of the identity in the error
propagation, and so of the energy, and of the final two-level solves.
Under ``JAX_ENABLE_X64`` the JAX script stops before those solves (its
``jnp.zeros(n)`` is float64 while x0 is float32, and ``twolevel_solve``'s
loop refuses the carry's change of type); this script solves in the
promoted type.
"""

import argparse

import numpy as np
import torch

from mlamg_torch import CSR, resolve_device
from mlamg_torch.cli.optim import Adam
from mlamg_torch.data import Grid
from mlamg_torch.mg import sa_interpolation_dense, twolevel_solve
from mlamg_torch.models import R_jacobi


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                   help="the default float type (float64: JAX_ENABLE_X64)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device, dtype = resolve_device(args.device), getattr(torch, args.dtype)

    g = Grid.structured_1d_poisson_dirichlet(24)
    A = CSR.from_scipy(g.A, device=device)
    n = g.n
    k = n // 3
    agg = torch.arange(n, device=device) // 3
    P0 = sa_interpolation_dense(A, agg, k)
    Rs = R_jacobi(A)
    Ad = A.todense()
    mask = (P0 != 0).to(torch.float32)
    eye = torch.eye(n, dtype=dtype, device=device)

    def energy(P, R):
        G = eye - P @ torch.linalg.solve(R.T @ Ad @ P, R.T @ Ad)
        Rw = Rs.to(G.dtype)  # JAX promotes the float32 R_s to G's type
        E = Rw @ G @ Rw
        return torch.linalg.matrix_norm(E, "fro") ** 2

    P = P0.clone()
    R = P0.clone()  # start Galerkin
    opt = Adam([P, R], 1e-2)
    for i in range(150):
        Pg, Rg = P.detach().requires_grad_(True), R.detach().requires_grad_(True)
        val = energy(Pg * mask, Rg * mask)
        val.backward()
        opt.step([Pg.grad, Rg.grad])
        if i % 30 == 0:
            print(f"step {i}: energy {float(val.detach()):.5f}")

    x0 = np.random.RandomState(0).randn(n)
    x0 /= np.linalg.norm(x0)
    work = torch.promote_types(dtype, torch.float32)
    A_w = A.with_data(A.data.to(work))
    x0 = torch.from_numpy(x0).to(device=device, dtype=torch.float32).to(work)
    for name, Pm in [("galerkin SA", P0), ("learned P", P * mask)]:
        _, conv, _, it = twolevel_solve(A_w, Pm.to(work), torch.zeros(n, dtype=work, device=device),
                                        x0, res_tol=1e-6, max_iter=200)
        print(f"{name:12s}: conv {float(conv):.4f} ({int(it)} iters)")


if __name__ == "__main__":
    main()
