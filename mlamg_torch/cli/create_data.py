"""Dataset generation (counterpart of ``mlamg_tpu/cli/create_data.py``).

Writes ``--n-grids`` ``.grid`` files of one problem family (``--type``:
isotropic or anisotropic random-hull FEM, jump-coefficient or anisotropic
structured FEM, 3d or 3d_aniso tetrahedral FEM), optionally split into
``train/`` and ``test/``.  The generators are numpy and scipy and draw from
one ``RandomState(seed)`` in the JAX CLI's order, so a seed writes the same
bytes as the JAX CLI.

    python -m mlamg_torch.cli.create_data out_dir --n-grids 100 --type anisotropic [--device cpu]

Nothing here runs on a device; ``--device`` is resolved all the same, as
in every entry point of the port (CUDA unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mlamg_torch.data.grid import Grid
from mlamg_torch.device import resolve_device


def gen_one(kind: str, rng: np.random.RandomState, target_dof: int,
            eps_log_range=(-4.0, 0.0), dof_range=None) -> Grid:
    lo, hi = eps_log_range
    if dof_range is not None:
        # reference recipe: every grid draws its own size (create_data.py:47)
        target_dof = int(rng.randint(dof_range[0], dof_range[1] + 1))
    if kind == "isotropic":
        return Grid.random_2d_unstructured(target_dof, seed=rng.randint(1 << 31))
    if kind == "anisotropic":
        eps = 10.0 ** rng.uniform(lo, hi)
        theta = rng.uniform(0, 2 * np.pi)
        return Grid.random_2d_unstructured(
            target_dof, epsilon=eps, theta=theta, seed=rng.randint(1 << 31)
        )
    if kind == "jump":
        nj = rng.randint(2, 8)
        jumps = np.column_stack(
            [rng.rand(nj), rng.rand(nj), 10.0 ** rng.uniform(-2, 2, nj)]
        )
        side = int(np.sqrt(target_dof))
        return Grid.structured_2d_poisson_dirichlet_jumps(side, side, jumps)
    if kind == "structured":
        side = int(np.sqrt(target_dof))
        eps = 10.0 ** rng.uniform(lo, hi)
        theta = rng.uniform(0, 2 * np.pi)
        return Grid.structured_2d_poisson_dirichlet(side, side, eps, theta)
    if kind in ("3d", "3d_aniso"):
        # reference recipe (utils/create_3d_laplace.py:81-94): tetrahedral
        # CG1 FEM on a unit-cube mesh with per-axis cell counts
        # N ~ U{8..14} (interior dofs (N-1)^3), iso: K = I; aniso:
        # eps_x, eps_y ~ 10^U(-4, 4), eps_z = 1, R = R_y(theta_y) R_z(theta_z)
        nx, ny, nz = (int(rng.randint(8, 15)) for _ in range(3))
        if kind == "3d":
            eps, R = np.ones(3), np.eye(3)
        else:
            eps = np.array([
                10.0 ** rng.uniform(-4.0, 4.0),
                10.0 ** rng.uniform(-4.0, 4.0),
                1.0,
            ])
            ty, tz = rng.uniform(0, 2 * np.pi, 2)
            Rz = np.array([
                [np.cos(tz), -np.sin(tz), 0.0],
                [np.sin(tz), np.cos(tz), 0.0],
                [0.0, 0.0, 1.0],
            ])
            Ry = np.array([
                [np.cos(ty), 0.0, np.sin(ty)],
                [0.0, 1.0, 0.0],
                [-np.sin(ty), 0.0, np.cos(ty)],
            ])
            R = Ry @ Rz
        return Grid.tet_3d_laplace_dirichlet(
            nx, ny, nz, epsilon=eps, R=R, seed=rng.randint(1 << 31)
        )
    raise ValueError(f"unknown dataset type {kind}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Generate .grid datasets")
    p.add_argument("out_dir", type=str)
    p.add_argument("--n-grids", type=int, default=100)
    p.add_argument("--type", default="isotropic",
                   choices=["isotropic", "anisotropic", "jump", "structured", "3d", "3d_aniso"])
    p.add_argument("--dof", type=int, default=300, help="approximate unknowns per grid")
    p.add_argument("--dof-min", type=int, default=0,
                   help="if >0, draw each grid's dof uniformly from [dof-min, dof-max] "
                        "(reference create_data.py:47 draws 25..400)")
    p.add_argument("--dof-max", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eps-log-min", type=float, default=-4.0)
    p.add_argument("--eps-log-max", type=float, default=0.0)
    p.add_argument("--split", type=float, default=0.0,
                   help="if >0, write train/ and test/ subdirs with this test fraction")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


def main(argv=None, log=print) -> list:
    """Write the dataset; returns the paths written, in order."""
    args = parse_args(argv)
    resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    if args.split > 0:
        n_test = int(args.n_grids * args.split)
        dirs = [("train", args.n_grids - n_test), ("test", n_test)]
    else:
        dirs = [("", args.n_grids)]
    written = []
    dof_range = (args.dof_min, args.dof_max) if args.dof_min > 0 else None
    for sub, count in dirs:
        d = os.path.join(args.out_dir, sub) if sub else args.out_dir
        os.makedirs(d, exist_ok=True)
        for i in range(count):
            g = gen_one(args.type, rng, args.dof,
                        eps_log_range=(args.eps_log_min, args.eps_log_max),
                        dof_range=dof_range)
            path = os.path.join(d, f"{args.type}_{i:04d}.grid")
            g.save(path)
            written.append(path)
            if (i + 1) % 20 == 0:
                log(f"{d}: {i + 1}/{count}")
    log("done")
    return written


if __name__ == "__main__":
    main()
