"""Unsteady Oseen / Navier-Stokes time stepping (counterpart of
``mlamg_tpu/cli/solve_ns.py``).

Implicit time steps of the lid-driven cavity (MAC) or of the DFG channel
around a cylinder (P1-P1); each step solves the saddle-point system with
FGMRES and the full-Schur fieldsplit, the Schur block preconditioned by
PCDR, SA-AMG or learned AMG.  Prints the JAX CLI's lines.

    python -m mlamg_torch.cli.solve_ns --n 16 --re 100 --steps 5 --schur-pc pcdr [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mlamg_torch.data.stokes import lid_driven_cavity
from mlamg_torch.deploy import (
    LearnedAMGPreconditioner,
    Options,
    PCDRPreconditioner,
    SAPreconditioner,
    SchurFieldsplitSolver,
)
from mlamg_torch.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Unsteady Oseen flow with fieldsplit AMG")
    p.add_argument("--problem", default="cavity", choices=["cavity", "cylinder"],
                   help="cavity: structured MAC lid-driven cavity; cylinder: "
                        "unstructured P1-P1 DFG channel around a cylinder")
    p.add_argument("--h", type=float, default=0.04, help="cylinder mesh spacing")
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--re", type=float, default=100.0)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--schur-pc", default="pcdr", choices=["pcdr", "sa", "mlamg"])
    p.add_argument("--pnet-model", type=str, default=None)
    p.add_argument("--float64", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, log=print) -> dict:
    """Run the steps; returns the system, the solver, the setup seconds
    (``setup_s``: Schur preconditioner and fieldsplit, each with its dense
    LU seconds) and one record per step: iters, the printed res and |du|,
    FGMRES's last residual estimate (``fgmres_res``), seconds, x and b (in
    the solve's float type)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch.float64 if args.float64 else torch.float32

    if args.problem == "cylinder":
        from mlamg_torch.data.cylflow import cylinder_flow_system

        sys_ = cylinder_flow_system(h=args.h, Re=args.re, dt=args.dt)
    else:
        sys_ = lid_driven_cavity(n=args.n, Re=args.re, dt=args.dt)
    log(f"problem={args.problem} n_u={sys_.n_u} n_p={sys_.n_p} Re={args.re} dt={args.dt}")

    t0 = time.perf_counter()
    if args.schur_pc == "pcdr":
        schur_pc = PCDRPreconditioner(sys_, dtype=dtype, device=dev)
    elif args.schur_pc == "sa":
        schur_pc = SAPreconditioner(sys_.Ap, Options({"pyamg_alpha": 0.2}), dtype=dtype,
                                    device=dev)
    else:
        opts = Options({"mlamg_max_iter": 4, "mlamg_amg_rtol": 0.0})
        if args.pnet_model:
            opts.set("mlamg_pnet_model", args.pnet_model)
        schur_pc = LearnedAMGPreconditioner(sys_.Ap, opts, dtype=dtype, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    solver = SchurFieldsplitSolver(sys_, schur_pc, dtype=dtype, device=dev)
    _sync(dev)
    setup = {"schur_pc": t1 - t0, "schur_pc_lu": schur_pc.lu_seconds,
             "fieldsplit": time.perf_counter() - t1, "fieldsplit_lu": solver.lu_seconds}

    K = sys_.saddle_matrix()
    u = np.zeros(sys_.n_u)
    Mv = getattr(sys_, "velocity_mass", None)  # FEM mass; MAC grids use I
    steps = []
    for step in range(args.steps):
        # implicit step: F already holds the M/dt reaction term, so the
        # right-hand side is [f + M u_old / dt ; g]
        mu = (Mv @ u) if Mv is not None else u
        b = np.concatenate([sys_.f + mu / args.dt, sys_.g])
        b_t = torch.from_numpy(b).to(dev, dtype)
        t0 = time.perf_counter()
        x_t, hist, iters = solver.solve(b=b_t, tol=args.tol)
        x = x_t.cpu().numpy()
        seconds = time.perf_counter() - t0
        r = np.linalg.norm(K @ x - b_t.cpu().numpy())
        du = np.linalg.norm(x[: sys_.n_u] - u)
        u = x[: sys_.n_u]
        log(f"step {step}: fgmres iters={int(iters)} res={r:.2e} |du|={du:.3e} "
            f"({seconds:.2f}s)")
        steps.append({"iters": int(iters), "res": float(r), "du": float(du),
                      "fgmres_res": float(hist[iters - 1]) if iters else 0.0,
                      "seconds": seconds, "x": x, "b": b_t.cpu().numpy()})
    log("done")
    return {"system": sys_, "solver": solver, "setup_s": setup, "steps": steps}


if __name__ == "__main__":
    main()
