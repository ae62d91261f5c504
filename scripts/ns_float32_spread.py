"""How far rounding alone moves the Navier-Stokes solve between the card and
the CPU, and how far two defects move it: the evidence behind
``chip_smoke.py``'s card-against-CPU bounds of the ns phase.

For seeds 0-4, one implicit step of the lid-driven cavity (n 32, Re 100,
dt 0.1) from the velocity state u0 = 0.1 * randn(seed) (seed 0: u0 = 0,
solve_ns's first step), with each Schur preconditioner (pcdr, sa, mlamg
with the committed C/F checkpoint), on the card and on the CPU in float32
and float64: FGMRES's iterations, the float64 residual over |b| and the
largest gap between the two solutions (velocity and mean-free pressure,
as ``chip_smoke._flow_gap``).  Then two defects, each on the card only:
mlamg with Jacobi weight 0.6 in place of 2/3 (greedy theta does not move
the cavity's red-black splitting anywhere in (0.5, 1)), and the cylinder (h 0.04)
PCDR solve with the stabilization block C dropped.

    python3 scripts/ns_float32_spread.py [--seeds 5] [--out runs/ns_spread.json]

Needs one CUDA card (``--device cpu`` runs both sides on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import NS_CKPT, _flow_gap  # noqa: E402
from mlamg_torch.data.cylflow import cylinder_flow_system  # noqa: E402
from mlamg_torch.data.stokes import lid_driven_cavity  # noqa: E402
from mlamg_torch.deploy import (LearnedAMGPreconditioner, Options,  # noqa: E402
                                PCDRPreconditioner, SAPreconditioner, SchurFieldsplitSolver)


def solve(system, pc: str, b: np.ndarray, device: str, dtype, weight: float = 2.0 / 3.0):
    """One fieldsplit FGMRES solve as solve_ns runs it; (iters, x)."""
    if pc == "pcdr":
        schur = PCDRPreconditioner(system, dtype=dtype, device=device)
    elif pc == "sa":
        schur = SAPreconditioner(system.Ap, Options({"pyamg_alpha": 0.2}), dtype=dtype,
                                 device=device)
    else:
        schur = LearnedAMGPreconditioner(system.Ap, Options({
            "mlamg_max_iter": 4, "mlamg_amg_rtol": 0.0, "mlamg_pnet_model": NS_CKPT,
            "mlamg_jacobi_weight": weight}), dtype=dtype, device=device)
    solver = SchurFieldsplitSolver(system, schur, dtype=dtype, device=device)
    x, _, iters = solver.solve(b=torch.from_numpy(b).to(device, dtype), tol=1e-6)
    return iters, x.cpu().numpy().astype(np.float64)


def rel_res(system, x: np.ndarray, b: np.ndarray) -> float:
    """The float64 residual of the saddle system over |b|."""
    return float(np.linalg.norm(system.saddle_matrix() @ x - b) / np.linalg.norm(b))


def reading(system, b, card, cpu, gap) -> dict:
    (ic, xc), (ih, xh) = card, cpu
    return dict(iters_card=ic, iters_cpu=ih, res_card=rel_res(system, xc, b),
                res_cpu=rel_res(system, xh, b), gap=gap(xc, xh))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    t0 = time.time()
    s = lid_driven_cavity(n=32, Re=100.0, dt=0.1)
    rows = []
    for seed in range(args.seeds):
        u0 = np.zeros(s.n_u) if seed == 0 else 0.1 * np.random.RandomState(seed).randn(s.n_u)
        b = np.concatenate([s.f + u0 / 0.1, s.g])
        for pc in ("pcdr", "sa", "mlamg"):
            for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
                rows.append(dict(seed=seed, pc=pc, dtype=name, **reading(
                    s, b, solve(s, pc, b, args.device, dtype), solve(s, pc, b, "cpu", dtype),
                    lambda x, y: _flow_gap(x, y, s.n_u))))
                print(json.dumps(rows[-1]), flush=True)
    controls = []
    b = np.concatenate([s.f, s.g])
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        controls.append(dict(defect="mlamg Jacobi weight 0.6 on the card", dtype=name, **reading(
            s, b, solve(s, "mlamg", b, args.device, dtype, weight=0.6),
            solve(s, "mlamg", b, "cpu", dtype), lambda x, y: _flow_gap(x, y, s.n_u))))
        print(json.dumps(controls[-1]), flush=True)
    cyl = cylinder_flow_system(h=0.04, Re=100.0, dt=0.1)
    b = np.concatenate([cyl.f, cyl.g])
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        cpu = solve(cyl, "pcdr", b, "cpu", dtype)
        C, cyl.C = cyl.C, None
        card = solve(cyl, "pcdr", b, args.device, dtype)
        cyl.C = C
        # an open flow fixes the pressure: the whole solution is compared
        controls.append(dict(defect="cylinder h 0.04 PCDR, C dropped on the card", dtype=name,
                             **reading(cyl, b, card, cpu, lambda x, y: float(
                                 np.abs(x - y).max() / np.abs(y).max()))))
        print(json.dumps(controls[-1]), flush=True)
    out = {"rows": rows, "controls": controls, "seconds": time.time() - t0,
           "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
