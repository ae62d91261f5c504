#!/usr/bin/env python3
"""The control of a cell's check, and the program's own readings beside it:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, one request of the cell's traffic (its first) is made as a
run makes it, where the mix draws dataset items on the item it draws.  The
program solves it; the control puts the reference in the program's place
in bfloat16, the precision below the configuration's float32: x_true
rounded to bfloat16 as the answer, and the first coarse operator worked
out by the reference in bfloat16.  Both go through the run's own
comparison; one JSON line per seed and side.  Not part of a benchmark
run.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import json  # noqa: E402

import torch  # noqa: E402

from harness import core  # noqa: E402


def readings(cell: str, seeds, device: str = "cuda", loaded: dict | None = None) -> list:
    spec = loaded or core.load_cell(cell)
    config, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    System = core.load_module(core.BENCH / "systems" / f"{config['system']}.py",
                              "bench_system").System
    system = System(config, dev, str(core.CACHE))
    fixed = traffic["operator"] == "fixed"
    h_fixed = system.build(system.operator(1.0)) if fixed else None
    out = []
    for seed in seeds:
        client = core.Client(traffic, seed, system, dev)
        scale, x_true, item = client.draw(core.WINDOW, 0)
        at = core.item_args(item)
        b = system.rhs(x_true, scale, *at)
        h = h_fixed if fixed else system.build(system.operator(scale, *at))
        tol = config["request"]["tol"] * float(torch.linalg.vector_norm(b))
        x, cycles, _ = system.solve(h, b, tol)
        state = system.coarse_state(h)
        program = {"residual": system.residual(x, b, scale, *at), "cycles": cycles,
                   **system.check_coarse(state, scale)}
        x_low = x_true.to(torch.bfloat16).float()
        control = {"residual": system.residual(x_low, b, scale, *at),
                   **system.check_coarse(system.control_state(state, scale), scale)}
        out.append({"seed": seed, "scale": scale, "item": item, "program": program,
                    "control": control})
    return out


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    for line in readings(a.workload, a.seeds):
        print(json.dumps(line), flush=True)
