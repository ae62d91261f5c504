"""How far rounding alone moves the two trained numbers the tools phase of
``chip_smoke.py`` holds against a reference, and how far a small defect
moves them: the evidence behind ``TOOLS_CF_LAST_RTOL`` and
``TOOLS_CONV_MSE_RTOL``.

- ``train_cf_interp`` (``scripts/repro_cf_interp.sh``'s 60 epochs, float64
  with float32 weights): the last epoch's three losses against
  ``runs_cf_interp/cf_interp.json`` (the JAX CLI's), on each device, as
  trained and with every initial weight moved one float32 ulp up or down
  (rounding-sized changes); the defects: the learning rate times 1 + 1e-3
  and times 10.
- ``train_convergence`` (the tools phase's samples: ``data_out/2d_iso/train``,
  3 splittings a grid, built once on the first device and cached): the
  first epoch's train mse on each device, as trained and from initial
  weights moved one ulp up or down; the defects: the learning rate times
  1 + 1e-2 and times 10.

    python3 scripts/tools_spread.py [--devices cuda cpu] [--out runs/tools_spread.json]

The devices run side by side, each in its own process; ``--devices cpu``
runs here without a card (the CPU half alone).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import NS_CF_JSON, TOOLS_CF_ARGS, TOOLS_CONV_ARGS  # noqa: E402


CF_VARIANTS = {"as_trained": 1.0, "ulp_up": 1.0, "ulp_down": 1.0, "lr_1e-3": 1 + 1e-3,
               "lr_x10": 10.0}
CONV_VARIANTS = {"as_trained": 1.0, "ulp_up": 1.0, "ulp_down": 1.0, "lr_1e-2": 1 + 1e-2,
                 "lr_x10": 10.0}


@torch.no_grad()
def ulp_move(net, variant: str) -> None:
    """Every weight moved one float32 ulp up or down (``ulp_up``,
    ``ulp_down``; other variants leave the weights)."""
    if variant in ("ulp_up", "ulp_down"):
        inf = float("inf") if variant == "ulp_up" else -float("inf")
        for p in net.parameters():
            p.copy_(torch.nextafter(p, torch.full_like(p, inf)))


def cf_last_epoch(device: str, variant: str) -> list:
    from mlamg_torch.cli import train_cf_interp

    args = train_cf_interp.parse_args([*TOOLS_CF_ARGS, "--device", device])
    args.lr *= CF_VARIANTS[variant]
    run = train_cf_interp.prepare(args)
    ulp_move(run.net, variant)
    last = []
    for _ in range(args.epochs):
        last = [run.step(i) for i in range(len(run.train))]
    return last


def conv_first_epoch(device: str, cache: str, variant: str) -> float:
    from mlamg_torch.cli import train_convergence
    from mlamg_torch.models import gnn

    argv = [*TOOLS_CONV_ARGS[:-1], "1", "--cache-samples", cache, "--device", device,
            "--lr", repr(1e-3 * CONV_VARIANTS[variant])]
    init = gnn.init_flax_

    def init_and_move(net, key):
        init(net, key)
        ulp_move(net, variant)
        return net

    gnn.init_flax_ = init_and_move
    try:
        record: dict = {}
        train_convergence.main(argv, log=lambda *_: None, record=record)
    finally:
        gnn.init_flax_ = init
    return record["train_mse"][0]


def device_runs(device: str, cache: str) -> dict:
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
        torch.use_deterministic_algorithms(True)
    t0 = time.time()
    out = {"cf_last": {v: cf_last_epoch(device, v) for v in CF_VARIANTS},
           "conv_first_mse": {v: conv_first_epoch(device, cache, v) for v in CONV_VARIANTS}}
    out["seconds"] = time.time() - t0
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from mlamg_torch.cli import train_convergence
    from mlamg_torch.data.grid import Grid

    with open(NS_CF_JSON) as f:
        ref = json.load(f)["train_loss_last_epoch"]
    with tempfile.TemporaryDirectory() as tmp:
        cache = f"{tmp}/samples.npz"
        t0 = time.time()
        samples = train_convergence.build_samples(Grid.load_dir(TOOLS_CONV_ARGS[0]), 0.1,
                                                  int(TOOLS_CONV_ARGS[2]), device=args.devices[0])
        train_convergence.save_samples(cache, samples)
        out: dict = {"samples": len(samples), "seconds_samples": time.time() - t0}
        with multiprocessing.get_context("spawn").Pool(len(args.devices)) as pool:
            jobs = {d: pool.apply_async(device_runs, (d, cache)) for d in args.devices}
            runs = {d: job.get() for d, job in jobs.items()}
    for d, r in runs.items():
        out[d] = {"cf_last_gap_to_json": {v: max(abs(a - b) / b for a, b in zip(losses, ref))
                                          for v, losses in r["cf_last"].items()},
                  "cf_last": r["cf_last"], "conv_first_mse": r["conv_first_mse"],
                  "seconds": r["seconds"]}
    if len(args.devices) == 2:
        a, b = (runs[d]["conv_first_mse"] for d in args.devices)
        out["conv_first_mse_gap_between_devices"] = {v: abs(a[v] - b[v]) / b[v] for v in a}
        base = runs[args.devices[-1]]["conv_first_mse"]["as_trained"]
        out["conv_first_mse_gap_to_the_last_device_as_trained"] = {
            f"{d}_{v}": abs(r["conv_first_mse"][v] - base) / base
            for d, r in runs.items() for v in r["conv_first_mse"]}
    print(json.dumps(out, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
