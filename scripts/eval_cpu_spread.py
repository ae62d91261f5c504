"""How far rounding alone moves the per-grid conv factors of the learned
evaluation and of the GA's fitness between the card and the CPU, and how
far a small defect moves them: the evidence behind ``chip_smoke.py``'s
``EVAL_CPU_TOL``.

- evaluation (``cli.evaluate_dataset.evaluate``, float32, the eval phase's
  test sets and checkpoints): for seeds 0-4 the trained weights times
  1 + 1e-3 * randn(seed) (seed 0: as trained), the same on both devices;
  the largest per-grid gap of each method (lloyd, random, ml);
- GA (generation 0's fitness path, ``train.population_convs`` over
  ``bucketed_convs`` on the first training bucket's 12 grids, the ga
  phase's flags): for seeds 0-4 the population ``init_population(
  PRNGKey(1 + seed))`` (seed 0: the ga phase's own), the largest gap;
- defects, on the card only: the 2d_iso weights times 1 + 1e-6, 1e-5
  and 1e-4, and the GA population times 1 + 1e-5 and 1e-3.

    python3 scripts/eval_cpu_spread.py [--seeds 5] [--out runs/eval_spread.json]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import EVAL_RUNS, GA_ARGS, TRAIN_DATA  # noqa: E402
from mlamg_torch.cli import train_dataset  # noqa: E402
from mlamg_torch.cli.evaluate_dataset import evaluate, load_model  # noqa: E402
from mlamg_torch.data.grid import Grid  # noqa: E402
from mlamg_torch.ga import flatten_params  # noqa: E402
from mlamg_torch.ga.codec import init_population  # noqa: E402
from mlamg_torch.train import bucketed_convs, population_convs  # noqa: E402
from mlamg_torch.utils import prng  # noqa: E402


@torch.no_grad()
def scaled(net, seed: int = 0, scale: float = 0.0):
    """``net`` with every weight times 1 + 1e-3 * randn(seed) (seed > 0)
    and then times 1 + ``scale``; numpy draws, so both devices get the same."""
    rng = np.random.RandomState(seed)
    for p in net.parameters():
        f = np.ones(p.shape) if seed == 0 else 1 + 1e-3 * rng.randn(*p.shape)
        p.mul_(torch.from_numpy(f * (1 + scale)).to(p.device, p.dtype))
    return net


def eval_convs(device: str, fam: str, seed: int = 0, scale: float = 0.0) -> dict:
    _, d, ck, _ = next(r for r in EVAL_RUNS if r[0] == fam)
    grids = Grid.load_dir(d)
    net, _ = load_model(ck, grids, device=device)
    res, _ = evaluate(grids, scaled(net, seed, scale), device=device, log=lambda *_: None)
    return res


def ga_convs(device: str, seeds, scale: float = 0.0) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        run = train_dataset.prepare(train_dataset.parse_args([
            TRAIN_DATA, *GA_ARGS, "--device", device, "--checkpoint-dir", f"{tmp}/ck",
            "--metrics-dir", f"{tmp}/runs"]), log=lambda *_: None)
        vec = flatten_params(run.net)[0]
        out = {}
        with torch.no_grad():
            for seed in seeds:
                pop = init_population(prng.PRNGKey(1 + seed), vec, 6, perturb=0.05)
                out[seed] = population_convs(run.net, pop * (1 + scale), lambda m: bucketed_convs(
                    m, run.train_buckets[:1], run.opts))
        run.writer.close()
    return out


def gap(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    out = {"eval": [], "ga": [], "controls": []}
    for fam in ("2d_iso", "2d_aniso"):
        for seed in range(args.seeds):
            card, cpu = eval_convs("cuda", fam, seed), eval_convs("cpu", fam, seed)
            out["eval"].append(dict(family=fam, seed=seed,
                                    gaps={m: gap(card[m], cpu[m]) for m in card}))
            print(json.dumps(out["eval"][-1]), flush=True)
    cpu0 = eval_convs("cpu", "2d_iso")
    for scale in (1e-6, 1e-5, 1e-4):
        card = eval_convs("cuda", "2d_iso", scale=scale)
        out["controls"].append(dict(defect=f"2d_iso weights x (1 + {scale}) on the card",
                                    gap=gap(card["ml"], cpu0["ml"])))
        print(json.dumps(out["controls"][-1]), flush=True)
    seeds = list(range(args.seeds))
    card, cpu = ga_convs("cuda", seeds), ga_convs("cpu", seeds)
    for seed in seeds:
        out["ga"].append(dict(seed=seed, gap=gap(card[seed], cpu[seed])))
        print(json.dumps(out["ga"][-1]), flush=True)
    for scale in (1e-5, 1e-3):
        bad = ga_convs("cuda", [0], scale=scale)[0]
        out["controls"].append(dict(defect=f"GA population x (1 + {scale}) on the card",
                                    gap=gap(bad, cpu[0])))
        print(json.dumps(out["controls"][-1]), flush=True)
    out.update(seconds=time.time() - t0, device=torch.cuda.get_device_name(0))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
