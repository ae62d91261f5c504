#!/usr/bin/env python3
"""How far one float32 pretraining epoch moves under rounding alone, and how
far defects move it: the evidence behind the float32 pretraining bounds of
``chip_smoke.py``'s train phase (``PRETRAIN_BCE_RTOL``, ``PRETRAIN_MSE_RTOL``).

    python3 scripts/pretrain_float32_spread.py --out spread.json               # card and CPU
    python3 scripts/pretrain_float32_spread.py --device cpu --out spread.json  # the CPU rows

Every row is one epoch of ``mlamg_torch.cli.pretrain_dataset`` with the train
phase's flags (``data_out/2d_iso --epochs 1 --rel-strength true``) in
float32: the epoch's mean (loss, bce, mse_c, mse_p).  The rows:

- ``cpu/s<S>``: seed S on the CPU, one thread, with PyTorch's deterministic
  algorithms (the train phase's reference);
- ``cpu/s0/threads3``: seed 0 at three threads without them;
- ``cpu/s0/ulp<D>``: seed 0's initial weights each moved one ulp up or down
  (the signs drawn by ``numpy.random.RandomState(D)``): rounding alone, on
  one device;
- ``cuda/s<S>``: seed S on the card, TF32 off;
- ``<device>/s0/<defect>``: defects, to see which the check can catch:
  ``lr+10%`` and ``lr*2`` (learning rates of 2.2e-3 and 4e-3 for 2e-3),
  ``alpha0.11`` (the targets of strength threshold 0.11 for 0.1) and, on
  the card, ``tf32`` (TF32 matmuls).

Prints one JSON object: each row's parts and its relative gaps in (bce,
mse_c, mse_p) from ``cpu/s<S>`` of its seed, and per kind of row the largest
gap of each part.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data_out", "2d_iso")
DEFECTS = {"lr+10%": ["--lr", "2.2e-3"], "lr*2": ["--lr", "4e-3"], "alpha0.11": ["--alpha", "0.11"]}


def epoch(device: str, seed: int, extra=(), ulp_draw=None, tf32=False,
          threads: int = 1, deterministic: bool = True) -> dict:
    """One float32 pretraining epoch: its mean (loss, bce, mse_c, mse_p)."""
    sys.path.insert(0, ROOT)
    import torch
    from mlamg_torch.cli import pretrain_dataset

    if device == "cpu":
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(deterministic)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    init = pretrain_dataset.init_flax_
    if ulp_draw is not None:
        def init_moved(net, key):
            init(net, key)
            rs = np.random.RandomState(ulp_draw)
            with torch.no_grad():
                for p in net.parameters():
                    up = torch.from_numpy(rs.rand(*p.shape) < 0.5)
                    p.copy_(torch.where(up, torch.nextafter(p, torch.full_like(p, np.inf)),
                                        torch.nextafter(p, torch.full_like(p, -np.inf))))
            return net
        pretrain_dataset.init_flax_ = init_moved
    t0 = time.time()
    try:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            _, parts = pretrain_dataset.main(
                [DATA, "--epochs", "1", "--rel-strength", "true", "--seed", str(seed),
                 *extra, "--device", device, "--out", f"{tmp}/p.ckpt"])
    finally:
        pretrain_dataset.init_flax_ = init
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return {"parts": [float(v) for v in parts], "seconds": time.time() - t0}


def rows(device: str, seeds, ulp_draws: int) -> tuple[dict, dict]:
    """(the CPU rows, the card rows) as ``name: (seed, kwargs)``."""
    cpu = {f"cpu/s{s}": (s, {}) for s in seeds}
    cpu["cpu/s0/threads3"] = (0, dict(threads=3, deterministic=False))
    cpu.update({f"cpu/s0/ulp{d}": (0, dict(ulp_draw=d)) for d in range(1, ulp_draws + 1)})
    cpu.update({f"cpu/s0/{k}": (0, dict(extra=v)) for k, v in DEFECTS.items()})
    card = {}
    if device == "cuda":
        card = {f"cuda/s{s}": (s, {}) for s in seeds}
        card.update({f"cuda/s0/{k}": (0, dict(extra=v)) for k, v in DEFECTS.items()})
        card["cuda/s0/tf32"] = (0, dict(tf32=True))
    return cpu, card


def kind(name: str) -> str:
    """``cpu/s3`` -> reference; ``cuda/s3`` -> cuda; ``cpu/s0/ulp2`` -> cpu/ulp."""
    dev, _, *rest = name.split("/")
    if not rest:
        return "reference" if dev == "cpu" else dev
    tag = rest[0].rstrip("0123456789") if rest[0].startswith("ulp") else rest[0]
    return f"{dev}/{tag}"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (card and CPU rows) or cpu")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--ulp-draws", type=int, default=4)
    p.add_argument("--workers", type=int, default=max(1, (os.cpu_count() or 2) - 2))
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args(argv)
    cpu_rows, card_rows = rows(args.device, args.seeds, args.ulp_draws)
    res = {}
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        jobs = {n: pool.apply_async(epoch, ("cpu", s), kw) for n, (s, kw) in cpu_rows.items()}
        for n, (s, kw) in card_rows.items():  # the card's rows beside the CPU's
            res[n] = epoch("cuda", s, **kw)
        for n, job in jobs.items():
            res[n] = job.get()
    worst: dict = {}
    for n, r in res.items():
        ref = np.asarray(res[f"cpu/s{cpu_rows.get(n, card_rows.get(n))[0]}"]["parts"][1:])
        r["rel_gap"] = (np.abs(np.asarray(r["parts"][1:]) - ref) / np.abs(ref)).tolist()
        if kind(n) != "reference":
            worst[kind(n)] = np.maximum(worst.get(kind(n), 0.0), r["rel_gap"]).tolist()
    out = {"rows": res, "largest_rel_gap_bce_mse_c_mse_p": worst, "seconds": time.time() - t0}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
