"""How far the float32 Galerkin products of ``bench_torch.py``'s rap cell
land from scipy's float64 P^T A P, over repeated runs: the evidence behind
the cell's bounds (``RAP_RTOL`` for ``rap_masked``, ``RAP_FUSED_RTOL`` for
``rap_fused``).

``rap_fused`` sums each A_H entry's ~124 terms with ``index_add`` (atomic
adds on the card, in no fixed order), so its error moves from run to run;
``rap_masked`` adds in a fixed elementwise order.  Each run prints the
largest error over A_H relative to max |A_H|, as the cell measures it, and
the last line the spread of both products.

    python3 scripts/rap_fused_spread.py [--runs 50] [--grid 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    import bench_torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=50)
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    ops = bench_torch.rap_operands(args.grid, device=args.device)
    Psp = ops["P"].to_scipy().astype(np.float64)
    want = (Psp.T @ ops["A"].astype(np.float64) @ Psp).tocsr()
    scale = abs(want).max()
    errs = {name: [] for name in ("fused", "masked")}
    for _ in range(args.runs):
        for name, product in bench_torch.rap_products(ops).items():
            AH, _ = product()
            errs[name].append(float(abs(AH.to_scipy().astype(np.float64) - want).max() / scale))
    out = {name: {"min": min(e), "median": float(np.median(e)), "max": max(e), "runs": len(e)}
           for name, e in errs.items()}
    out.update(grid=args.grid, device=str(ops["Ac"].device), max_abs_AH=float(scale))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
