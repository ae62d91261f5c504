"""Host against device Galerkin product in the unstructured SA setup: where
does ``rap_mode="device"`` start to pay?

Times ``build_unstructured_hierarchy`` at the 600k cell's settings (alpha
0.2, 5 levels, min_coarse 1200, lloyd_maxiter 5, fmt "well" on the card)
with ``rap_mode="host"`` and ``"device"``, in the order host, device,
device, host, per setup stage and per level (branch, pt_width, ap_width,
product seconds), with the card's peak memory over each build, on two
inputs:

- the random-hull P1 FEM matrix of ``chip_smoke.py`` (600k dofs, seed 7),
  read from ``--hull-npz`` when that file exists (meshing it takes two
  minutes of host time; ``--save-hull`` writes it after meshing);
- the 2048^2 five-point Poisson as a CSR (4,194,304 dofs, 20,963,328 nnz).

    python3 scripts/rap_crossover.py [--out chiprun_out/rap_crossover.json]
    python3 scripts/rap_crossover.py --device cpu --hull-n 20000 --grid 128

With ``--split`` it times instead, per level of each input's host-built
hierarchy, the stages of one device product apart, the card synchronized
around each: the host's boolean patterns, P on the card, the patterns'
upload, the ELL packs of A and P, the product AP, P's transpose with the
ELL packs of P^T and AP, the product P^T (AP), the read-back of A_H, and
``rap_masked`` end to end on the same operands; beside them the host
branch's P and scipy product.

Needs one CUDA card unless ``--device cpu`` (for a rehearsal at a small
size; its times are the CPU's, and it records no peak memory).  Prints a
JSON line per build (per level with ``--split``), a table per input and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import nvidia_smi_line, poisson2d  # noqa: E402
from mlamg_torch.data import Grid  # noqa: E402
from mlamg_torch.mg import amg_unstructured as amg  # noqa: E402
from mlamg_torch.mg.amg_unstructured import build_unstructured_hierarchy  # noqa: E402
from mlamg_torch.mg.interp import smoothed_aggregation  # noqa: E402
from mlamg_torch.ops import matmul  # noqa: E402
from mlamg_torch.ops.sparse import CSR  # noqa: E402

BUILD = dict(alpha=0.2, max_levels=5, min_coarse=1200, lloyd_maxiter=5)
ORDER = ("host", "device", "device", "host")


def hull(n: int, npz: str, save: bool):
    if os.path.exists(npz):
        return sp.load_npz(npz).tocsr()
    A = Grid.random_2d_unstructured(n, seed=7).A.astype(np.float32).tocsr()
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(npz)), exist_ok=True)
        sp.save_npz(npz, A, compressed=False)
    return A


def build_once(A, mode: str, device: str) -> dict:
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    prof: dict = {}
    t0 = time.time()
    h, _ = build_unstructured_hierarchy(A, rap_mode=mode, device=device,
                                        fmt="well" if cuda else "csr", profile_out=prof, **BUILD)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t0
    branch, per_level = prof.pop("rap_branch"), prof.pop("rap_levels")
    out = {
        "mode": mode, "setup_s": setup_s, "stages_s": prof,
        "levels": [{"level": l, "n": int(lev.agg.numel()), "k": lev.k, "branch": b, **r}
                   for l, (lev, b, r) in enumerate(zip(h.levels, branch, per_level))],
        "coarse_k": int(h.coarse.lu.shape[0]),
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "peak_over_start_bytes": torch.cuda.max_memory_allocated() - base if cuda else None,
    }
    del h
    if cuda:
        torch.cuda.empty_cache()
    return out


def split_levels(A, device: str) -> list:
    """Per level of the host-built hierarchy of ``A``: seconds of each stage
    of ``rap_mode="device"``'s product (``_device_rap_level`` with one
    smoothing step, stage by stage) and of the host branch's."""
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    h, _ = build_unstructured_hierarchy(A, rap_mode="host", device=device, fmt="csr", **BUILD)
    out = []
    for lvl, lev in enumerate(h.levels):
        level_A = lev.A.to_scipy().tocsr()
        level_A.sort_indices()
        agg, k, omega = lev.agg.cpu().numpy(), lev.k, lev.omegas[0]
        a_width = int(np.diff(level_A.indptr).max())
        d = level_A.diagonal()
        Dinv = (1.0 / np.where(d != 0, d, 1.0)).astype(np.float32)
        A_dev = CSR.from_scipy(level_A, dtype=torch.float32, device=device)
        sync()
        st: dict = {}
        t = time.perf_counter()

        def tick(label):
            nonlocal t
            sync()
            now = time.perf_counter()
            st[label] = now - t
            t = now

        _, APpat, AHpat = amg.galerkin_patterns(level_A, agg, k)
        pt_width = int(np.bincount(agg[level_A.tocoo().col], minlength=k).max())
        ap_width = int(np.diff(APpat.indptr).max())
        tick("patterns_host")
        P_dev = smoothed_aggregation(A_dev, torch.from_numpy(agg).to(device), k, omega=omega)
        tick("p_device")
        AP_pat = amg._pattern_csr(APpat, device)
        AH_pat = amg._pattern_csr(AHpat, device)
        tick("patterns_upload")
        A_ell, P_ell = A_dev.to_ell(a_width), P_dev.to_ell(a_width)
        tick("ell_a_p")
        AP = matmul.spgemm_masked(A_ell, P_ell, AP_pat, a_width=a_width, b_width=a_width,
                                  chunk=amg._auto_chunk(a_width))
        tick("product_ap")
        Pt_ell = matmul.transpose(P_dev).to_ell(pt_width)
        AP_ell = AP.to_ell(ap_width)
        tick("transpose_ell_pt_ap")
        AH = matmul.spgemm_masked(Pt_ell, AP_ell, AH_pat, a_width=pt_width, b_width=ap_width,
                                  chunk=amg._auto_chunk(ap_width))
        tick("product_ah")
        AH_sp = AH.to_scipy()
        tick("readback")
        del A_ell, P_ell, AP, Pt_ell, AP_ell, AH
        rap_masked = amg.rap_masked(A_dev, P_dev, AP_pat, AH_pat, a_width=a_width,
                                    p_width=a_width, pt_width=pt_width, ap_width=ap_width)
        tick("rap_masked_whole")
        del rap_masked
        Psp = amg.host_prolongator(level_A, agg, k, Dinv, [omega])
        tick("host_p")
        AH_host = (Psp.T @ (level_A @ Psp)).tocsr()
        tick("host_product")
        AH_host.sum_duplicates()
        AH_sp.sum_duplicates()
        diff = abs(AH_sp - AH_host).max() / abs(AH_host).max()
        row = {"level": lvl, "n": level_A.shape[0], "nnz": int(level_A.nnz), "k": k,
               "a_width": a_width, "pt_width": pt_width, "ap_width": ap_width,
               "nnz_ap": int(APpat.nnz), "nnz_ah": int(AHpat.nnz),
               "chunks_ap": -(-int(APpat.nnz) // amg._auto_chunk(a_width)),
               "chunks_ah": -(-int(AHpat.nnz) // amg._auto_chunk(ap_width)),
               "ah_rel_diff": float(diff), "stages_s": st}
        del A_dev, P_dev, AP_pat, AH_pat
        if cuda:
            torch.cuda.empty_cache()
        out.append(row)
    return out


def split_table(name: str, rows: list) -> str:
    keys = list(rows[0]["stages_s"])
    lines = [f"{name}: seconds per stage, level by level", "  " + " | ".join(["level"] + keys)]
    for r in rows:
        lines.append("  " + " | ".join([str(r["level"])]
                                       + [f"{r['stages_s'][k]:.4f}" for k in keys]))
    return "\n".join(lines)


def table(name: str, runs: list) -> str:
    lines = [f"{name}: setup s (rap s per level) [branch]"]
    for r in runs:
        rap = ", ".join(f"{lev['rap_s']:.3f}" for lev in r["levels"])
        br = ",".join(lev["branch"] for lev in r["levels"])
        peak = "not measured" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 2**20:.1f} MiB"
        lines.append(f"  {r['mode']:6s} {r['setup_s']:8.3f} s  rap ({rap})  [{br}]  peak {peak}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--hull-n", type=int, default=600_000)
    ap.add_argument("--hull-npz", default="_chipwork/hull600k.npz")
    ap.add_argument("--save-hull", action="store_true")
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--out", default=None)
    ap.add_argument("--split", action="store_true",
                    help="time the stages of the device product per level instead")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rap_crossover: no CUDA card (pass --device cpu for a rehearsal)")
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = nvidia_smi_line() if args.device == "cuda" else None
    if smi:
        print(smi, flush=True)
    t0 = time.time()
    npz = args.hull_npz if args.hull_n == 600_000 else ""  # the file holds the 600k hull
    inputs = {f"hull{args.hull_n}": hull(args.hull_n, npz, args.save_hull and bool(npz))}
    hull_s = time.time() - t0
    inputs[f"poisson{args.grid}"] = poisson2d(args.grid)
    result = {"device": args.device, "nvidia_smi": smi, "hull_seconds": hull_s, "inputs": {}}
    for name, A in inputs.items():
        if args.split:
            rows = split_levels(A, args.device)
            for row in rows:
                print(json.dumps({"input": name, **row}), flush=True)
            result["inputs"][name] = {"n": A.shape[0], "nnz": int(A.nnz), "split": rows}
            print(split_table(f"{name} (n {A.shape[0]}, nnz {A.nnz})", rows), flush=True)
            continue
        runs = []
        for mode in ORDER:
            run = build_once(A, mode, args.device)
            print(json.dumps({"input": name, **run}), flush=True)
            runs.append(run)
        result["inputs"][name] = {"n": A.shape[0], "nnz": int(A.nnz), "runs": runs}
        print(table(f"{name} (n {A.shape[0]}, nnz {A.nnz})", runs), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if smi:
        print(smi, flush=True)
    return result


if __name__ == "__main__":
    main()
