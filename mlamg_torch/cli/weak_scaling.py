"""Weak-scaling harness for the distributed solver path (counterpart of
``mlamg_tpu/cli/weak_scaling.py``).

Each shard keeps the same local problem (n_loc rows of a banded 2D
Poisson), the shard count S doubles, and each row reports the time per
iteration of the halo-exchange SpMV (``pspmv_halo``) and of an iteration
of the distributed two-level solve (``ptwolevel_solve``'s cycle and
residual norm, its set-up excluded), each as the slope between two
iteration counts with the device synchronized around them.

    python -m mlamg_torch.cli.weak_scaling --virtual-devices 8 [--device cpu]

``--virtual-devices N`` puts N shards on the run's one device: those rows
validate the distributed path and its exchange pattern, not interconnect
scaling.  The analytic projections over a ring of real devices are
printed only when ``--link-gbps``, ``--hop-latency-us`` and (for the
production one) ``--prod-cycle-ms`` are given: this CLI carries no
interconnect or cycle time of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mlamg_torch.device import resolve_device


def banded_poisson(nx: int, ny: int):
    """The 5-point Poisson on an nx x ny grid, y-major: bandwidth nx, so a
    row partition needs a halo of nx."""
    import scipy.sparse as sp

    Tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    return sp.csr_matrix(sp.kron(sp.eye(ny), Tx) + sp.kron(Ty, sp.eye(nx))).tocsr()


def box_aggregates(nx: int, ny: int, side: int) -> np.ndarray:
    """Aggregate id of each node of the y-major nx x ny grid: side x side
    boxes."""
    i = np.arange(nx * ny)
    return (i // nx // side) * (nx // side) + (i % nx) // side


def box_prolongator(A, nx: int, ny: int, side: int, device) -> tuple[torch.Tensor, int]:
    """(P, k): the Jacobi-smoothed prolongator (omega 0.65) of the side x
    side box aggregates, dense (n, k) on ``device`` in A's float32.  It is
    formed sparse (A's pattern, columns moved to their aggregates) and
    densified, the JAX CLI's ``sa_interpolation_dense`` operator without
    its (nnz, k) product."""
    from mlamg_torch.mg.interp import smoothed_aggregation
    from mlamg_torch.ops.sparse import CSR

    agg = box_aggregates(nx, ny, side)
    k = int(agg.max()) + 1
    S = smoothed_aggregation(CSR.from_scipy(A, device=device),
                             torch.from_numpy(agg).to(device), k, omega=0.65)
    return S.todense(), k


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_slope(f_lo, f_hi, iters_lo: int, iters_hi: int, device: torch.device,
               repeat: int = 3) -> float:
    """Seconds per iteration: the smallest over ``repeat`` of the slope
    between ``f_lo`` (``iters_lo`` iterations) and ``f_hi``, after one
    call of each to warm up."""
    for f in (f_lo, f_hi):
        f()
    synchronize(device)
    best = np.inf
    for _ in range(repeat):
        t0 = time.perf_counter()
        f_lo()
        synchronize(device)
        t1 = time.perf_counter()
        f_hi()
        synchronize(device)
        t2 = time.perf_counter()
        best = min(best, ((t2 - t1) - (t1 - t0)) / (iters_hi - iters_lo))
    return best


def ici_projection(cycle_ms_1shard: float, nx: int, k: int, pre: int = 1, post: int = 1, *,
                   link_gbps: float, hop_latency_us: float) -> dict:
    """Analytic weak-scaling projection of the distributed two-level cycle
    over a ring of devices: per iteration each shard sends 2*(pre+post+1)
    halo slices of nx float32 rows to its ring neighbours and joins 2
    all-reduces of a (k,) vector (charged 2*(S-1)/S of its bytes), with no
    overlap of communication and the measured 1-shard compute.
    ``link_gbps`` is one link's bandwidth per direction (GB/s)."""
    halo_bytes = 2 * (pre + post + 1) * nx * 4
    msgs = 2 * (pre + post + 1) + 2
    rows = []
    for S in (2, 4, 8, 16):
        allreduce_bytes = 2 * (S - 1) / S * (2 * k * 4)
        t_comm_ms = ((halo_bytes + allreduce_bytes) / (link_gbps * 1e9) * 1e3
                     + msgs * hop_latency_us * 1e-3)
        efficiency = cycle_ms_1shard / (cycle_ms_1shard + t_comm_ms)
        rows.append(dict(shards=S, comm_ms=round(t_comm_ms, 6),
                         projected_efficiency=round(efficiency, 4)))
    return dict(model="no-overlap ring: t(S) = t(1) + halo exchanges + ring all-reduce",
                assumptions=dict(link_gbps=link_gbps, hop_latency_us=hop_latency_us,
                                 halo_bytes_per_iter=halo_bytes, msgs_per_iter=msgs),
                cycle_ms_1shard=cycle_ms_1shard, rows=rows)


def production_ici_projection(cycle_ms_1chip: float, *, link_gbps: float, hop_latency_us: float,
                              nx: int = 4096, levels: int = 7, k_coarse: int = 1024, nu: int = 2,
                              box_side: int = 2) -> dict:
    """Weak-scaling projection of the structured V-cycle (nx^2 rows per
    device, ``levels`` levels coarsened by ``box_side``, Chebyshev of
    degree nu+1) from its measured 1-device cycle time: per level each
    pre/post smooth, the residual and the interpolation and restriction
    exchange one halo row of the level's width with each ring neighbour,
    and the replicated coarsest solve costs one ring all-gather of the
    (k_coarse,) residual; no overlap."""
    halo_bytes, msgs, w = 0, 0, nx
    for _ in range(levels):
        halo_bytes += 2 * (2 * (nu + 1) + 3) * w * 4
        msgs += 2 * (2 * (nu + 1) + 3)
        w //= box_side
    rows = []
    for S in (2, 4, 8, 16):
        gather_bytes = (S - 1) / S * k_coarse * 4
        t_comm_ms = ((halo_bytes + gather_bytes) / (link_gbps * 1e9) * 1e3
                     + (msgs + 2) * hop_latency_us * 1e-3)
        efficiency = cycle_ms_1chip / (cycle_ms_1chip + t_comm_ms)
        rows.append(dict(shards=S, comm_ms=round(t_comm_ms, 6),
                         projected_efficiency=round(efficiency, 4)))
    return dict(model=("no-overlap ring on the measured 1-device structured V-cycle: "
                       "t(S) = t(1) + halo + coarse all-gather"),
                assumptions=dict(cycle_ms_1chip=cycle_ms_1chip, nx_per_chip=nx, levels=levels,
                                 k_coarse=k_coarse, link_gbps=link_gbps,
                                 hop_latency_us=hop_latency_us, halo_bytes_per_cycle=halo_bytes),
                rows=rows)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Weak scaling of the row-partitioned SpMV and two-level cycle",
        epilog="The JAX CLI's --platform is --device here; it has no --bench-json: "
               "the projections take their numbers from the flags only.")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu runs on the host)")
    p.add_argument("--virtual-devices", type=int, default=0,
                   help="put this many shards on the run's one device")
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--ny-loc", type=int, default=32)
    p.add_argument("--agg", type=int, default=4, help="box aggregate side")
    p.add_argument("--out", type=str, default=None, help="write JSON here")
    p.add_argument("--link-gbps", type=float, default=None,
                   help="one link's bandwidth per direction, GB/s, for the projections")
    p.add_argument("--hop-latency-us", type=float, default=None,
                   help="latency of one neighbour message, us, for the projections")
    p.add_argument("--prod-cycle-ms", type=float, default=None,
                   help="measured 1-device ms per structured V-cycle, for the production "
                        "projection")
    return p.parse_args(argv)


def main(argv=None, log=print) -> dict:
    """Print each row and then the JSON line; returns it."""
    from mlamg_torch.parallel import PartitionedELL, make_mesh, pspmv_halo
    from mlamg_torch.parallel.pcycle import DistributedCycle

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if args.virtual_devices:
        devices = [dev] * args.virtual_devices
    elif dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    nx, ny_loc, side = args.nx, args.ny_loc, args.agg

    rows = []
    for S in [s for s in (1, 2, 4, 8, 16) if s <= len(devices)]:
        A = banded_poisson(nx, ny_loc * S)
        n = A.shape[0]
        P, k = box_prolongator(A, nx, ny_loc * S, side, dev)
        mesh = make_mesh(pop=1, row=S, devices=devices[:S])
        Ap = PartitionedELL.from_scipy(A, S, halo=nx, device=dev)
        x = np.random.RandomState(0).randn(n).astype(np.float32)
        xs = Ap.shard_x(x, mesh)

        def spmv_chain(iters, Ap=Ap, mesh=mesh, xs=xs):
            v = xs
            for _ in range(iters):
                v = pspmv_halo(Ap, v, mesh).map(lambda p: p * 0.25)
            return v

        t_spmv = time_slope(lambda: spmv_chain(10), lambda: spmv_chain(30), 10, 30, dev)
        cycle = DistributedCycle(Ap, P, np.zeros(n, np.float32), mesh)

        def cycle_chain(iters, cycle=cycle, xs=xs):
            v = xs
            for _ in range(iters):
                v = cycle(v)
                cycle.residual_norm(v)
            return v

        t_cycle = time_slope(lambda: cycle_chain(4), lambda: cycle_chain(12), 4, 12, dev)
        rows.append(dict(shards=S, n=n, nnz=int(A.nnz), k=k, spmv_us_per_iter=t_spmv * 1e6,
                         cycle_ms_per_iter=t_cycle * 1e3))
        log(rows[-1])
        del P, cycle

    base = rows[0]
    for r in rows:
        r["spmv_weak_efficiency"] = base["spmv_us_per_iter"] / r["spmv_us_per_iter"]
        r["cycle_weak_efficiency"] = base["cycle_ms_per_iter"] / r["cycle_ms_per_iter"]
    link = dict(link_gbps=args.link_gbps, hop_latency_us=args.hop_latency_us)
    has_link = None not in link.values()
    virtual = bool(args.virtual_devices)
    out = dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        virtual=virtual,
        virtual_cpu=virtual and dev.type == "cpu",
        physical_cores=os.cpu_count(),
        note=("virtual shards share one device; efficiencies here validate the distributed "
              "path and its exchange pattern, not interconnect scaling") if virtual else "",
        nx=nx, ny_loc=ny_loc, rows=rows,
        ici_projection=ici_projection(base["cycle_ms_per_iter"], nx, base["k"], **link)
        if has_link else None,
        ici_projection_production=production_ici_projection(args.prod_cycle_ms, **link)
        if has_link and args.prod_cycle_ms else None,
    )
    log(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
