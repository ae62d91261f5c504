"""Two processes on the CPU: ``mlamg_torch.parallel`` across a real
process boundary (``torch.distributed`` over gloo), as
``tests/test_multihost.py`` runs ``mlamg_tpu.parallel``.  The test starts
this file twice as a script (``python tests/test_torch_multihost.py
<rank> 2 <port>``); each process holds 4 CPU shards of an 8-shard mesh and
checks, against serial oracles: the population fitness, ``pspmv`` and
``pspmv_halo`` across the boundary, ``pbf``, the coordinator's broadcast,
and a two-level solve equal to the serial one.  A process prints
``WORKER-OK <rank>`` when all hold."""

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_mesh():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), "2",
                               str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=REPO)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"
        assert f"WORKER-OK {rank}" in out, out[-4000:]


def worker(rank: int, world: int, port: str) -> None:
    import numpy as np
    import scipy.sparse as sp
    import torch

    from mlamg_torch import parallel as par
    from mlamg_torch.graph.bellman_ford import bellman_ford
    from mlamg_torch.mg.cycle import twolevel_solve
    from mlamg_torch.mg.interp import sa_interpolation_dense
    from mlamg_torch.ops.sparse import CSR
    from mlamg_torch.parallel import distributed

    torch.set_num_threads(1)
    par.initialize(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                   local_device_count=4, device="cpu")
    try:
        assert (par.process_count(), par.process_index()) == (world, rank)
        F64 = torch.float64

        # 1. population-sharded fitness across processes
        mesh = par.make_mesh(pop=8, row=1)
        assert mesh.shape == {"pop": 8, "row": 1} and (mesh.ranks.ravel() == rank).sum() == 4
        rng = np.random.RandomState(0)
        population = rng.randn(13, 6)  # not divisible by 8
        fit = par.multihost_population_eval(lambda p: -((p - 2.0) ** 2).sum(1), mesh)(population)
        np.testing.assert_allclose(fit, -np.sum((population - 2.0) ** 2, axis=1), atol=1e-12)

        # 2. row-partitioned SpMV across the process boundary
        row_mesh = par.make_mesh(pop=1, row=8)
        n = 64
        A = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.0)],
                     [-1, 0, 1]).tocsr()
        x = rng.randn(n)
        Ap = par.PartitionedELL.from_scipy(A, 8, dtype=F64, device="cpu")
        y = par.gather_global(par.pspmv(Ap, Ap.shard_x(x, row_mesh), row_mesh)).ravel()[:n]
        np.testing.assert_allclose(y, A @ x, atol=1e-12)
        Ah = par.PartitionedELL.from_scipy(A, 8, halo=1, dtype=F64, device="cpu")
        y = par.gather_global(par.pspmv_halo(Ah, Ah.shard_x(x, row_mesh), row_mesh)).ravel()[:n]
        np.testing.assert_allclose(y, A @ x, atol=1e-12)

        # 3. distributed Bellman-Ford across processes
        C = sp.diags([rng.rand(n - 1) + 0.1, rng.rand(n - 1) + 0.1], [-1, 1]).tocsr()
        Cp = par.pbf_partition(C, 8, halo=1, dtype=F64, device="cpu")
        centers = np.array([3, 47])
        cmask = np.zeros((8, 8), bool)
        cmask.ravel()[centers] = True
        dist, near = par.pbf(Cp, par.make_global(cmask, row_mesh, "row"), row_mesh)
        d_ref, n_ref = bellman_ford(CSR.from_scipy(C, dtype=F64, device="cpu"),
                                    torch.from_numpy(centers))
        np.testing.assert_array_equal(par.gather_global(dist).ravel()[:n], d_ref.numpy())
        np.testing.assert_array_equal(par.gather_global(near).ravel()[:n], n_ref.numpy())

        # 4. coordinator broadcast
        seed = np.array([123456789], np.uint32) if rank == 0 else np.zeros(1, np.uint32)
        assert int(par.broadcast_from_coordinator(seed)[0]) == 123456789

        # 5. a two-level solve whose halo exchanges cross the boundary
        nx = 16
        T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
        A2 = sp.csr_matrix(sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx)))
        i = np.arange(nx * nx)
        agg = torch.from_numpy((i // nx // 2) * (nx // 2) + (i % nx) // 2)
        Ac = CSR.from_scipy(A2, dtype=F64, device="cpu")
        P = sa_interpolation_dense(Ac, agg, int(agg.max()) + 1, omega=0.65)
        x0 = torch.from_numpy(rng.randn(nx * nx))
        A2p = par.PartitionedELL.from_scipy(A2, 8, halo=nx, dtype=F64, device="cpu")
        xs, conv, _, it = par.ptwolevel_solve(A2p, P, np.zeros(nx * nx), x0, row_mesh)
        _, conv_s, _, it_s = twolevel_solve(Ac, P, torch.zeros_like(x0), x0, res_tol=1e-8,
                                            max_iter=300)
        assert it == it_s and abs(conv - conv_s) < 1e-10, (it, it_s, conv, conv_s)
        assert np.linalg.norm(A2 @ par.gather_global(xs).ravel()) < 1e-7
    finally:
        distributed.shutdown()
    print(f"WORKER-OK {rank}", flush=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
