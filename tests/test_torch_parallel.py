"""The row-partitioned and population-parallel paths: ``mlamg_torch.parallel``
against ``mlamg_tpu.parallel`` on the same numpy inputs (CPU, float64; the
JAX side on the conftest's 8 virtual CPU devices, the port's on 8 virtual
CPU shards), at the JAX tests' sizes (``tests/test_parallel_ga.py``,
``tests/test_pcycle.py``): ``from_scipy``'s arrays bit for bit, the SpMVs
and Jacobi to 1e-12, Bellman-Ford and Lloyd exactly, the population
evaluation, the mesh and the global arrays; the weak-scaling CLI's keys;
and the leftovers of modules ported earlier (``agg_matrix_dense``,
``agg_matrix_csr``, ``make_forward``, ``AggNet(return_intermediate=True)``).
The solves are in ``tests/test_torch_pcycle.py``."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu import parallel as jpar
from mlamg_tpu.graph import lloyd_aggregation as j_lloyd
from mlamg_tpu.graph.bellman_ford import agg_matrix_csr as j_agg_csr
from mlamg_tpu.graph.bellman_ford import agg_matrix_dense as j_agg_dense
from mlamg_tpu.models import FullAggNet as JFullAggNet
from mlamg_tpu.models.agg_interp import make_forward as j_make_forward
from mlamg_tpu.models.graphdata import graph_from_matrix_basic as j_graph
from mlamg_tpu.ops import CSR as JCSR
from mlamg_tpu.parallel.pspmv import partitioned_jacobi as j_jacobi

from mlamg_torch import parallel as par
from mlamg_torch.convert import fullaggnet_from_params, partitioned_ell_from_numpy
from mlamg_torch.graph.bellman_ford import agg_matrix_csr, agg_matrix_dense, bellman_ford
from mlamg_torch.graph.lloyd import lloyd_aggregation
from mlamg_torch.models.agg_interp import make_forward
from mlamg_torch.models.graphdata import graph_from_matrix_basic
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.parallel.pspmv import partitioned_jacobi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
SPMV_ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The parallel ops are many small torch operations; under pytest's
    workers one thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    """(JAX row mesh, port row mesh): 8 row shards each."""
    return jpar.make_mesh(pop=1, row=8), par.make_mesh(pop=1, row=8, devices=["cpu"] * 8)


def poisson1d(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()


def poisson2d(nx):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return sp.csr_matrix(sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


def both(A, halo=None, dtype="float64"):
    """(JAX PartitionedELL, port PartitionedELL) of A over 8 shards."""
    return (jpar.PartitionedELL.from_scipy(A, 8, halo=halo, dtype=getattr(jnp, dtype)),
            par.PartitionedELL.from_scipy(A, 8, halo=halo, dtype=getattr(torch, dtype),
                                          device="cpu"))


def flat(x, n):
    return np.asarray(par.gather_global(x)).ravel()[:n]


@pytest.mark.parametrize("case", ["random_global", "tridiag_halo", "poisson2d_halo_padded",
                                  "poisson2d_float32"])
def test_from_scipy_arrays_equal_jax(rng, case):
    """data and col bit for bit (n = 100 pads the last shard), and the
    port's converter of a JAX partition gives the same tensors."""
    A, halo, dtype = {
        "random_global": (sp.random(64, 64, density=0.2, format="csr", random_state=rng), None,
                          "float64"),
        "tridiag_halo": (poisson1d(64), 2, "float64"),
        "poisson2d_halo_padded": (poisson2d(10), 10, "float64"),
        "poisson2d_float32": (poisson2d(16), 16, "float32"),
    }[case]
    J, T = both(A, halo, dtype)
    np.testing.assert_array_equal(np.asarray(J.data), T.data.numpy())
    np.testing.assert_array_equal(np.asarray(J.col), T.col.numpy())
    assert T.data.dtype == getattr(torch, dtype) and (T.shape, T.num_shards, T.halo) == (
        J.shape, J.num_shards, J.halo)
    C = partitioned_ell_from_numpy(J.data, J.col, J.shape, J.num_shards, J.halo, device="cpu")
    assert torch.equal(C.data, T.data) and torch.equal(C.col, T.col)
    assert (C.shape, C.num_shards, C.halo, C.n_loc) == (T.shape, T.num_shards, T.halo, T.n_loc)


def test_halo_bandwidth_error_is_jaxs(rng):
    A = sp.random(32, 32, density=0.5, format="csr", random_state=rng)
    with pytest.raises(ValueError) as want:
        jpar.PartitionedELL.from_scipy(A, 8, halo=1)
    with pytest.raises(ValueError) as got:
        par.PartitionedELL.from_scipy(A, 8, halo=1, device="cpu")
    assert str(got.value) == str(want.value) and "bandwidth" in str(got.value)


@pytest.mark.parametrize("kind", ["allgather", "halo_1d", "halo_2d_padded"])
def test_pspmv_matches_scipy_and_jax(rng, meshes, kind):
    jm, m = meshes
    A, halo = {"allgather": (sp.random(64, 64, density=0.2, format="csr", random_state=rng), None),
               "halo_1d": (poisson1d(64), 2),
               "halo_2d_padded": (poisson2d(10), 10)}[kind]
    n = A.shape[0]
    J, T = both(A, halo)
    x = rng.randn(n)
    jop, op = (jpar.pspmv, par.pspmv) if halo is None else (jpar.pspmv_halo, par.pspmv_halo)
    y = flat(op(T, T.shard_x(x, m), m), n)
    np.testing.assert_allclose(y, A @ x, rtol=0, atol=SPMV_ATOL)
    yj = np.asarray(jop(J, J.shard_x(jnp.asarray(x), jm), jm)).ravel()[:n]
    np.testing.assert_allclose(y, yj, rtol=0, atol=SPMV_ATOL)
    # an unsharded (S, n_loc) input gives the same
    np.testing.assert_array_equal(flat(op(T, T.shard_x(x), m), n), y)


def test_pspmv_halo_is_differentiable(rng, meshes):
    """Within one process the halo product is a torch graph: the gradient
    of v . (A x) with respect to x is A^T v."""
    _, m = meshes
    A = sp.random(40, 40, density=0.3, format="csr", random_state=rng)
    A = sp.csr_matrix(sp.triu(A, -3) - sp.triu(A, 4))
    T = par.PartitionedELL.from_scipy(A, 8, halo=4, dtype=F64, device="cpu")
    x = torch.tensor(rng.randn(40), dtype=F64, requires_grad=True)
    v = rng.randn(8 * T.n_loc)
    y = par.pspmv_halo(T, T.shard_x(x), m).parts[0]
    (y.reshape(-1) * torch.from_numpy(v)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), A.T @ v[:40], rtol=0, atol=SPMV_ATOL)


def test_partitioned_jacobi_matches_jax_and_serial(rng, meshes):
    from mlamg_torch.mg.smoothers import jacobi

    jm, m = meshes
    n = 64
    A = poisson1d(n)
    J, T = both(A, 2)
    b = rng.randn(n)
    dinv = 1.0 / A.diagonal()
    ys = partitioned_jacobi(T, T.shard_x(dinv), T.shard_x(b), T.shard_x(np.zeros(n)), m, nu=3)
    yj = j_jacobi(J, J.shard_x(jnp.asarray(dinv), jm), J.shard_x(jnp.asarray(b), jm),
                  J.shard_x(jnp.zeros(n), jm), jm, nu=3)
    np.testing.assert_allclose(flat(ys, n), np.asarray(yj).ravel()[:n], rtol=0, atol=SPMV_ATOL)
    Ac = CSR.from_scipy(A, dtype=F64, device="cpu")
    ref = jacobi(Ac, torch.from_numpy(b), torch.zeros(n, dtype=F64), Ac.diagonal() ** -1, nu=3)
    np.testing.assert_allclose(flat(ys, n), ref.numpy(), rtol=0, atol=SPMV_ATOL)


@pytest.mark.parametrize("directed", [False, True])
def test_pbf_equals_jax_and_serial(rng, meshes, directed):
    """Distances and nearest centers equal JAX's pbf and the port's serial
    Bellman-Ford exactly (a directed graph through ``pbf_partition``)."""
    jm, m = meshes
    n = 64
    lo = rng.rand(n - 1) + 0.1
    up = rng.rand(n - 1) + 0.1 if directed else lo
    C = sp.diags([lo, up], [-1, 1]).tocsr()
    centers = np.array([3, 47] if directed else [5, 40])
    cmask = np.zeros((8, 8), bool)
    cmask.ravel()[centers] = True
    J = jpar.pbf_partition(C, 8, halo=1, dtype=jnp.float64)
    T = par.pbf_partition(C, 8, halo=1, dtype=F64, device="cpu")
    dist, near = par.pbf(T, cmask, m)
    dj, nj = jpar.pbf(J, jnp.asarray(cmask), jm)
    np.testing.assert_array_equal(par.gather_global(dist), np.asarray(dj))
    np.testing.assert_array_equal(par.gather_global(near), np.asarray(nj))
    d_ref, n_ref = bellman_ford(CSR.from_scipy(C, dtype=F64, device="cpu"),
                                torch.from_numpy(centers))
    np.testing.assert_array_equal(flat(dist, n), d_ref.numpy())
    np.testing.assert_array_equal(flat(near, n), n_ref.numpy())


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_plloyd_equals_jax_and_serial(rng, meshes, case):
    jm, m = meshes
    if case == "1d":
        n, k, maxiter, halo = 64, 6, 5, 1
        w = rng.rand(n - 1) + 0.1
        C = sp.diags([w, w], [-1, 1]).tocsr()
    else:
        nx, k, maxiter = 12, 12, 4
        C = abs(poisson2d(nx))
        C.setdiag(0)
        C.eliminate_zeros()
        n, halo = C.shape[0], nx
    seeds = np.sort(rng.permutation(n)[:k]).astype(np.int32)
    J, T = both(C, halo)
    record: dict = {}
    agg, centers = par.plloyd(T, seeds, m, maxiter=maxiter, record=record)
    # per iteration the assignment's and the interior's Bellman-Ford, then the last assignment
    assert len(record["sweeps"]) == 2 * maxiter + 1 and min(record["sweeps"]) >= 1
    agg_j, centers_j = jpar.plloyd(J, seeds, jm, maxiter=maxiter)
    np.testing.assert_array_equal(par.gather_global(agg), np.asarray(agg_j))
    np.testing.assert_array_equal(centers.numpy(), np.asarray(centers_j))
    agg_s, roots_s, _ = lloyd_aggregation(CSR.from_scipy(C, dtype=F64, device="cpu"),
                                          seeds=seeds, maxiter=maxiter)
    np.testing.assert_array_equal(flat(agg, n), agg_s.numpy())
    np.testing.assert_array_equal(np.sort(centers.numpy()), np.sort(roots_s.numpy()))
    agg_js, _, _ = j_lloyd(JCSR.from_scipy(C, dtype=jnp.float64), seeds=seeds, maxiter=maxiter)
    np.testing.assert_array_equal(agg_s.numpy(), np.asarray(agg_js))


def test_two_blocks_of_devices_give_the_same_bits(rng):
    """A row axis of two device blocks (``cpu`` and ``cpu:0``, told apart
    by the mesh) exchanges between blocks by copies: the halo product,
    Bellman-Ford and Lloyd equal the one-block mesh's bit for bit."""
    one = par.make_mesh(pop=1, row=8, devices=["cpu"] * 8)
    two = par.make_mesh(pop=1, row=8, devices=["cpu"] * 3 + ["cpu:0"] * 5)
    from mlamg_torch.parallel import _comm

    assert len(_comm.layout(two, "row").blocks) == 2
    C = abs(poisson2d(12))
    C.setdiag(0)
    C.eliminate_zeros()
    T = par.PartitionedELL.from_scipy(C, 8, halo=12, dtype=F64, device="cpu")
    x = rng.randn(C.shape[0])
    seeds = np.sort(rng.permutation(C.shape[0])[:12])
    cmask = np.zeros((8, T.n_loc), bool)
    cmask.ravel()[seeds] = True
    for run in (lambda m: [par.pspmv_halo(T, T.shard_x(x), m)],
                lambda m: list(par.pbf(T, cmask, m)),
                lambda m: [par.plloyd(T, seeds, m, maxiter=3)[0]]):
        for a, b in zip(run(one), run(two)):
            np.testing.assert_array_equal(par.gather_global(a), par.gather_global(b))


def test_shard_population_eval_pads_to_the_pop_axis(rng):
    """P = 13 on 8 pop shards: padded with the last row, cut back to 13;
    equal to JAX's evaluator and to the unsharded function; each block
    sees its own rows."""
    pop = rng.randn(13, 6)
    seen = []

    def fit(p):
        seen.append(p.shape[0])
        return -((p - 2.0) ** 2).sum(1)

    mesh = par.make_mesh(pop=8, row=1, devices=["cpu"] * 4 + ["cpu:0"] * 4)
    got = par.shard_population_eval(fit, mesh)(pop)
    assert seen == [8, 8] and got.shape == (13,) and got.dtype == F64
    want = jpar.shard_population_eval(lambda p: -jnp.sum((p - 2.0) ** 2, axis=1),
                                      jpar.make_mesh(pop=8, row=1))(jnp.asarray(pop))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.numpy(), fit(torch.from_numpy(pop)).numpy())


def test_mesh_and_global_arrays(rng):
    m = par.make_mesh(pop=2, row=4, devices=["cpu"] * 8)
    assert m.shape == {"pop": 2, "row": 4} and m.shape == dict(jpar.make_mesh(pop=2, row=4).shape)
    assert par.make_mesh(pop=None, row=2, devices=["cpu"] * 8).shape == {"pop": 4, "row": 2}
    with pytest.raises(ValueError, match="exceeds"):
        par.make_mesh(pop=3, row=4, devices=["cpu"] * 8)
    with pytest.raises(AssertionError):
        jpar.make_mesh(pop=3, row=4)
    rows = par.make_mesh(pop=1, row=8, devices=["cpu"] * 8)
    x = rng.randn(8, 5)
    g = par.make_global(x, rows, "row")
    np.testing.assert_array_equal(par.gather_global(g, rows), x)
    pops = par.make_mesh(pop=4, row=1, devices=["cpu"] * 4)
    from mlamg_torch.parallel.mesh import population_sharding, replicated

    p = par.make_global(x, pops, population_sharding(pops))
    assert p.parts[0].shape == (8, 5)
    np.testing.assert_array_equal(par.gather_global(p), x)
    np.testing.assert_array_equal(par.make_global(x, pops, replicated(pops)).numpy(), x)
    assert par.broadcast_from_coordinator({"a": 1}) == {"a": 1}
    assert (par.process_count(), par.process_index(), par.is_coordinator()) == (1, 0, True)
    with pytest.raises(ValueError, match="pop 1"):
        par.pspmv(par.PartitionedELL.from_scipy(poisson1d(16), 4, device="cpu"),
                  np.zeros(16), m)


def test_weak_scaling_prints_the_jax_clis_keys(capsys):
    """``--virtual-devices 2`` at a small size: rows at S = 1, 2 with the
    JAX CLI's keys (mlamg_tpu/cli/weak_scaling.py), ``virtual`` true, and
    no projection without the link's numbers (the times are the CPU's,
    under pytest's other workers: only their presence is checked)."""
    from mlamg_torch.cli import weak_scaling

    out = weak_scaling.main(["--virtual-devices", "2", "--nx", "16", "--ny-loc", "4",
                             "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    jax_keys = {"device", "virtual_cpu", "physical_cores", "note", "nx", "ny_loc", "rows",
                "ici_projection", "ici_projection_production"}
    assert set(out) == jax_keys | {"virtual"}
    assert out["virtual"] and out["virtual_cpu"] and "not interconnect scaling" in out["note"]
    assert [r["shards"] for r in out["rows"]] == [1, 2]
    for r in out["rows"]:
        assert set(r) == {"shards", "n", "nnz", "k", "spmv_us_per_iter", "cycle_ms_per_iter",
                          "spmv_weak_efficiency", "cycle_weak_efficiency"}
        assert np.isfinite([r["spmv_us_per_iter"], r["cycle_ms_per_iter"]]).all()
    assert out["ici_projection"] is None and out["ici_projection_production"] is None
    proj = weak_scaling.ici_projection(1.0, 16, 8, link_gbps=100.0, hop_latency_us=2.0)
    from mlamg_tpu.cli.weak_scaling import ici_projection as j_proj

    assert proj["rows"] == j_proj(1.0, 16, 8, ici_gbps=100.0, hop_latency_us=2.0)["rows"]


# ---- leftovers of modules ported earlier -------------------------------------


def test_agg_matrices_equal_jax():
    agg = np.array([2, 0, 3, 1, 0, 2, 3])  # 3 = k: unassigned
    dense = agg_matrix_dense(torch.from_numpy(agg), 3)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(j_agg_dense(jnp.asarray(agg), 3)))
    assert dense.dtype == torch.float32
    got, want = agg_matrix_csr(torch.from_numpy(agg), 3), j_agg_csr(jnp.asarray(agg), 3)
    for f in ("data", "row", "col", "indptr"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert (got.shape, got.nnz) == (tuple(want.shape), int(want.nnz))


@pytest.fixture(scope="module")
def r5():
    """The committed runs_iso_r5 weights and config, and a 2d_iso test grid."""
    from mlamg_torch.data.grid import Grid

    with open(os.path.join(REPO, "runs_iso_r5", "grad_best.ckpt"), "rb") as f:
        ck = pickle.load(f)
    g = Grid.load(os.path.join(REPO, "data_out", "2d_iso", "test", "isotropic_0000.grid"))
    return ck["best_params"], dict(ck["extra"]["net_config"]), g


def test_make_forward_and_intermediate_masks_equal_jax(r5):
    """``make_forward`` (k = ceil(alpha n)) and the per-layer top-k masks
    of ``AggNet(..., return_intermediate=True)`` against the JAX model op
    by op, in float64: masks and aggregates equal, P within 1e-12."""
    params, config, g = r5
    A = g.A.tocsr()
    net = fullaggnet_from_params(params, config, device="cpu", dtype=F64)
    jnet = JFullAggNet(**config)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    Aj, At = JCSR.from_scipy(A, dtype=jnp.float64), CSR.from_scipy(A, dtype=F64, device="cpu")
    with torch.no_grad():
        agg, P, *_ = make_forward(net, 0.1)(At)
    agg_j, P_j, *_ = j_make_forward(jnet, 0.1)(jparams, Aj)
    assert agg.shape[0] == A.shape[0] and int(agg.max()) < int(np.ceil(0.1 * A.shape[0]))
    np.testing.assert_array_equal(agg.numpy(), np.asarray(agg_j))
    np.testing.assert_allclose(P.todense().numpy(), np.asarray(P_j.todense()), rtol=0, atol=1e-12)

    k = int(np.ceil(0.1 * A.shape[0]))
    gt = graph_from_matrix_basic(At, ell_width=config["bf_width"],
                                 rel_strength=config["rel_strength"])
    gj = j_graph(Aj, ell_width=config["bf_width"], rel_strength=config["rel_strength"])
    with torch.no_grad():
        masks = net.AggNetM(gt, k, return_intermediate=True)
    want = jnet.apply(jparams, gj, k, method=lambda mdl, g, k: mdl.AggNetM(
        g, k, return_intermediate=True))
    assert len(masks) == len(want) == config["iterations"]
    for a, b in zip(masks, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(a.sum()) == k
    with torch.no_grad():
        last, _ = net.AggNetM(gt, k)
    assert torch.equal(last, masks[-1])


# ---- the device rule ------------------------------------------------------------


def test_parallel_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from mlamg_torch.cli import visualize, weak_scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = os.path.join(REPO, "data_out", "2d_iso", "test", "isotropic_0000.grid")
    for call in (lambda: par.make_mesh(pop=1, row=2),
                 lambda: par.make_mesh(pop=1, row=2, devices=["cuda", "cuda"]),
                 lambda: par.PartitionedELL.from_scipy(poisson1d(16), 2),
                 lambda: par.pbf_partition(poisson1d(16), 2, halo=1),
                 lambda: partitioned_ell_from_numpy(np.zeros((2, 8, 3)), np.zeros((2, 8, 3)),
                                                    (16, 16), 2, None),
                 lambda: weak_scaling.main(["--virtual-devices", "2", "--nx", "8",
                                            "--ny-loc", "2"]),
                 lambda: visualize.main(["model-error", grid])):
        with pytest.raises(RuntimeError, match="device='cpu'|CUDA is not available"):
            call()
    assert par.make_mesh(pop=1, row=2, device="cpu").devices.tolist() == [
        [torch.device("cpu")] * 2]
