"""Port parity, the Navier-Stokes deployment path: the flow generators,
PETSc IO, the C/F-interpolation network, the three Schur preconditioners,
the fieldsplit solver and ``solve_ns`` of ``mlamg_torch`` against
``mlamg_tpu`` on the same inputs (CPU, float64).

The pressure Laplacian ``Ap`` of both flows is a pure Neumann operator:
SA and the learned preconditioner factor its coarse operator, which is
then exactly singular, so their output on it is set by rounding (in both
packages alike).  Their apply is held on the pinned Laplacian
(``train_cf_interp``'s), their setup (P, coarse operator) on both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu import deploy as jdeploy
from mlamg_tpu.cli import solve_ns as jsolve_ns
from mlamg_tpu.cli.train_cf_interp import cf_inputs, pinned_pressure_laplacian
from mlamg_tpu.data import cylflow as jcylflow
from mlamg_tpu.data import fem as jfem
from mlamg_tpu.data import petsc_io as jpetsc
from mlamg_tpu.data import stokes as jstokes
from mlamg_tpu.models.cf_interp import CFInterpolationNetwork as JCFNet
from mlamg_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint

from mlamg_torch import deploy
from mlamg_torch.cli import solve_ns
from mlamg_torch.convert import cfnet_from_params, params_from_cfnet
from mlamg_torch.data import cylflow, fem, petsc_io, stokes
from mlamg_torch.models.cf_interp import cf_rank
from mlamg_torch.ops.sparse import CSR

F64 = torch.float64
CKPT = "runs_cf_interp/cf_best.ckpt"
MLAMG = {"mlamg_max_iter": 4, "mlamg_amg_rtol": 0.0}


def t(a):
    return torch.from_numpy(np.array(a))


def assert_sparse_identical(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.shape == b.shape


SYSTEMS = {
    "cavity": lambda pkg: pkg.lid_driven_cavity(n=8, Re=100.0, dt=0.1),
    "stokes": lambda pkg: pkg.lid_driven_cavity(n=6, Re=10.0, wind=(0.0, 0.0)),
    "cylinder": lambda pkg: pkg.cylinder_flow_system(h=0.06, Re=100.0, dt=0.1),
}


def system_pair(name):
    if name == "cylinder":
        return SYSTEMS[name](jcylflow), SYSTEMS[name](cylflow)
    return SYSTEMS[name](jstokes), SYSTEMS[name](stokes)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_generators_bit_for_bit(name):
    js, ts = system_pair(name)
    for blk in ("F", "B", "Mp", "Ap", "Fp"):
        assert_sparse_identical(getattr(ts, blk), getattr(js, blk))
    for vec in ("f", "g", "Mu_diag"):
        np.testing.assert_array_equal(getattr(ts, vec), getattr(js, vec))
    assert (ts.n_u, ts.n_p, ts.dt, ts.Re) == (js.n_u, js.n_p, js.dt, js.Re)
    assert_sparse_identical(ts.saddle_matrix(), js.saddle_matrix())
    np.testing.assert_array_equal(ts.rhs(), js.rhs())
    if name == "cylinder":
        assert_sparse_identical(ts.C, js.C)
        assert_sparse_identical(ts.velocity_mass, js.velocity_mass)
        for attr in ("pressure_pin_nodes", "free_velocity_nodes", "vertices", "elements"):
            np.testing.assert_array_equal(getattr(ts, attr), getattr(js, attr))


def test_fem_forms_and_mesh_bit_for_bit():
    v, e = cylflow.cylinder_channel_mesh(h=0.1)
    jv, je = jcylflow.cylinder_channel_mesh(h=0.1)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(e, je)
    for a, b in zip(cylflow.classify_boundary(v), jcylflow.classify_boundary(v)):
        np.testing.assert_array_equal(a, b)
    assert_sparse_identical(fem.mass_form(v, e), jfem.mass_form(v, e))
    assert_sparse_identical(fem.bp_stabilization(v, e), jfem.bp_stabilization(v, e))
    wind = lambda x, y: np.column_stack([y * (0.41 - y), 0.1 * x])  # noqa: E731
    assert_sparse_identical(fem.convection_form(v, e, wind), jfem.convection_form(v, e, wind))
    assert_sparse_identical(fem.convection_form(v, e, lambda x, y: np.array([1.0, -0.5])),
                            jfem.convection_form(v, e, lambda x, y: np.array([1.0, -0.5])))
    for a, b in zip(fem.div_forms(v, e), jfem.div_forms(v, e)):
        assert_sparse_identical(a, b)
    np.testing.assert_array_equal(fem.boundary_vertices_from_edges(e[:7, :2]),
                                  jfem.boundary_vertices_from_edges(e[:7, :2]))


def test_petsc_io_round_trips_with_jax(tmp_path, rng):
    A = sp.random(30, 20, density=0.2, random_state=1, format="csr")
    v = rng.randn(17)
    petsc_io.write_petsc_mat(str(tmp_path / "a"), A)
    jpetsc.write_petsc_mat(str(tmp_path / "ja"), A)
    petsc_io.write_petsc_vec(str(tmp_path / "v"), v)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "ja").read_bytes()
    assert_sparse_identical(jpetsc.read_petsc_mat(str(tmp_path / "a")), A)
    assert_sparse_identical(petsc_io.read_petsc_mat(str(tmp_path / "ja")), A)
    np.testing.assert_array_equal(jpetsc.read_petsc_vec(str(tmp_path / "v")), v)
    np.testing.assert_array_equal(petsc_io.read_petsc_vec(str(tmp_path / "v")), v)
    with pytest.raises(ValueError, match="not a PETSc binary Mat"):
        petsc_io.read_petsc_mat(str(tmp_path / "v"))


def cf_case(A, theta=0.56):
    """JAX's (CSR, is_coarse, c_rank, num_c) and the port's, of one matrix."""
    jin = cf_inputs(A, theta, jnp.float64)
    return jin, (CSR.from_scipy(A, dtype=F64, device="cpu"), t(jin[1]), t(jin[2]).long(), jin[3])


@pytest.mark.parametrize("source", ["init", "checkpoint"])
def test_cfnet_matches_jax(source):
    A = pinned_pressure_laplacian(jstokes.lid_driven_cavity(n=14, Re=10.0))
    jin, tin = cf_case(A)
    if source == "init":
        jnet = JCFNet(dims=(4, 4, 8), K=2)
        params = jnet.init(jax.random.PRNGKey(0), *jin)
        config = {"dims": [4, 4, 8], "K": 2, "row_normalize": True}
    else:
        ck = jload_checkpoint(CKPT)
        params, config = ck["best_params"], ck["extra"]["net_config"]
        jnet = JCFNet(dims=tuple(config["dims"]), K=config["K"],
                      row_normalize=config["row_normalize"])
    np_params = jax.tree.map(np.asarray, params)
    net = cfnet_from_params(np_params, config, device="cpu", dtype=F64)
    back = params_from_cfnet(net)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                    jax.tree.leaves(np_params)))
    Pj = jnet.apply(params, *jin)
    with torch.no_grad():
        Pt = net(*tin)
    np.testing.assert_array_equal(Pt.row.numpy(), np.asarray(Pj.row))
    np.testing.assert_array_equal(Pt.col.numpy(), np.asarray(Pj.col))
    np.testing.assert_allclose(Pt.data.numpy(), np.asarray(Pj.data), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(Pt.indptr.numpy(), np.asarray(Pj.indptr))
    assert float(np.abs(np.asarray(Pj.data)).max()) > 0


def pc_pair(kind, A):
    """(JAX, port) Schur preconditioners of kind sa / mlamg / net on A."""
    if kind == "sa":
        o = {"pyamg_alpha": 0.2}
        return (jdeploy.SAPreconditioner(A, jdeploy.Options(o), dtype=jnp.float64),
                deploy.SAPreconditioner(A, deploy.Options(o), dtype=F64, device="cpu"))
    o = dict(MLAMG, **({"mlamg_pnet_model": CKPT} if kind == "net" else {}))
    return (jdeploy.LearnedAMGPreconditioner(A, jdeploy.Options(o), dtype=jnp.float64),
            deploy.LearnedAMGPreconditioner(A, deploy.Options(o), dtype=F64, device="cpu"))


PC_MATRICES = {
    "cavity": lambda: jstokes.lid_driven_cavity(n=10, Re=100.0, dt=0.1).Ap,
    "cylinder": lambda: jcylflow.cylinder_flow_system(h=0.06, dt=0.1).Ap,
}


@pytest.mark.parametrize("flow", list(PC_MATRICES))
@pytest.mark.parametrize("kind", ["mlamg", "net", "sa"])
def test_amg_preconditioners_match_jax(rng, flow, kind):
    """Setup on the raw (singular) Laplacian; apply on the pinned one,
    where the fallback's P also carries the reference's column -1 (node 0
    is F before any C node)."""
    Ap = PC_MATRICES[flow]()
    jpc, tpc = pc_pair(kind, Ap)
    if kind == "sa":
        for a, b in zip(tpc.h.Ps, jpc.h.Ps):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(tpc.P.todense().numpy(), np.asarray(jpc.P.todense()),
                                   rtol=0, atol=1e-10)
        assert tpc.num_coarse == jpc.num_coarse
    jpc, tpc = pc_pair(kind, pinned_pressure_laplacian(type("S", (), {"Ap": Ap})))
    for _ in range(2):
        v = rng.randn(Ap.shape[0])
        want = np.asarray(jpc(jnp.asarray(v)))
        np.testing.assert_allclose(tpc(t(v)).numpy(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("name", ["cavity", "cylinder"])
def test_pcdr_matches_jax(rng, name):
    js, ts = system_pair(name)
    jpc = jdeploy.PCDRPreconditioner(js, dtype=jnp.float64)
    tpc = deploy.PCDRPreconditioner(ts, dtype=F64, device="cpu")
    assert (tpc.Rp_solver is not None) and tpc.Kp_solver.singular == (name == "cavity")
    v = rng.randn(ts.n_p)
    want = np.asarray(jpc(jnp.asarray(v)))
    np.testing.assert_allclose(tpc(t(v)).numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("case", ["pcdr", "pcdr-bs2", "net-pinned", "cylinder-pcdr"])
def test_fieldsplit_solve_matches_jax(case):
    js, ts = system_pair("cylinder" if case.startswith("cylinder") else "cavity")
    bs = 2 if case.endswith("bs2") else None
    if case == "net-pinned":
        jpc, tpc = pc_pair("net", pinned_pressure_laplacian(js))
    else:
        jpc = jdeploy.PCDRPreconditioner(js, dtype=jnp.float64)
        tpc = deploy.PCDRPreconditioner(ts, dtype=F64, device="cpu")
    jsol = jdeploy.SchurFieldsplitSolver(js, jpc, dtype=jnp.float64, momentum_bs=bs)
    tsol = deploy.SchurFieldsplitSolver(ts, tpc, dtype=F64, momentum_bs=bs, device="cpu")
    xj, hj, ij = jsol.solve(tol=1e-8)
    xt, ht, it = tsol.solve(tol=1e-8)
    assert it == int(ij) and it > 3
    xj, xt = np.array(xj), xt.numpy()
    if not case.startswith("cylinder"):
        # the enclosed flow fixes the pressure up to a constant, which the
        # Krylov coefficients set (with bs 2 they differ by 1.5e-6 there)
        for x in (xj, xt):
            x[ts.n_u:] -= x[ts.n_u:].mean()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9 * np.abs(xj).max())
    v = np.random.RandomState(3).randn(ts.n_u + ts.n_p)
    want = np.asarray(jsol.matvec(jnp.asarray(v)))  # BSR blocks pass through float32
    np.testing.assert_allclose(tsol.matvec(t(v)).numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    if not bs:
        np.testing.assert_allclose(want, ts.saddle_matrix() @ v, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def step_lines(lines):
    """[(iters, res)] from the printed ``step k: fgmres iters=.. res=..`` lines."""
    out = []
    for ln in lines:
        if ln.startswith("step "):
            parts = dict(p.split("=", 1) for p in ln.split() if "=" in p)
            out.append((int(parts["iters"]), float(parts["res"])))
    return out


@pytest.mark.parametrize("argv,res_rtol", [
    (["--n", "8", "--schur-pc", "pcdr"], 0.0),
    (["--problem", "cylinder", "--h", "0.06", "--schur-pc", "pcdr"], 0.0),
    # the coarse LUs of Ap are exactly singular: rounding moves the final
    # residual by up to ~0.5% (2.39e-06 against 2.38e-06)
    (["--n", "10", "--schur-pc", "sa"], 1e-2),
    (["--n", "8", "--schur-pc", "mlamg"], 1e-2),
    (["--n", "8", "--schur-pc", "mlamg", "--pnet-model", CKPT], 1e-2),
], ids=["cavity-pcdr", "cylinder-pcdr", "cavity-sa", "cavity-mlamg", "cavity-mlamg-net"])
def test_solve_ns_matches_jax_cli(capsys, argv, res_rtol):
    """SA runs at n 10: at n 8 (n_p 64 = min_coarse) build_hierarchy makes
    no level, and both packages' V-cycle then fails."""
    argv = argv + ["--steps", "2", "--float64"]
    jsolve_ns.main(argv + ["--platform", "cpu"])
    jlines = capsys.readouterr().out.splitlines()
    lines = []
    out = solve_ns.main(argv + ["--device", "cpu"], log=lines.append)
    assert lines[0] == jlines[0] and lines[-1] == jlines[-1] == "done"
    got, want = step_lines(lines), step_lines(jlines)
    assert len(got) == len(want) == 2
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, rg), (_, rw) in zip(got, want):
        if res_rtol:
            assert abs(rg - rw) <= res_rtol * rw, (rg, rw)
        else:  # the printed three digits agree
            assert f"{rg:.2e}" == f"{rw:.2e}"
    assert [s["iters"] for s in out["steps"]] == [g[0] for g in got]
    assert out["setup_s"]["fieldsplit_lu"] > 0


def test_cf_rank_matches_jax():
    from mlamg_tpu.models.cf_interp import cf_rank as jcf_rank

    mask = np.random.RandomState(0).rand(50) < 0.3
    for a, b in zip(cf_rank(mask), jcf_rank(mask)):
        np.testing.assert_array_equal(a, b)
