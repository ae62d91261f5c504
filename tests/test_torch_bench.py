"""``bench_torch.py``, the port's counterpart of ``bench.py``: its seven
cells on the CPU at small sizes, parity with the JAX package on the cells'
own problems (the same numpy inputs), and its rules (bench.py's metric
names and byte count, no unknown card, a failed cell fails the run, the
port's device rule).

Tolerances: float64 throughout the parity tests.  The V-cycle
convergence factor 1e-10 relative (the cycles agree to ~1e-12,
``tests/test_torch_structured.py``); the Galerkin products 1e-10 relative
to the largest entry of A_H (their sums run in another order); the
FullAggNet forward op by op: scores, C and P 1e-10 relative, centers
and P's columns equal, agg_id equal but at exact Bellman-Ford ties.
"""

import ast
import importlib.util
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.mg import amg_unstructured as jamg
from mlamg_tpu.mg import cycle as jcycle
from mlamg_tpu.mg.interp import smoothed_aggregation as j_smoothed_aggregation
from mlamg_tpu.mg.structured import build_structured_hierarchy as j_build
from mlamg_tpu.models import FullAggNet as JFullAggNet
from mlamg_tpu.ops import matmul as jmm
from mlamg_tpu.ops.dia import DIA as JDIA
from mlamg_tpu.ops.sparse import CSR as JCSR

from mlamg_torch.data import Grid
from mlamg_torch.mg.structured import build_structured_hierarchy
from mlamg_torch.ops.dia import DIA

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64
PEAK = 1e15  # a rate for the CPU runs of the kernel cells (no card, no table entry)
RTOL = 1e-10
# bench.py's function of each cell
BENCH_FUNCTIONS = {"spmv": "main", "unstructured": "bench_unstructured",
                   "twolevel": "bench_twolevel", "vcycle_16m": "bench_vcycle_16m",
                   "unstructured_multilevel": "bench_unstructured_multilevel",
                   "rap": "bench_rap", "model_forward": "bench_model_forward"}


def load(name: str):
    """The repository-root script ``name``.py as a module."""
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bt = load("bench_torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The cells are many small tensor ops: under pytest's parallel
    workers, torch's default of one thread per core oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_py_functions():
    return {node.name: node for node in ast.parse((REPO / "bench.py").read_text()).body
            if isinstance(node, ast.FunctionDef)}


def bench_py_metrics() -> dict:
    """{bench.py function: (metric, unit)} from the dict literals that
    carry a literal ``"metric"`` (read by AST; bench.py is not run)."""
    out = {}
    for name, fn in bench_py_functions().items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                d = {k.value: v.value for k, v in zip(node.keys, node.values)
                     if isinstance(k, ast.Constant) and isinstance(v, ast.Constant)}
                if "metric" in d:
                    out[name] = (d["metric"], d["unit"])
    return out


@pytest.fixture(scope="module")
def hull():
    """A random hull of ~2k dofs (the 600k cell's generator, seed 7)."""
    return Grid.random_2d_unstructured(2000, seed=7).A.astype(np.float32)


SMALL = {
    "spmv": lambda hull: bt.bench_spmv(64, device="cpu", peak_bytes_per_s=PEAK),
    "unstructured": lambda hull: bt.bench_unstructured(hull, device="cpu", peak_bytes_per_s=PEAK),
    "twolevel": lambda hull: bt.bench_twolevel(64, 8, 8, samples=20, device="cpu"),
    "vcycle_16m": lambda hull: bt.bench_vcycle_16m(64, min_coarse=64, samples=20, device="cpu"),
    "unstructured_multilevel": lambda hull: bt.bench_unstructured_multilevel(
        hull, min_coarse=60, samples=20, device="cpu"),
    "rap": lambda hull: bt.bench_rap(32, samples=20, device="cpu"),
    "model_forward": lambda hull: bt.bench_model_forward(16, samples=20, device="cpu"),
}


@pytest.mark.parametrize("cell", bt.CELLS)
def test_cell_runs_on_the_cpu(cell, hull):
    """Each cell at a small size on the CPU: bench.py's metric and unit, a
    finite positive value, its check passed; the cycles' wall time as a
    median and a tail percentile with ten of 20 samples beyond it, no
    device time (the CPU has none) and no kernel launch."""
    res = SMALL[cell](hull)
    assert (res["metric"], res["unit"]) == bench_py_metrics()[BENCH_FUNCTIONS[cell]]
    assert np.isfinite(res["value"]) and res["value"] > 0
    check = res["check"]
    if cell == "rap":
        assert check["rel_err_masked"] <= check["rtol_masked"] == 1e-5
        assert check["rel_err_fused"] <= check["rtol_fused"] == 2e-5
    elif "rtol" in check:
        assert check["rel_err"] <= check["rtol"] == 1e-5
    elif "below" in check:
        assert np.isfinite(check["conv_factor"]) and check["conv_factor"] < check["below"]
    else:
        assert check and all(check.values())
    if cell not in ("spmv", "unstructured"):
        assert res["samples"] == 20 and res["tail_pct"] == 50
        assert 0 < res["wall_ms"] <= res["wall_tail_ms"]
        assert res["device_ms"] is None and res["idle"] is None
    assert res["launches"] == {"dia_spmv": 0, "well_spmv": 0}


def test_metric_names_and_units_are_bench_pys():
    want = bench_py_metrics()
    assert {cell: want[fn] for cell, fn in BENCH_FUNCTIONS.items()} == bt.METRICS
    assert bt.CELLS[0] == "spmv" and len(bt.CELLS) == 7


def test_vcycle_conv_factor_matches_jax():
    """Cell 4's 6-cycle factor (bench.py's formula) on a 64^2 bilinear
    hierarchy, float64, against the same cycles of the JAX package."""
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64))
    A = (sp.kron(sp.eye(64), T) + sp.kron(T, sp.eye(64))).tocsr()
    kw = dict(sides=(2,) * 7, min_coarse=64, kind="bilinear")
    hj = j_build(JDIA.from_scipy(A, dtype=jnp.float64), 64, 64, block=False, **kw)
    ht = build_structured_hierarchy(DIA.from_scipy(A, dtype=F64, device="cpu"), 64, 64, **kw)
    x0 = np.random.RandomState(0).randn(64 * 64)
    conv, norms = bt.vcycle_conv(ht, torch.zeros(64 * 64, dtype=F64), torch.from_numpy(x0),
                                 **bt.VCYCLE)
    step = jax.jit(partial(jcycle.vcycle, **bt.VCYCLE))
    x, jnorms = jnp.asarray(x0), []
    for _ in range(6):
        x = step(hj, jnp.zeros(64 * 64), x)
        jnorms.append(float(jnp.linalg.norm(x)))
    jconv = (jnorms[-1] / jnorms[1]) ** (1.0 / 4)
    np.testing.assert_allclose(norms, jnorms, rtol=RTOL)
    assert abs(conv - jconv) <= RTOL * jconv and 0 < conv < 1


@pytest.fixture(scope="module")
def rap32():
    """Cell 6's operands at 32^2 in float64: the port's and the JAX
    package's, from the same numpy aggregates."""
    ops = bt.rap_operands(32, device="cpu", dtype=F64)
    A, agg, k = ops["A"], ops["agg"], ops["k"]
    Aj = JCSR.from_scipy(A, dtype=jnp.float64)
    Pj = j_smoothed_aggregation(Aj, jnp.asarray(agg), k)
    _, APpat, AHpat = jamg.galerkin_patterns(A, agg, k)
    return ops, dict(Aj=Aj, Pj=Pj, APp=JCSR.from_scipy(APpat, dtype=jnp.float64),
                     AHp=JCSR.from_scipy(AHpat, dtype=jnp.float64))


@pytest.mark.parametrize("product", ["fused", "masked"])
def test_rap_products_match_jax(rap32, product):
    """rap_fused (nnz_out 4 nnz_pad, p_width 5) and rap_masked (bench.py's
    four widths) against mlamg_tpu's on the same A, aggregates and SA P."""
    ops, j = rap32
    got, overflow = bt.rap_products(ops)[product]()
    if product == "fused":
        want, j_overflow = jmm.rap_fused(j["Aj"], j["Pj"], k=ops["k"],
                                         nnz_out=4 * j["Aj"].nnz_pad, p_width=5,
                                         return_overflow=True)
        assert not bool(overflow) and not bool(j_overflow)
    else:
        want = jamg.rap_masked(j["Aj"], j["Pj"], j["APp"], j["AHp"], **ops["widths"])
    got, want = got.to_scipy(), want.to_scipy()
    assert got.shape == want.shape == (ops["k"], ops["k"])
    assert abs(got - want).max() <= RTOL * abs(want).max()


def test_forward_from_flax_init_matches_jax():
    """Cell 7's FullAggNet with init_flax_(PRNGKey(0)) against flax's
    FullAggNet.init(PRNGKey(0)) (on float32 A, as bench.py) and apply op
    by op, in float64 on the 16^2 grid.  Scores, C and the centers agree;
    the first stage that differs is agg_id, and only where rounding sets
    it: on this symmetric grid the untrained CNet's edge weights leave
    nodes at exactly equal path lengths from two centers (13 of 256 nodes,
    e.g. node 58 at 4.603685100904359 from centers 10 and 25 in both), so
    the last bits of C (5.8e-16 apart) pick the Bellman-Ford winner.  P
    from the same agg_id agrees to the last bits."""
    from scipy.sparse.csgraph import dijkstra

    net, At, k = bt.forward_model(16, device="cpu", dtype=F64)
    A = JGrid.structured_2d_poisson_dirichlet(16, 16).A.tocsr()
    np.testing.assert_array_equal(At.to_scipy().toarray(), A.toarray())
    width = int(np.max(np.diff(A.indptr)))
    jnet = JFullAggNet(dim=8, num_conv=2, iterations=2, bf_width=width)
    params = jnet.init(jax.random.PRNGKey(0), JCSR.from_scipy(A, dtype=jnp.float32), k)
    Aj = JCSR.from_scipy(A, dtype=jnp.float64)
    with torch.no_grad():
        agg_t, P_t, C_t, cen_t, _ = net(At, k)
        _, scores_t = net.AggNetM(net.basic_graph(At), k)
    agg_j, P_j, C_j, cen_j, _ = jnet.apply(params, Aj, k)
    _, scores_j = jnet.apply(params, jnet.basic_graph(Aj), k,
                             method=lambda m, g, k: m.AggNetM(g, k))
    for name, got, want in (("scores", scores_t, scores_j), ("C", C_t.data, C_j.data)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max(), name
    np.testing.assert_array_equal(cen_t.numpy(), np.asarray(cen_j))
    assert all(bt.check_forward((agg_t, P_t, C_t, cen_t, None), At, k).values())
    agg_t, agg_j = agg_t.numpy(), np.asarray(agg_j)
    differ = np.flatnonzero(agg_t != agg_j)
    dist = dijkstra(C_t.to_scipy(), directed=True, indices=cen_t.numpy())  # (k, n)
    ties = np.abs(dist[agg_t[differ], differ] - dist[agg_j[differ], differ])
    print(f"agg_id differs at {differ.size} of {agg_t.size} nodes, each an exact Bellman-Ford "
          f"tie (largest gap {ties.max(initial=0.0)}); e.g. {differ[:1]}: "
          f"{dist[agg_t[differ[:1]], differ[:1]]} from {agg_t[differ[:1]]} (port), "
          f"{dist[agg_j[differ[:1]], differ[:1]]} from {agg_j[differ[:1]]} (JAX)")
    assert differ.size <= 0.1 * agg_t.size
    assert np.all(ties <= RTOL * dist[agg_j[differ], differ])
    with torch.no_grad():
        P_same = net.int_only(At, torch.from_numpy(agg_j), k)
    np.testing.assert_array_equal(P_same.col.numpy(), np.asarray(P_j.col))
    want = np.asarray(P_j.data)
    assert np.abs(P_same.data.numpy() - want).max() <= RTOL * np.abs(want).max()


def fake_timed(offsets):
    """A deterministic ``timed``: 1 ms per iteration plus the next offset."""
    it = iter(offsets)
    return lambda k: 1e-3 * k + next(it)


@pytest.mark.parametrize("offsets", [
    [0.0, 0.004, 0.001, 0.0, 0.002, 0.003, 0.0, 0.0],     # agree within 5% after three
    [0.0, 0.0, 0.09, 0.0, 0.0, 0.01, 0.03, 0.0],          # one negative slope dropped
])
def test_slope_equals_bench_pys(offsets):
    bench = load("bench")
    assert bt.slope(fake_timed(offsets), 10, 60) == bench.slope(fake_timed(offsets), 10, 60)
    with pytest.raises(RuntimeError, match="non-positive"):
        bt.slope(lambda k: -k, 10, 60)
    with pytest.raises(RuntimeError, match="non-positive"):
        bench.slope(lambda k: -k, 10, 60)


def test_headline_bytes_are_bench_pys():
    """bench.py's ``bytes_per_it`` expression (line 541), evaluated on D
    and n, against bench_torch.dia_bytes."""
    main = bench_py_functions()["main"]
    expr = next(node.value for node in ast.walk(main) if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "bytes_per_it")
    code = compile(ast.Expression(expr), "bench.py", "eval")
    for D, n in ((5, 4096 ** 2), (9, 1000), (1, 7)):
        assert bt.dia_bytes(D, n) == eval(code, {"D": D, "n": n})
    assert bt.dia_bytes(5, 4096 ** 2) == 469_762_048


def test_unknown_card_raises():
    assert bt.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "cpu"):
        with pytest.raises(ValueError, match="no HBM rate"):
            bt.hbm_bytes_per_s(name)
    with pytest.raises(ValueError, match="no HBM rate"):
        bt.bench_spmv(16, device="cpu")  # the CPU has no HBM rate, and none is given


def test_tail_percentile_leaves_ten_samples_beyond():
    for n in (20, 30, 57, 100, 1000):
        p = bt.tail_percentile(n)
        assert n * (100 - p) / 100 >= 10 and n * (100 - (p + 1)) / 100 < 10
    assert (bt.tail_percentile(20), bt.tail_percentile(100)) == (50, 90)
    with pytest.raises(ValueError):
        bt.tail_percentile(19)


@pytest.fixture
def fake_cells(monkeypatch):
    """Every cell replaced by one that returns its metric at once; the
    shared operators by small stand-ins."""
    fns = {"spmv": "bench_spmv", "unstructured": "bench_unstructured",
           "twolevel": "bench_twolevel", "vcycle_16m": "bench_vcycle_16m",
           "unstructured_multilevel": "bench_unstructured_multilevel",
           "rap": "bench_rap", "model_forward": "bench_model_forward"}
    for cell, fn in fns.items():
        monkeypatch.setattr(bt, fn, lambda *a, _cell=cell, **kw: bt._cell(_cell, 1.5))
    monkeypatch.setattr(bt, "poisson2d", lambda nx: sp.eye(4, format="csr"))
    monkeypatch.setattr(bt, "hull600k", lambda: sp.eye(4, format="csr"))
    return fns


def test_main_prints_bench_pys_last_line(fake_cells, capsys):
    out = bt.main(["--device", "cpu", "--samples", "20"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out
    assert (out["metric"], out["unit"]) == bt.METRICS["spmv"] and out["value"] == 1.5
    assert [m["metric"] for m in out["detail"]["extra_metrics"]] == [
        bt.METRICS[c][0] for c in bt.CELLS[1:]]


def test_a_failed_cell_exits_non_zero(fake_cells, monkeypatch, capsys):
    def boom(*a, **kw):
        raise RuntimeError("A_H differs from scipy's")

    monkeypatch.setattr(bt, "bench_rap", boom)
    with pytest.raises(SystemExit) as exc:
        bt.main(["--device", "cpu", "--samples", "20"])
    assert exc.value.code not in (0, None)
    captured = capsys.readouterr()
    assert "extra_metrics" not in captured.out and "A_H differs" in captured.err
    # a cell whose value is not a finite positive number fails too
    monkeypatch.setattr(bt, "bench_rap", lambda *a, **kw: bt._cell("rap", float("nan")))
    with pytest.raises(SystemExit):
        bt.main(["--device", "cpu", "--samples", "20", "--cells", "rap"])


def test_main_needs_cuda_unless_asked_for_the_cpu(fake_cells, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.main([])
    out = bt.main(["--device", "cpu", "--cells", "twolevel", "--samples", "20"])
    assert out["metric"] == "twolevel_cycle_ms" and out["detail"]["extra_metrics"] == []


@pytest.mark.parametrize("cell", ["bench_twolevel", "bench_rap", "bench_model_forward"])
def test_cells_need_cuda_unless_asked_for_the_cpu(cell, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(bt, cell)(16, samples=20)
