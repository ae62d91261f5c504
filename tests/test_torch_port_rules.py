"""Rules of the port: ``mlamg_torch``, ``chip_smoke.py`` and
``bench_torch.py`` import no JAX and nothing of ``mlamg_tpu`` (nor
``bench_torch.py`` anything of ``bench.py``); entry points run on CUDA
unless the caller asks for the CPU; ``chip_smoke.py`` and ``bench_torch.py``
fail where there is no card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mlamg_tpu")


def port_sources():
    files = (sorted((REPO / "mlamg_torch").rglob("*.py"))
             + [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
             + sorted((REPO / "examples_torch").glob("*.py")))
    assert len(files) > 15
    return files


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_nothing_of_mlamg_tpu():
    bad = {
        str(p.relative_to(REPO)): sorted(set(imported_roots(p)) & set(FORBIDDEN))
        for p in port_sources()
    }
    bad = {k: v for k, v in bad.items() if v}
    assert not bad, bad


def test_bench_torch_imports_nothing_of_bench_py():
    """bench_torch.py keeps its own copy of what it takes from bench.py."""
    roots = set(imported_roots(REPO / "bench_torch.py"))
    assert not roots & {"bench", *FORBIDDEN}, roots
    assert roots <= {"argparse", "json", "math", "subprocess", "sys", "time", "traceback",
                     "numpy", "scipy", "torch", "mlamg_torch", "__future__"}, roots


def test_bench_torch_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    assert '"metric"' not in out.stdout


def test_ast_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom mlamg_tpu.ops import sparse\ndef g():\n    import jax.numpy\n")
    assert set(imported_roots(f)) & set(FORBIDDEN) == {"jax", "mlamg_tpu"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from mlamg_torch import resolve_device
    from mlamg_torch.mg.amg_unstructured import build_unstructured_hierarchy
    from mlamg_torch.ops.sparse import CSR
    from mlamg_torch.ops.unstructured import WindowedELL

    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(50, 50), format="csr")
    for call in (lambda: build_unstructured_hierarchy(A),
                 lambda: WindowedELL.from_scipy(A),
                 lambda: CSR.from_scipy(A),
                 lambda: resolve_device(None),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    h, perm = build_unstructured_hierarchy(A, min_coarse=10, device="cpu")
    assert h.levels[0].Dinv.device.type == "cpu" and sorted(perm) == list(range(50))


def test_galerkin_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from mlamg_torch.mg.amg_unstructured import build_unstructured_hierarchy
    from mlamg_torch.mg.cycle import build_hierarchy
    from mlamg_torch.ops.dia import auto_format
    from mlamg_torch.ops.sparse import COO, CSR, ELL

    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(50, 50), format="csr")
    for call in (lambda: build_unstructured_hierarchy(A, rap_mode="device", min_coarse=10),
                 lambda: build_unstructured_hierarchy(A, rap_mode="device", setup_device="cpu",
                                                      min_coarse=10),
                 lambda: ELL.from_scipy(A),
                 lambda: COO.from_scipy(A),
                 lambda: auto_format(A)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    prof: dict = {}
    h, _ = build_unstructured_hierarchy(A, rap_mode="device", min_coarse=10, device="cpu",
                                        profile_out=prof)
    assert h.levels[0].A.device.type == "cpu" and prof["rap_branch"] == ["masked"]
    hs = build_hierarchy(CSR.from_scipy(A, device="cpu"), alpha=0.5, min_coarse=10,
                         sparse_levels=1)
    assert isinstance(hs.As[1], CSR) and hs.As[1].device.type == "cpu"


def test_structured_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from mlamg_torch.convert import hierarchy_from_numpy
    from mlamg_torch.mg.structured import build_structured_hierarchy
    from mlamg_torch.ops.dia import DIA

    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(16, 16))
    A = (sp.kron(sp.eye(16), T) + sp.kron(T, sp.eye(16))).tocsr()
    lev = {"data": np.ones((1, 4)), "offsets": (0,), "shape": (4, 4)}
    coarse = {"lu": np.eye(2), "piv": np.zeros(0), "singular": False, "method": "inverse"}
    for call in (lambda: DIA.from_scipy(A),
                 lambda: build_structured_hierarchy(DIA.from_scipy(A), 16, 16,
                                                    sides=(2,), min_coarse=4, kind="bilinear"),
                 lambda: hierarchy_from_numpy([lev], [{"ny": 2, "nx": 2}], [np.ones(4)],
                                              [1.0], coarse)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    h = build_structured_hierarchy(DIA.from_scipy(A, device="cpu"), 16, 16,
                                   sides=(2,), min_coarse=4, kind="bilinear")
    assert h.As[0].device.type == "cpu" and h.coarse.lu.shape == (64, 64)


def test_evaluation_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    import pickle

    from mlamg_torch.cli import evaluate_dataset
    from mlamg_torch.convert import fullaggnet_from_params
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.train import GridBundle

    g = Grid.load_dir(str(REPO / "data_out" / "2d_iso" / "test"))[2]
    with open(REPO / "runs_iso_r5" / "grad_best.ckpt", "rb") as f:
        ck = pickle.load(f)
    config = ck["extra"]["net_config"]
    argv = [str(REPO / "data_out" / "2d_iso" / "test"), "--model",
            str(REPO / "runs_iso_r5" / "grad_best.ckpt"), "--out", str(tmp_path)]
    for call in (lambda: GridBundle.from_grid(g, 0.1),
                 lambda: fullaggnet_from_params(ck["best_params"], config),
                 lambda: evaluate_dataset.main(argv)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    b = GridBundle.from_grid(g, 0.1, device="cpu")
    net = fullaggnet_from_params(ck["best_params"], config, device="cpu")
    assert b.A.device.type == "cpu" and next(net.parameters()).device.type == "cpu"
    summary = evaluate_dataset.main(argv + ["--device", "cpu"])
    assert summary["n_grids"] == 10 and 0 < summary["ml"] < 1
    assert (tmp_path / "eval_test_alpha0.1.pkl").exists()


def test_deploy_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from mlamg_torch.cli import solve_ns
    from mlamg_torch.data.stokes import lid_driven_cavity
    from mlamg_torch.deploy import (LearnedAMGPreconditioner, Options, PCDRPreconditioner,
                                    SAPreconditioner, SchurFieldsplitSolver)
    from mlamg_torch.mg.cycle import build_hierarchy
    from mlamg_torch.ops.bsr import BSR

    s = lid_driven_cavity(n=10, Re=100.0, dt=0.1)
    ckpt = str(REPO / "runs_cf_interp" / "cf_best.ckpt")
    for call in (lambda: PCDRPreconditioner(s),
                 lambda: SAPreconditioner(s.Ap),
                 lambda: LearnedAMGPreconditioner(s.Ap),
                 lambda: LearnedAMGPreconditioner(s.Ap, Options({"mlamg_pnet_model": ckpt})),
                 lambda: SchurFieldsplitSolver(s, lambda r: r),
                 lambda: BSR.from_scipy(s.F, 2),
                 lambda: solve_ns.main(["--n", "10", "--steps", "1"], log=lambda *_: None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from mlamg_torch.ops.sparse import CSR

    h = build_hierarchy(CSR.from_scipy(s.Ap, device="cpu"), alpha=0.2)
    assert h.As[0].device.type == "cpu" and h.coarse.lu.device.type == "cpu"
    out = solve_ns.main(["--n", "10", "--steps", "1", "--schur-pc", "mlamg", "--pnet-model", ckpt,
                         "--device", "cpu"], log=lambda *_: None)
    assert out["steps"][0]["iters"] > 0 and out["solver"].B.data.device.type == "cpu"


def test_training_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from mlamg_torch.cli import pretrain_dataset, train_dataset, train_gradient, train_one_sample
    from mlamg_torch.data.grid import Grid
    from mlamg_torch.train import make_buckets

    data = str(REPO / "data_out" / "2d_iso")
    grids = Grid.load_dir(str(REPO / "data_out" / "2d_iso" / "test"))[:2]
    for call in (lambda: pretrain_dataset.main([data, "--epochs", "1", "--limit", "1"]),
                 lambda: train_gradient.main([data, "--steps", "1", "--limit", "1"]),
                 lambda: train_dataset.main([data, "--max-generations", "1"]),
                 lambda: train_one_sample.main(["--n", "4", "--max-generations", "1"]),
                 lambda: make_buckets(grids, 0.1),
                 lambda: pretrain_dataset.build_targets(grids, 0.1, "olson")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    _, buckets = make_buckets(grids, 0.1, device="cpu")
    assert buckets[0].As[0].device.type == "cpu"


def run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_card():
    out = run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_launches_per_cycle_counts_the_w_cycle():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))

    class Lev:
        omegas = (0.6,)

    class H:
        levels = (Lev(),) * 4

    # 13 SpMVs per level visit at nu=4, visits 1+2+4+8 for a W-cycle
    assert chip_smoke.launches_per_cycle(H(), nu=4, gamma=2) == 13 * 15 == 195
    assert chip_smoke.launches_per_cycle(H(), nu=4, gamma=1) == 13 * 4
    assert np.isclose(chip_smoke.HBM_BYTES_PER_S, 3.35e12)


def test_structured_launch_counts_follow_the_hierarchy(monkeypatch):
    """chip_smoke's derived dia_spmv counts equal the SpMVs the structured
    path makes (counted here through the plain version on the CPU)."""
    from collections import Counter

    from mlamg_torch.mg.cycle import vcycle
    from mlamg_torch.mg.factored import BoxAgg2D, factored_sa
    from mlamg_torch.mg.structured import build_structured_hierarchy
    from mlamg_torch.ops import dia

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))

    calls = Counter()
    plain = dia.dia_spmv_reference

    def counted(*args, **kw):
        calls["spmv"] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(dia, "dia_spmv_reference", counted)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64))
    A = (sp.kron(sp.eye(64), T) + sp.kron(T, sp.eye(64))).tocsr()
    Ad = dia.DIA.from_scipy(A, device="cpu")
    for kw in (dict(sides=(2,) * 6, min_coarse=16, kind="bilinear"),
               dict(sides=(4, 2), min_coarse=8, smooth_steps=(2, 1), kind="sa")):
        calls.clear()
        h = build_structured_hierarchy(Ad, 64, 64, **kw)
        assert calls["spmv"] == chip_smoke.probe_launches(h) > 0
        calls.clear()
        x = torch.ones(64 * 64)
        vcycle(h, torch.zeros_like(x), x, nu=2, smoother="chebyshev")
        assert calls["spmv"] == chip_smoke.vcycle_launches(h, nu=2)
    # bilinear: 3 levels of 7; the SA levels add 2 per smoothing factor
    assert chip_smoke.vcycle_launches(h, nu=2) == (7 + 4) + (7 + 2)
    assert factored_sa(Ad, BoxAgg2D(64, 64, 4, 4), omega=0.6).smooth_steps == 1


# the one name the port's surfaces give otherwise: the JAX package's Pallas
# kernel entry ``well_spmv_pallas`` is the port's CUDA kernel entry
RENAMED = {"well_spmv_pallas": "well_spmv"}


def jax_surface():
    """{port module name: [(JAX name, port name, defining port module)]} from
    every ``mlamg_tpu/**/__init__.py``'s ``from mlamg_tpu... import`` lines,
    read by AST (nothing of the JAX package is imported)."""
    out = {}
    for init in sorted((REPO / "mlamg_tpu").rglob("__init__.py")):
        package = ".".join(init.relative_to(REPO).parent.parts).replace("mlamg_tpu", "mlamg_torch", 1)
        names = []
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("mlamg_tpu"):
                source = node.module.replace("mlamg_tpu", "mlamg_torch", 1)
                names += [(a.name, RENAMED.get(a.name, a.name), source) for a in node.names]
        out[package] = names
    return out


def test_port_surfaces_export_every_name_of_the_jax_packages():
    import importlib

    surface = jax_surface()
    assert {"mlamg_torch", "mlamg_torch.mg", "mlamg_torch.graph", "mlamg_torch.ops"} <= set(surface)
    counted = 0
    for package, names in surface.items():
        mod = importlib.import_module(package)
        for jax_name, name, source in names:
            assert hasattr(mod, name), f"{package} lacks {name} (JAX: {jax_name})"
            defining = importlib.import_module(source)
            # a submodule (``from mlamg_tpu.data import fem``) or a name of it
            want = (importlib.import_module(f"{source}.{name}") if not hasattr(defining, name)
                    else getattr(defining, name))
            assert getattr(mod, name) is want, f"{package}.{name} is not {source}.{name}"
            counted += 1
    assert counted >= 130
    assert sum(jax != port for names in surface.values() for jax, port, _ in names) == 1


def test_surface_imports_build_no_kernel_and_touch_no_card():
    """Importing every surface builds nothing and initialises no CUDA
    context (kernels build at their first launch)."""
    code = ("import torch, mlamg_torch, mlamg_torch.mg, mlamg_torch.graph, mlamg_torch.models, "
            "mlamg_torch.ops, mlamg_torch.utils, mlamg_torch.data, mlamg_torch.native, "
            "mlamg_torch.train, mlamg_torch.parallel, mlamg_torch.deploy, mlamg_torch.viz\n"
            "from mlamg_torch.ops import _build, segment\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not _build._LIBS, _build._LIBS\n"
            "from mlamg_torch.mg import twolevel_solve, vcycle_solve, pcg, fgmres\n"
            "from mlamg_torch.graph import lloyd_aggregation, LLOYD_DISTANCES\n"
            "from mlamg_torch.models import FullAggNet, amg_loss\n"
            "from mlamg_torch.ops import CSR, ELL, DIA, well_spmv\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_lloyd_distances_are_the_branches_of_lloyd_distance():
    from mlamg_torch.graph import LLOYD_DISTANCES, lloyd_distance
    from mlamg_torch.ops.sparse import CSR

    C = CSR.from_scipy(sp.diags([-1.0, 2.0, -0.5], [-1, 0, 1], shape=(6, 6), format="csr"),
                       device="cpu")
    assert LLOYD_DISTANCES == ("unit", "abs", "inv", "same", "sub")
    for d in LLOYD_DISTANCES:
        assert lloyd_distance(C, d).shape == C.shape
    with pytest.raises(ValueError, match="unrecognized distance"):
        lloyd_distance(C, "other")


EXAMPLES = sorted(p.stem for p in (REPO / "examples_torch").glob("*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_cuda_and_raise_without_it(name, no_cuda):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  REPO / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.parse_args([]).device is None and mod.parse_args([]).dtype == "float32"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
