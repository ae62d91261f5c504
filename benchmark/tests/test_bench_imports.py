"""No module of the benchmark imports JAX, the JAX package or the
repository's earlier benchmarks; the references and data makers import
nothing of the measured package.  Top-level names are compared whole
(``mlamg_torch`` begins with ``mlamg_t`` but is not ``mlamg_tpu``)."""

import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mlamg_tpu", "bench", "bench_torch", "chip_smoke"}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_old_benchmarks():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not top_level_imports(f) & FORBIDDEN, f


def test_references_import_nothing_of_the_port():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert {f.name for f in files} >= {"poisson2d.py", "hull_fem.py", "sa_aggregation.py"}
    for f in files:
        assert "mlamg_torch" not in top_level_imports(f), f


def test_the_check_compares_whole_names():
    assert "mlamg_torch" not in FORBIDDEN and "mlamg_tpu" in FORBIDDEN


def test_a_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from harness import core

    monkeypatch.setitem(sys.modules, "mlamg_torch_extra", types.ModuleType("mlamg_torch_extra"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "mlamg_tpu.ops", types.ModuleType("mlamg_tpu.ops"))
    assert core.forbidden_modules() == ["jax", "mlamg_tpu"]
