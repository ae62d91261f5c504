"""Rules of the port: ``mlamg_torch`` and ``chip_smoke.py`` import no JAX
and nothing of ``mlamg_tpu``; entry points run on CUDA unless the caller
asks for the CPU; ``chip_smoke.py`` fails where there is no card or no
repository around it."""

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
    files = sorted((REPO / "mlamg_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
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
