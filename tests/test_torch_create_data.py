"""Port parity, the dataset generator: every problem generator of
``mlamg_torch.data.grid`` against ``mlamg_tpu.data.grid`` bit for bit (both
are numpy and scipy), the bz2 pickle files read across packages, and
``mlamg_torch.cli.create_data`` writing the committed datasets byte for
byte (``data_out/2d_iso``, ``data_out/2d_aniso``, ``data_out/3d_iso`` from
the recipes of ``scripts/repro_*.sh``) and the JAX CLI's bytes for every
``--type``.
"""

import filecmp
import os
from pathlib import Path

import numpy as np
import pytest

from mlamg_tpu.cli import create_data as j_create_data
from mlamg_tpu.data import fem as jfem
from mlamg_tpu.data import grid as jgrid

from mlamg_torch.cli import create_data
from mlamg_torch.data import fem, grid

REPO = Path(__file__).resolve().parents[1]

# the recipes behind the committed datasets (scripts/repro_iso_r5.sh:10,
# scripts/repro_aniso_r5.sh:12, scripts/repro_3d_iso_r5.sh:11)
COMMITTED = {
    "2d_iso": ["--n-grids", "50", "--type", "isotropic", "--dof-min", "64", "--dof-max", "250",
               "--split", "0.2", "--seed", "7"],
    "2d_aniso": ["--n-grids", "50", "--type", "anisotropic", "--dof-min", "64", "--dof-max",
                 "250", "--split", "0.2", "--seed", "11"],
    "3d_iso": ["--n-grids", "40", "--type", "3d", "--split", "0.25", "--seed", "21"],
}


def assert_grids_equal(a, b):
    assert a.A.shape == b.A.shape
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a.A, name), getattr(b.A, name), err_msg=name)
        assert getattr(a.A, name).dtype == getattr(b.A, name).dtype
    np.testing.assert_array_equal(a.x, b.x)
    assert a.extra.keys() == b.extra.keys()
    for k in a.extra:
        np.testing.assert_array_equal(a.extra[k], b.extra[k], err_msg=k)


JUMPS = np.array([[0.2, 0.3, 10.0], [0.7, 0.6, 0.01], [0.5, 0.9, 1.0]])
ROT = (0.3, -1.1, 2.0)

GENERATORS = {
    "1d_neumann": lambda G: G.structured_1d_poisson_neumann(9),
    "2d_neumann": lambda G: G.structured_2d_poisson_neumann(6, 5, 0.01, 0.7),
    "2d_jumps": lambda G: G.structured_2d_poisson_dirichlet_jumps(7, 6, JUMPS),
    "tet_3d_iso": lambda G: G.tet_3d_laplace_dirichlet(3, 4, 3, seed=11),
    "tet_3d_aniso": lambda G: G.tet_3d_laplace_dirichlet(
        4, 3, 3, epsilon=[1e-2, 10.0, 1.0], R=jgrid.rotation_matrix_3d(*ROT), jitter=0.2, seed=5),
    "fd_3d_aniso": lambda G: G.structured_3d_laplace_dirichlet(
        4, 3, 5, epsilon=[1e-2, 10.0, 1.0], R=jgrid.rotation_matrix_3d(*ROT)),
    "fd_3d_iso": lambda G: G.structured_3d_laplace_dirichlet(3, 3, 3),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_is_jax_bit_for_bit(name):
    assert_grids_equal(GENERATORS[name](grid.Grid), GENERATORS[name](jgrid.Grid))


def test_rotation_and_jump_kappa_are_jax_bit_for_bit():
    np.testing.assert_array_equal(grid.rotation_matrix_3d(*ROT), jgrid.rotation_matrix_3d(*ROT))
    kp, kj = fem.jump_kappa(JUMPS), jfem.jump_kappa(JUMPS)
    for x, y in np.random.RandomState(0).rand(20, 2):
        assert kp(x, y) == kj(x, y)
    assert kp(0.21, 0.29) == 10.0 and kp(0.69, 0.61) == 0.01


def test_grid_files_are_read_across_packages(tmp_path):
    g = grid.Grid.tet_3d_laplace_dirichlet(3, 3, 3, seed=2)
    g.save(str(tmp_path / "ours"))
    jgrid.Grid.tet_3d_laplace_dirichlet(3, 3, 3, seed=2).save(str(tmp_path / "theirs"))
    assert filecmp.cmp(tmp_path / "ours.grid", tmp_path / "theirs.grid", shallow=False)
    back = jgrid.Grid.load(str(tmp_path / "ours"))
    assert back.extra.pop("filename").endswith("ours.grid")
    assert_grids_equal(back, g)
    obj = {"a": np.arange(3), "b": "x"}
    grid.pickle_save_bz2(str(tmp_path / "p.bz2"), obj)
    assert jgrid.pickle_load_bz2(str(tmp_path / "p.bz2")).keys() == obj.keys()
    jgrid.pickle_save_bz2(str(tmp_path / "q.bz2"), obj)
    np.testing.assert_array_equal(grid.pickle_load_bz2(str(tmp_path / "q.bz2"))["a"], obj["a"])


def tree_files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.grid"))


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_create_data_regenerates_the_committed_dataset_byte_for_byte(tmp_path, name):
    out = tmp_path / name
    written = create_data.main([str(out), *COMMITTED[name], "--device", "cpu"],
                               log=lambda *_: None)
    want = REPO / "data_out" / name
    files = tree_files(want)
    assert tree_files(out) == files and len(written) == len(files) > 0
    differ = [f for f in files if not filecmp.cmp(out / f, want / f, shallow=False)]
    assert not differ, differ


@pytest.mark.parametrize("kind", ["jump", "structured", "3d_aniso"])
def test_create_data_writes_the_jax_clis_bytes(tmp_path, kind):
    argv = ["--n-grids", "3", "--type", kind, "--dof", "40", "--seed", "3", "--split", "0.34"]
    create_data.main([str(tmp_path / "ours"), *argv, "--device", "cpu"], log=lambda *_: None)
    j_create_data.main([str(tmp_path / "theirs"), *argv])
    files = tree_files(tmp_path / "theirs")
    assert tree_files(tmp_path / "ours") == files and len(files) == 3
    assert all(filecmp.cmp(tmp_path / "ours" / f, tmp_path / "theirs" / f, shallow=False)
               for f in files)
    assert os.listdir(tmp_path / "ours") == os.listdir(tmp_path / "theirs")
