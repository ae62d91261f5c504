"""The learned two-level evaluation as a whole: ``mlamg_torch``'s
``evaluate`` against the JAX package's functions per grid in float64, and
the port's float32 CLI against the committed results of the JAX CLI.

The JAX FullAggNet is run op by op: under ``jax.jit`` XLA's fusions round
differently, and the trained model amplifies rounding (see
``tests/test_torch_models.py``), so the jitted learned outputs are one
rounding realisation among others.  The committed results came from the
jitted JAX CLI: there the baselines match to the last digits and the three
learned means differ by up to 0.0044."""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.graph.lloyd import _lloyd_core as j_lloyd_core
from mlamg_tpu.graph.strength import strength_measure as j_strength
from mlamg_tpu.mg.interp import sa_interpolation_dense as j_sa_dense
from mlamg_tpu.models import FullAggNet as JFullAggNet
from mlamg_tpu.train import GridBundle as JBundle
from mlamg_tpu.train import SolveOptions as JOptions
from mlamg_tpu.train import lloyd_reference_conv as j_lloyd_conv
from mlamg_tpu.train import measured_conv as j_measured_conv
from mlamg_tpu.train import random_reference_conv as j_random_conv

from mlamg_torch.cli.common import dataset_bf_width, load_dataset_grids
from mlamg_torch.cli.evaluate_dataset import evaluate, load_model
from mlamg_torch.data.grid import Grid
from mlamg_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {"2d_iso": "runs_iso_r5", "2d_aniso": "runs_aniso_r5_c", "3d_iso": "runs_3d_iso_r5"}
METHODS = ("lloyd", "random", "ml", "ml_agg_only", "ml_int_only")


def family_grids(family):
    grids = Grid.load_dir(os.path.join(REPO, "data_out", family, "test"))
    return grids, sorted(grids, key=lambda g: g.n)


def jax_convs(family, grids, chosen):
    """Per-grid conv factors of the five methods through the JAX package's
    functions (float64), with the learned model run op by op."""
    ckpt = os.path.join(REPO, CHECKPOINTS[family], "grad_best.ckpt")
    _, config = load_model(ckpt, grids, device="cpu")
    with open(ckpt, "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f)["best_params"])
    net = JFullAggNet(**config)
    opts = JOptions(smoother="multicolor_gs")
    conv = jax.jit(lambda A, P, x0, c, nc: j_measured_conv(A, P, x0, opts, colors=c, num_colors=nc),
                   static_argnums=4)
    out = {m: [] for m in METHODS}
    for g in chosen:
        b = JBundle.from_grid(JGrid(g.A, g.x, g.extra), 0.1, jnp.float64)

        def c(P):
            return float(conv(b.A, P, b.x0, b.colors, b.num_colors))

        out["lloyd"].append(j_lloyd_conv(b, "olson", opts))
        out["random"].append(j_random_conv(b, opts=opts, strength_kind="olson"))
        agg, P, _, _, _ = net.apply(params, b.A, b.k)
        out["ml"].append(c(P))
        out["ml_agg_only"].append(c(j_sa_dense(b.A, agg, b.k)))
        seeds = jax.random.permutation(jax.random.PRNGKey(0), b.A.shape[0])[: b.k]
        lloyd_agg, _ = j_lloyd_core(j_strength(b.A, "olson", width=b.width),
                                    seeds.astype(jnp.int32), 10)
        out["ml_int_only"].append(c(net.apply(params, b.A, lloyd_agg, b.k, method="int_only")))
    return {m: np.asarray(v) for m, v in out.items()}


def check_slice_against_jax(family, rank):
    """All five methods on the ``rank``-th smallest test grid of
    ``family``, within 1e-8 of JAX."""
    grids, by_size = family_grids(family)
    chosen = [by_size[rank]]
    net, config = load_model(os.path.join(REPO, CHECKPOINTS[family], "grad_best.ckpt"), grids,
                             device="cpu", dtype=torch.float64)
    assert config["bf_width"] == (15 if family == "3d_iso" else 11)
    got, seconds = evaluate(chosen, net, ablations=True, device="cpu", dtype=torch.float64,
                            log=lambda *_: None)
    assert set(got) == set(METHODS) == set(seconds)
    want = jax_convs(family, grids, chosen)
    for m in METHODS:
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-8, err_msg=m)
        assert ((0 < got[m]) & (got[m] < 1)).all()


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_slice_matches_jax_per_grid_in_float64(rank):
    """The three smallest 2d_iso test grids (the other families:
    ``tests/test_torch_eval_families.py``)."""
    check_slice_against_jax("2d_iso", rank)


def test_cli_float32_reproduces_the_committed_results(tmp_path):
    """``python -m mlamg_torch.cli.evaluate_dataset`` on the 10 2d_iso test
    grids, in a process that never imports JAX, against the pkl the JAX
    CLI wrote: Lloyd and random per grid within 1e-6; the learned means
    within 0.005 of the jitted JAX realisation (0.0030-0.0044 apart), with
    ML still ahead of Lloyd."""
    code = (
        "import sys\n"
        "from mlamg_torch.cli import evaluate_dataset\n"
        "evaluate_dataset.main(sys.argv[1:])\n"
        "assert 'jax' not in sys.modules\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, "data_out/2d_iso/test", "--model", "runs_iso_r5/grad_best.ckpt",
         "--ablations", "true", "--device", "cpu", "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / "eval_test_alpha0.1.pkl", "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(REPO, "results/eval_2d_iso_test_rel/eval_test_alpha0.1.pkl"), "rb") as f:
        want = pickle.load(f)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    gaps = {m: np.abs(got[m] - want[m]) for m in METHODS}
    matched = {m: int((gaps[m] <= 1e-4).sum()) for m in METHODS}
    print("grids within 1e-4 of the committed pkl:", matched)
    print("largest per-grid gap:", {m: round(float(g.max()), 4) for m, g in gaps.items()})
    for m in ("lloyd", "random"):
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-6)
        assert matched[m] == 10
    for m in METHODS:
        assert abs(summary[m] - float(np.mean(want[m]))) <= (0.002 if m in ("lloyd", "random")
                                                            else 0.005), m
    assert summary["ml"] < summary["lloyd"]


def test_grid_files_round_trip_between_packages(tmp_path):
    """``.grid`` files: the port reads the JAX package's and writes files
    the JAX package reads."""
    import scipy.sparse as sp

    name = os.path.join(REPO, "data_out", "2d_aniso", "test", "anisotropic_0003.grid")
    gj, gt = JGrid.load(name), Grid.load(name)
    assert (gt.A != gj.A).nnz == 0 and gt.extra == gj.extra
    np.testing.assert_array_equal(gt.x, gj.x)
    assert gt.extra["filename"] == name
    gt.save(str(tmp_path / "copy"))
    back = JGrid.load(str(tmp_path / "copy.grid"))
    assert (back.A != gj.A).nnz == 0
    np.testing.assert_array_equal(back.x, gj.x)
    assert [g.n for g in Grid.load_dir(str(tmp_path))] == [gj.n]
    train, test = load_dataset_grids(os.path.join(REPO, "data_out", "2d_iso"))
    assert (len(train), len(test)) == (40, 10)
    assert sp.issparse(test[0].A)


def test_dataset_bf_width_matches_jax_and_rejects_asymmetric_patterns():
    from mlamg_tpu.cli.common import dataset_bf_width as j_width

    for family in CHECKPOINTS:
        grids, _ = family_grids(family)
        assert dataset_bf_width(grids) == j_width([JGrid(g.A) for g in grids])
    g = family_grids("2d_iso")[0][0]
    A = g.A.tolil()
    A[0, g.n - 1] = -1e-3  # one entry without its mirror
    with pytest.raises(ValueError, match="not symmetric"):
        dataset_bf_width([Grid(A.tocsr(), None, {"filename": "asym.grid"})])


def test_checkpoint_loader_reads_plain_numpy_trees():
    ck = load_checkpoint(os.path.join(REPO, "runs_3d_iso_r5", "grad_best.ckpt"))
    assert ck["extra"]["net_config"]["bf_width"] == 15
    leaves = jax.tree.leaves(ck["best_params"])
    assert leaves and all(isinstance(v, np.ndarray) for v in leaves)
