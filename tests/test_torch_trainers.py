"""Port parity, the remaining trainers and tools: ``train_cf_interp``
(losses, weights and checkpoints across packages), ``train_convergence``
(the labelled samples and their cache), ``evaluate_model`` and
``optimize_grid_param``, ``mlamg_torch`` against ``mlamg_tpu`` (CPU); and
the device rule of the new entry points.

Tolerances: ``train_cf_interp`` runs in float64 with float32 weights, so
its first loss equals the committed JSON's within 1e-9 and the port's
steps follow JAX's jitted ones within 1e-12; the sample features within
1e-6 and the labels within ``EVAL_CPU_TOL`` (1e-4, the two-level solve's
float32 rounding spread, ``scripts/eval_cpu_spread.py``); the printed
convs of the two CLIs alike to their four printed decimals.
"""

import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_torch.cli import (create_data, evaluate_model, optimize_grid_param, train_cf_interp,
                             train_convergence)
from mlamg_torch.data.grid import Grid

REPO = Path(__file__).resolve().parents[1]
CF_JSON = REPO / "runs_cf_interp" / "cf_interp.json"
CF_CKPT = REPO / "runs_cf_interp" / "cf_best.ckpt"
TEST_DIR = REPO / "data_out" / "2d_iso" / "test"
SMALL_GRIDS = ("isotropic_0005.grid", "isotropic_0002.grid")  # n 80 and 85
EVAL_CPU_TOL = 1e-4
FIRST_LOSS_RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one torch thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(*_):
    pass


# ---- train_cf_interp ---------------------------------------------------------

@pytest.fixture(scope="module")
def cf_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cf")
    argv = ["--train-sizes", "8", "--epochs", "2", "--eval-sizes", "8", "--eval-rhs-seeds", "1",
            "--eval-size", "8", "--device", "cpu", "--checkpoint", str(tmp / "cf.ckpt"),
            "--out", str(tmp / "cf.json")]
    record: dict = {}
    result = train_cf_interp.main(argv, log=quiet, record=record)
    return result, tmp, record


def test_train_cf_interp_first_loss_equals_the_committed_json(cf_run):
    result, tmp, record = cf_run
    want = json.loads(CF_JSON.read_text())
    got = result["train_loss_first_epoch"][0]
    assert abs(got - want["train_loss_first_epoch"][0]) <= FIRST_LOSS_RTOL * abs(got)
    assert json.loads((tmp / "cf.json").read_text()).keys() == want.keys()
    assert len(record["seconds_per_epoch"]) == 2
    assert result["pressure_solves"][0]["fgmres_learned_mean"] > 0


def test_cf_checkpoints_deploy_in_both_packages(cf_run):
    """The port's checkpoint in the JAX package's LearnedAMGPreconditioner,
    and the committed JAX one in the port's: the same P (1e-12)."""
    from mlamg_tpu.cli.train_cf_interp import pinned_pressure_laplacian
    from mlamg_tpu.data.stokes import lid_driven_cavity
    from mlamg_tpu.deploy import LearnedAMGPreconditioner as JPC
    from mlamg_tpu.deploy import Options as JOptions

    from mlamg_torch.deploy import LearnedAMGPreconditioner, Options

    _, tmp, _ = cf_run
    with open(tmp / "cf.ckpt", "rb") as f:
        ck = pickle.load(f)
    assert ck["extra"]["net_config"] == {"dims": [8, 8, 16], "K": 3, "row_normalize": True}
    A = pinned_pressure_laplacian(lid_driven_cavity(n=10, Re=10.0))
    for ckpt in (tmp / "cf.ckpt", CF_CKPT):
        want = JPC(A, JOptions({"mlamg_pnet_model": str(ckpt)}), dtype=jnp.float64).P
        got = LearnedAMGPreconditioner(A, Options({"mlamg_pnet_model": str(ckpt)}),
                                       dtype=torch.float64, device="cpu").P
        W, G = np.asarray(want.todense()), got.todense().numpy()
        assert np.abs(G - W).max() <= 1e-12 * np.abs(W).max()


def test_cf_training_follows_jax_step_for_step():
    """Three Adam steps (one per training operator) of the port against the
    JAX CLI's jitted step: the losses within 1e-12, and every weight equal
    but those whose gradient is rounding noise (the biases that instance
    norms and the score standardisation cancel, |g| < 1e-12)."""
    import optax
    from functools import partial

    from mlamg_tpu.cli.train_cf_interp import cf_inputs as j_cf_inputs
    from mlamg_tpu.cli.train_cf_interp import pinned_pressure_laplacian
    from mlamg_tpu.data.stokes import lid_driven_cavity
    from mlamg_tpu.models.cf_interp import CFInterpolationNetwork as JCF
    from mlamg_tpu.models.loss import amg_loss as j_amg_loss

    from mlamg_torch.convert import params_from_cfnet

    run = train_cf_interp.prepare(train_cf_interp.parse_args(["--device", "cpu"]))
    jnet = JCF(dims=(8, 8, 16), K=3)
    ops = [j_cf_inputs(pinned_pressure_laplacian(lid_driven_cavity(n=n, Re=10.0)), 0.56,
                       jnp.float64) for n in (8, 10, 12)]
    params = jnet.init(jax.random.PRNGKey(0), *ops[0])
    tx = optax.adam(3e-3)
    state = tx.init(params)

    @partial(jax.jit, static_argnames=("num_c",))
    def step(params, state, Ac, is_c, c_rank, tv, num_c):
        loss, grads = jax.value_and_grad(
            lambda p: j_amg_loss(jnet.apply(p, Ac, is_c, c_rank, num_c), Ac, tv))(params)
        updates, state = tx.update(grads, state)
        return optax.apply_updates(params, updates), state, loss, grads

    noise = jax.tree.map(lambda p: np.zeros(p.shape, bool), params)
    for i, (Ac, is_c, c_rank, num_c) in enumerate(ops):
        tv = jnp.asarray(run.train[i][4].numpy())
        params, state, want, grads = step(params, state, Ac, is_c, c_rank, tv, num_c)
        got = run.step(i)
        assert abs(got - float(want)) <= 1e-12 * abs(float(want)), i
        noise = jax.tree.map(lambda m, g: m | (np.abs(np.asarray(g)) < 1e-12), noise, grads)
    ours = params_from_cfnet(run.net)
    for (path, w), g, m in zip(jax.tree_util.tree_leaves_with_path(params),
                               jax.tree.leaves(ours), jax.tree.leaves(noise)):
        np.testing.assert_array_equal(g[~m], np.asarray(w)[~m], err_msg=str(path))


# ---- train_convergence --------------------------------------------------------

@pytest.fixture(scope="module")
def sample_runs():
    """build_samples on the two smallest 2d_iso test grids, 3 splittings
    each (one per regime), in both packages."""
    from mlamg_tpu.cli.train_convergence import build_samples as j_build_samples
    from mlamg_tpu.data import Grid as JGrid

    grids = [Grid.load(str(TEST_DIR / f)) for f in SMALL_GRIDS]
    aggs: list = []
    ours = train_convergence.build_samples(grids, 0.1, 3, seed=0, device="cpu", aggs=aggs)
    theirs = j_build_samples([JGrid.load(str(TEST_DIR / f)) for f in SMALL_GRIDS], 0.1, 3, seed=0)
    return ours, theirs, aggs


def test_build_samples_match_jax(sample_runs):
    ours, theirs, aggs = sample_runs
    assert len(ours) == len(theirs) == len(aggs) == 6
    for (A, f, label), (jA, jf, jlabel) in zip(ours, theirs):
        assert (A.to_scipy() != jA.to_scipy()).nnz == 0
        f, jf = f.numpy(), np.asarray(jf)
        assert f.shape == jf.shape == (A.shape[0], 8) and f.dtype == np.float32
        assert np.abs(f - jf).max() <= 1e-6
        assert abs(label - float(jlabel)) <= EVAL_CPU_TOL
    assert len({round(s[2], 3) for s in ours}) > 3  # the regimes span a range of convs


def test_sample_caches_are_read_across_packages(sample_runs, tmp_path):
    """The npz cache: the port's file read as the JAX CLI reads one, and a
    file written as the JAX CLI writes one read by the port."""
    from mlamg_tpu.ops import CSR as JCSR

    ours, theirs, _ = sample_runs
    train_convergence.save_samples(str(tmp_path / "ours.npz"), ours)
    raw = np.load(tmp_path / "ours.npz", allow_pickle=True)["samples"]
    for rec, (A, f, label) in zip(raw, ours):
        A_sp, feats, lab = rec  # the JAX CLI's loop
        assert (JCSR.from_scipy(sp.csr_matrix(A_sp)).to_scipy() != A.to_scipy()).nnz == 0
        np.testing.assert_array_equal(np.asarray(jnp.asarray(feats)), f.numpy())
        assert float(lab) == label
    jraw = np.asarray([(s0.to_scipy().tocsr(), np.asarray(f), l) for s0, f, l in theirs],
                      dtype=object)  # the JAX CLI's writer
    np.savez(tmp_path / "theirs.npz", samples=jraw)
    back = train_convergence.load_samples(str(tmp_path / "theirs.npz"), "cpu")
    for (A, f, label), (jA, jf, jlabel) in zip(back, theirs):
        assert (A.to_scipy() != jA.to_scipy()).nnz == 0
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        assert label == float(jlabel)


def test_train_convergence_runs_from_its_cache(sample_runs, tmp_path):
    """main from a cache of the samples: a second run from the same cache
    gives the same metrics, and the checkpoint holds the JAX package's
    parameter tree."""
    ours, _, _ = sample_runs
    cache = str(tmp_path / "c.npz")
    train_convergence.save_samples(cache, ours)
    argv = [str(TEST_DIR), "--epochs", "5", "--dims", "4", "4", "--K", "2", "--test-frac", "0.34",
            "--cache-samples", cache, "--device", "cpu", "--checkpoint", str(tmp_path / "m.ckpt")]
    record: dict = {}
    a = train_convergence.main(argv, log=quiet, record=record)
    b = train_convergence.main(argv, log=quiet)
    # (json: the correlations of two samples are NaN, which never equals itself)
    assert json.dumps(a) == json.dumps(b) and (a["n_train"], a["n_val"], a["n_test"]) == (2, 2, 2)
    assert len(record["train_mse"]) == 5 and np.isfinite(record["train_mse"]).all()
    assert record["aggs"] == [] and len(record["labels"]) == 6  # loaded, not built
    with open(tmp_path / "m.ckpt", "rb") as f:
        tree = pickle.load(f)["best_params"]["params"]
    assert sorted(tree) == ["Dense_0", "Dense_1", "tag_0", "tag_1"]


# ---- evaluate_model and optimize_grid_param ---------------------------------

def test_evaluate_model_prints_the_jax_clis_lines(capsys, tmp_path):
    from mlamg_tpu.cli import evaluate_model as j_evaluate_model

    argv = [str(TEST_DIR / SMALL_GRIDS[0]), "--model", str(REPO / "runs_iso_r5" / "grad_best.ckpt")]
    j_evaluate_model.main(argv)
    want = capsys.readouterr().out.splitlines()
    lines: list = []
    out = evaluate_model.main(argv + ["--device", "cpu"], log=lines.append)
    assert lines == want
    assert out["connected"] is True and out["sizes"].sum() == out["n"]
    png = tmp_path / "em.png"
    again = evaluate_model.main(argv + ["--device", "cpu", "--plot", str(png)], log=lines.append)
    assert lines[len(want):] == want + [f"wrote {png}"] and png.stat().st_size > 1000
    assert again["ml_conv"] == out["ml_conv"]


def test_optimize_grid_param_matches_jax_and_never_worsens(capsys):
    """Generation 0 against the JAX CLI (which stops there: its mutation
    stores a JAX array, on which the GA's elitism fails): the Lloyd seed
    population equal, each seed's conv within EVAL_CPU_TOL of the JAX CLI's
    vmapped measurement, the printed best alike; then the port's GA for 3
    generations, its best conv never rising and every assignment a valid
    aggregate id."""
    from mlamg_tpu.cli import optimize_grid_param as j_opt
    from mlamg_tpu.data import Grid as JGrid
    from mlamg_tpu.graph import lloyd_aggregation, strength_measure
    from mlamg_tpu.mg import sa_interpolation_dense
    from mlamg_tpu.train import GridBundle, SolveOptions, measured_conv

    argv = ["--n", "6", "--population", "4", "--alpha", "0.2"]
    j_opt.main(argv + ["--generations", "0"])
    want_lines = capsys.readouterr().out.splitlines()
    lines: list = []
    out = optimize_grid_param.main(argv + ["--generations", "3", "--device", "cpu"],
                                   log=lines.append)
    assert lines[0] == want_lines[0]

    b = GridBundle.from_grid(JGrid.structured_2d_poisson_dirichlet(6, 6, 1.0, 0.0), 0.2)
    C = strength_measure(b.A, "abs")
    seeds = np.stack([np.asarray(lloyd_aggregation(C, ratio=0.2, key=jax.random.PRNGKey(i))[0])
                      for i in range(4)])
    np.testing.assert_array_equal(out["seed_population"], seeds)
    conv_of = jax.jit(jax.vmap(lambda a: measured_conv(
        b.A, sa_interpolation_dense(b.A, a.astype(jnp.int32), b.k), b.x0,
        SolveOptions(max_iter=80))))
    want = np.asarray(conv_of(jnp.asarray(seeds, jnp.float32)))
    assert np.abs(out["seed_convs"] - want).max() <= EVAL_CPU_TOL
    convs = out["convs"]
    assert len(convs) == 4 and all(b_ <= a_ for a_, b_ in zip(convs, convs[1:]))
    assert out["best"].dtype == np.float32 and set(np.unique(out["best"])) <= set(range(b.k))


# ---- the device rule ---------------------------------------------------------

def test_new_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid_file = str(TEST_DIR / SMALL_GRIDS[0])
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(20, 20), format="csr")
    for call in (lambda: create_data.main([str(tmp_path / "d"), "--n-grids", "1"]),
                 lambda: train_cf_interp.main(["--epochs", "1"]),
                 lambda: train_cf_interp.cf_inputs(A, 0.56),
                 lambda: train_convergence.main([str(TEST_DIR), "--epochs", "1"]),
                 lambda: train_convergence.build_samples([Grid.load(grid_file)], 0.1, 1),
                 lambda: evaluate_model.main([grid_file]),
                 lambda: optimize_grid_param.main(["--generations", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "d").exists()
    Ac, is_c, _, num_c = train_cf_interp.cf_inputs(A, 0.56, device="cpu")
    assert Ac.device.type == "cpu" and Ac.dtype == torch.float64 and int(is_c.sum()) == num_c
