"""The GA, ``mlamg_torch`` against ``mlamg_tpu`` on the same inputs (CPU):
``ParallelGA`` with every operator and option, ``init_population`` and the
fold ids bit for bit; the GA CLIs (``train_dataset`` with ``--resume``
across both packages' checkpoints, ``train_one_sample``); SPSA and
CuckooSearch against JAX's with the same keys.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from mlamg_tpu.ga import GAConfig as JGAConfig
from mlamg_tpu.ga import ParallelGA as JParallelGA
from mlamg_tpu.ga import flatten_params as j_flatten_params
from mlamg_tpu.ga import init_population as j_init_population
from mlamg_tpu.optimize import SPSA as JSPSA
from mlamg_tpu.optimize import CuckooSearch as JCuckooSearch
from mlamg_tpu.utils import load_checkpoint as j_load_checkpoint
from mlamg_tpu.utils import save_checkpoint as j_save_checkpoint

from mlamg_torch.cli import train_dataset, train_one_sample
from mlamg_torch.convert import fullaggnet_from_params
from mlamg_torch.ga import GAConfig, ParallelGA, flatten_params, fold_ids, init_population
from mlamg_torch.optimize import SPSA, CuckooSearch
from mlamg_torch.utils import prng
from mlamg_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data_out", "2d_iso")
CONFIG = dict(dim=8, num_conv=2, iterations=2, bf_width=11, rel_strength=True)
GENERATIONS = 5


@pytest.fixture(scope="module")
def r5():
    """The committed checkpoint's parameter tree (float32)."""
    with open(os.path.join(REPO, "runs_iso_r5", "grad_best.ckpt"), "rb") as f:
        return pickle.load(f)["best_params"]


# ---------------------------------------------------------------------------
# ParallelGA
# ---------------------------------------------------------------------------

TARGET = np.random.RandomState(11).randn(30)


def fitness_fn(pop, generation):
    """Deterministic numpy fitness (positive, for roulette); depends on the
    generation, as a minibatch fitness does."""
    d = np.abs(np.asarray(pop, np.float64) - TARGET[None, :]).mean(axis=1)
    return 1.0 / (1.0 + d) + 1e-3 * (generation % 3)


FOLDS = np.repeat(np.arange(3), 10).astype(np.int32)
GA_CASES = {
    "steady_state_folds": (dict(crossover_probability=0.5), True, "iteration"),
    "steady_state_weightwise": (dict(crossover_probability=0.7, mutation_probability=0.3),
                                False, "iteration"),
    "roulette_folds": (dict(selection="roulette", crossover_probability=0.6), True, "iteration"),
    "roulette_weightwise": (dict(selection="roulette", crossover_probability=0.5), False,
                            "iteration"),
    "greedy_folds": (dict(selection="greedy"), True, "iteration"),
    "adaptive_sigma": (dict(adaptive_sigma=True, crossover_probability=0.5,
                            mutation_min_perturb=-0.08, mutation_max_perturb=0.08), True,
                       "iteration"),
    "sparsity": (dict(mutation_sparsity=0.05, adaptive_sigma=True), True, "iteration"),
    "scope": (dict(mutation_scope=FOLDS != 1, crossover_probability=0.5), True, "iteration"),
    "restart_every": (dict(restart_every=2, crossover_probability=0.5), True, "iteration"),
    "stochastic": (dict(crossover_probability=0.5, adaptive_sigma=True), True,
                   "stochastic_iteration"),
    "stochastic_weightwise_roulette": (dict(selection="roulette", crossover_probability=0.5),
                                       False, "stochastic_iteration"),
}


@pytest.mark.parametrize("case", sorted(GA_CASES))
def test_parallel_ga_matches_jax(case):
    """Five generations from the same float32 population, fitness and key:
    population, fitness, computed, key, sigma and last_stats equal JAX's
    bit for bit."""
    kw, folds, step = GA_CASES[case]
    pop0 = np.random.RandomState(5).randn(8, 30).astype(np.float32)
    gas = [cls(pop0, fitness_fn, cfg_cls(**kw), fold_ids=FOLDS if folds else None, key=7)
           for cls, cfg_cls in ((ParallelGA, GAConfig), (JParallelGA, JGAConfig))]
    for _ in range(GENERATIONS):
        for ga in gas:
            getattr(ga, step)()
    got, want = gas
    np.testing.assert_array_equal(got.population, want.population)
    np.testing.assert_array_equal(got.fitness, want.fitness)
    np.testing.assert_array_equal(got.computed, want.computed)
    np.testing.assert_array_equal(got.key, want.key)
    assert got.sigma == want.sigma and got.num_generation == want.num_generation
    assert got.last_stats == want.last_stats
    assert not np.array_equal(got.population, pop0)
    assert got.best_solution()[1] == want.best_solution()[1]


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def test_init_population_matches_jax_on_r5_weights(r5):
    """init_population(PRNGKey(1), vec, 24, 0.05) on the 16,328 runs_iso_r5
    weights: JAX's (P, W) float32 population bit for bit, row 0 the
    weights."""
    net = fullaggnet_from_params(r5, CONFIG, device="cpu")
    vec = flatten_params(net)[0]
    jvec, _, _, _ = j_flatten_params(jax.tree.map(jnp.asarray, r5))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    got = init_population(prng.PRNGKey(1), vec, 24, perturb=0.05)
    want = np.asarray(j_init_population(jax.random.PRNGKey(1), jvec, 24, perturb=0.05))
    assert got.shape == want.shape == (24, 16328) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], vec.numpy())


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_fold_ids_match_jax(r5, depth):
    net = fullaggnet_from_params(r5, CONFIG, device="cpu")
    ids, names = fold_ids(net, fold_depth=depth)
    _, _, jids, jnames = j_flatten_params(jax.tree.map(jnp.asarray, r5), fold_depth=depth)
    assert names == jnames
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, np.asarray(jids))
    if depth == 2:
        assert names == ["params/AggNetM", "params/CNet", "params/PNet"]


# ---------------------------------------------------------------------------
# the CLIs and checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """3 train and 2 test grids (the smallest files)."""
    root = tmp_path_factory.mktemp("ga_data")
    for sub, k in (("train", 3), ("test", 2)):
        src = os.path.join(DATA, sub)
        names = sorted((f for f in os.listdir(src) if f.endswith(".grid")),
                       key=lambda f: os.path.getsize(os.path.join(src, f)))[:k]
        os.makedirs(root / sub)
        for f in names:
            shutil.copy(os.path.join(src, f), root / sub / f)
    return str(root)


def ga_argv(data, out, *extra):
    """float64, population 4, 25 solve iterations (the reference convs are
    measured and written beside the checkpoints)."""
    return [data, "--population-size", "4", "--float64", "true", "--bucket-step", "128",
            "--max-iter", "25", "--error-norm", "false", "--adaptive-sigma", "true",
            "--init-perturb", "0.05", "--mutation-perturb", "0.08", "--checkpoint-every", "1",
            "--rel-strength", "true", "--device", "cpu", "--checkpoint-dir", f"{out}/ck",
            "--metrics-dir", f"{out}/runs", *extra]


@pytest.fixture(scope="module")
def three_generations(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("ga_run")
    res = train_dataset.main(ga_argv(dataset, out, "--max-generations", "3"))
    return out, res


def assert_same_state(a: dict, b: dict):
    for k in ("population", "fitness", "key"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert a["generation"] == b["generation"] and a["sigma"] == b["sigma"]
    for (pa, x), (pb, y) in zip(jax.tree_util.tree_leaves_with_path(a["best_params"]),
                                jax.tree_util.tree_leaves_with_path(b["best_params"])):
        assert pa == pb
        np.testing.assert_array_equal(x, y)


def test_train_dataset_reports_and_checkpoints(three_generations):
    """The JAX CLI's report: a loss per generation, the test loss at 0 and
    at the end, the elitist train loss never rising; every generation's
    checkpoint holds the whole GA state."""
    out, res = three_generations
    losses = [r["train_loss"] for r in res["reports"]]
    assert [r["generation"] for r in res["reports"]] == [0, 1, 2, 3]
    assert all(b <= a for a, b in zip(losses, losses[1:]))
    assert "test_loss" in res["reports"][0] and "test_loss" in res["reports"][-1]
    ck = load_checkpoint(f"{out}/ck/model_003.ckpt")
    assert ck["population"].shape == (4, 16328) and ck["population"].dtype == np.float32
    assert ck["key"].dtype == np.uint32 and isinstance(ck["sigma"], float)
    assert 1.0 / float(np.max(ck["fitness"])) == pytest.approx(losses[-1], rel=1e-6)
    assert ck["extra"]["net_config"]["rel_strength"] is True
    assert os.path.exists(f"{out}/ck/.ref_convs_train_olson.json")


def test_resume_equals_uninterrupted_run(dataset, three_generations, tmp_path):
    """2 generations, then --resume for 1 more, equals the 3-generation run
    bit for bit, from the port's checkpoint and from the same state written
    by the JAX package's save_checkpoint."""
    out, _ = three_generations
    ck2 = load_checkpoint(f"{out}/ck/model_002.ckpt")
    j_path = str(tmp_path / "jax_written.ckpt")
    j_save_checkpoint(j_path, generation=ck2["generation"], best_params=ck2["best_params"],
                      population=ck2["population"], fitness=ck2["fitness"], key=ck2["key"],
                      sigma=ck2["sigma"], extra=ck2["extra"])
    want = load_checkpoint(f"{out}/ck/model_003.ckpt")
    for name, start in (("port", f"{out}/ck/model_002.ckpt"), ("jax", j_path)):
        d = tmp_path / name
        train_dataset.main(ga_argv(dataset, d, "--max-generations", "1", "--resume", start))
        assert_same_state(load_checkpoint(f"{d}/ck/model_003.ckpt"), want)


def test_checkpoints_load_across_packages(three_generations, tmp_path):
    """The port's checkpoint through mlamg_tpu.utils.load_checkpoint, and a
    JAX-written one through the port's."""
    out, _ = three_generations
    path = f"{out}/ck/model_003.ckpt"
    ours, theirs = load_checkpoint(path), j_load_checkpoint(path)
    assert_same_state(theirs, ours)
    vec, _ = ravel_pytree(jax.tree.map(jnp.asarray, theirs["best_params"]))
    assert vec.shape == (16328,)
    j_path = str(tmp_path / "j.ckpt")
    j_save_checkpoint(j_path, generation=3, best_params=theirs["best_params"],
                      population=theirs["population"], fitness=theirs["fitness"],
                      key=theirs["key"], sigma=theirs["sigma"], extra=theirs["extra"])
    assert_same_state(load_checkpoint(j_path), ours)


def test_mesh_pop_is_rejected(dataset, tmp_path, three_generations):
    """``--mesh-pop 2`` runs the population fitness on 2 pop shards of the
    run's device: its first generation's GA state equals the unsharded
    run's (``--mesh-pop 0``) bit for bit."""
    out, _ = three_generations
    train_dataset.main(ga_argv(dataset, tmp_path, "--max-generations", "1", "--mesh-pop", "2"))
    assert_same_state(load_checkpoint(f"{tmp_path}/ck/model_001.ckpt"),
                      load_checkpoint(f"{out}/ck/model_001.ckpt"))


def test_train_one_sample_writes_its_checkpoint(tmp_path, capsys):
    ga = train_one_sample.main(["--problem", "2d", "--n", "6", "--max-generations", "1",
                                "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "lloyd benchmark conv=" in printed and "gen 1: train conv ratio" in printed
    ck = load_checkpoint(str(tmp_path / "one_sample.ckpt"))
    assert ck["generation"] == 1
    np.testing.assert_array_equal(ck["population"], ga.population)
    np.testing.assert_array_equal(ck["key"], ga.key)
    assert np.isfinite(ck["fitness"]).all()


# ---------------------------------------------------------------------------
# the gradient-free optimizers
# ---------------------------------------------------------------------------


def obj(x):
    """A sum of absolute values: no multiply-add for XLA to fuse."""
    t = np.array([1.0, -2.0, 0.5, 0.0])
    return abs(x[0] - t[0]) + abs(x[1] - t[1]) + abs(x[2] - t[2]) + abs(x[3] - t[3])


def j_obj(x):
    t = jnp.array([1.0, -2.0, 0.5, 0.0])
    return jnp.abs(x[0] - t[0]) + jnp.abs(x[1] - t[1]) + jnp.abs(x[2] - t[2]) + jnp.abs(x[3] - t[3])


def test_spsa_matches_jax_bit_for_bit():
    x = np.array([0.3, 0.1, -0.2, 0.7])
    got, want = SPSA(obj, c=1e-3, lr=0.1), JSPSA(j_obj, c=1e-3, lr=0.1)
    gx, wx = x.copy(), jnp.asarray(x)
    for i in range(6):
        gx = got.step(gx, prng.PRNGKey(i))
        wx = want.step(wx, jax.random.PRNGKey(i))
        np.testing.assert_array_equal(gx, np.asarray(wx))
    assert obj(gx) < obj(x)


def test_cuckoo_search_matches_jax():
    """The same nests, the same improvements and abandonments; the Lévy
    flights draw normals, so the population agrees to erf_inv's float64
    ulps (tests/test_torch_prng.py), not bit for bit."""
    pop = np.random.RandomState(3).randn(6, 4)
    got = CuckooSearch(obj, pop, key=prng.PRNGKey(2))
    want = JCuckooSearch(j_obj, jnp.asarray(pop), key=jax.random.PRNGKey(2))
    for _ in range(5):
        got.step()
        want.step()
        np.testing.assert_array_equal(got.key, np.asarray(want.key))
        np.testing.assert_allclose(got.pop, np.asarray(want.pop), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got.fitness, np.asarray(want.fitness), rtol=1e-12,
                                   atol=1e-14)
    assert got.best()[1] == pytest.approx(want.best()[1], rel=1e-12)
    assert got.best()[1] < min(obj(r) for r in pop)
