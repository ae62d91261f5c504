"""The GA's population fitness, ``mlamg_torch.train`` against ``mlamg_tpu``
on the same inputs (CPU, float64): three individuals (the committed
``runs_iso_r5`` weights and two perturbed copies) on the three smallest
``data_out/2d_iso`` training grids (n 68, 70, 74; one bucket of 128).

The JAX model and ``measured_conv`` run op by op (no ``jax.jit``), as the
port follows them (the trained FullAggNet amplifies rounding, see
``tests/test_torch_models.py``): per-grid convs within 1e-8, unpadded
(:func:`make_population_fitness`) and padded
(:func:`make_population_fitness_bucketed`), and the fitness from them as
the JAX package computes it, with and without ``loss_relative``, both
metrics and the minibatch draw; and with the population split over a pop
mesh (2 CPU shards), as the JAX package shard_maps it, the unsharded
fitness bit for bit.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.models import FullAggNet as JFullAggNet
from mlamg_tpu.train import GridBundle as JGridBundle
from mlamg_tpu.train import SolveOptions as JSolveOptions
from mlamg_tpu.train import make_buckets as j_make_buckets
from mlamg_tpu.train import measured_conv as j_measured_conv

from mlamg_torch.cli.common import compute_reference_convs
from mlamg_torch.convert import fullaggnet_from_params
from mlamg_torch.data.grid import Grid
from mlamg_torch.ga import flatten_params, init_population
from mlamg_torch.parallel import make_mesh
from mlamg_torch.train import (
    GridBundle, SolveOptions, bucketed_convs, evaluate_model_on_bundles, fitness_from_convs,
    make_buckets, make_population_fitness, make_population_fitness_bucketed, population_convs,
)
from mlamg_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data_out", "2d_iso")
F64 = torch.float64
CONFIG = dict(dim=8, num_conv=2, iterations=2, bf_width=11, rel_strength=True)
CONV_ATOL = 1e-8
# padded against unpadded conv of the r5 weights on these grids: 0.0208 in
# both packages (printed with -s); padding reorders the model's sums
PAD_ATOL = 0.05
OPTS = dict(max_iter=75, smoother="multicolor_gs")
POP, PERTURB = 3, 0.02


def fit_rtol(convs_atol=CONV_ATOL):
    """The fitness's relative bound: the convs' gap over the smallest conv
    (~0.4), with room for the division's rounding."""
    return 4 * convs_atol


@pytest.fixture(scope="module")
def setup():
    """(port net, population (3, W) float64, unravel to JAX params, grids,
    unpadded port bundles, padded port bucket, the JAX bucket, reference
    convs)."""
    with open(os.path.join(REPO, "runs_iso_r5", "grad_best.ckpt"), "rb") as f:
        ck = pickle.load(f)
    net = fullaggnet_from_params(ck["best_params"], CONFIG, device="cpu", dtype=F64)
    _, j_unravel = ravel_pytree(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                             ck["best_params"]))
    vec = flatten_params(net)[0]
    pop = init_population(prng.PRNGKey(1), vec, POP, PERTURB)
    grids = sorted(Grid.load_dir(os.path.join(DATA, "train")), key=lambda g: g.n)[:3]
    bundles = [GridBundle.from_grid(g, 0.1, F64, device="cpu") for g in grids]
    pbundles, (tb,) = make_buckets(grids, 0.1, F64, step=128, device="cpu")
    cache = os.path.join(DATA, "train", ".ref_convs_olson.json")
    refs = compute_reference_convs(bundles, "olson", SolveOptions(**OPTS), grids=grids,
                                   cache_path=cache)
    compute_reference_convs(pbundles, "olson", SolveOptions(**OPTS), grids=grids,
                            cache_path=cache)
    jgrids = [JGrid.load(g.extra["filename"]) for g in grids]
    _, (jb,) = j_make_buckets(jgrids, 0.1, jnp.float64, step=128)
    return dict(net=net, pop=pop, j_unravel=j_unravel, jgrids=jgrids, bundles=bundles,
                pbundles=pbundles, tb=tb, jb=jb, refs=refs)


@pytest.fixture(scope="module")
def jax_convs(setup):
    """(unpadded, padded) (3, 3) convs of JAX's op-by-op model and
    measured_conv."""
    jopts = JSolveOptions(**OPTS)
    net = JFullAggNet(**CONFIG)
    jb = setup["jb"]
    plain, padded = [], []
    for row in setup["pop"]:
        params = setup["j_unravel"](jnp.asarray(row, jnp.float64))
        prow, drow = [], []
        for g in setup["jgrids"]:
            b = JGridBundle.from_grid(g, 0.1, jnp.float64)
            _, P, _, _, _ = net.apply(params, b.A, b.k)
            prow.append(float(j_measured_conv(b.A, P, b.x0, jopts, colors=b.colors,
                                              num_colors=b.num_colors)))
        for j in range(len(setup["jgrids"])):
            Aj = jax.tree.map(lambda x: x[j], jb.A)
            _, P, _, _, _ = net.apply(params, Aj, jb.k, pad=(jb.n_real[j], jb.k_real[j]))
            drow.append(float(j_measured_conv(Aj, P, jb.x0[j], jopts, colors=jb.colors[j],
                                              num_colors=jb.num_colors)))
        plain.append(prow)
        padded.append(drow)
    return np.asarray(plain), np.asarray(padded)


def j_fitness(convs, refs, loss_relative=True, metric="mean_ratio"):
    """The JAX package's fitness arithmetic (mlamg_tpu/train.py) on convs."""
    convs, refs = jnp.asarray(convs), jnp.asarray(refs)
    if metric == "ratio_of_means":
        rel = jnp.mean(convs, axis=1) / (jnp.mean(refs) if loss_relative else 1.0)
        return np.asarray(1.0 / jnp.maximum(rel, 1e-9))
    rel = convs / refs[None, :] if loss_relative else convs
    return np.asarray(1.0 / jnp.maximum(jnp.mean(rel, axis=1), 1e-9))


def test_population_convs_match_jax_per_grid(setup, jax_convs):
    """Each individual's conv on each grid, unpadded and padded, within
    1e-8 of JAX's; the module's own weights are restored."""
    net, pop = setup["net"], setup["pop"]
    keep = flatten_params(net)[0].clone()
    opts = SolveOptions(**OPTS)
    plain = population_convs(net, pop, lambda m: evaluate_model_on_bundles(
        m, setup["bundles"], opts))
    padded = population_convs(net, pop, lambda m: bucketed_convs(m, [setup["tb"]], opts))
    print(f"unpadded convs {plain.tolist()}\npadded convs {padded.tolist()}")
    np.testing.assert_allclose(plain, jax_convs[0], rtol=0, atol=CONV_ATOL)
    np.testing.assert_allclose(padded, jax_convs[1], rtol=0, atol=CONV_ATOL)
    np.testing.assert_array_equal(flatten_params(net)[0].numpy(), keep.numpy())
    assert len({tuple(r) for r in plain.tolist()}) == POP  # the perturbations matter


@pytest.mark.parametrize("loss_relative", [True, False])
def test_unbucketed_fitness_matches_jax(setup, jax_convs, loss_relative):
    """The fitness of the last two individuals (the per-grid convs of all
    three are held above)."""
    fit = make_population_fitness(setup["net"], setup["bundles"], SolveOptions(**OPTS),
                                  loss_relative=loss_relative)
    got = fit(setup["pop"][1:], 0)
    assert got.dtype == np.float64 and got.shape == (POP - 1,)
    np.testing.assert_allclose(got, j_fitness(jax_convs[0][1:], setup["refs"], loss_relative),
                               rtol=fit_rtol())


@pytest.mark.parametrize("metric", ["mean_ratio", "ratio_of_means"])
@pytest.mark.parametrize("loss_relative", [True, False])
def test_bucketed_fitness_matches_jax(setup, jax_convs, loss_relative, metric):
    """``loss_relative`` and ``fitness_metric`` as the JAX package applies
    them, on the last individual; without ``loss_relative`` the fitness is
    1 / mean conv, which differs from the relative one."""
    refs = np.asarray([setup["pbundles"][i].ref_conv for i in setup["tb"].idx])
    fit = make_population_fitness_bucketed(setup["net"], setup["pbundles"], [setup["tb"]],
                                           SolveOptions(**OPTS), loss_relative=loss_relative,
                                           fitness_metric=metric)
    got = fit(setup["pop"][-1:], 0)
    want = j_fitness(jax_convs[1][-1:], refs, loss_relative, metric)
    np.testing.assert_allclose(got, want, rtol=fit_rtol())
    other = j_fitness(jax_convs[1][-1:], refs, not loss_relative, metric)
    assert np.abs(got - other).min() > 1e3 * fit_rtol() * np.abs(other).max()


@pytest.mark.parametrize("generation", [0, 5])
def test_minibatch_fitness_draws_jax_batch(setup, jax_convs, generation):
    """With ``batch_size`` 2 of 3 grids, generation g evaluates
    ``RandomState(g).choice(3, 2, replace=False)``, as JAX does."""
    fit = make_population_fitness(setup["net"], setup["bundles"], SolveOptions(**OPTS),
                                  batch_size=2)
    batch = np.random.RandomState(generation).choice(3, size=2, replace=False)
    want = j_fitness(jax_convs[0][:, batch], setup["refs"][batch])
    np.testing.assert_allclose(fit(setup["pop"][:2], generation), want[:2], rtol=fit_rtol())


def test_fitness_arithmetic_in_the_bundles_dtype():
    """float32 convs and references give float32 fitness, as JAX computes
    it without x64; NaN convs count as 1.0."""
    convs = np.array([[0.5, np.nan], [0.25, 0.75]])
    got = fitness_from_convs(convs, [0.5, 0.5], np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.float32(1) / np.array(
        [np.mean(np.float32([1.0, 2.0])), np.mean(np.float32([0.5, 1.5]))], np.float32))


def test_padding_invariance(setup, jax_convs):
    """In the style of tests/test_bucketed.py: one individual's padded and
    unpadded convs agree per grid.  Padding changes the order of the
    model's sums, and the trained model amplifies rounding, so the bound is
    loose; the gaps equal JAX's own."""
    plain = population_convs(setup["net"], setup["pop"][:1], lambda m: evaluate_model_on_bundles(
        m, setup["bundles"], SolveOptions(**OPTS)))[0]
    padded = population_convs(setup["net"], setup["pop"][:1], lambda m: bucketed_convs(
        m, [setup["tb"]], SolveOptions(**OPTS)))[0]
    gap = np.abs(plain - padded).max()
    print(f"padded vs unpadded: port {gap}, JAX {np.abs(jax_convs[0][0] - jax_convs[1][0]).max()}")
    assert np.isfinite(padded).all() and gap <= PAD_ATOL
    np.testing.assert_allclose(plain - padded, jax_convs[0][0] - jax_convs[1][0], rtol=0,
                               atol=2 * CONV_ATOL)



@pytest.mark.parametrize("bucketed", [False, True])
def test_fitness_on_a_pop_mesh_matches_jax_and_unsharded(setup, jax_convs, bucketed):
    """``mesh=make_mesh(pop=2)``: the 3 individuals padded to 4 and split
    over 2 pop shards give the unsharded fitness and convs bit for bit,
    and JAX's fitness of its op-by-op convs."""
    mesh = make_mesh(pop=2, row=1, devices=["cpu", "cpu"])
    opts = SolveOptions(**OPTS)
    if bucketed:
        refs = np.asarray([setup["pbundles"][i].ref_conv for i in setup["tb"].idx])

        def make(m):
            return make_population_fitness_bucketed(setup["net"], setup["pbundles"],
                                                    [setup["tb"]], opts, mesh=m)
    else:
        refs = setup["refs"]

        def make(m):
            return make_population_fitness(setup["net"], setup["bundles"], opts, mesh=m)
    sharded, plain = make(mesh), make(None)
    got = sharded(setup["pop"], 0)
    np.testing.assert_array_equal(got, plain(setup["pop"], 0))
    np.testing.assert_array_equal(sharded.last_convs, plain.last_convs)
    assert got.dtype == np.float64 and sharded.last_convs.shape == (POP, 3)
    np.testing.assert_allclose(got, j_fitness(jax_convs[int(bucketed)], refs), rtol=fit_rtol())
