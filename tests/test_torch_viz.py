"""Figures: ``mlamg_torch.viz`` and ``mlamg_torch.cli.visualize`` against
``mlamg_tpu.viz`` and the JAX model (CPU).  The plot functions render; the
segments, polygons and colours of their collections equal the JAX
package's on the same grid and aggregates; the six ``visualize``
subcommands write their files; and the numbers behind ``model-error``
(the error after k cycles and its conv) and ``model-passes`` (each AggNet
layer's top-k mask) equal JAX's model run op by op in float64 (1e-10)."""

import os
import pickle

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from mlamg_tpu import viz as jviz  # noqa: E402
from mlamg_tpu.data import Grid as JGrid  # noqa: E402
from mlamg_tpu.mg import twolevel_solve as j_twolevel  # noqa: E402
from mlamg_tpu.models import FullAggNet as JFullAggNet  # noqa: E402
from mlamg_tpu.models.graphdata import graph_from_matrix_basic as j_graph  # noqa: E402
from mlamg_tpu.train import GridBundle as JGridBundle  # noqa: E402

from mlamg_torch import viz  # noqa: E402
from mlamg_torch.cli import visualize  # noqa: E402
from mlamg_torch.data.grid import Grid  # noqa: E402
from mlamg_torch.train import GridBundle  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "data_out", "2d_iso", "test", "isotropic_0000.grid")
MODEL = os.path.join(REPO, "runs_iso_r5", "grad_best.ckpt")
NUM_ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_plot_functions_render(tmp_path):
    g = Grid.structured_2d_poisson_dirichlet(6, 6)
    agg = np.arange(g.n) % 4
    for name, fn in [("grid", lambda ax: viz.plot_grid(g, ax)),
                     ("agg", lambda ax: viz.plot_agg(g, agg, ax)),
                     ("spider", lambda ax: viz.plot_spider_agg(g, agg, None, ax))]:
        fig, ax = plt.subplots()
        fn(ax)
        out = tmp_path / f"{name}.png"
        fig.savefig(out)
        plt.close(fig)
        assert out.stat().st_size > 1000
    g3 = Grid.structured_3d_laplace_dirichlet(4, 4, 4)
    fig = plt.figure()
    viz.plot_agg_3d(g3, np.arange(g3.n) % 5)
    fig.savefig(tmp_path / "agg3d.png")
    plt.close(fig)
    assert (tmp_path / "agg3d.png").stat().st_size > 1000


def test_async_plotter(tmp_path):
    g = Grid.structured_2d_poisson_dirichlet(5, 5)
    out = tmp_path / "async_agg.png"
    with viz.AsyncPlotter() as ap:
        ap.plot("agg", g, np.arange(g.n) % 3, out_path=str(out))
    assert out.exists() and out.stat().st_size > 1000


def artists(draw):
    """Every collection's segments or polygon vertices, colours and
    widths, and every scatter's offsets, after ``draw(ax)``."""
    fig, ax = plt.subplots()
    draw(ax)
    out = []
    for c in ax.collections:
        if hasattr(c, "get_segments"):
            geo = [np.asarray(s) for s in c.get_segments()]
        else:
            geo = [p.vertices for p in c.get_paths()]
        out.append((type(c).__name__, geo, c.get_facecolors(), c.get_edgecolors(),
                    c.get_linewidths(), np.asarray(c.get_offsets())))
    out.append([(ln.get_xdata(), ln.get_ydata()) for ln in ax.lines])
    plt.close(fig)
    return out


def assert_same_artists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a[:-1], b[:-1]):
        assert x[0] == y[0] and len(x[1]) == len(y[1])
        for p, q in zip(x[1], y[1]):
            np.testing.assert_array_equal(p, q)
        for p, q in zip(x[2:], y[2:]):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(q))
    for (px, py), (qx, qy) in zip(a[-1], b[-1]):
        np.testing.assert_array_equal(px, qx)
        np.testing.assert_array_equal(py, qy)


@pytest.mark.parametrize("kind", ["grid", "agg", "spider", "spider_p"])
def test_collections_equal_jaxs(rng, kind):
    g, jg = Grid.load(GRID), JGrid.load(GRID)
    agg = rng.randint(0, 12, size=g.n)
    P = np.abs(rng.randn(g.n, 12))
    mine, theirs = {
        "grid": (lambda ax: viz.plot_grid(g, ax), lambda ax: jviz.plot_grid(jg, ax)),
        "agg": (lambda ax: viz.plot_agg(g, agg, ax), lambda ax: jviz.plot_agg(jg, agg, ax)),
        "spider": (lambda ax: viz.plot_spider_agg(g, agg, None, ax),
                   lambda ax: jviz.plot_spider_agg(jg, agg, None, ax)),
        "spider_p": (lambda ax: viz.plot_spider_agg(g, agg, P, ax),
                     lambda ax: jviz.plot_spider_agg(jg, agg, P, ax)),
    }[kind]
    a = artists(mine)
    assert len(a) > 1 and sum(len(x[1]) for x in a[:-1]) > 0
    assert_same_artists(a, artists(theirs))


def test_visualize_subcommands_write_files(tmp_path):
    lines = []
    res = {"lloyd": np.array([0.5, 0.6]), "ml": np.array([0.4, 0.7]),
           "random": np.array([0.6, 0.8])}
    with open(tmp_path / "eval.pkl", "wb") as f:
        pickle.dump(res, f)
    cases = [("grid", GRID, []), ("aggregates", GRID, ["--model", MODEL]),
             ("dataset-stats", os.path.join(REPO, "data_out", "2d_iso", "test"), []),
             ("eval-results", str(tmp_path / "eval.pkl"), []),
             ("model-error", GRID, ["--model", MODEL, "--cycles", "4"]),
             ("model-passes", GRID, [])]
    for cmd, path, extra in cases:
        out = tmp_path / f"{cmd}.png"
        visualize.main([cmd, path, "--out", str(out), "--device", "cpu", *extra],
                       log=lines.append)
        assert out.stat().st_size > 1000, cmd
    assert len(lines) == 6 and all(ln.startswith("wrote ") for ln in lines)
    g3 = Grid.structured_3d_laplace_dirichlet(4, 4, 3)
    g3.save(str(tmp_path / "g3.grid"))
    visualize.main(["aggregates", str(tmp_path / "g3.grid"), "--out", str(tmp_path / "a3.png"),
                    "--device", "cpu"], log=lines.append)
    assert (tmp_path / "a3.png").stat().st_size > 1000


@pytest.fixture(scope="module")
def models():
    """(port FullAggNet, JAX FullAggNet, its float64 params, port bundle,
    JAX bundle) of the committed runs_iso_r5 weights on GRID, float64."""
    with open(MODEL, "rb") as f:
        ck = pickle.load(f)
    config = dict(ck["extra"]["net_config"])
    g = Grid.load(GRID)
    b = GridBundle.from_grid(g, 0.1, torch.float64, device="cpu")
    net = visualize.load_net(MODEL, g, "cpu", dtype=torch.float64)
    config["bf_width"] = net.bf_width
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), ck["best_params"])
    jb = JGridBundle.from_grid(JGrid.load(GRID), 0.1, jnp.float64)
    return net, JFullAggNet(**config), jparams, b, jb


def test_model_error_numbers_equal_jax(models):
    net, jnet, jparams, b, jb = models
    e, conv = visualize.model_error(net, b, 10)
    _, P, *_ = jnet.apply(jparams, jb.A, jb.k)
    xj, conv_j, _, _ = j_twolevel(jb.A, P, jnp.zeros(jb.A.shape[0]), jb.x0, res_tol=0.0,
                                  max_iter=10)
    assert e.shape == (b.A.shape[0],) and 0 < conv < 1
    np.testing.assert_allclose(e, np.asarray(xj), rtol=0, atol=NUM_ATOL * np.abs(e).max())
    assert abs(conv - float(conv_j)) <= NUM_ATOL


def test_model_passes_masks_equal_jax(models):
    net, jnet, jparams, b, jb = models
    masks = visualize.model_passes(net, b)
    gj = j_graph(jb.A, ell_width=jnet.bf_width, rel_strength=jnet.rel_strength)
    want = jnet.apply(jparams, gj, jb.k, method=lambda m, g, k: m.AggNetM(
        g, k, return_intermediate=True))
    assert len(masks) == len(want) == 2
    for a, w in zip(masks, want):
        np.testing.assert_array_equal(a, np.asarray(w))
        assert a.sum() == b.k
