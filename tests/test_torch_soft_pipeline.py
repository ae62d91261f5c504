"""The soft pipeline's loss and gradients, ``mlamg_torch`` against
``mlamg_tpu`` (CPU, float64): ``soft_conv_loss`` with multicolor GS on a
padded bucket grid and on an unpadded grid, at two parameter points (the
committed ``runs_iso_r5`` checkpoint and flax's initialisation at seed 0,
converted), and the discrete decisions of ``_soft_parts`` (top-k, push
Bellman-Ford, ``agg_id``) on every 2d_iso test grid.

The JAX side runs ``jax.value_and_grad`` op by op (no ``jax.jit``), as the
port follows it.  At the flax initialisation every gradient tensor equals
JAX's; with the trained checkpoint (and at noisy weights,
``tests/test_torch_train_gradient.py``), the tensors in ``AMPLIFIED`` do
not, and JAX's own jitted and op-by-op gradients of them differ too.
They are the root Dense of the first NNConvs, which act on node features
that are still constant (1/n on every node): InstanceNorm (eps 1e-5) maps
their rounding to ~316 times that, so these gradients are set by the
order of the backward's sums, not by the model (``ROADMAP.md`` Queue 3).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.mg.smoothers import greedy_coloring as j_greedy_coloring
from mlamg_tpu.models import FullAggNet as JFullAggNet
from mlamg_tpu.models import soft_pipeline as jsp
from mlamg_tpu.ops.sparse import CSR as JCSR
from mlamg_tpu.train import make_buckets as j_make_buckets

from mlamg_torch.convert import fullaggnet_from_params, param_leaves
from mlamg_torch.data.grid import Grid
from mlamg_torch.models import soft_pipeline as tsp
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.train import make_buckets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
LOSS_RTOL, GRAD_RTOL = 1e-9, 1e-6
# the root Dense of the NNConvs that still see constant node features (see
# the module docstring): the first three of each MPNN
AMPLIFIED = {f"{net}/node_conv_{c}/Dense_3/{leaf}"
             for net in ("CNet", "PNet")
             for c in ("in", "0", "1") for leaf in ("kernel", "bias")}
CFG = dict(bf_iters=24, tau_assign=0.08, topk_sigma=0.5, num_loops=5, test_vectors=16, ridge=1e-4)


def load(split):
    return Grid.load_dir(os.path.join(REPO, "data_out", "2d_iso", split))


@pytest.fixture(scope="module")
def models(problems):
    """(JAX net, {point: JAX params}, {point: port net}); flax initialises
    on the padded grid, whose shapes the gradient cases share."""
    with open(os.path.join(REPO, "runs_iso_r5", "grad_best.ckpt"), "rb") as f:
        ck = pickle.load(f)
    config = dict(ck["extra"]["net_config"])
    jnet = JFullAggNet(dim=8, num_conv=2, iterations=2, bf_width=config["bf_width"],
                       rel_strength=True)
    init = jnet.init(jax.random.PRNGKey(0), problems["padded"]["jax"][0], problems["padded"]["k"])
    params = {name: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
              for name, p in (("r5", ck["best_params"]), ("init", init))}
    nets = {name: fullaggnet_from_params(jax.tree.map(np.asarray, p), config, device="cpu",
                                         dtype=F64) for name, p in params.items()}
    return jnet, params, nets


@pytest.fixture(scope="module")
def problems():
    """{"padded": the smallest training grid (n 68) in its bucket of the
    three smallest (n_pad 128), "unpadded": the same grid alone}: per mode
    the JAX and port operators, k, pad, colours and seeded test vectors
    (zero on padding rows)."""
    grids = sorted(load("train"), key=lambda g: g.n)[:3]
    jgrids = [JGrid.load(g.extra["filename"]) for g in grids]
    _, (jb,) = j_make_buckets(jgrids, 0.1, jnp.float64, step=128)
    _, (tb,) = make_buckets(grids, 0.1, F64, step=128, device="cpu")
    rng = np.random.RandomState(0)
    n = grids[0].n
    tv = rng.randn(128, 16)
    tv[n:] = 0.0
    tv /= np.linalg.norm(tv, axis=0)
    colors = j_greedy_coloring(grids[0].A.tocsr())
    out = {
        "padded": dict(
            jax=(jax.tree.map(lambda x: x[0], jb.A), (jb.n_real[0], jb.k_real[0]), jb.colors[0]),
            torch=(tb.As[0], tb.pad(0), tb.colors[0]),
            k=jb.k, num_colors=jb.num_colors, tv=tv),
        "unpadded": dict(
            jax=(JCSR.from_scipy(grids[0].A, dtype=jnp.float64), None, jnp.asarray(colors)),
            torch=(CSR.from_scipy(grids[0].A, dtype=F64, device="cpu"), None,
                   torch.from_numpy(colors.astype(np.int64))),
            k=int(np.ceil(0.1 * n)), num_colors=int(colors.max()) + 1,
            tv=tv[:n] / np.linalg.norm(tv[:n], axis=0)),
    }
    assert tb.k == jb.k == 13 and tb.pad(0) == (68, 7)
    return out


def jax_value_and_grad(jnet, params, prob):
    A, pad, colors = prob["jax"]
    cfg = jsp.SoftConfig(**CFG)

    def f(p):
        return jsp.soft_conv_loss(jnet, p, A, prob["k"], jnp.asarray(prob["tv"]), cfg, pad=pad,
                                  colors=colors, num_colors=prob["num_colors"])[0]

    return jax.value_and_grad(f)(params)


@pytest.mark.parametrize("mode", ["padded", "unpadded"])
@pytest.mark.parametrize("point", ["init", "r5"])
def test_soft_conv_loss_and_gradients_match_jax(models, problems, point, mode):
    """The loss within 1e-9 relative and every gradient tensor within 1e-6
    relative in norm (``AMPLIFIED`` aside, see the module docstring); no
    NaN in the gradients of a padded grid."""
    jnet, params, nets = models
    prob = problems[mode]
    want_loss, want_grad = jax_value_and_grad(jnet, params[point], prob)
    net = nets[point]
    net.zero_grad(set_to_none=True)
    A, pad, colors = prob["torch"]
    conv, aux = tsp.soft_conv_loss(net, A, prob["k"], torch.from_numpy(prob["tv"]),
                                   tsp.SoftConfig(**CFG), pad=pad, colors=colors,
                                   num_colors=prob["num_colors"])
    conv.backward()
    loss_gap = abs(float(conv) - float(want_loss)) / abs(float(want_loss))
    gaps = {}
    for path, p, is_kernel in param_leaves(net):
        want = want_grad
        for key in path:
            want = want[key]
        want = np.asarray(want)
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert bool(torch.isfinite(got).all()), path
        got = got.numpy().T if is_kernel else got.numpy()
        gaps["/".join(path[1:])] = float(np.linalg.norm(got - want)
                                         / max(np.linalg.norm(want), 1e-300))
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:6]
    print(f"{point} {mode}: loss {float(conv)!r} gap {loss_gap:.3g}; largest gradient gaps {worst}")
    assert loss_gap <= LOSS_RTOL
    bad = {k: v for k, v in gaps.items() if v > GRAD_RTOL and k not in AMPLIFIED}
    assert not bad, bad
    if point == "init":
        assert max(gaps.values()) <= GRAD_RTOL
    if pad is not None:  # the k - k_real designated padding centers
        np.testing.assert_array_equal(np.sort(aux["centers"].numpy())[-6:], np.arange(68, 74))


def test_discrete_decisions_match_jax_on_every_test_grid(models):
    """Scores, centers and ``agg_id`` of ``_soft_parts`` (top-k, push
    Bellman-Ford on C held constant) on the 10 2d_iso test grids padded to
    buckets of 128, trained checkpoint: equal to JAX's; and the
    straight-through assignment's forward value is the one-hot of
    ``agg_id``."""
    jnet, params, nets = models
    grids = load("test")
    jgrids = [JGrid.load(g.extra["filename"]) for g in grids]
    _, jbuckets = j_make_buckets(jgrids, 0.1, jnp.float64, step=128)
    _, tbuckets = make_buckets(grids, 0.1, F64, step=128, device="cpu")
    checked = 0
    for jb, tb in zip(jbuckets, tbuckets):
        for j, A in enumerate(tb.As):
            Aj = jax.tree.map(lambda x: x[j], jb.A)
            pad = (jb.n_real[j], jb.k_real[j])
            sj, cj, _, _, aj = jnet.apply(params["r5"], Aj, jb.k, pad, method=jsp._soft_parts)
            with torch.no_grad():
                st, ct, _, _, at = tsp._soft_parts(nets["r5"], A, tb.k, tb.pad(j))
            real = slice(0, tb.pad(j)[0])
            np.testing.assert_allclose(st[real].numpy(), np.asarray(sj)[real], rtol=1e-12, atol=0)
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
            np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
            checked += 1
    assert checked == 10
    with torch.no_grad():
        P, aux = tsp.soft_interpolation(nets["r5"], tbuckets[0].As[0], tbuckets[0].k,
                                        tsp.SoftConfig(**CFG), pad=tbuckets[0].pad(0))
    agg = aux["agg_id"]
    hard = torch.nn.functional.one_hot(agg.clamp(max=tbuckets[0].k - 1), tbuckets[0].k).to(F64)
    hard = hard * (agg < tbuckets[0].k)[:, None]
    np.testing.assert_allclose(aux["assignment"].numpy(), hard.numpy(), rtol=0, atol=1e-15)
