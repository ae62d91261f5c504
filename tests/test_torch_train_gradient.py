"""Gradient training, ``mlamg_torch`` against ``mlamg_tpu`` (CPU, float64
unless said otherwise): the shape buckets, the padded FullAggNet forward,
the bucketed discrete fitness, one pretraining step's loss and gradients,
one ``train_gradient`` step with weight noise, and both CLIs end to end
(float32), whose checkpoints the JAX package loads and runs.

The JAX model runs op by op (no ``jax.jit``): the trained FullAggNet
amplifies rounding, so only the op-by-op JAX program is the port's
reference (``tests/test_torch_models.py``).  The training steps start from
weights drawn as flax's init draws them (``init_flax_``).
"""

import dataclasses
import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mlamg_tpu.cli import evaluate_dataset as j_evaluate_dataset
from mlamg_tpu.cli.pretrain_dataset import build_targets as j_build_targets
from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.models import FullAggNet as JFullAggNet
from mlamg_tpu.models import soft_pipeline as jsp
from mlamg_tpu.models.graphdata import graph_from_matrix as j_graph_from_matrix
from mlamg_tpu.models.graphdata import graph_from_matrix_basic as j_graph_basic
from mlamg_tpu.ops.sparse import CSR as JCSR
from mlamg_tpu.train import SolveOptions as JSolveOptions
from mlamg_tpu.train import make_buckets as j_make_buckets
from mlamg_tpu.train import measured_conv as j_measured_conv
from mlamg_tpu.utils import load_checkpoint as j_load_checkpoint

from mlamg_torch.cli import pretrain_dataset, train_gradient
from mlamg_torch.cli.common import compute_reference_convs, dataset_bf_width
from mlamg_torch.convert import param_leaves, params_from_fullaggnet
from mlamg_torch.data.grid import Grid
from mlamg_torch.ga.codec import flatten_params
from mlamg_torch.models.agg_interp import FullAggNet
from mlamg_torch.models.gnn import init_flax_
from mlamg_torch.models.soft_pipeline import SoftConfig
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.train import (
    SolveOptions, bucketed_convs, make_buckets, make_population_fitness_bucketed,
)
from mlamg_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data_out", "2d_iso")
F64 = torch.float64
CONFIG = dict(dim=8, num_conv=2, iterations=2, bf_width=11, rel_strength=True)
LOSS_RTOL, GRAD_RTOL, CONV_ATOL = 1e-9, 1e-6, 1e-8
# the root Dense of the NNConvs that still see constant node features (see
# tests/test_torch_soft_pipeline.py): the first three of each MPNN
AMPLIFIED = {f"{net}/node_conv_{c}/Dense_3/{leaf}"
             for net in ("CNet", "PNet")
             for c in ("in", "0", "1") for leaf in ("kernel", "bias")}


def smallest(k):
    return sorted(Grid.load_dir(os.path.join(DATA, "train")), key=lambda g: g.n)[:k]


def jax_grids(grids):
    return [JGrid.load(g.extra["filename"]) for g in grids]


def jnet():
    return JFullAggNet(**CONFIG)


@pytest.fixture(scope="module")
def r5():
    """The committed checkpoint: (JAX params, port net), float64."""
    with open(os.path.join(REPO, "runs_iso_r5", "grad_best.ckpt"), "rb") as f:
        ck = pickle.load(f)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), ck["best_params"])
    from mlamg_torch.convert import fullaggnet_from_params

    return params, fullaggnet_from_params(ck["best_params"], CONFIG, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def fresh():
    """Weights drawn as flax's init draws them at seed 0: (JAX params, port net)."""
    net = init_flax_(FullAggNet(**CONFIG), prng.PRNGKey(0)).to(F64)
    return jax.tree.map(jnp.asarray, params_from_fullaggnet(net)), net


@pytest.fixture(scope="module")
def bucket():
    """The three smallest training grids (n 68, 70, 74) in one bucket of
    128, on both sides, with the committed reference convs."""
    grids = smallest(3)
    jbundles, (jb,) = j_make_buckets(jax_grids(grids), 0.1, jnp.float64, step=128)
    bundles, (tb,) = make_buckets(grids, 0.1, F64, step=128, device="cpu")
    opts = SolveOptions(max_iter=75, smoother="multicolor_gs")
    refs = compute_reference_convs(bundles, "olson", opts, grids=grids,
                                   cache_path=os.path.join(DATA, "train", ".ref_convs_olson.json"))
    return grids, jb, bundles, tb, refs


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)
    assert gap <= rtol, (what, gap)


def grad_gaps(net, jgrad):
    """{path: relative gap in norm} of the module's .grad against a JAX
    gradient tree."""
    gaps = {}
    for path, p, is_kernel in param_leaves(net):
        want = jgrad
        for key in path:
            want = want[key]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        got = got.numpy().T if is_kernel else got.numpy()
        want = np.asarray(want)
        gaps["/".join(path[1:])] = float(np.linalg.norm(got - want)
                                         / max(np.linalg.norm(want), 1e-300))
    return gaps


# ---------------------------------------------------------------------------
# buckets, the padded forward, the bucketed fitness
# ---------------------------------------------------------------------------


def test_make_buckets_matches_jax():
    """Two buckets (n_pad 128 and 256): every padded array, x0, colouring,
    n_real, k_real, k and the grid order equal JAX's."""
    grids = smallest(3) + sorted(Grid.load_dir(os.path.join(DATA, "train")), key=lambda g: g.n)[-2:]
    _, jbs = j_make_buckets(jax_grids(grids), 0.1, jnp.float64, step=128)
    _, tbs = make_buckets(grids, 0.1, F64, step=128, device="cpu")
    assert len(tbs) == len(jbs) == 2
    for jb, tb in zip(jbs, tbs):
        assert (tb.k, tb.num_colors) == (jb.k, jb.num_colors)
        np.testing.assert_array_equal(tb.idx, jb.idx)
        np.testing.assert_array_equal(tb.n_real, np.asarray(jb.n_real))
        np.testing.assert_array_equal(tb.k_real, np.asarray(jb.k_real))
        for name in ("data", "row", "col", "indptr"):
            got = torch.stack([getattr(A, name) for A in tb.As]).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(jb.A, name)), err_msg=name)
        assert tb.As[0].shape == jb.A.shape and tb.As[0].nnz_pad == jb.A.data.shape[1]
        np.testing.assert_array_equal(tb.x0.numpy(), np.asarray(jb.x0))
        np.testing.assert_array_equal(tb.colors.numpy(), np.asarray(jb.colors))


def test_padded_forward_matches_jax_and_keeps_padding_apart(r5, bucket):
    """Padded FullAggNet forward, trained checkpoint: centers, agg_id and
    P's columns equal JAX's op-by-op padded forward, C and P data within
    1e-10; k_real centers on real nodes (as many as the unpadded forward
    picks) and the rest pinned to the first padding nodes, real nodes and
    real rows of P only in aggregates of real centers, padding rows of P
    1.0."""
    params, net = r5
    grids, jb, _, tb, _ = bucket
    for j, A in enumerate(tb.As):
        n_real, k_real = tb.pad(j)
        Aj = jax.tree.map(lambda x: x[j], jb.A)
        agg_j, P_j, C_j, cen_j, _ = jnet().apply(params, Aj, jb.k, pad=(jb.n_real[j], jb.k_real[j]))
        with torch.no_grad():
            agg, P, C, cen, _ = net(A, tb.k, pad=(n_real, k_real))
            agg_u, P_u, _, cen_u, _ = net(CSR.from_scipy(grids[j].A, dtype=F64, device="cpu"),
                                          k_real)
        np.testing.assert_array_equal(cen.numpy(), np.asarray(cen_j))
        np.testing.assert_array_equal(agg.numpy(), np.asarray(agg_j))
        np.testing.assert_array_equal(P.col.numpy(), np.asarray(P_j.col))
        assert_rel(C.data.numpy(), C_j.data, 1e-10, "C")
        assert_rel(P.data.numpy(), P_j.data, 1e-10, "P")
        on_real = cen.numpy() < n_real
        assert on_real.sum() == k_real == len(cen_u) and bool((agg_u.numpy() < k_real).all())
        np.testing.assert_array_equal(np.sort(cen.numpy()[~on_real]),
                                      np.arange(n_real, n_real + tb.k - k_real))
        real_aggs = set(np.flatnonzero(on_real))
        rows, cols, live = P.row.numpy(), P.col.numpy(), P.row.numpy() < P.shape[0]
        assert set(agg.numpy()[:n_real]) <= real_aggs
        assert set(cols[live & (rows < n_real)]) <= real_aggs
        np.testing.assert_array_equal(P.data.numpy()[live & (rows >= n_real)], 1.0)


def test_bucketed_fitness_matches_jax_per_grid(r5, bucket):
    """Per padded grid, the discrete conv (FullAggNet P, multicolor-GS
    two-level solve, max_iter 75) within 1e-8 of JAX's op-by-op model and
    ``measured_conv``; the fitness (mean_ratio and ratio_of_means) from
    them."""
    params, net = r5
    _, jb, bundles, tb, refs = bucket
    opts = SolveOptions(max_iter=75, smoother="multicolor_gs")
    jopts = JSolveOptions(max_iter=75, smoother="multicolor_gs")
    want = []
    for j in range(len(tb.As)):
        Aj = jax.tree.map(lambda x: x[j], jb.A)
        _, Pj, _, _, _ = jnet().apply(params, Aj, jb.k, pad=(jb.n_real[j], jb.k_real[j]))
        want.append(float(j_measured_conv(Aj, Pj, jb.x0[j], jopts, colors=jb.colors[j],
                                          num_colors=jb.num_colors)))
    got = bucketed_convs(net, [tb], opts)
    print(f"padded discrete convs: port {got.tolist()}, JAX {want}")
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)
    vec = flatten_params(net)[0]
    for metric, expect in (("mean_ratio", 1.0 / np.mean(np.asarray(want) / refs)),
                           ("ratio_of_means", np.mean(refs) / np.mean(want))):
        fit = make_population_fitness_bucketed(net, bundles, [tb], opts, fitness_metric=metric)
        got_fit = fit(torch.stack([vec, vec]), 0)
        assert got_fit.shape == (2,)
        np.testing.assert_allclose(got_fit, expect, rtol=1e-7)
    np.testing.assert_array_equal(flatten_params(net)[0].numpy(), vec.numpy())  # restored


# ---------------------------------------------------------------------------
# one pretraining step, one train_gradient step
# ---------------------------------------------------------------------------


def j_heads(mdl, A, k, agg_id):
    """The JAX pretraining CLI's heads (a closure of its main)."""
    g = j_graph_basic(A, rel_strength=mdl.rel_strength)
    _, scores = mdl.AggNetM(g, k)
    _, bf_edges = mdl.CNet(g)
    _, p_edges = mdl.PNet(j_graph_from_matrix(A, agg_id))
    return scores, bf_edges[:, 0], p_edges[:, 0]


def test_pretrain_step_matches_jax(fresh):
    """Targets equal JAX's (Lloyd centers, SA smoother, agg_id; the
    normalised log strength within 2 float32 ulps); on the same targets the
    loss parts within 1e-9 and every gradient tensor within 1e-6 of the
    JAX CLI's loss op by op; the Adam step is optax's (1e-12)."""
    params, net = fresh
    g = smallest(1)
    (Aj32, k, ic_j, cv_j, pv_j, agg_j), = j_build_targets(jax_grids(g), 0.1, "olson")
    (A, kt, ic, cv, pv, agg), = pretrain_dataset.build_targets(g, 0.1, "olson", device="cpu",
                                                                dtype=F64)
    assert kt == k
    np.testing.assert_array_equal(ic.numpy(), np.asarray(ic_j, np.float64))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(pv_j, np.float64))
    np.testing.assert_array_equal(agg.numpy(), np.asarray(agg_j))
    # float32 olson strength: the log targets within 2 ulps of [0, 1]
    np.testing.assert_allclose(cv.numpy(), np.asarray(cv_j, np.float64), rtol=0, atol=2 ** -23)
    cv = torch.from_numpy(np.asarray(cv_j, np.float64))  # the same targets on both sides
    Aj = JCSR.from_scipy(g[0].A, dtype=jnp.float64)

    def loss_fn(prm):
        scores, c_out, p_out = jnet().apply(prm, Aj, k, agg_j, method=j_heads)
        n = ic_j.shape[0]
        pos_w = (n - k) / max(k, 1)
        ic64, cv64, pv64 = (jnp.asarray(a, jnp.float64) for a in (ic_j, cv_j, pv_j))
        bce = -jnp.mean(pos_w * ic64 * jax.nn.log_sigmoid(scores)
                        + (1 - ic64) * jax.nn.log_sigmoid(-scores))
        mask = Aj.mask
        mse_c = jnp.sum(jnp.where(mask, (c_out - cv64) ** 2, 0)) / jnp.sum(mask)
        mse_p = jnp.sum(jnp.where(mask, (p_out - pv64) ** 2, 0)) / jnp.sum(mask)
        return bce + 10.0 * mse_c + 10.0 * mse_p, (bce, mse_c, mse_p)

    (lj, parts_j), gj = jax.value_and_grad(loss_fn, has_aux=True)(params)
    net.zero_grad(set_to_none=True)
    loss, parts = pretrain_dataset.pretrain_loss(net, A, k, ic, cv, pv, agg)
    loss.backward()
    for got, want in zip((loss, *parts), (lj, *parts_j)):
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    gaps = grad_gaps(net, gj)
    assert max(gaps.values()) <= GRAD_RTOL, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    # the pretraining optimiser: plain optax.adam(lr) on the parameters
    from mlamg_torch.cli.optim import Adam

    ps = [p.detach().clone() for p in net.parameters()]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in net.parameters()]
    Adam(ps, 2e-3).step(grads)
    tx = optax.adam(2e-3)
    up, _ = tx.update([jnp.asarray(g_.numpy()) for g_ in grads],
                      tx.init([jnp.asarray(p.detach().numpy()) for p in net.parameters()]))
    for p, p0, u in zip(ps, net.parameters(), up):
        np.testing.assert_allclose((p - p0.detach()).numpy(), np.asarray(u), rtol=1e-12, atol=0)


def flat_gaps(got, want, unravel):
    """{path: relative gap in norm} of two flat gradients, per tensor of
    the JAX parameter tree ``unravel`` builds."""
    gaps = {}
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(unravel(jnp.asarray(got)))[0],
                            jax.tree.leaves(unravel(jnp.asarray(want)))):
        name = "/".join(k.key for k in path[1:])
        gaps[name] = float(jnp.linalg.norm(a - b) / max(float(jnp.linalg.norm(b)), 1e-300))
    return gaps


def test_train_gradient_step_with_weight_noise_matches_jax(fresh, bucket):
    """One step of the JAX CLI's loop at ``--grid-chunk 2`` on a bucket of
    the three smallest grids, op by op: the bucket split into chunks of 2
    and 1 grids (every array equal to the JAX CLI's ``split``), each
    chunk's test vectors (salt 0 and 1, 1e-14) and noise draw
    ``fold_in(PRNGKey(17), bi)`` (1e-15), the chunk-weighted loss of
    mean(conv / ref) (1e-9) and its gradient at the noisy weights (every
    tensor within 1e-6 but the ``AMPLIFIED`` ones, set by rounding), then
    the clipped Adam step from the same gradient (1e-12)."""
    params, net = fresh
    grids, jb, _, tb, refs = bucket
    tau = train_gradient.tau_at(0, 600, 0.08, 0.015)
    cfg = dict(bf_iters=24, tau_assign=tau, topk_sigma=0.5, num_loops=5, test_vectors=16,
               ridge=1e-4)
    # JAX: the CLI's split, test vectors, noise and bucket_loss per grid
    jchunks = [dataclasses.replace(jb, A=jax.tree.map(lambda x: x[s:s + 2], jb.A),
                                   x0=jb.x0[s:s + 2], n_real=jb.n_real[s:s + 2],
                                   k_real=jb.k_real[s:s + 2], colors=jb.colors[s:s + 2],
                                   idx=jb.idx[s:s + 2]) for s in (0, 2)]

    def j_bucket_vecs(b, salt):
        tv = jax.random.normal(jax.random.PRNGKey(0 * 9973 + salt), (len(b.idx), 128, 16),
                               jnp.float64)
        tv = jnp.where(jnp.arange(128)[None, :, None] < b.n_real[:, None, None], tv, 0.0)
        return tv / jnp.maximum(jnp.linalg.norm(tv, axis=1, keepdims=True), 1e-30)

    vec, unravel = ravel_pytree(params)
    wn = float(jnp.sqrt(jnp.mean(vec ** 2))) * 0.01

    def bucket_loss(v, b, tv, rf):
        convs = [jsp.soft_conv_loss(jnet(), unravel(v), jax.tree.map(lambda x: x[j], b.A), b.k,
                                    tv[j], jsp.SoftConfig(**cfg), pad=(b.n_real[j], b.k_real[j]),
                                    colors=b.colors[j], num_colors=b.num_colors)[0]
                 for j in range(len(b.idx))]
        return jnp.mean(jnp.stack(convs) / jnp.asarray(rf))

    # the port: the CLI's own functions
    chunks = train_gradient.split_bucket(tb, 2)
    assert [list(c.idx) for c in chunks] == [list(c.idx) for c in jchunks] == [[0, 1], [2]]
    for c, jc in zip(chunks, jchunks):
        assert (c.n_real, c.k_real) == (tuple(np.asarray(jc.n_real)), tuple(np.asarray(jc.k_real)))
        assert (c.k, c.num_colors) == (jc.k, jc.num_colors)
        np.testing.assert_array_equal(torch.stack([A.data for A in c.As]).numpy(),
                                      np.asarray(jc.A.data))
        np.testing.assert_array_equal(c.x0.numpy(), np.asarray(jc.x0))
        np.testing.assert_array_equal(c.colors.numpy(), np.asarray(jc.colors))
    tvs = [train_gradient.bucket_vecs(c, 0, s, 16, F64) for s, c in enumerate(chunks)]
    jtvs = [j_bucket_vecs(c, s) for s, c in enumerate(jchunks)]
    for s in range(2):
        assert_rel(tvs[s].numpy(), jtvs[s], 1e-14, f"test vectors of chunk {s}")
    crefs = [list(refs[:2]), list(refs[2:])]
    weights = np.asarray([2.0, 1.0]) / 3.0
    tvec = flatten_params(net)[0]
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(vec))
    twn = float(torch.sqrt(torch.mean(tvec ** 2))) * 0.01
    loss, g = train_gradient.soft_step(net, tvec, chunks, tvs, crefs, weights,
                                       SoftConfig(**cfg), twn, prng.PRNGKey(17), 0)
    # the float64 draw is JAX's within a few ulps, and the model amplifies
    # such differences, so JAX is evaluated at the port's noisy weights
    lj, gj = 0.0, 0.0
    for bi in range(2):
        noisy_t = (tvec + twn * torch.from_numpy(prng.normal(prng.fold_in(prng.PRNGKey(17), bi),
                                                             (tvec.shape[0],), np.float64)))
        noisy = vec + wn * jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(17), bi),
                                             vec.shape, vec.dtype)
        assert_rel(noisy_t.numpy(), noisy, 1e-15, f"noisy weights of chunk {bi}")
        l_c, g_c = jax.value_and_grad(bucket_loss)(jnp.asarray(noisy_t.numpy()), jchunks[bi],
                                                   jtvs[bi], crefs[bi])
        lj, gj = lj + weights[bi] * float(l_c), gj + weights[bi] * g_c
    assert abs(loss - lj) <= LOSS_RTOL * abs(lj)
    gaps = flat_gaps(g.numpy(), gj, unravel)
    print(f"train step: loss {loss!r}, JAX {lj!r}; largest gradient gaps "
          f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:8]}")
    bad = {k: v for k, v in gaps.items() if v > GRAD_RTOL and k not in AMPLIFIED}
    assert not bad, bad
    from mlamg_torch.cli.optim import Adam, cosine_decay_schedule

    tx = optax.chain(optax.clip_by_global_norm(100.0),
                     optax.adam(optax.cosine_decay_schedule(3e-3, 600, alpha=0.3)))
    up, _ = tx.update(gj, tx.init(vec))
    Adam([tvec], cosine_decay_schedule(3e-3, 600, alpha=0.3), clip=100.0).step(
        [torch.from_numpy(np.asarray(gj))])
    assert_rel(tvec.numpy() - np.asarray(vec), up, 1e-12, "update")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_clis_run_and_write_what_the_jax_clis_write(tmp_path, capsys):
    """pretrain_dataset (1 epoch) and train_gradient (2 steps from it, with
    weight noise, the tau anneal and one grid per chunk) on 4 grids in float32: the JAX CLIs'
    lines, ``summary.json``'s keys, ``runs/metrics.jsonl``; the
    checkpoints load in the JAX package (``load_checkpoint``, flax apply)
    and ``mlamg_tpu.cli.evaluate_dataset`` evaluates the trained one."""
    pre = str(tmp_path / "p.ckpt")
    pretrain_dataset.main([DATA, "--epochs", "1", "--limit", "4", "--rel-strength", "true",
                           "--device", "cpu", "--out", pre])
    out = tmp_path / "grad"
    summary = train_gradient.main([
        DATA, "--steps", "2", "--limit", "4", "--bucket-step", "128", "--eval-every", "1",
        "--checkpoint-every", "1", "--rel-strength", "true", "--weight-noise", "0.01",
        "--tau-final", "0.015", "--grid-chunk", "1", "--start-model", pre, "--device", "cpu",
        "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "4 training grids" and lines[1].startswith("epoch 1: loss ")
    assert "center-recall@k" in lines[1] and lines[2] == f"saved {pre}"
    assert "loaded 4 train / 1 test grids (2 train buckets)" in lines
    assert "16328 weights" in lines
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and "discrete train" in steps[1] and "s/step)" in steps[1]
    with open(out / "summary.json") as f:
        assert json.load(f) == summary
    assert set(summary) == {"steps", "best_discrete_train", "final_discrete_train",
                            "final_discrete_test", "train_lloyd_conv", "test_lloyd_conv"}
    assert all(np.isfinite(v) for v in summary.values())
    with open(out / "runs" / "metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["tag"] for r in recs] == ["Loss/Train", "Loss/Test"] * 2
    # the JAX package reads both checkpoints and runs the model
    g = JGrid.load(smallest(1)[0].extra["filename"])
    for path in (pre, str(out / "grad_best.ckpt")):
        ck = j_load_checkpoint(path)
        nc = ck["extra"]["net_config"]
        assert nc == dict(CONFIG, bf_width=dataset_bf_width(smallest(4)))
        params = jax.tree.map(jnp.asarray, ck["best_params"])
        agg, P, *_ = jax.jit(lambda p, A: JFullAggNet(**nc).apply(p, A, 7))(
            params, JCSR.from_scipy(g.A, dtype=jnp.float32))
        assert int(jnp.max(agg)) <= 7 and bool(jnp.isfinite(P.data).all())
    test_dir = tmp_path / "one"
    test_dir.mkdir()
    shutil.copy(os.path.join(DATA, "test", "isotropic_0005.grid"), test_dir)
    j_evaluate_dataset.main([str(test_dir), "--model", str(out / "grad_best.ckpt"),
                             "--platform", "cpu", "--out", str(tmp_path / "ev")])
    with open(tmp_path / "ev" / "eval_one_alpha0.1.json") as f:
        ev = json.load(f)
    assert ev["n_grids"] == 1 and 0 < ev["ml"] <= 1.0
