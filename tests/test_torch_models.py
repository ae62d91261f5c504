"""GNN layers and the FullAggNet forward, ``mlamg_torch`` against
``mlamg_tpu`` (CPU, float64), with the weights of the repository's
checkpoints.

The JAX model is run op by op (not under ``jax.jit``).  The trained
FullAggNet amplifies rounding: its node features start constant, and what
the rounding of their mean leaves is multiplied by ~316 at every
InstanceNorm, so XLA's fused (jitted) program, which rounds differently,
gives other learned outputs; op by op, JAX and the port agree to the last
bits (see ``test_fullaggnet_amplifies_rounding``)."""

import copy
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlamg_tpu.models import FullAggNet as JFullAggNet
from mlamg_tpu.models import gnn as jgnn
from mlamg_tpu.models.graphdata import graph_from_matrix as j_graph_from_matrix
from mlamg_tpu.models.graphdata import graph_from_matrix_basic as j_graph_basic
from mlamg_tpu.ops.sparse import CSR as JCSR

from mlamg_torch.cli.common import dataset_bf_width
from mlamg_torch.convert import fullaggnet_from_params
from mlamg_torch.data.grid import Grid
from mlamg_torch.models.graphdata import build_in_ell, graph_from_matrix, graph_from_matrix_basic
from mlamg_torch.ops.sparse import CSR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
CHECKPOINTS = {"2d_iso": "runs_iso_r5", "2d_aniso": "runs_aniso_r5_c", "3d_iso": "runs_3d_iso_r5"}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def load_ckpt(family):
    with open(os.path.join(REPO, CHECKPOINTS[family], "grad_best.ckpt"), "rb") as f:
        return pickle.load(f)


def load_grids(family):
    return Grid.load_dir(os.path.join(REPO, "data_out", family, "test"))


def assert_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def iso_model():
    ck = load_ckpt("2d_iso")
    config = dict(ck["extra"]["net_config"])
    tnet = fullaggnet_from_params(ck["best_params"], config, device="cpu", dtype=F64)
    params = jax.tree.map(jnp.asarray, ck["best_params"])["params"]
    return tnet, params, config


@pytest.fixture(scope="module")
def graphs():
    """The n = 85 2d_iso grid's graph with random node features."""
    A = load_grids("2d_iso")[2].A
    Aj = JCSR.from_scipy(A, dtype=jnp.float64)
    At = CSR.from_scipy(A, dtype=F64, device="cpu")
    gj = j_graph_basic(Aj, ell_width=11, rel_strength=True)
    gt = graph_from_matrix_basic(At, ell_width=11, rel_strength=True)
    return gj, gt


# ---------------------------------------------------------------------------
# graph data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel_strength", [False, True])
@pytest.mark.parametrize("width", [None, 11])
def test_graph_from_matrix_basic_matches_jax(rel_strength, width):
    A = load_grids("2d_iso")[0].A
    gj = j_graph_basic(JCSR.from_scipy(A, dtype=jnp.float64), ell_width=width,
                       rel_strength=rel_strength)
    gt = graph_from_matrix_basic(CSR.from_scipy(A, dtype=F64, device="cpu"), ell_width=width,
                                 rel_strength=rel_strength)
    np.testing.assert_array_equal(gt.edge_attr.numpy(), np.asarray(gj.edge_attr))
    np.testing.assert_array_equal(gt.x.numpy(), np.asarray(gj.x))
    if width is not None:
        np.testing.assert_array_equal(gt.in_ell.numpy(), np.asarray(gj.in_ell))


def test_graph_from_matrix_matches_jax(rng):
    A = load_grids("2d_aniso")[0].A
    agg = rng.randint(0, 7, size=A.shape[0])
    gj = j_graph_from_matrix(JCSR.from_scipy(A, dtype=jnp.float64), jnp.asarray(agg), ell_width=11)
    gt = graph_from_matrix(CSR.from_scipy(A, dtype=F64, device="cpu"), t(agg), ell_width=11)
    np.testing.assert_array_equal(gt.edge_attr.numpy(), np.asarray(gj.edge_attr))
    np.testing.assert_array_equal(gt.in_ell.numpy(), np.asarray(gj.in_ell))


def test_build_in_ell_checks_its_width():
    A = load_grids("2d_iso")[0].A
    At = CSR.from_scipy(A, dtype=F64, device="cpu")
    deg = int(np.diff(A.indptr).max())
    assert build_in_ell(At.row, At.col, A.shape[0]).shape == (A.shape[0], deg)
    with pytest.raises(ValueError, match="dataset_bf_width"):
        build_in_ell(At.row, At.col, A.shape[0], deg - 1)


# ---------------------------------------------------------------------------
# layers, with checkpoint weights and random features
# ---------------------------------------------------------------------------


def test_mlp_and_instance_norm_match_jax(iso_model, rng):
    tnet, params, _ = iso_model
    x = rng.randn(85, 8)
    mlp = params["AggNetM"]["layer_0"]["mlp_0"]
    want = jgnn.MLP([8] * 4 + [8]).apply({"params": mlp}, jnp.asarray(x))
    assert_rel(tnet.AggNetM.layer_0.mlp_0(t(x)).detach().numpy(), np.asarray(want), 1e-14)
    want = jgnn.InstanceNorm().apply({}, jnp.asarray(x))
    assert_rel(tnet.AggNetM.layer_0.norm(t(x)).numpy(), np.asarray(want), 1e-14)
    mask = rng.rand(85) < 0.8
    want = jgnn.InstanceNorm().apply({}, jnp.asarray(x), jnp.asarray(mask))
    assert_rel(tnet.AggNetM.layer_0.norm(t(x), t(mask)).numpy(), np.asarray(want), 1e-14)
    const = np.full((85, 3), 1.0 / 85)  # the model's first input: exactly zero
    np.testing.assert_array_equal(tnet.AggNetM.layer_0.norm(t(const)).numpy(),
                                  np.asarray(jgnn.InstanceNorm().apply({}, jnp.asarray(const))))


def test_tagconv_matches_jax(iso_model, graphs, rng):
    tnet, params, _ = iso_model
    gj, gt = graphs
    x = rng.randn(85, 8)
    tag = params["AggNetM"]["layer_1"]["tag_1"]
    want = jgnn.TAGConv(8).apply({"params": tag}, gj, jnp.asarray(x), gj.edge_attr[:, -1])
    got = tnet.AggNetM.layer_1.tag_1(gt, t(x), gt.edge_attr[:, -1])
    assert_rel(got.detach().numpy(), np.asarray(want), 1e-13)


@pytest.mark.parametrize("conv", ["node_conv_in", "node_conv_2", "node_conv_out"])
def test_nnconv_matches_jax(iso_model, graphs, rng, conv):
    tnet, params, _ = iso_model
    gj, gt = graphs
    din, dout = {"node_conv_in": (1, 8), "node_conv_2": (8, 8), "node_conv_out": (8, 1)}[conv]
    x, e = rng.randn(85, din), rng.rand(gt.src.shape[0], 2)
    want = jgnn.NNConv(din, dout).apply({"params": params["CNet"][conv]}, gj, jnp.asarray(x),
                                        jnp.asarray(e))
    got = getattr(tnet.CNet, conv)(gt, t(x), t(e))
    assert_rel(got.detach().numpy(), np.asarray(want), 1e-13)


@pytest.mark.parametrize("conv", ["edge_conv_in", "edge_conv_out"])
def test_edge_model_matches_jax(iso_model, rng, conv):
    """flax LayerNorm: eps 1e-6 and the one-pass variance."""
    tnet, params, _ = iso_model
    E, d = 300, (8 if conv == "edge_conv_in" else 1)
    src, dst, e = rng.randn(E, d), rng.randn(E, d), rng.randn(E, 2)
    out = 2 if conv == "edge_conv_in" else 1
    want = jgnn.EdgeModel(8, out).apply({"params": params["PNet"][conv]}, jnp.asarray(src),
                                        jnp.asarray(dst), jnp.asarray(e))
    got = getattr(tnet.PNet, conv)(t(src), t(dst), t(e))
    assert_rel(got.detach().numpy(), np.asarray(want), 1e-13)
    assert getattr(tnet.PNet, conv).LayerNorm_0.eps == 1e-6


# ---------------------------------------------------------------------------
# the forward from the real checkpoints
# ---------------------------------------------------------------------------


CASES = [("2d_iso", 0), ("2d_aniso", 0), ("3d_iso", 0)]  # smallest grid of each


@pytest.mark.parametrize("family,idx", CASES)
def test_fullaggnet_forward_matches_jax(family, idx):
    """Scores, centers, C data, agg_id and P data against the JAX model run
    op by op; the agg-only and int-only halves as well."""
    grids = load_grids(family)
    g = sorted(grids, key=lambda g: g.n)[idx]
    ck = load_ckpt(family)
    nc = ck["extra"]["net_config"]
    width = max(int(nc["bf_width"]), dataset_bf_width(grids))
    config = dict(nc, bf_width=width)
    tnet = fullaggnet_from_params(ck["best_params"], config, device="cpu", dtype=F64)
    jnet = JFullAggNet(dim=nc["dim"], num_conv=nc["num_conv"], iterations=nc["iterations"],
                       bf_width=width, rel_strength=nc["rel_strength"])
    params = jax.tree.map(jnp.asarray, ck["best_params"])
    n = g.n
    k = int(np.ceil(0.1 * n))
    Aj = JCSR.from_scipy(g.A, dtype=jnp.float64)
    At = CSR.from_scipy(g.A, dtype=F64, device="cpu")
    with torch.no_grad():
        agg_t, P_t, C_t, cen_t, mask_t = tnet(At, k)
        _, scores_t = tnet.AggNetM(tnet.basic_graph(At), k)
        int_t = tnet.int_only(At, agg_t, k)
    agg_j, P_j, C_j, cen_j, mask_j = jnet.apply(params, Aj, k)
    _, scores_j = jnet.apply(params, jnet.basic_graph(Aj), k,
                             method=lambda m, g, k: m.AggNetM(g, k))
    gaps = {name: float(np.abs(a - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-300))
            for name, a, b in (("scores", scores_t.numpy(), scores_j),
                               ("C", C_t.data.numpy(), C_j.data), ("P", P_t.data.numpy(), P_j.data))}
    print(f"{family}: largest relative gaps {gaps}")
    assert_rel(scores_t.numpy(), np.asarray(scores_j), 1e-10)
    np.testing.assert_array_equal(cen_t.numpy(), np.asarray(cen_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert_rel(C_t.data.numpy(), np.asarray(C_j.data), 1e-10)
    np.testing.assert_array_equal(agg_t.numpy(), np.asarray(agg_j))
    assert_rel(P_t.data.numpy(), np.asarray(P_j.data), 1e-10)
    np.testing.assert_array_equal(P_t.col.numpy(), np.asarray(P_j.col))
    np.testing.assert_array_equal(tnet.agg_only(At, k).numpy(), np.asarray(agg_j))
    int_j = jnet.apply(params, Aj, agg_j, k, method="int_only")
    assert_rel(int_t.data.numpy(), np.asarray(int_j.data), 1e-10)


def test_fullaggnet_amplifies_rounding(iso_model):
    """Why the parity above is taken op by op: one ulp more on one node's
    input feature (1/n on every node) moves CNet's edge weights by more than
    1e-3 of their size."""
    tnet, _, _ = iso_model
    A = load_grids("2d_iso")[1].A
    g = graph_from_matrix_basic(CSR.from_scipy(A, dtype=F64, device="cpu"), ell_width=11,
                                rel_strength=True)
    x = g.x.clone()
    x[0] = torch.nextafter(x[0], torch.ones_like(x[0]))
    nudged = dataclasses.replace(g, x=x)
    with torch.no_grad():
        _, e0 = tnet.CNet(g)
        _, e1 = tnet.CNet(nudged)
    change = float((e1 - e0).abs().max()) / float(e0.abs().max())
    print(f"one ulp on one node moves CNet's edge weights by {change:.3g} of their size")
    assert change > 1e-3


# ---------------------------------------------------------------------------
# the checkpoint converter
# ---------------------------------------------------------------------------


def test_converter_maps_flax_names_and_transposes_kernels(iso_model):
    tnet, params, config = iso_model
    kernel = np.asarray(params["CNet"]["node_conv_2"]["Dense_2"]["kernel"])  # (16, 64)
    np.testing.assert_array_equal(tnet.CNet.node_conv_2.Dense_2.weight.detach().numpy(),
                                  kernel.T)
    ln = params["PNet"]["edge_conv_1"]["LayerNorm_0"]
    np.testing.assert_array_equal(tnet.PNet.edge_conv_1.LayerNorm_0.weight.detach().numpy(),
                                  np.asarray(ln["scale"]))
    assert tnet.AggNetM.layer_0.tag_1.Dense_1.bias is None  # TAGConv: bias on W_0 only
    n_params = sum(np.asarray(v).size for v in jax.tree.leaves(params))
    assert sum(p.numel() for p in tnet.parameters()) == n_params


def test_converter_rejects_missing_unknown_and_misshapen_keys():
    ck = load_ckpt("2d_iso")
    config = dict(ck["extra"]["net_config"])
    bad = copy.deepcopy(ck["best_params"])
    del bad["params"]["PNet"]["edge_conv_0"]["Dense_1"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        fullaggnet_from_params(bad, config, device="cpu")
    bad = copy.deepcopy(ck["best_params"])
    bad["params"]["CNet"]["extra_layer"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unknown"):
        fullaggnet_from_params(bad, config, device="cpu")
    with pytest.raises(ValueError, match="shapes"):  # rel_strength changes CNet's shapes
        fullaggnet_from_params(ck["best_params"], dict(config, rel_strength=False), device="cpu")
