"""Port parity, the models and tools of the remaining CLIs: connected
components, ``DisjointSets``, ``mg/helpers``, ``graph_from_matrix_node_vals``,
``EdgeConv``, ``ConvergencePredictor``, ``AggOnlyNet``, the continuous
interpolation networks with ``EC_loss`` and ``E_loss_discrete``, flax's
initial weights and the parameter conversion; ``mlamg_torch`` against
``mlamg_tpu`` on the same numpy inputs (CPU).

Tolerances: integer and numpy results exactly; the networks in float64
(flax's float32 initial weights cast to float64, JAX applied op by op)
within 1e-10 relative to the largest entry; flax's initial weights bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mlamg_tpu.data import Grid as JGrid
from mlamg_tpu.graph import components as jcomp
from mlamg_tpu.graph.disjoint_sets import DisjointSets as JDisjointSets
from mlamg_tpu.mg import helpers as jhelpers
from mlamg_tpu.models import convergence as jconv
from mlamg_tpu.models import interpolation as jinterp
from mlamg_tpu.models.agg_interp import AggOnlyNet as JAggOnlyNet
from mlamg_tpu.models.gnn import EdgeConv as JEdgeConv
from mlamg_tpu.models.graphdata import graph_from_matrix_node_vals as j_node_vals
from mlamg_tpu.ops.sparse import CSR as JCSR

from mlamg_torch.convert import module_from_params, params_from_module
from mlamg_torch.data.grid import Grid
from mlamg_torch.graph import components
from mlamg_torch.graph.disjoint_sets import DisjointSets
from mlamg_torch.mg import helpers
from mlamg_torch.models import interpolation
from mlamg_torch.models.agg_interp import AggOnlyNet
from mlamg_torch.models.convergence import ConvergencePredictor, load_mat_dataset
from mlamg_torch.models.gnn import EdgeConv, init_flax_
from mlamg_torch.models.graphdata import graph_from_matrix_node_vals
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng

CPU = "cpu"
F64 = torch.float64
RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one torch thread per pytest worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def f64_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def grid_A():
    """A 40-node random-hull FEM matrix (symmetric pattern)."""
    return sp.csr_matrix(JGrid.random_2d_unstructured(40, seed=5).A)


def two_blobs():
    """Two 5x5 grids side by side, not joined: two components."""
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(5, 5))
    P = (sp.kron(sp.eye(5), T) + sp.kron(T, sp.eye(5))).tocsr()
    return sp.block_diag([P, P, sp.eye(1)]).tocsr()


# ---- graph: components and disjoint sets ------------------------------------

@pytest.mark.parametrize("which", ["blobs", "hull"])
def test_connected_components_match_jax(grid_A, which):
    A = two_blobs() if which == "blobs" else grid_A
    lab = components.connected_components(CSR.from_scipy(A, device=CPU))
    want = jcomp.connected_components(JCSR.from_scipy(A))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want))
    assert components.num_connected_components(CSR.from_scipy(A, device=CPU)) == int(
        jcomp.num_connected_components(JCSR.from_scipy(A)))
    assert components.num_connected_components(CSR.from_scipy(A, device=CPU)) == (
        3 if which == "blobs" else 1)


def test_check_aggregates_connected_matches_jax(grid_A):
    rng = np.random.RandomState(0)
    n = grid_A.shape[0]
    # connected: each node joins its nearest of k centers (a shortest-path
    # forest); scattered: random ids
    k = 8
    pattern = sp.csr_matrix((np.ones(grid_A.nnz), grid_A.indices, grid_A.indptr), grid_A.shape)
    _, _, src = sp.csgraph.dijkstra(pattern, indices=np.arange(0, n, n // k)[:k], min_only=True,
                                    return_predecessors=True)
    contiguous = np.searchsorted(np.arange(0, n, n // k)[:k], src)
    scattered = rng.randint(0, k, n)
    with_unassigned = contiguous.copy()
    with_unassigned[contiguous == 3] = k  # the sentinel id: not an aggregate
    for agg, expect in ((contiguous, True), (scattered, False), (with_unassigned, None)):
        got = components.check_aggregates_connected(CSR.from_scipy(grid_A, device=CPU), t(agg), k)
        want = bool(jcomp.check_aggregates_connected(JCSR.from_scipy(grid_A),
                                                     jnp.asarray(agg, jnp.int32), k))
        assert got == want
        if expect is not None:
            assert got is expect


def test_disjoint_sets_match_jax():
    rng = np.random.RandomState(1)
    ours, theirs = DisjointSets(30), JDisjointSets(30)
    for a, b in rng.randint(0, 30, (40, 2)):
        assert ours.union(int(a), int(b)) == theirs.union(int(a), int(b))
        assert ours.num_sets == theirs.num_sets
    np.testing.assert_array_equal(ours.labels(), theirs.labels())
    np.testing.assert_array_equal(ours.parent, theirs.parent)
    assert all(ours.connected(i, j) == theirs.connected(i, j)
               for i, j in rng.randint(0, 30, (20, 2)))


# ---- mg/helpers: numpy, bit for bit -----------------------------------------

def test_helpers_match_jax_bit_for_bit():
    n = 15
    A = helpers.gen_1d_poisson_fd(n)
    np.testing.assert_array_equal(A, jhelpers.gen_1d_poisson_fd(n))
    k = np.linspace(1.0, 3.0, n + 1)
    np.testing.assert_array_equal(helpers.gen_1d_poisson_fd_vc(n, k),
                                  jhelpers.gen_1d_poisson_fd_vc(n, k))
    for f in (2, 3, 0.5, 1 / 3):
        for a, b in zip(helpers.grid_from_coarsening_factor(n, f),
                        jhelpers.grid_from_coarsening_factor(n, f)):
            np.testing.assert_array_equal(a, b)
    C, _ = helpers.grid_from_coarsening_factor(n, 2)
    np.testing.assert_array_equal(helpers.ideal_interpolation(A, C),
                                  jhelpers.ideal_interpolation(A, C))
    u0 = helpers.random_u(n, rng=np.random.RandomState(3))
    np.testing.assert_array_equal(u0, jhelpers.random_u(n, rng=np.random.RandomState(3)))
    f = np.zeros(n)
    np.testing.assert_array_equal(helpers.relax(A, u0, f, nu=3), jhelpers.relax(A, u0, f, nu=3))
    P = helpers.ideal_interpolation(A, C)
    A1 = P.T @ A @ P
    np.testing.assert_array_equal(helpers.twolevel(A, P, A1, u0, f),
                                  jhelpers.twolevel(A, P, A1, u0, f))
    assert helpers.det_conv_factor(A, C, f, u0, f, 0.666) == jhelpers.det_conv_factor(
        A, C, f, u0, f, 0.666)
    assert helpers.det_conv_factor_optimal_omega(A, C, f, u0, f) == \
        jhelpers.det_conv_factor_optimal_omega(A, C, f, u0, f)
    S = sp.csr_matrix(A)
    got, want = helpers.normalize_mat(S), jhelpers.normalize_mat(S)
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    assert got.data.min() >= 0.1 and got.data.max() <= 1.0


# ---- graph data and EdgeConv -------------------------------------------------

def node_vals_graphs(A, x):
    return (graph_from_matrix_node_vals(CSR.from_scipy(A, dtype=F64, device=CPU), t(x)),
            j_node_vals(JCSR.from_scipy(A, dtype=jnp.float64), jnp.asarray(x)))


def test_graph_from_matrix_node_vals_matches_jax(grid_A):
    x = np.random.RandomState(2).randn(grid_A.shape[0])
    g, jg = node_vals_graphs(grid_A, x)
    np.testing.assert_array_equal(g.x.numpy(), np.asarray(jg.x))
    np.testing.assert_array_equal(g.edge_attr.numpy(), np.asarray(jg.edge_attr))
    np.testing.assert_array_equal(g.src.numpy(), np.asarray(jg.src))
    np.testing.assert_array_equal(g.dst.numpy(), np.asarray(jg.dst))
    assert g.x.shape == (grid_A.shape[0], 1) and g.n == jg.n


def test_edgeconv_matches_jax(grid_A):
    rng = np.random.RandomState(4)
    n = grid_A.shape[0]
    x = rng.randn(n, 3)
    g, jg = node_vals_graphs(grid_A, x)
    e = rng.randn(g.src.shape[0], 2)  # one row per edge slot, padding included
    assert jg.src.shape == g.src.shape
    jnet = JEdgeConv(6, 2)
    params = f64_tree(jnet.init(jax.random.PRNGKey(0), jg, jnp.asarray(x), jnp.asarray(e)))
    want = jnet.apply(params, jg, jnp.asarray(x), jnp.asarray(e))
    net = module_from_params(EdgeConv(3 + 3 + 2, 6, 2), params, device=CPU, dtype=F64)
    assert gap(net(g, t(x), t(e)).detach().numpy(), want) <= RTOL


# ---- ConvergencePredictor ---------------------------------------------------

@pytest.mark.parametrize("logit_head", [True, False])
def test_convergence_predictor_value_and_gradient_match_jax(grid_A, logit_head):
    x = np.random.RandomState(5).rand(grid_A.shape[0], 8)
    g, jg = node_vals_graphs(grid_A, x)
    jnet = jconv.ConvergencePredictor(dims=(6, 8), K=3, logit_head=logit_head)
    params = f64_tree(jnet.init(jax.random.PRNGKey(1), jg))
    want, want_grad = jax.value_and_grad(lambda p: jnet.apply(p, jg))(params)
    net = module_from_params(ConvergencePredictor(8, dims=(6, 8), K=3, logit_head=logit_head),
                             params, device=CPU, dtype=F64)
    out = net(g)
    grads = torch.autograd.grad(out, list(net.parameters()))
    assert gap(out.detach().numpy(), want) <= RTOL
    for p, gr in zip(net.parameters(), grads):
        p.grad = gr
    got_grad = jax.tree.map(np.asarray, {"params": _grad_tree(net)})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got_grad),
                            jax.tree.leaves(want_grad)):
        assert gap(a, b) <= RTOL, path


def _grad_tree(net) -> dict:
    from mlamg_torch.convert import param_leaves

    tree: dict = {}
    for path, p, is_kernel in param_leaves(net):
        node = tree
        for key in path[1:-1]:
            node = node.setdefault(key, {})
        v = p.grad.numpy()
        node[path[-1]] = v.T if is_kernel else v
    return tree


def test_init_equals_flax_init_bit_for_bit(grid_A):
    """init_flax_ against flax's init for the C/F interpolation network (its
    TAGConv kernels, the hops' bias-free Dense, the edge head with its
    LayerNorm) and the convergence predictor: every leaf equal."""
    from mlamg_tpu.cli.train_cf_interp import cf_inputs as j_cf_inputs
    from mlamg_tpu.cli.train_cf_interp import pinned_pressure_laplacian
    from mlamg_tpu.data.stokes import lid_driven_cavity
    from mlamg_tpu.models.cf_interp import CFInterpolationNetwork as JCF

    from mlamg_torch.convert import params_from_cfnet
    from mlamg_torch.models.cf_interp import CFInterpolationNetwork

    A = pinned_pressure_laplacian(lid_driven_cavity(n=8, Re=10.0))
    for seed in (0, 3):
        want = JCF(dims=(8, 8, 16), K=3).init(jax.random.PRNGKey(seed),
                                              *j_cf_inputs(A, 0.56, jnp.float64))
        got = params_from_cfnet(init_flax_(CFInterpolationNetwork(dims=(8, 8, 16), K=3),
                                           prng.PRNGKey(seed)))
        _assert_trees_equal(got, want)
    _, jg = node_vals_graphs(grid_A, np.ones((grid_A.shape[0], 8)))
    want = jconv.ConvergencePredictor(dims=(16, 32, 16), K=10).init(jax.random.PRNGKey(0), jg)
    got = params_from_module(init_flax_(ConvergencePredictor(8, dims=(16, 32, 16), K=10),
                                        prng.PRNGKey(0)))
    _assert_trees_equal(got, want)


def _assert_trees_equal(got, want):
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        assert g.dtype == w.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_load_mat_dataset_reads_splittings(tmp_path, grid_A):
    import pickle

    import scipy.io as sio

    sio.savemat(tmp_path / "m0.mat", {"A": grid_A})
    sio.savemat(tmp_path / "m1.mat", {"K": 2 * grid_A})
    entries = [{"matrix": "m0.mat", "split": [0, 1]}, {"matrix": "m1.mat", "key": "K"}]
    with open(tmp_path / "s.pkl", "wb") as f:
        pickle.dump(entries, f)
    got = load_mat_dataset(str(tmp_path / "s.pkl"), str(tmp_path))
    want = jconv.load_mat_dataset(str(tmp_path / "s.pkl"), str(tmp_path))
    for (a, ea), (b, eb) in zip(got, want):
        assert ea == eb and (a != b).nnz == 0
    assert (got[1][0] != 2 * grid_A).nnz == 0


# ---- AggOnlyNet -------------------------------------------------------------

@pytest.mark.parametrize("pull,rel_strength", [(False, False), (True, True)])
def test_aggonlynet_matches_jax(grid_A, pull, rel_strength):
    """On the random hull: a structured grid's scores tie, and top-k then
    breaks the ties in each library's own way."""
    A, k = grid_A, 5
    bf_width = int(np.diff(A.indptr).max()) if pull else None
    cfg = dict(dim=8, num_conv=2, iterations=2, bf_width=bf_width, rel_strength=rel_strength)
    jA = JCSR.from_scipy(A, dtype=jnp.float64)
    jnet = JAggOnlyNet(**cfg)
    params = f64_tree(jnet.init(jax.random.PRNGKey(2), jA, k))
    j_agg, jP, jC, j_centers, _ = jnet.apply(params, jA, k)
    net = module_from_params(AggOnlyNet(**cfg), params, device=CPU, dtype=F64)
    with torch.no_grad():
        agg, P, C, centers, _ = net(CSR.from_scipy(A, dtype=F64, device=CPU), k)
    np.testing.assert_array_equal(agg.numpy(), np.asarray(j_agg))
    np.testing.assert_array_equal(centers.numpy(), np.asarray(j_centers))
    assert gap(C.data.numpy(), np.asarray(jC.data)) <= RTOL
    assert gap(P.todense().numpy(), np.asarray(jP.todense())) <= RTOL
    assert params_from_module(net).keys() == {"params"}


# ---- continuous interpolation networks and their losses ---------------------

@pytest.fixture(scope="module")
def small_graph():
    A = sp.csr_matrix(Grid.structured_2d_poisson_dirichlet(4, 4).A)
    x = np.random.RandomState(6).rand(A.shape[0], 1)
    return A, x


def test_interpolation_networks_match_jax(small_graph):
    A, x = small_graph
    g, jg = node_vals_graphs(A, x)
    n = A.shape[0]
    c = np.random.RandomState(7).rand(n)
    cols = np.array([0, 5, n - 1])
    jP = jinterp.InterpolationNetwork(K=2)
    params = f64_tree(jP.init(jax.random.PRNGKey(3), jg, jnp.asarray(c), 0))
    want = np.stack([np.asarray(jP.apply(params, jg, jnp.asarray(c), int(i))) for i in cols], 1)
    net = module_from_params(interpolation.InterpolationNetwork(K=2), params, device=CPU, dtype=F64)
    assert gap(net(g, t(c), t(cols)).detach().numpy(), want) <= RTOL

    jcf = jinterp.CoarseFineNetwork(K=2, dims=(5, 4, 1))
    params = f64_tree(jcf.init(jax.random.PRNGKey(4), jg))
    net = module_from_params(interpolation.CoarseFineNetwork(K=2, dims=(5, 4, 1)), params,
                             device=CPU, dtype=F64)
    assert gap(net(g).detach().numpy(), jcf.apply(params, jg)) <= RTOL

    jfull = jinterp.ContinuousInterpolationFullNetwork(K_interp=2, K_cf=2)
    params = f64_tree(jfull.init(jax.random.PRNGKey(5), jg))
    want_P, want_c = jfull.apply(params, jg)
    net = module_from_params(interpolation.ContinuousInterpolationFullNetwork(K_interp=2, K_cf=2),
                             params, device=CPU, dtype=F64)
    got_P, got_c = net(g)
    assert got_P.shape == (n, n)
    assert gap(got_c.detach().numpy(), want_c) <= RTOL
    assert gap(got_P.detach().numpy(), want_P) <= RTOL
    back = params_from_module(net)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_energy_losses_match_jax(small_graph):
    from mlamg_tpu.models.loss import R_jacobi as j_R_jacobi

    A, _ = small_graph
    n = A.shape[0]
    rng = np.random.RandomState(8)
    Phat, c = rng.rand(n, n), rng.rand(n)
    R = np.asarray(j_R_jacobi(JCSR.from_scipy(A, dtype=jnp.float64)))
    for Aj, At in ((JCSR.from_scipy(A, dtype=jnp.float64), CSR.from_scipy(A, dtype=F64, device=CPU)),
                   (jnp.asarray(A.toarray()), t(A.toarray()))):
        want = jinterp.EC_loss(Aj, jnp.asarray(Phat), jnp.asarray(c), jnp.asarray(R))
        assert gap(interpolation.EC_loss(At, t(Phat), t(c), t(R)).numpy(), want) <= RTOL
    P = np.asarray(jhelpers.ideal_interpolation(A, np.arange(n) % 3 == 0))
    want = jinterp.E_loss_discrete(JCSR.from_scipy(A, dtype=jnp.float64), jnp.asarray(P),
                                   jnp.asarray(R))
    got = interpolation.E_loss_discrete(CSR.from_scipy(A, dtype=F64, device=CPU), t(P), t(R))
    assert gap(got.numpy(), want) <= RTOL
