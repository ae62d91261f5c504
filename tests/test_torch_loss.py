"""Training's building blocks, ``mlamg_torch`` against ``mlamg_tpu`` on the
same numpy inputs (CPU, float64): ``fold_in``, ``soft_topk_mask``,
``multi_source_bf``, ``soft_assignment``, ``amg_loss`` and ``E_loss``, the
optimiser against optax, the flat weight order against ``ravel_pytree``,
the converter both ways and flax's initialisation rules.

The JAX functions run op by op (no ``jax.jit``), as the port follows them.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch
from jax.flatten_util import ravel_pytree

from mlamg_tpu.graph.bellman_ford import bellman_ford as j_bellman_ford
from mlamg_tpu.graph.topk import soft_topk_mask as j_soft_topk_mask
from mlamg_tpu.models import loss as jloss
from mlamg_tpu.models import soft_pipeline as jsp
from mlamg_tpu.ops.sparse import CSR as JCSR

from mlamg_torch.cli.optim import Adam, cosine_decay_schedule
from mlamg_torch.convert import fullaggnet_from_params, params_from_fullaggnet
from mlamg_torch.data.grid import Grid
from mlamg_torch.ga.codec import assign_flat, flat_grad, flatten_params
from mlamg_torch.graph.bellman_ford import bellman_ford
from mlamg_torch.graph.topk import soft_topk_mask, topk_mask
from mlamg_torch.models import loss as tloss
from mlamg_torch.models import soft_pipeline as tsp
from mlamg_torch.models.agg_interp import FullAggNet
from mlamg_torch.models.gnn import Dense, LayerNorm, init_flax_
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


@pytest.fixture(scope="module")
def small_grid():
    """The smallest 2d_iso training grid (n 68)."""
    grids = Grid.load_dir(os.path.join(REPO, "data_out", "2d_iso", "train"))
    return min(grids, key=lambda g: g.n).A.tocsr()


@pytest.fixture(scope="module")
def checkpoint():
    with open(os.path.join(REPO, "runs_iso_r5", "grad_best.ckpt"), "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# random keys, soft top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,data", [(0, 0), (17, 5), (31 * 3 + 17, 599 * 131 + 1), (7, 2**32 - 1)])
def test_fold_in_matches_jax_bit_for_bit(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(seed), data), want)


@pytest.mark.parametrize("shape", [(16328,), (3, 128, 16)])
def test_normal_serves_the_trainers_shapes(shape):
    """The weight-noise draw (W,) and a bucket's test vectors (B, n_pad, t):
    within 3 ulps in float32 (the bound tests/test_torch_prng.py holds)."""
    key = prng.fold_in(prng.PRNGKey(17), 131)
    want = np.asarray(jax.random.normal(jnp.asarray(key), shape, jnp.float32))
    got = prng.normal(key, shape, np.float32)
    assert got.shape == want.shape
    ulps = np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))
    assert ulps.max() <= 3, ulps.max()


@pytest.mark.parametrize("k", [1, 5, 40])
def test_soft_topk_mask_matches_jax(rng, k):
    """Value (1e-15) and gradient (1e-14); the threshold is held constant,
    and k = n takes the smallest score minus one."""
    x = rng.randn(40)
    x[3] = x[7]  # a tie
    want, vjp = jax.vjp(lambda v: j_soft_topk_mask(v, k, sigma=0.5), jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = soft_topk_mask(xt, k, sigma=0.5)
    w = rng.randn(40)
    (got * t(w)).sum().backward()
    assert rel(got.detach(), want) <= 1e-15
    assert rel(xt.grad, vjp(jnp.asarray(w))[0]) <= 1e-14
    # sigma -> 0 gives the hard mask
    hard = soft_topk_mask(t(x + np.arange(40) * 1e-3), k, sigma=1e-9)
    np.testing.assert_array_equal(hard.numpy(), topk_mask(t(x + np.arange(40) * 1e-3), k).numpy())


# ---------------------------------------------------------------------------
# multi-source Bellman-Ford and the soft assignment
# ---------------------------------------------------------------------------


def integer_weights(A, rng):
    """A's pattern with small integer weights: many tied shortest paths."""
    C = A.copy()
    C.data = rng.randint(1, 4, size=C.nnz).astype(np.float64)
    return C


def test_multi_source_bf_matches_scalar_bf_and_jax(small_grid, rng):
    """Distances (exact) against JAX's, their row minimum against the scalar
    Bellman-Ford's nearest distance, and the gradient of a weighted sum in
    C's values against JAX's (1e-14): ties split evenly as JAX's
    segment_min and minimum split them."""
    C = integer_weights(small_grid, rng)
    Ct = CSR.from_scipy(C, dtype=F64, device="cpu")
    Cj = JCSR.from_scipy(C, dtype=jnp.float64)
    centers = np.sort(rng.choice(C.shape[0], 7, replace=False))
    data = Ct.data.clone().requires_grad_()
    D = tsp.multi_source_bf(Ct.with_data(data), t(centers), 24)
    Dj, vjp = jax.vjp(lambda d: jsp.multi_source_bf(Cj.with_data(d), jnp.asarray(centers), 24),
                      Cj.data)
    np.testing.assert_array_equal(D.detach().numpy(), np.asarray(Dj))
    dist, _ = bellman_ford(Ct, t(centers))
    np.testing.assert_array_equal(D.detach().min(1).values.numpy(), dist.numpy())
    np.testing.assert_array_equal(dist.numpy(), np.asarray(j_bellman_ford(Cj, jnp.asarray(centers))[0]))
    W = rng.rand(*D.shape)
    (D * t(W)).sum().backward()
    assert rel(data.grad, vjp(jnp.asarray(W))[0]) <= 1e-14


def test_soft_assignment_hard_limit_and_dead_pairs(rng):
    D = rng.rand(30, 6) * 5
    D[4, 2] = D[9, :] = tsp._BIG  # a dead pair, a fully unreachable row
    logw = np.log(rng.rand(6) + 0.1)
    Dt = t(D).requires_grad_()
    Wt = tsp.soft_assignment(Dt, t(logw), 0.3)
    Wj, vjp = jax.vjp(lambda d: jsp.soft_assignment(d, jnp.asarray(logw), 0.3), jnp.asarray(D))
    assert rel(Wt.detach(), Wj) <= 1e-15
    assert Wt[4, 2] == 0.0 and bool((Wt[9] == 0).all())
    cot = rng.randn(30, 6)
    (Wt * t(cot)).sum().backward()
    assert bool(torch.isfinite(Dt.grad).all())
    assert rel(Dt.grad, vjp(jnp.asarray(cot))[0]) <= 1e-13
    # tau -> 0: the one-hot of each live row's nearest center
    hard = tsp.soft_assignment(t(D), torch.zeros(6, dtype=F64), 1e-6).numpy()
    live = np.arange(30) != 9
    np.testing.assert_array_equal(hard[live].argmax(1), D[live].argmin(1))
    np.testing.assert_allclose(hard[live].max(1), 1.0, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# amg_loss and E_loss
# ---------------------------------------------------------------------------


def sa_prolongator(A, k, rng):
    """A dense Jacobi-smoothed prolongator of random aggregates."""
    n = A.shape[0]
    agg = np.concatenate([np.arange(k), rng.randint(0, k, n - k)])
    T = np.eye(k)[agg]
    d = A.diagonal()
    return T - (2.0 / 3.0) * (A @ T) / d[:, None]


@pytest.mark.parametrize("ridge,neumann", [(0.0, False), (1e-4, False), (1e-4, True)])
def test_amg_loss_value_and_gradient_match_jax(small_grid, rng, ridge, neumann):
    """Value within 1e-13 relative and the gradient in P within 1e-11, for
    the Jacobi error sweep; the Neumann bordering on the operator with its
    constant nullspace restored (row sums zero)."""
    A = small_grid.copy()
    if neumann:
        A = (A - sp.diags(np.asarray(A.sum(1)).ravel())).tocsr()
    n, k = A.shape[0], 7
    P = sa_prolongator(A, k, rng)
    tv = np.asarray(jloss.make_test_vectors(n, 8, jax.random.PRNGKey(3), jnp.float64))
    tv_t = tloss.make_test_vectors(n, 8, prng.PRNGKey(3), F64)
    assert rel(tv_t, tv) <= 1e-14
    Aj, At = JCSR.from_scipy(A, dtype=jnp.float64), CSR.from_scipy(A, dtype=F64, device="cpu")
    kw = dict(tot_num_loop=5, ridge=ridge, neumann_solve_fix=neumann)
    want, vjp = jax.vjp(lambda p: jloss.amg_loss(p, Aj, jnp.asarray(tv), **kw), jnp.asarray(P))
    Pt = t(P).requires_grad_()
    got = tloss.amg_loss(Pt, At, t(tv), **kw)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-13 * abs(float(want))
    assert rel(Pt.grad, vjp(jnp.ones_like(want))[0]) <= 1e-11
    assert 0.0 < float(got) < 1.0


def test_amg_loss_takes_a_csr_prolongator(small_grid, rng):
    """A CSR P gives the dense P's value (1e-13)."""
    A = small_grid
    P = sa_prolongator(A, 7, rng)
    At = CSR.from_scipy(A, dtype=F64, device="cpu")
    Pc = CSR.from_scipy(sp.csr_matrix(P), dtype=F64, device="cpu")
    tv = tloss.make_test_vectors(A.shape[0], 8, prng.PRNGKey(1), F64)
    dense = float(tloss.amg_loss(t(P), At, tv, ridge=1e-4))
    assert abs(float(tloss.amg_loss(Pc, At, tv, ridge=1e-4)) - dense) <= 1e-13 * dense


def test_e_loss_and_r_jacobi_match_jax(small_grid, rng):
    A = small_grid
    P = sa_prolongator(A, 7, rng)
    Aj, At = JCSR.from_scipy(A, dtype=jnp.float64), CSR.from_scipy(A, dtype=F64, device="cpu")
    assert rel(tloss.R_jacobi(At), jloss.R_jacobi(Aj)) <= 1e-15
    want = float(jloss.E_loss(Aj, jnp.asarray(P)))
    assert abs(float(tloss.E_loss(At, t(P))) - want) <= 1e-12 * want


# ---------------------------------------------------------------------------
# the optimiser, the flat order, the converter, the initialisation
# ---------------------------------------------------------------------------


def test_adam_matches_optax_over_five_steps(rng):
    """chain(clip_by_global_norm(100), adam(cosine_decay_schedule)) on fixed
    gradients, two of them clipped, and plain adam(lr): each step within
    1e-12 relative of optax."""
    W, steps = 200, 5
    vec0 = rng.randn(W)
    grads = [rng.randn(W) * s for s in (1.0, 30.0, 0.1, 12.0, 2.0)]  # norms ~14 ... 424
    assert sum(np.linalg.norm(g) > 100 for g in grads) == 2
    for clip, lr in ((100.0, optax.cosine_decay_schedule(3e-3, 8, alpha=0.3)), (None, 2e-3)):
        tx = optax.adam(lr) if clip is None else optax.chain(optax.clip_by_global_norm(clip),
                                                             optax.adam(lr))
        state, pj = tx.init(jnp.asarray(vec0)), jnp.asarray(vec0)
        pt = t(vec0).clone()
        opt = Adam([pt], cosine_decay_schedule(3e-3, 8, alpha=0.3) if clip else 2e-3, clip=clip)
        for g in grads:
            up, state = tx.update(jnp.asarray(g), state)
            pj = optax.apply_updates(pj, up)
            opt.step([t(g)])
            assert rel(pt - t(vec0), np.asarray(pj) - vec0) <= 1e-12


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(3e-3, 600, alpha=0.3)
    mine = cosine_decay_schedule(3e-3, 600, alpha=0.3)
    for c in (0, 1, 299, 599, 600, 700):
        assert abs(mine(c) - float(sched(c))) <= 1e-15


def test_flat_order_is_ravel_pytree_and_round_trips(checkpoint):
    params = checkpoint["best_params"]
    config = checkpoint["extra"]["net_config"]
    net = fullaggnet_from_params(params, config, device="cpu", dtype=F64)
    vec, unravel = flatten_params(net)
    want, _ = ravel_pytree(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))
    assert vec.shape == (16328,)
    assert jax.tree.structure(unravel(vec)) == jax.tree.structure(params)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, unravel(vec), params)))
    # converter both ways
    back = params_from_fullaggnet(net)
    assert all(jax.tree.leaves(jax.tree.map(lambda a, b: np.array_equal(a, b) and a.shape == b.shape,
                                            back, params)))
    again = fullaggnet_from_params(back, config, device="cpu", dtype=F64)
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                 net.state_dict().values()))
    # a vector written into the module, and the gradients read in the same order
    assign_flat(net, vec * 2)
    np.testing.assert_array_equal(flatten_params(net)[0].numpy(), 2 * np.asarray(want))
    for p in net.parameters():
        p.grad = p.detach().clone()
    np.testing.assert_array_equal(flat_grad(net).numpy(), 2 * np.asarray(want))


def test_flax_initialisation_rules(checkpoint):
    """init_flax_ follows flax's rules: each Dense kernel lecun_normal
    (truncated to 2 std; its sample std within 25% of 1/sqrt(fan_in) for
    the larger layers), biases zero but EdgeModel's head (0.1 in the MPNN
    output), LayerNorm 1 and 0; the same key gives the same weights, and
    the tree and shapes are flax's."""
    net = init_flax_(FullAggNet(dim=8, num_conv=2, iterations=2, bf_width=11, rel_strength=True),
                     prng.PRNGKey(0))
    for name, m in net.named_modules():
        if isinstance(m, Dense):
            w = m.weight.detach()
            std = 1.0 / np.sqrt(w.shape[1])
            assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-12
            if w.numel() >= 128:
                assert abs(float(w.std()) / std - 1) < 0.25, (name, float(w.std()), std)
            if m.bias is not None:
                head = name.endswith("edge_conv_out.Dense_1")
                assert bool((m.bias == (0.1 if head else 0.0)).all()), name
        elif isinstance(m, LayerNorm):
            assert bool((m.weight == 1).all()) and bool((m.bias == 0).all())
    again = init_flax_(FullAggNet(dim=8, num_conv=2, iterations=2, bf_width=11, rel_strength=True),
                       prng.PRNGKey(0))
    np.testing.assert_array_equal(flatten_params(net)[0].numpy(), flatten_params(again)[0].numpy())
    # flax's tree and shapes: those of the checkpoint trained with this config
    jparams = checkpoint["best_params"]
    assert jax.tree.structure(params_from_fullaggnet(net)) == jax.tree.structure(jparams)
    assert all(jax.tree.leaves(jax.tree.map(lambda a, b: a.shape == b.shape,
                                            params_from_fullaggnet(net), jparams)))


# init_flax_ against flax: every key, uniform draw and bound is JAX's bit for
# bit; erf_inv's log1p is numpy's where XLA's CPU backend has its own, which
# leaves ~1% of the kernel weights 1-3 float32 ulps from JAX's (190 of
# 16,328 at seed 0 with jax 0.9); the bound leaves a margin of one ulp
INIT_ULPS, INIT_UNEQUAL_SHARE = 4, 0.02


@pytest.mark.parametrize("rel_strength", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_init_equals_flax_init(small_grid, seed, rel_strength):
    """init_flax_(net, PRNGKey(s)) against the JAX package's
    FullAggNet.init(PRNGKey(s), A, k), leaf by leaf in float32: the same
    tree, biases and LayerNorms equal, the kernels within INIT_ULPS ulps
    and almost all equal."""
    from mlamg_tpu.models import FullAggNet as JFullAggNet

    cfg = dict(dim=8, num_conv=2, iterations=2, bf_width=11, rel_strength=rel_strength)
    want = JFullAggNet(**cfg).init(jax.random.PRNGKey(seed), JCSR.from_scipy(small_grid), 7)
    got = params_from_fullaggnet(init_flax_(FullAggNet(**cfg), prng.PRNGKey(seed)))
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    unequal = total = 0
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, path
        gap = np.abs(g.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
        if path[-1].key != "kernel":
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        assert gap.max() <= INIT_ULPS, (path, int(gap.max()))
        unequal += int((gap > 0).sum())
        total += gap.size
    assert unequal <= INIT_UNEQUAL_SHARE * total, (unequal, total)
