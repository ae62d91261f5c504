"""Differentiable relaxation of the FullAggNet pipeline (counterpart of
``mlamg_tpu/models/soft_pipeline.py``).

The discrete forward (hard top-k, Bellman-Ford) has no useful gradient.
Its soft surrogate converges to it as the temperatures go to zero, and
:func:`~mlamg_torch.models.loss.amg_loss` backpropagates through it into
all three sub-networks:

- **PNet**: exactly (P values enter the loss directly);
- **CNet**: along shortest-path trees: the (n, k) multi-source distances
  of :func:`multi_source_bf` are piecewise differentiable in the edge
  weights, and :func:`soft_assignment` replaces the per-node argmin by a
  softmax over centers;
- **AggNet**: through the chosen centers' soft top-k mask values, which
  enter the assignment logits.

The discrete assignment is invariant to positive scaling of C, so C is
normalised to unit mean edge weight: the temperature then means the same
on every grid.  The straight-through estimator makes the forward value
the discrete pipeline's P; only the backward is soft.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mlamg_torch.graph.bellman_ford import bellman_ford, nearest_center_to_agg
from mlamg_torch.graph.topk import soft_topk_mask, topk_indices
from mlamg_torch.models.graphdata import graph_from_matrix, graph_from_matrix_basic
from mlamg_torch.models.loss import amg_loss
from mlamg_torch.ops.matmul import spmm
from mlamg_torch.ops.sparse import CSR, segment_slots

_BIG = 1e6  # finite "infinity": keeps the arithmetic NaN-free under autograd


@dataclasses.dataclass(frozen=True)
class SoftConfig:
    """Temperatures and loop counts of the relaxation."""

    bf_iters: int = 32  # min-plus sweeps (>= the weighted graph's hop diameter)
    tau_assign: float = 0.08  # softmax temperature of the (n, k) assignment
    topk_sigma: float = 0.5  # soft top-k sharpness of the center weights
    num_loops: int = 5  # amg_loss loops
    test_vectors: int = 32
    omega: float = 2.0 / 3.0
    ridge: float = 1e-4  # relative coarse-diagonal ridge (degeneracy guard)


def multi_source_bf(C: CSR, centers: torch.Tensor, num_iters: int) -> torch.Tensor:
    """(n, k) shortest-path distances from every node to each center:
    ``num_iters`` min-plus sweeps, each relaxing every edge for every
    center at once (a min over each node's incoming edges, in ``C``'s
    column slots).  Differentiable almost everywhere in ``C.data``; where
    several edges tie for a minimum, the gradient is split evenly among
    them, as JAX's ``segment_min`` splits it.  Unreachable pairs hold
    ``_BIG``.  The sweeps keep their intermediates for the backward (the
    JAX package recomputes them under ``jax.checkpoint``; training grids
    are small, so memory is no concern here)."""
    n = C.shape[0]
    k = centers.shape[0]
    live = C.mask
    big = torch.full_like(C.data, _BIG)
    w = torch.where(live, C.data, big)
    rsafe = C.row.clamp(max=n - 1)
    slots = segment_slots(torch.where(live, C.col, torch.full_like(C.col, n)), n)
    D = torch.full((n, k), _BIG, dtype=C.dtype, device=C.device)
    D[centers, torch.arange(k, device=C.device)] = 0.0
    inf_row = torch.full((1, k), float("inf"), dtype=C.dtype, device=C.device)
    for _ in range(num_iters):
        cand = D[rsafe] + w[:, None]  # (E, k)
        best_in = torch.cat([cand, inf_row])[slots].amin(1)  # (n, k)
        D = torch.minimum(D, best_in)
    return D


def soft_assignment(D: torch.Tensor, log_center_weight: torch.Tensor, tau: float) -> torch.Tensor:
    """(n, k) soft membership: row-wise softmax of ``-D / tau +
    log_center_weight``; the hard nearest-center one-hot as tau -> 0.
    Unreachable pairs get exactly 0 and a fully unreachable row (a
    disconnected padding node) a zero row, with no NaN in the backward."""
    logits = -D / tau + log_center_weight[None, :]
    dead = D >= _BIG / 2
    logits = torch.where(dead, torch.full_like(logits, float("-inf")), logits)
    mx = logits.amax(1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.where(dead, torch.zeros_like(logits), torch.exp(logits - mx))
    return e / e.sum(1, keepdim=True).clamp(min=1e-30)


def _soft_parts(net, A: CSR, k: int, pad=None):
    """(scores, centers, C data, P-hat data, agg_id) of a FullAggNet for the
    soft pipeline.  The aggregation that PNet reads as a feature comes from
    the push Bellman-Ford on C held constant; the graphs have no ELL width,
    as in the JAX package."""
    n_real = None if pad is None else pad[0]
    g = graph_from_matrix_basic(A, n_real=n_real, rel_strength=net.rel_strength)
    _, scores = net.AggNetM(g, k, pad)
    centers = topk_indices(scores, k)
    _, bf_edges = net.CNet(g)
    c_data = torch.where(A.mask, bf_edges[:, 0], torch.zeros_like(A.data))
    _, nearest = bellman_ford(A.with_data(c_data.detach()), centers)
    agg_id = nearest_center_to_agg(centers, nearest)
    _, p_edges = net.PNet(graph_from_matrix(A, agg_id, n_real=n_real))
    return scores, centers, c_data, p_edges[:, 0], agg_id


def soft_interpolation(net, A: CSR, k: int, cfg: SoftConfig, pad=None):
    """Differentiable dense (n, k) P of the soft pipeline, and a dict of
    the discrete byproducts (``centers``, ``agg_id``, ``assignment``)."""
    scores, centers, c_data, phat, agg_id = _soft_parts(net, A, k, pad)
    live = A.mask
    zero = torch.zeros_like(c_data)
    c_abs = c_data.abs()
    mean_c = torch.where(live, c_abs, zero).sum() / live.sum().clamp(min=1)
    C = A.with_data(torch.where(live, c_abs / mean_c.clamp(min=1e-30), zero))
    D = multi_source_bf(C, centers, cfg.bf_iters)

    m = soft_topk_mask(scores, k, sigma=cfg.topk_sigma)[centers]
    W = soft_assignment(D, torch.log(m + 1e-9), cfg.tau_assign)
    # straight through: the forward is the discrete assignment with its
    # smallest-center-id tie-break (an argmin over D would break ties
    # otherwise), the backward the soft W
    assigned = agg_id < k
    W_hard = F.one_hot(torch.where(assigned, agg_id, torch.zeros_like(agg_id)), k)
    W_hard = W_hard.to(W.dtype) * assigned[:, None]
    W = W + (W_hard - W).detach()

    # P = P_hat W, P_hat with A's pattern and PNet's values; padding rows
    # hold 1.0 as in remap_columns
    pdata = phat
    if pad is not None:
        pad_row = live & (A.row.clamp(max=A.shape[0] - 1) >= pad[0])
        pdata = torch.where(pad_row, torch.ones_like(pdata), pdata)
    P_soft = spmm(A.with_data(torch.where(live, pdata, zero)), W)
    return P_soft, {"centers": centers, "agg_id": agg_id, "assignment": W}


def soft_conv_loss(net, A: CSR, k: int, test_vecs: torch.Tensor, cfg: SoftConfig, pad=None,
                   colors: torch.Tensor | None = None, num_colors: int = 0):
    """Differentiable two-level convergence factor of the soft pipeline,
    and the byproducts of :func:`soft_interpolation`.

    ``test_vecs`` should be zero on padding rows (the padding block is then
    invisible).  With ``colors``/``num_colors`` the error smoother is one
    multicolor Gauss-Seidel sweep (colour by colour, each a full residual),
    the smoother of the measured cycle; otherwise weighted Jacobi."""
    P_soft, aux = soft_interpolation(net, A, k, cfg, pad=pad)
    smooth_fn = None
    if colors is not None and num_colors > 0:
        d = A.diagonal()
        Dinv = 1.0 / torch.where(d != 0, d, torch.ones_like(d))
        on_color = [(colors == c)[:, None] for c in range(num_colors)]

        def smooth_fn(x):
            for on in on_color:
                x = torch.where(on, x + Dinv[:, None] * -spmm(A, x), x)
            return x

    conv = amg_loss(P_soft, A, test_vecs, tot_num_loop=cfg.num_loops, omega=cfg.omega,
                    ridge=cfg.ridge, smooth_fn=smooth_fn)
    return conv, aux
