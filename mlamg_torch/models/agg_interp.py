"""Aggregation and interpolation networks (counterpart of
``mlamg_tpu/models/agg_interp.py``).

``FullAggNet`` runs

    node scores (AggNet: iterated TAGConv+MLP, top-k)           -> centers
    Bellman-Ford edge weights (CNet MPNN)                       -> C matrix
    Bellman-Ford                                                -> aggregates
    interpolation smoother P-hat (PNet MPNN on 2-feature graph) -> P = P-hat Agg

``pad = (n_real, k_real)`` runs a grid padded to a shape bucket (see
:func:`pad_aware_scores`).  ``AggOnlyNet`` keeps the learned
aggregation and takes the classical Jacobi-smoothed prolongator of it.

Spans (``utils/profiler.py``, fenced, while recording): ``graph``, one
``aggnet`` (``layer=i``) per AggNet layer, ``topk`` (the centers),
``cnet``, ``bellman_ford``, ``pnet`` and ``remap`` (P = P-hat Agg).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from mlamg_torch.graph.bellman_ford import bellman_ford, bellman_ford_pull, nearest_center_to_agg
from mlamg_torch.graph.topk import topk_indices, topk_mask
from mlamg_torch.mg.interp import remap_columns
from mlamg_torch.models.gnn import MLP, EdgeModel, InstanceNorm, NNConv, TAGConv
from mlamg_torch.models.graphdata import (
    GraphData, gather_dst, gather_src, graph_from_matrix, graph_from_matrix_basic,
)
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils.profiler import Profiler


class MPNN(nn.Module):
    """Residual message passing with edge-feature updates: an input lift,
    ``num_internal_conv`` NNConv + EdgeModel blocks on instance-normalised
    node features, and scalar node and edge heads (ReLU).  ``edge_features``
    is the input graph's edge feature count."""

    def __init__(self, dim: int, num_internal_conv: int = 4, edge_features: int = 1):
        super().__init__()
        self.num_internal_conv = num_internal_conv
        self.norm = InstanceNorm()
        self.node_conv_in = NNConv(1, dim, edge_features)
        self.edge_conv_in = EdgeModel(2 * dim + edge_features, dim, 2)
        for i in range(num_internal_conv):
            setattr(self, f"node_conv_{i}", NNConv(dim, dim, 2))
            setattr(self, f"edge_conv_{i}", EdgeModel(2 * dim + 2, dim, 2))
        self.node_conv_out = NNConv(dim, 1, 2)
        self.edge_conv_out = EdgeModel(1 + 1 + 2, dim, 1, out_bias_init=0.1)

    def forward(self, g: GraphData):
        x, e, nm = g.x, g.edge_attr, g.node_mask

        def block(node_conv, edge_conv, x, e, edge_in):
            x = torch.relu(node_conv(g, self.norm(x, nm), edge_in)) + x  # (n,1) -> (n,dim)
            e_new = edge_conv(gather_src(g, x), gather_dst(g, x), e)
            return x, torch.relu(e_new) + e  # (E,Fe) -> (E,2)

        x, e = block(self.node_conv_in, self.edge_conv_in, x, e, e.abs())
        for i in range(self.num_internal_conv):
            x, e = block(getattr(self, f"node_conv_{i}"), getattr(self, f"edge_conv_{i}"), x, e, e)
        x = torch.relu(self.node_conv_out(g, self.norm(x, nm), e))
        e = torch.relu(self.edge_conv_out(gather_src(g, x), gather_dst(g, x), e))
        return x, e


def pad_aware_scores(scores: torch.Tensor, k: int, pad=None) -> torch.Tensor:
    """Scores of a grid padded to a shape bucket.

    With ``pad = (n_real, k_real)`` the k-entry top-k must pick exactly
    ``k_real`` real nodes: the other ``k - k_real`` slots go to the padding
    nodes n_real .. n_real + k - k_real - 1 (score 1e30), whose aggregates
    stay apart from the real block; the remaining padding nodes get -1e30.
    Without ``pad`` the scores are returned as they are.
    """
    if pad is None:
        return scores
    n_real, k_real = pad
    nid = torch.arange(scores.shape[0], device=scores.device)
    big = torch.tensor(1e30, dtype=scores.dtype, device=scores.device)
    pad_hot = (nid >= n_real) & (nid < n_real + (k - k_real))
    return torch.where(nid < n_real, scores, torch.where(pad_hot, big, -big))


class AggBinarizationLayer(nn.Module):
    """[InstanceNorm -> TAGConv -> ReLU -> MLP] x num_conv -> top-k.  The
    TAGConv edge weight is the graph's last edge feature."""

    def __init__(self, dim: int, num_conv: int = 6, in_dim: int = 1):
        super().__init__()
        self.num_conv = num_conv
        self.norm = InstanceNorm()
        for i in range(num_conv):
            head = 1 if i == num_conv - 1 else dim
            setattr(self, f"tag_{i}", TAGConv(in_dim if i == 0 else dim, dim))
            setattr(self, f"mlp_{i}", MLP(dim, [dim] * 4 + [head]))

    def forward(self, g: GraphData, x: torch.Tensor, k: int, pad=None):
        ew = g.edge_attr[:, -1]
        for i in range(self.num_conv):
            x = getattr(self, f"tag_{i}")(g, self.norm(x, g.node_mask), ew)
            x = getattr(self, f"mlp_{i}")(torch.relu(x))
        scores = pad_aware_scores(x[:, 0], k, pad)
        return topk_mask(scores, k)[:, None], scores


class AggNet(nn.Module):
    """Iterated binarization: each layer after the first reads the previous
    layer's 0/1 top-k mask."""

    def __init__(self, dim: int, iterations: int = 2, num_conv: int = 6):
        super().__init__()
        self.iterations = iterations
        for i in range(iterations):
            setattr(self, f"layer_{i}", AggBinarizationLayer(dim, num_conv))

    def layers(self, g: GraphData, k: int, pad=None) -> list:
        """[(0/1 mask, scores)] of every layer, in order."""
        x, out = g.x, []
        for i in range(self.iterations):
            with Profiler("aggnet", fence=True, layer=i):
                x, scores = getattr(self, f"layer_{i}")(g, x, k, pad)
            out.append((x[:, 0], scores))
        return out

    def forward(self, g: GraphData, k: int, pad=None, *, return_intermediate: bool = False):
        """(mask, scores) of the last layer; with ``return_intermediate``
        the list of every layer's 0/1 mask."""
        out = self.layers(g, k, pad)
        if return_intermediate:
            return [mask for mask, _ in out]
        return out[-1]


@dataclasses.dataclass(frozen=True)
class LearnedParts:
    """What :meth:`FullAggNet.parts` computes: ``masks`` and ``scores``
    hold each AggNet layer's 0/1 top-k mask and scores, ``C`` CNet's
    Bellman-Ford weights on A's pattern, ``p_hat`` PNet's values of P-hat
    on A's pattern, and ``P`` = P-hat Agg."""

    agg_id: torch.Tensor
    P: CSR
    C: CSR
    centers: torch.Tensor
    masks: tuple
    scores: tuple
    p_hat: torch.Tensor


class FullAggNet(nn.Module):
    """AggNet + CNet (Bellman-Ford weights) + PNet (interpolation smoother).

    ``bf_width`` (the largest row degree of A's symmetric pattern) selects
    the pull-mode Bellman-Ford and sizes the graphs' ``in_ell``; None runs
    the push form.  ``rel_strength`` adds the row-relative strength edge
    feature to the AggNet/CNet graph.  The parameters start at zero;
    :func:`mlamg_torch.models.gnn.init_flax_` draws flax's initial values.
    """

    def __init__(self, dim: int = 64, num_conv: int = 2, iterations: int = 4,
                 bf_width: int | None = None, rel_strength: bool = False):
        super().__init__()
        self.bf_width, self.rel_strength = bf_width, rel_strength
        self.PNet = MPNN(dim, num_internal_conv=4, edge_features=2)
        self.AggNetM = AggNet(dim, iterations=iterations, num_conv=num_conv)
        self.CNet = MPNN(dim, num_internal_conv=5, edge_features=2 if rel_strength else 1)

    def _bf(self, C: CSR, centers: torch.Tensor):
        if self.bf_width is not None:
            return bellman_ford_pull(C, centers, width=self.bf_width)
        return bellman_ford(C, centers)

    def basic_graph(self, A: CSR, n_real: int | None = None) -> GraphData:
        return graph_from_matrix_basic(A, n_real=n_real, ell_width=self.bf_width,
                                       rel_strength=self.rel_strength)

    def _aggregate(self, A: CSR, k: int, pad=None):
        """(agg_id, C, centers, AggNet's [(mask, scores)] per layer) of the
        learned aggregation."""
        with Profiler("graph", fence=True):
            g = self.basic_graph(A, None if pad is None else pad[0])
        layers = self.AggNetM.layers(g, k, pad)
        with Profiler("topk", fence=True):
            centers = topk_indices(layers[-1][1], k)
        with Profiler("cnet", fence=True):
            _, bf_edges = self.CNet(g)
            C = A.with_data(torch.where(A.mask, bf_edges[:, 0], torch.zeros_like(A.data)))
        with Profiler("bellman_ford", fence=True):
            _, nearest = self._bf(C, centers)
            agg_id = nearest_center_to_agg(centers, nearest)
        return agg_id, C, centers, layers

    def agg_only(self, A: CSR, k: int) -> torch.Tensor:
        """The learned aggregation alone: agg_id."""
        return self._aggregate(A, k)[0]

    def int_only(self, A: CSR, agg_id: torch.Tensor, k: int) -> CSR:
        """The learned interpolation of a given aggregation."""
        _, p_edges = self.PNet(graph_from_matrix(A, agg_id))
        return remap_columns(A, p_edges[:, 0], agg_id, k)  # P = P_hat Agg

    def parts(self, A: CSR, k: int, pad=None) -> LearnedParts:
        """The whole forward pass and what it computes on the way (see
        :class:`LearnedParts`); ``pad`` as in :meth:`forward`."""
        n_real = None if pad is None else pad[0]
        agg_id, C, centers, layers = self._aggregate(A, k, pad)
        with Profiler("pnet", fence=True):
            g2 = graph_from_matrix(A, agg_id, n_real=n_real, ell_width=self.bf_width)
            p_hat = self.PNet(g2)[1][:, 0]
        with Profiler("remap", fence=True):
            P = remap_columns(A, p_hat, agg_id, k, n_real=n_real)
        masks, scores = zip(*layers)
        return LearnedParts(agg_id, P, C, centers, masks, scores, p_hat)

    def forward(self, A: CSR, k: int, pad=None):
        """Returns (agg_id, P (CSR n x k), C, centers, node_mask).

        ``pad = (n_real, k_real)``, host ints: A is a grid in its first
        n_real rows plus identity padding rows; exactly k_real centers land
        on real nodes (:func:`pad_aware_scores`), and the padding rows of P
        hold 1.0, so the coarse operator stays block diagonal and
        nonsingular."""
        p = self.parts(A, k, pad)
        return p.agg_id, p.P, p.C, p.centers, p.masks[-1]


class AggOnlyNet(nn.Module):
    """Learned aggregation (AggNet top-k centers, CNet Bellman-Ford weights)
    with the classical Jacobi-SA prolongator of it (reference
    agg_interp.py:257-294).  ``bf_width`` and ``rel_strength`` as in
    :class:`FullAggNet`."""

    def __init__(self, dim: int = 64, num_conv: int = 6, iterations: int = 2,
                 bf_width: int | None = None, rel_strength: bool = False):
        super().__init__()
        self.bf_width, self.rel_strength = bf_width, rel_strength
        self.AggNetM = AggNet(dim, iterations=iterations, num_conv=num_conv)
        self.CNet = MPNN(dim, num_internal_conv=5, edge_features=2 if rel_strength else 1)

    def forward(self, A: CSR, k: int, pad=None):
        """Returns (agg_id, P (CSR n x k), C, centers, node_mask)."""
        from mlamg_torch.mg.interp import smoothed_aggregation

        g = graph_from_matrix_basic(A, n_real=None if pad is None else pad[0],
                                    ell_width=self.bf_width, rel_strength=self.rel_strength)
        node_mask, scores = self.AggNetM(g, k, pad)
        centers = topk_indices(scores, k)
        _, bf_edges = self.CNet(g)
        C = A.with_data(torch.where(A.mask, bf_edges[:, 0], torch.zeros_like(A.data)))
        if self.bf_width is not None:
            _, nearest = bellman_ford_pull(C, centers, width=self.bf_width)
        else:
            _, nearest = bellman_ford(C, centers)
        agg_id = nearest_center_to_agg(centers, nearest)
        return agg_id, smoothed_aggregation(A, agg_id, k), C, centers, node_mask


def make_forward(model: nn.Module, alpha: float):
    """f(A) -> ``model(A, k)`` with k = ceil(alpha * n) from A's shape."""

    def f(A: CSR):
        return model(A, int(math.ceil(alpha * A.shape[0])))

    return f
