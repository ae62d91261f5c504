"""GNN building blocks (counterpart of ``mlamg_tpu/models/gnn.py``).

Submodules carry the flax names (``Dense_0``, ``LayerNorm_0``, ...), so a
checkpoint's parameter tree maps onto ``state_dict`` keys one to one
(:func:`mlamg_torch.convert.fullaggnet_from_params`).  Message passing is
gather -> elementwise math -> :func:`scatter_to_dst`.

Every sum in these layers is a chain of elementwise adds in a fixed order
(no matmul, no library reduction), so the card computes the same bits as
the CPU.  That matters here: the FullAggNet's node features start
constant (1/n), and whatever the rounding of their mean leaves behind
(zero or a few ulps) is amplified by 1/sqrt(eps) ~ 316 at every later
InstanceNorm, so the learned outputs depend on the exact rounding.  The
orders are those of the JAX package run op by op on the CPU: a Dense adds
its products in input order, and a mean over nodes adds in
:func:`~mlamg_torch.ops.segment.tree_sum`'s order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from mlamg_torch.models.graphdata import GraphData, gather_dst, gather_src, scatter_to_dst
from mlamg_torch.ops.segment import ordered_sum, tree_sum


class Dense(nn.Module):
    """flax ``nn.Dense``: x @ kernel + bias, the products added in input
    order.  ``weight`` is (out, in), as in ``nn.Linear``; ``bias_init`` is
    the bias's initial value (see :func:`init_flax_`)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, bias_init: float = 0.0):
        super().__init__()
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ordered_sum(x[:, :, None] * self.weight.T, 1)
        return y if self.bias is None else y + self.bias


def _dense(module: nn.Module, i: int, d_in: int, d_out: int, bias: bool = True,
           bias_init: float = 0.0) -> None:
    setattr(module, f"Dense_{i}", Dense(d_in, d_out, bias=bias, bias_init=bias_init))


class MLP(nn.Module):
    """Dense stack with ReLU between layers (and after the last)."""

    def __init__(self, in_dim: int, features: Sequence[int], act_last: bool = True):
        super().__init__()
        self.n_layers, self.act_last = len(features), act_last
        for i, f in enumerate(features):
            _dense(self, i, in_dim, f)
            in_dim = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1 or self.act_last:
                x = torch.relu(x)
        return x


class InstanceNorm(nn.Module):
    """Zero mean, unit population variance over the node axis (eps 1e-5);
    with ``mask``, statistics over the real nodes only and padding rows
    zeroed.

    The statistics add in :func:`tree_sum`'s order and divide by
    multiplying with 1/n, as the JAX package's CPU backend does (see the
    module docstring for why the order matters)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is None:
            inv_n = torch.full((), 1.0 / x.shape[0], dtype=x.dtype, device=x.device)
            d = x - tree_sum(x) * inv_n
            var = tree_sum(d * d) * inv_n
            return d * (1.0 / torch.sqrt(var + self.eps))
        m = mask.to(x.dtype)[:, None]
        cnt = tree_sum(m).clamp(min=1.0)
        d = (x - tree_sum(x * m) / cnt) * m
        var = tree_sum(d * d) / cnt
        return d * (1.0 / torch.sqrt(var + self.eps))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()``: eps 1e-6 and the one-pass variance
    max(0, mean(x^2) - mean(x)^2) over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        inv_d = torch.full((), 1.0 / d, dtype=x.dtype, device=x.device)
        mu = ordered_sum(x, -1)[..., None] * inv_d
        mu2 = ordered_sum(x * x, -1)[..., None] * inv_d
        var = (mu2 - mu * mu).clamp(min=0.0)
        return (x - mu) * ((1.0 / torch.sqrt(var + self.eps)) * self.weight) + self.bias


def _sym_norm_weights(g: GraphData, edge_weight: torch.Tensor) -> torch.Tensor:
    """D^-1/2 W D^-1/2 edge scaling for TAGConv (degrees from |weights|)."""
    mask = g.edge_mask
    w = torch.where(mask, edge_weight, torch.zeros_like(edge_weight))
    src = g.src.clamp(max=g.n - 1)
    deg = scatter_to_dst(g, w.abs()[:, None])[:, 0]
    dinv_sqrt = 1.0 / torch.sqrt(deg.clamp(min=1e-12))
    return w * dinv_sqrt[src] * dinv_sqrt[g.dst.clamp(max=g.n - 1)] * mask


class TAGConv(nn.Module):
    """Topology-adaptive graph conv: y = sum_{k=0..K} hat(A)^k x W_k, with a
    bias on W_0 only."""

    def __init__(self, in_dim: int, out_dim: int, K: int = 3):
        super().__init__()
        self.K = K
        _dense(self, 0, in_dim, out_dim)
        for k in range(1, K + 1):
            _dense(self, k, in_dim, out_dim, bias=False)

    def forward(self, g: GraphData, x: torch.Tensor, edge_weight: torch.Tensor) -> torch.Tensor:
        w = _sym_norm_weights(g, edge_weight)
        src = g.src.clamp(max=g.n - 1)
        h = x
        out = self.Dense_0(h)
        for k in range(1, self.K + 1):
            h = scatter_to_dst(g, w[:, None] * h[src])
            out = out + getattr(self, f"Dense_{k}")(h)
        return out


class EdgeModel(nn.Module):
    """Edge MLP on concat(src_feat, dst_feat, edge_attr): Dense, ReLU,
    LayerNorm, Dense.  ``out_bias_init`` starts the last bias positive, so a
    single-unit ReLU head is alive at initialisation."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, out_bias_init: float = 0.0):
        super().__init__()
        _dense(self, 0, in_dim, hid_dim)
        self.LayerNorm_0 = LayerNorm(hid_dim)
        _dense(self, 1, hid_dim, out_dim, bias_init=out_bias_init)

    def forward(self, src_feat, dst_feat, edge_attr) -> torch.Tensor:
        h = torch.cat([src_feat, dst_feat, edge_attr], dim=1)
        h = self.LayerNorm_0(torch.relu(self.Dense_0(h)))
        return self.Dense_1(h)


class EdgeConv(nn.Module):
    """Deeper edge MLP on concat(x[src], x[dst], edge_attr): two
    Dense, ReLU, LayerNorm blocks and a Dense (role of EdgeConvModel,
    agg_interp.py:59-77)."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int):
        super().__init__()
        _dense(self, 0, in_dim, hid_dim)
        self.LayerNorm_0 = LayerNorm(hid_dim)
        _dense(self, 1, hid_dim, hid_dim)
        self.LayerNorm_1 = LayerNorm(hid_dim)
        _dense(self, 2, hid_dim, out_dim)

    def forward(self, g: GraphData, x: torch.Tensor, edge_attr: torch.Tensor) -> torch.Tensor:
        h = torch.cat([gather_src(g, x), gather_dst(g, x), edge_attr], dim=1)
        h = self.LayerNorm_0(torch.relu(self.Dense_0(h)))
        h = self.LayerNorm_1(torch.relu(self.Dense_1(h)))
        return self.Dense_2(h)


class NNConv(nn.Module):
    """Edge-conditioned convolution: an edge MLP (``edge_hidden`` widths,
    ReLU) maps each edge's features to an (in_dim x out_dim) matrix, row
    major, applied to the source node's features; plus a root Dense."""

    def __init__(self, in_dim: int, out_dim: int, edge_dim: int,
                 edge_hidden: Sequence[int] = (4, 16)):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        widths = [edge_dim, *edge_hidden, in_dim * out_dim]
        self.n_edge = len(widths) - 1
        for i in range(self.n_edge):
            _dense(self, i, widths[i], widths[i + 1])
        _dense(self, self.n_edge, in_dim, out_dim)  # root

    def forward(self, g: GraphData, x: torch.Tensor, edge_attr: torch.Tensor) -> torch.Tensor:
        h = edge_attr
        for i in range(self.n_edge):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        W = h.reshape(-1, self.in_dim, self.out_dim)
        msg = ordered_sum(gather_src(g, x)[:, :, None] * W, 1)
        root = getattr(self, f"Dense_{self.n_edge}")(x)
        return root + scatter_to_dst(g, msg)


@torch.no_grad()
def init_flax_(net: nn.Module, key) -> nn.Module:
    """flax's ``init`` of the JAX package's model, in place, from ``key``
    (:func:`mlamg_torch.utils.prng.PRNGKey`): each Dense kernel
    ``lecun_normal`` drawn with the key flax derives for it
    (:func:`~mlamg_torch.utils.prng.flax_param_key` of the module's path
    and counter 1, the kernel being its first parameter), as (in, out) and
    taken transposed; each bias its ``bias_init`` (zero but for the
    EdgeModel heads'); each LayerNorm scale 1 and bias 0.  The draws are
    numpy's, so they do not depend on the torch version or the device."""
    from mlamg_torch.utils import prng

    root = np.asarray(key, np.uint32)
    for name, m in net.named_modules():
        if isinstance(m, Dense):
            kernel = prng.lecun_normal(prng.flax_param_key(root, name.split("."), 1),
                                       (m.weight.shape[1], m.weight.shape[0]))
            m.weight.copy_(torch.from_numpy(kernel.T.copy()))
            if m.bias is not None:
                m.bias.fill_(m.bias_init)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
    return net
