"""Continuous (fully differentiable) interpolation networks (counterpart
of ``mlamg_tpu/models/interpolation.py``).

Interpolation weights and soft C/F scores learned by plain gradient
descent against energy-norm losses.  The per-column network of P-hat
(column i from the features [delta_i, c]) runs on all n columns as one
batch: the features are (n nodes, n columns, channels), each TAGConv hop
propagates the n x channels block at once, and each Dense acts on every
(node, column) pair; the JAX package ``vmap``s the same network over the
columns.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mlamg_torch.models.gnn import TAGConv, _sym_norm_weights
from mlamg_torch.models.graphdata import GraphData, scatter_to_dst
from mlamg_torch.ops.sparse import CSR


def _tagconv_columns(conv: TAGConv, g: GraphData, x: torch.Tensor,
                     edge_weight: torch.Tensor) -> torch.Tensor:
    """``conv`` on a batch of feature columns: x (n, B, F) -> (n, B, out),
    column b the same as ``conv(g, x[:, b], edge_weight)``."""
    n, B, F = x.shape
    w = _sym_norm_weights(g, edge_weight)
    src = g.src.clamp(max=g.n - 1)
    h = x.reshape(n, B * F)
    out = conv.Dense_0(x.reshape(n * B, F))
    for k in range(1, conv.K + 1):
        h = scatter_to_dst(g, w[:, None] * h[src])
        out = out + getattr(conv, f"Dense_{k}")(h.reshape(n * B, F))
    return out.reshape(n, B, -1)


class InterpolationNetwork(nn.Module):
    """Per-column interpolation net: features [delta_i, c] -> TAGConv stack
    (ReLU after each) -> column i of P-hat (reference
    interpolation.py:44-67).  ``forward(g, c, cols)`` gives the (n,
    len(cols)) block of those columns."""

    def __init__(self, K: int = 50, dims: Sequence[int] = (15, 30, 15, 1)):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        d_in = 2
        for j, d in enumerate(self.dims):
            setattr(self, f"tag_{j}", TAGConv(d_in, d, K))
            d_in = d

    def forward(self, g: GraphData, c: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        n = g.n
        delta = (torch.arange(n, device=c.device)[:, None] == cols[None, :]).to(c.dtype)
        x = torch.stack([delta, c[:, None].expand_as(delta)], dim=2)  # (n, B, 2)
        ew = g.edge_attr[:, 0]
        for j in range(len(self.dims)):
            x = torch.relu(_tagconv_columns(getattr(self, f"tag_{j}"), g, x, ew))
        return x[:, :, 0]


class CoarseFineNetwork(nn.Module):
    """Soft C/F scores in (0, 1): a TAGConv stack, ReLU between layers and
    a sigmoid last (reference interpolation.py:76-94).  ``in_dim`` is the
    graph's node feature count."""

    def __init__(self, K: int = 20, dims: Sequence[int] = (60, 100, 200, 80, 1),
                 in_dim: int = 1):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        d_in = in_dim
        for j, d in enumerate(self.dims):
            setattr(self, f"tag_{j}", TAGConv(d_in, d, K))
            d_in = d

    def forward(self, g: GraphData) -> torch.Tensor:
        x = g.x
        ew = g.edge_attr[:, 0]
        last = len(self.dims) - 1
        for j in range(len(self.dims)):
            x = getattr(self, f"tag_{j}")(g, x, ew)
            x = torch.relu(x) if j < last else torch.sigmoid(x)
        return x[:, 0]


class ContinuousInterpolationFullNetwork(nn.Module):
    """C/F scores and the full (n, n) P-hat, all columns in one batch
    (reference interpolation.py:97-129).  Submodules ``P`` and ``CF`` as
    in flax."""

    def __init__(self, K_interp: int = 50, K_cf: int = 20, in_dim: int = 1):
        super().__init__()
        self.P = InterpolationNetwork(K=K_interp)
        self.CF = CoarseFineNetwork(K=K_cf, in_dim=in_dim)

    def forward(self, g: GraphData):
        c = self.CF(g)
        return self.P(g, c, torch.arange(g.n, device=c.device)), c


def _dense(A) -> torch.Tensor:
    return A.todense() if isinstance(A, CSR) else A


def EC_loss(A, Phat: torch.Tensor, c: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Relaxed two-level energy loss with soft C/F penalties (reference
    interpolation.py:149-158):

        Pbar = Phat diag(c)
        || R (I - Pbar (Pbar^T A Pbar + I - diag(c))^-1 Pbar^T A) R ||_F^2
        + 0.001 ||c||_1 + 0.01 ||(1 - c) c||_2
    """
    Ad = _dense(A)
    n = Ad.shape[0]
    Pbar = Phat * c[None, :]
    I = torch.eye(n, dtype=Ad.dtype, device=Ad.device)
    M = Pbar.T @ Ad @ Pbar + I - torch.diag(c)
    E = R @ (I - Pbar @ torch.linalg.solve(M, Pbar.T @ Ad)) @ R
    return (torch.linalg.matrix_norm(E, "fro") ** 2 + 0.001 * c.abs().sum()
            + 0.01 * torch.linalg.vector_norm((1 - c) * c))


def E_loss_discrete(A, P: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """|| R (I - P (P^T A P)^-1 P^T A) R ||_F^2 (reference
    interpolation.py:143-147)."""
    Ad = _dense(A)
    I = torch.eye(Ad.shape[0], dtype=Ad.dtype, device=Ad.device)
    E = R @ (I - P @ torch.linalg.solve(P.T @ Ad @ P, P.T @ Ad)) @ R
    return torch.linalg.matrix_norm(E, "fro") ** 2
