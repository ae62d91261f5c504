"""C/F-splitting interpolation network (counterpart of
``mlamg_tpu/models/cf_interp.py``), the model the learned Schur
preconditioner loads.

Given a C/F splitting (from greedy coarsening), a residual TAGConv stack
scores the C<->F edges of the matrix graph and emits an interpolation
operator P with a unit entry on each coarse point and columns restricted
to C.  Edges that are not C<->F stay in place with weight 0, and the
column of a coarse point is its C rank.  Every sum adds in a fixed order
(``tree_sum``, ``slot_sum``), so the card gives the CPU's bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from mlamg_torch.models.gnn import EdgeModel, InstanceNorm, TAGConv
from mlamg_torch.models.graphdata import GraphData, build_in_ell
from mlamg_torch.ops.segment import slot_sum, tree_sum
from mlamg_torch.ops.sparse import COO, CSR, segment_slots


def cf_graph(A: CSR, is_coarse: torch.Tensor) -> GraphData:
    """Graph for C/F interpolation: node feature 1 on C, edge weight
    |a_ij| kept only on C<->F edges (the others become padding)."""
    n = A.shape[0]
    rsafe = A.row.clamp(max=n - 1)
    keep = A.mask & (is_coarse[rsafe] != is_coarse[A.col])
    attr = torch.where(keep, A.data.abs(), torch.zeros_like(A.data))[:, None]
    x = is_coarse.to(A.dtype)[:, None]
    src = torch.where(keep, A.row, torch.full_like(A.row, n))
    dst = torch.where(keep, A.col, torch.zeros_like(A.col))
    return GraphData(src, dst, attr, x, n, in_ell=build_in_ell(src, dst, n))


class ResidualTAGStack(nn.Module):
    """TAGConv residual tower with instance norms and an edge head; the
    head's scores are standardised over the live edges and taken in
    magnitude.  ``dims`` is the channel plan; the submodules carry the flax
    names (``tag_in``, ``tag_{i}a``, ``tag_{i}b``, ``tag_out``,
    ``edge_head``)."""

    def __init__(self, dims: Sequence[int] = (16, 16, 32, 32, 64, 64), K: int = 5,
                 edge_hidden: int = 64):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        self.tag_in = TAGConv(1, self.dims[0], K)
        for i in range(len(self.dims) - 1):
            setattr(self, f"tag_{i}a", TAGConv(self.dims[i], self.dims[i + 1], K))
            setattr(self, f"tag_{i}b", TAGConv(self.dims[i + 1], self.dims[i + 1], K))
        self.tag_out = TAGConv(self.dims[-1], self.dims[-1], K)
        self.edge_head = EdgeModel(2 * self.dims[-1] + 1, edge_hidden, 1)
        self.norm = InstanceNorm()

    def forward(self, g: GraphData) -> torch.Tensor:
        ew = g.edge_attr[:, 0]
        x = torch.relu(self.norm(self.tag_in(g, g.x, ew)))
        for i in range(len(self.dims) - 1):
            h = torch.relu(getattr(self, f"tag_{i}a")(g, x, ew))
            h = self.norm(getattr(self, f"tag_{i}b")(g, h, ew))
            if h.shape == x.shape:
                h = h + x
            x = torch.relu(h)
        x = torch.relu(self.tag_out(g, x, ew))

        mask = g.edge_mask
        zero = torch.zeros_like(x[:1])
        xs = torch.where(mask[:, None], x[g.src.clamp(max=g.n - 1)], zero)
        xd = torch.where(mask[:, None], x[g.dst.clamp(max=g.n - 1)], zero)
        e = self.edge_head(xs, xd, g.edge_attr)[:, 0]
        cnt = mask.sum().clamp(min=1).to(e.dtype)
        ez = torch.zeros_like(e)
        mean = tree_sum(torch.where(mask, e, ez))[0] / cnt
        var = tree_sum(torch.where(mask, (e - mean) ** 2, ez))[0] / cnt
        return ((e - mean) * (1.0 / torch.sqrt(var + 1e-8))).abs()


class CFInterpolationNetwork(nn.Module):
    """P from a C/F splitting.  ``row_normalize`` (the default) rescales
    every F row of P to unit sum, so that P reproduces constants; a row
    whose scores sum to ~0 gets uniform weights over its C neighbours."""

    def __init__(self, dims: Sequence[int] = (16, 16, 32, 32, 64, 64), K: int = 5,
                 row_normalize: bool = True):
        super().__init__()
        self.row_normalize = row_normalize
        self.model = ResidualTAGStack(dims=dims, K=K)

    def forward(self, A: CSR, is_coarse: torch.Tensor, c_rank: torch.Tensor,
                num_coarse: int) -> CSR:
        """P as an (n, num_coarse) CSR.  ``is_coarse`` (n,) bool; ``c_rank``
        (n,) int with c_rank[c] the column of coarse point c."""
        n = A.shape[0]
        c_rank = c_rank.long()
        w = self.model(cf_graph(A, is_coarse))

        # edge i -> j gives P[i, rank[j]] when j is coarse and i fine
        rsafe = A.row.clamp(max=n - 1)
        keep = A.mask & is_coarse[A.col] & ~is_coarse[rsafe]
        rows = torch.where(keep, A.row, torch.full_like(A.row, n))
        cols = torch.where(keep, c_rank[A.col], torch.zeros_like(A.col))
        vals = torch.where(keep, w, torch.zeros_like(w))
        if self.row_normalize:
            slots = segment_slots(rows, n)
            rs = slot_sum(vals, slots)[rsafe]
            cnt = slot_sum(keep.to(vals.dtype), slots)[rsafe]
            big = rs > 1e-12
            normed = torch.where(big, vals / torch.where(big, rs, torch.ones_like(rs)),
                                 1.0 / cnt.clamp(min=1.0))
            vals = torch.where(keep, normed, torch.zeros_like(normed))

        # the unit entry of each coarse point
        ids = torch.arange(n, device=A.device)
        node_rows = torch.where(is_coarse, ids, torch.full_like(ids, n))
        node_cols = torch.where(is_coarse, c_rank, torch.zeros_like(c_rank))
        node_vals = is_coarse.to(vals.dtype)
        all_rows = torch.cat([rows, node_rows])
        return COO(torch.cat([vals, node_vals]), all_rows, torch.cat([cols, node_cols]),
                   (n, num_coarse), int(all_rows.shape[0])).sort_rows()


def cf_rank(is_coarse: np.ndarray):
    """(c_rank, num_coarse) from a boolean C mask; c_rank[i] is the number
    of C points up to and including i, minus one."""
    is_coarse = np.asarray(is_coarse, bool)
    rank = np.cumsum(is_coarse) - 1
    return rank.astype(np.int32), int(is_coarse.sum())
