"""Graph features straight from sparse matrices (counterpart of
``mlamg_tpu/models/graphdata.py``).

The matrix's stored entries are the edge list: edge e runs src = row[e] ->
dst = col[e]; edges with ``src == n`` are padding.  Every message
aggregation is a gather over ``in_ell`` (each node's incoming edges in
edge order) plus an in-order row sum: the order of the JAX package's
``segment_sum`` on the CPU, with no scatter, and the same on every run on
the card.
"""

from __future__ import annotations

import dataclasses

import torch

from mlamg_torch.ops.segment import segment_max, slot_sum
from mlamg_torch.ops.sparse import CSR, segment_slots


@dataclasses.dataclass(frozen=True)
class GraphData:
    """Edge-list graph with node and edge features.

    src, dst  : (E_pad,) int64; src == n marks padding
    edge_attr : (E_pad, F) float
    x         : (n, Fx) float node features
    n         : number of nodes
    node_mask : (n,) bool or None; False marks padding nodes, which
        global reductions (InstanceNorm) ignore
    in_ell    : (n, w) int64 edge positions of each node's incoming edges
        (E_pad in empty slots), from :func:`build_in_ell`
    """

    src: torch.Tensor
    dst: torch.Tensor
    edge_attr: torch.Tensor
    x: torch.Tensor
    n: int
    node_mask: torch.Tensor | None = None
    in_ell: torch.Tensor | None = None

    @property
    def edge_mask(self) -> torch.Tensor:
        return self.src < self.n


def build_in_ell(row: torch.Tensor, col: torch.Tensor, n: int,
                 width: int | None = None) -> torch.Tensor:
    """(n, width) edge positions of each node's incoming edges, in edge
    order.  ``width`` defaults to the largest in-degree; an in-degree above
    a given ``width`` raises (its messages would be dropped)."""
    dst = torch.where(row < n, col, torch.full_like(col, n))
    try:
        return segment_slots(dst, n, width)
    except ValueError as e:
        raise ValueError(f"build_in_ell: {e}; recompute width with dataset_bf_width") from None


def _in_ell(A: CSR, width: int | None) -> torch.Tensor:
    """``build_in_ell`` of A's pattern; without a width, A's cached column
    slots (the same table)."""
    if width is None:
        return A.col_slots
    return build_in_ell(A.row, A.col, A.shape[0], width)


def _node_init(n: int, n_real: int | None, dtype, device):
    """(x, node_mask): node feature 1/n and no mask; with shape-bucket
    padding (``n_real`` real nodes first), 1/n_real on the real nodes, 0 on
    the padding nodes and the mask of the real ones, so the real nodes'
    outputs match the unpadded graph's."""
    if n_real is None:
        return torch.full((n, 1), 1.0 / n, dtype=dtype, device=device), None
    mask = torch.arange(n, device=device) < n_real
    one = torch.tensor(1.0, dtype=dtype, device=device) / n_real
    return torch.where(mask, one, torch.zeros_like(one))[:, None], mask


def graph_from_matrix_basic(A: CSR, n_real: int | None = None, ell_width: int | None = None,
                            rel_strength: bool = False) -> GraphData:
    """Node features 1/n, edge feature |a_ij|; with ``rel_strength`` a
    second edge feature |a_ij| / max_j' |a_ij'| over the off-diagonal of
    row i (0 on the diagonal).  ``n_real``: see :func:`_node_init`."""
    n = A.shape[0]
    zero = torch.zeros_like(A.data)
    absa = torch.where(A.mask, A.data.abs(), zero)
    if rel_strength:
        rsafe = A.row.clamp(max=n - 1)
        offdiag = torch.where(rsafe == A.col, zero, absa)
        rowmax = segment_max(offdiag, rsafe, n)
        rel = absa / rowmax[rsafe].clamp(min=1e-30)
        rel = torch.where(A.mask & (rsafe != A.col), rel, zero)
        attr = torch.stack([absa, rel], dim=1)
    else:
        attr = absa[:, None]
    x, mask = _node_init(n, n_real, A.dtype, A.device)
    return GraphData(A.row, A.col, attr, x, n, mask, _in_ell(A, ell_width))


def graph_from_matrix(A: CSR, agg_id: torch.Tensor, n_real: int | None = None,
                      ell_width: int | None = None) -> GraphData:
    """Two edge features: |a_ij| and cluster adjacency (0 = same aggregate,
    1 = different).  ``n_real``: see :func:`_node_init`."""
    n = A.shape[0]
    rsafe = A.row.clamp(max=n - 1)
    same = agg_id[rsafe] == agg_id[A.col]
    attr = torch.stack([A.data.abs(), (~same).to(A.dtype)], dim=1)
    attr = torch.where(A.mask[:, None], attr, torch.zeros_like(attr))
    x, mask = _node_init(n, n_real, A.dtype, A.device)
    return GraphData(A.row, A.col, attr, x, n, mask, _in_ell(A, ell_width))


def graph_from_matrix_node_vals(A: CSR, x: torch.Tensor) -> GraphData:
    """Caller-supplied node features ``x`` ((n,) or (n, F)) and the signed
    entries a_ij as the one edge feature (reference data.py:48-51)."""
    if x.ndim == 1:
        x = x[:, None]
    attr = torch.where(A.mask, A.data, torch.zeros_like(A.data))[:, None]
    return GraphData(A.row, A.col, attr, x, A.shape[0], None, _in_ell(A, None))


def gather_src(g: GraphData, x: torch.Tensor) -> torch.Tensor:
    """x[src] with padding rows zeroed."""
    xs = x[g.src.clamp(max=g.n - 1)]
    return torch.where(g.edge_mask[:, None], xs, torch.zeros_like(xs))


def gather_dst(g: GraphData, x: torch.Tensor) -> torch.Tensor:
    xd = x[g.dst.clamp(max=g.n - 1)]
    return torch.where(g.edge_mask[:, None], xd, torch.zeros_like(xd))


def scatter_to_dst(g: GraphData, messages: torch.Tensor) -> torch.Tensor:
    """Sum edge messages into their destination nodes (padding dropped)."""
    return slot_sum(messages, g.in_ell)
