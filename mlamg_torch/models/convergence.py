"""Convergence-factor regression GNN (counterpart of
``mlamg_tpu/models/convergence.py``).

Predicts the two-level convergence factor of a (matrix, splitting) pair
from the matrix graph with node features describing the splitting: a
TAGConv tower, a mean pool over the nodes, Dense(32) and Dense(1), then a
sigmoid (or the raw logit with ``logit_head``).  The pool adds in
:func:`~mlamg_torch.ops.segment.tree_sum`'s order and multiplies by 1/n,
as the JAX package's CPU backend takes ``jnp.mean``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mlamg_torch.models.gnn import Dense, TAGConv
from mlamg_torch.models.graphdata import GraphData
from mlamg_torch.ops.segment import tree_sum


class ConvergencePredictor(nn.Module):
    """``in_dim`` node features in; ``logit_head`` returns the pre-sigmoid
    score (training in logit space avoids the saturated sigmoid near
    conv ~ 1).  Submodules carry the flax names (``tag_{i}``,
    ``Dense_0``, ``Dense_1``)."""

    def __init__(self, in_dim: int, dims: Sequence[int] = (32, 64, 64, 32), K: int = 30,
                 logit_head: bool = False):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        self.logit_head = logit_head
        d_in = in_dim
        for i, d in enumerate(self.dims):
            setattr(self, f"tag_{i}", TAGConv(d_in, d, K))
            d_in = d
        self.Dense_0 = Dense(d_in, 32)
        self.Dense_1 = Dense(32, 1)

    def forward(self, g: GraphData) -> torch.Tensor:
        x = g.x
        ew = g.edge_attr[:, 0]
        for i in range(len(self.dims)):
            x = torch.relu(getattr(self, f"tag_{i}")(g, x, ew))
        inv_n = torch.tensor(1.0 / x.shape[0], dtype=x.dtype, device=x.device)
        pooled = tree_sum(x) * inv_n  # (1, d)
        z = self.Dense_1(torch.relu(self.Dense_0(pooled)))[0, 0]
        return z if self.logit_head else torch.sigmoid(z)


def load_mat_dataset(splitting_pkl: str, mat_dir: str):
    """[(scipy CSR, entry)] from a pickled list of splitting entries, each
    naming a ``.mat`` file under ``mat_dir`` (``entry["matrix"]``) and its
    variable (``entry.get("key", "A")``); role of MeshDataset, reference
    convergence.py:120-148.  Unpickling runs code, so load only files this
    project wrote."""
    import os
    import pickle

    import scipy.io as sio
    import scipy.sparse as sp

    with open(splitting_pkl, "rb") as f:
        splittings = pickle.load(f)
    out = []
    for entry in splittings:
        mat = sio.loadmat(os.path.join(mat_dir, entry["matrix"]))
        out.append((sp.csr_matrix(mat[entry.get("key", "A")]), entry))
    return out
