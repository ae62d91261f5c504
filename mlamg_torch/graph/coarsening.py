"""C/F splitting by diagonal dominance (counterpart of
``mlamg_tpu/graph/coarsening.py``).

- :func:`greedy_coarsening`: the reference's sequential greedy algorithm,
  numpy on the host (setup only), exact.
- :func:`greedy_coarsening_parallel`: a Luby-style variant that makes the
  strict local dominance minima C in parallel rounds, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from mlamg_torch.ops.segment import segment_min, slot_sum
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.utils import prng


def diag_dominance(A) -> np.ndarray:
    """|a_ii| / sum_j |a_ij| per row (numpy, matches ns/lib/greedy.py:4-10)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    absA = abs(A)
    rowsum = np.asarray(absA.sum(axis=1)).ravel()
    return np.abs(A.diagonal()) / rowsum


def greedy_coarsening(A, theta: float):
    """Sequential greedy C/F splitting (host-side oracle-parity version).

    Returns (num_F, F, C) exactly as the reference (ns/lib/greedy.py:13-36):
    rows with dominance >= theta start as F; repeatedly promote the least
    dominant undecided row to C, recompute its undecided neighbours'
    dominance against (U ∪ F), moving any that cross theta into F.
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    dominance = diag_dominance(A)
    absA = abs(A).tocsr()
    diag = np.abs(A.diagonal())

    state = np.zeros(n, dtype=np.int8)  # 0=U, 1=F, 2=C
    state[dominance >= theta] = 1

    undecided = state == 0
    while undecided.any():
        u_idx = np.where(undecided)[0]
        c = u_idx[np.argmin(dominance[u_idx])]
        state[c] = 2
        undecided[c] = False
        # update undecided neighbours of c
        nbrs = absA.indices[absA.indptr[c] : absA.indptr[c + 1]]
        for i in nbrs:
            if state[i] != 0:
                continue
            cols = absA.indices[absA.indptr[i] : absA.indptr[i + 1]]
            vals = absA.data[absA.indptr[i] : absA.indptr[i + 1]]
            keep = state[cols] != 2  # entries over U ∪ F
            denom = vals[keep].sum()
            dominance[i] = diag[i] / denom if denom > 0 else np.inf
            if dominance[i] >= theta:
                state[i] = 1
                undecided[i] = False
    F = np.where(state == 1)[0]
    C = np.where(state == 2)[0]
    return len(F), F, C


def greedy_coarsening_parallel(A_csr: CSR, theta: float, max_rounds: int = 64) -> torch.Tensor:
    """Parallel C/F splitting (Luby-style local-minimum selection).

    Each round, every undecided node whose dominance (plus a fixed jitter
    from ``uniform(PRNGKey(0))``, JAX's draw, that breaks ties) is at or
    below all its undecided neighbours' becomes C; then the dominance is
    recomputed over the non-C columns and undecided nodes that reach
    ``theta`` become F.  Runs ``max_rounds`` rounds; what is left undecided
    becomes F.  Returns the (n,) int8 state, 1 = F, 2 = C.
    """
    n = A_csr.shape[0]
    live = A_csr.mask
    r = A_csr.row.clamp(max=n - 1)
    c = A_csr.col
    zero = torch.zeros((), dtype=A_csr.dtype, device=A_csr.device)
    inf = zero + float("inf")
    absdata = A_csr.data.abs() * live
    absdiag = A_csr.diagonal().abs()

    def dominance(data):
        rowsum = slot_sum(data, A_csr.row_slots)
        return absdiag / torch.where(rowsum > 0, rowsum, zero + 1.0)

    dom = dominance(absdata)
    np_dtype = torch.empty((), dtype=A_csr.dtype).numpy().dtype
    tie = torch.from_numpy(prng.uniform(prng.PRNGKey(0), (n,), np_dtype)).to(A_csr.device) * 1e-9
    one, two = (torch.tensor(v, dtype=torch.int8, device=A_csr.device) for v in (1, 2))
    state = torch.where(dom >= theta, one, one - 1)
    for _ in range(max_rounds):
        und = state == 0
        key = torch.where(und, dom + tie, inf)
        nb_min_in = segment_min(torch.where(und[r] & live, key[r], inf), c, n)
        nb_min_out = segment_min(torch.where(und[c] & live, key[c], inf), r, n)
        selected = und & (key <= torch.minimum(nb_min_in, nb_min_out))
        state = torch.where(selected, two, state)
        dom = dominance(torch.where(state[c] != 2, absdata, zero))
        state = torch.where((state == 0) & (dom >= theta), one, state)
    return torch.where(state == 0, one, state)
