"""The unstructured SA hierarchy of ``mlamg_torch`` on a scipy operator:
``build_unstructured_hierarchy`` with the configuration's settings and
``uvcycle_solve``.

The harness hands the hierarchy its float32 matrix in the natural order.
A request permutes b by the ``perm`` the build returned, solves, and gives
x back in the natural order.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch
from mlamg_torch.mg.amg_unstructured import build_unstructured_hierarchy, uvcycle_solve

from reference import hull_fem, sa_aggregation


class System:
    def __init__(self, config: dict, device: torch.device, cache_dir: str):
        op = config["operator"]
        A = hull_fem.load_or_make(op["n_interior"], op["seed"], cache_dir)
        self.A = sp.csr_matrix(A, dtype=np.float32)
        self.n, self.nnz = self.A.shape[0], int(self.A.nnz)
        self.device = device
        with warnings.catch_warnings():  # torch's note that sparse CSR is in beta
            warnings.simplefilter("ignore", UserWarning)
            self.A_dev = torch.sparse_csr_tensor(
                torch.from_numpy(self.A.indptr.astype(np.int64)),
                torch.from_numpy(self.A.indices.astype(np.int64)),
                torch.from_numpy(self.A.data), size=self.A.shape,
                check_invariants=False).to(device)
        self.hierarchy = config["hierarchy"]
        self.cycle = config["cycle"]
        self.max_cycles = config["request"]["max_cycles"]
        self._reference = {}

    def start(self) -> None:
        """Starts what the first build would start in its clock: cuBLAS
        and cuSOLVER (a small dense inverse) and the host library that
        orders the levels (RCM of a 2x2 matrix)."""
        from mlamg_torch import native

        eye = torch.eye(32, device=self.device)
        torch.linalg.inv(eye + eye) @ eye
        native.rcm_ordering(sp.eye(2, format="csr"))

    def operator(self, scale: float):
        return self.A if scale == 1.0 else (self.A * np.float32(scale)).astype(np.float32)

    def rhs(self, x_true: torch.Tensor, scale: float) -> torch.Tensor:
        b = self.A_dev @ x_true
        return b if scale == 1.0 else b * scale

    def build(self, A):
        h, perm = build_unstructured_hierarchy(A, device=self.device, **self.hierarchy)
        perm_t = torch.from_numpy(np.asarray(perm, np.int64)).to(self.device)
        inv = torch.empty_like(perm_t)
        inv[perm_t] = torch.arange(self.n, device=self.device)
        return h, perm_t, inv, np.asarray(perm)

    def solve(self, hh, b: torch.Tensor, tol: float):
        h, perm_t, inv, _ = hh
        x, _, err, iters = uvcycle_solve(h, b[perm_t], torch.zeros_like(b), res_tol=tol,
                                         max_iter=self.max_cycles, **self.cycle)
        converged = iters < self.max_cycles or float(err[iters - 1]) <= tol
        return x[inv], iters, converged

    def level0(self, hh):
        return hh[0].levels[0].A

    def spmv_bytes(self) -> int:
        """Least bytes of one product: values and columns of the stored
        nonzeros, x and y."""
        return self.nnz * 8 + 2 * self.n * 4

    def coarse_state(self, hh):
        """The program's perm, level-0 aggregation and first coarse
        operator (read from its ELL arrays) as host arrays."""
        h, _, _, perm = hh
        lev0, W = h.levels[0], h.levels[1].A
        k = W.shape[0]
        data = W.data[:, :k].cpu().numpy()
        col = W.col[:, :k].cpu().numpy().astype(np.int64)
        row = np.broadcast_to(np.arange(k), data.shape)
        live = data != 0
        A1 = sp.csr_matrix((data[live].astype(np.float64), (row[live], col[live])), shape=(k, k))
        return perm, lev0.agg.cpu().numpy(), int(lev0.k), A1

    def reference(self, scale: float):
        """The reference's RCM order, aggregation and k for the operator
        at ``scale``: the float32 matrix the program is handed."""
        if scale not in self._reference:
            hc = self.hierarchy
            self._reference[scale] = sa_aggregation.aggregate(
                self.operator(scale), hc["alpha"], hc["lloyd_maxiter"])
        return self._reference[scale]

    def check_coarse(self, state, scale: float) -> dict:
        """``aggregation``: the nodes whose level-0 aggregate differs from
        the reference's, the two compared as partitions of the natural
        order (every node where the program's is no partition);
        ``coarse_op``: the first coarse operator against the reference's,
        aggregates matched by the partition."""
        perm, agg, k, A1 = state
        n = self.n
        ref_perm, ref_agg, ref_k = self.reference(scale)
        sound = (perm.shape == (n,) and np.array_equal(np.sort(perm), np.arange(n))
                 and agg.shape == (n,) and A1.shape == (k, k)
                 and np.array_equal(np.unique(agg), np.arange(k)))
        if not sound:
            return {"aggregation": float(n), "coarse_op": float("inf")}
        mine, ref = np.empty(n, np.int64), np.empty(n, np.int64)
        mine[perm], ref[ref_perm] = agg, ref_agg
        differ = sa_aggregation.nodes_apart(mine, ref)
        if differ or k != ref_k:
            return {"aggregation": float(max(differ, 1)), "coarse_op": float("inf")}
        to_mine = np.empty(k, np.int64)
        to_mine[ref] = mine  # the program's label of each reference aggregate
        A1 = A1[to_mine][:, to_mine].tocsr()
        A0 = self._permuted(scale, ref_perm)
        want = hull_fem.coarse_reference(A0, ref_agg, k, self.hierarchy["trunc_theta"], A1)
        return {"aggregation": 0.0, "coarse_op": float(abs(A1 - want).max() / abs(want).max())}

    def control_state(self, state, scale: float):
        """The reference in the program's place: its own RCM order and
        aggregation, and its first coarse operator in bfloat16."""
        ref_perm, ref_agg, k = self.reference(scale)
        A0 = self._permuted(scale, ref_perm)
        low = hull_fem.truncate_lump(hull_fem.galerkin(A0, ref_agg, k, low=True),
                                     self.hierarchy["trunc_theta"])
        return ref_perm, ref_agg, k, low

    def _permuted(self, scale: float, perm: np.ndarray) -> sp.csr_matrix:
        return (self.A.astype(np.float64) * scale)[perm][:, perm].tocsr()

    def residual(self, x, b, scale: float) -> float:
        x64 = x.double().cpu().numpy()
        b64 = b.double().cpu().numpy()
        r = b64 - scale * (self.A.astype(np.float64) @ x64)
        return float(np.linalg.norm(r) / np.linalg.norm(b64))
