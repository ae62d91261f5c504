"""The learned two-level solver of ``mlamg_torch`` on a dataset of grids:
a trained FullAggNet builds each grid's hierarchy
(``build_learned_twolevel``: colouring, graph, AggNet, CNet,
Bellman-Ford, PNet, P = P-hat Agg, Galerkin, LU) and ``learned_solve``
runs its two-level multicolour Gauss-Seidel cycles.  The items are the
dataset's grids; the harness serves one a request (``traffic/grid.json``).

The check holds the program to ``reference/learned_twolevel.py``:

- ``centers``: the nodes where a layer's 0/1 mask differs from the stable
  top-k of that layer's own scores, plus the centers that differ from the
  last layer's;
- ``aggregation``: the nodes whose aggregate differs from the reference's
  float32 Bellman-Ford on the program's C and centers;
- ``gnn``: the worst, over AggNet's scores of each layer, C and P-hat, of
  the max abs gap to the teacher-forced float64 reference over the max abs
  of the program's (0 where both are zero);
- ``coarse_op``: the program's P^T A P against the reference's float64
  product of the program's P.

For ``gnn`` the program's net runs again on the kept item with forward
hooks on its InstanceNorms, which give the forced values; the run must
equal the timed build's outputs bit for bit, else ``gnn`` reads infinite.
"""

from __future__ import annotations

import math
import warnings
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
from mlamg_torch.cli.evaluate_dataset import load_model
from mlamg_torch.data.grid import Grid
from mlamg_torch.mg.learned import build_learned_twolevel, learned_solve
from mlamg_torch.ops.sparse import CSR

from reference import learned_twolevel as ref

ROOT = Path(__file__).resolve().parents[2]
FORCED_SITES = ("aggnet.layer_0", "cnet", "pnet")


class System:
    def __init__(self, config: dict, device: torch.device, cache_dir: str):
        self.device = device
        model, data = config["model"], config["dataset"]
        grids = Grid.load_dir(str(ROOT / data["dir"]))
        self.net, net_config = load_model(str(ROOT / model["checkpoint"]), grids, device=device)
        for key in ("dim", "num_conv", "iterations", "bf_width", "rel_strength"):
            if net_config[key] != model[key]:
                raise ValueError(f"{key}: the checkpoint gives {net_config[key]!r}, "
                                 f"the configuration {model[key]!r}")
        self.iterations, self.rel_strength = model["iterations"], model["rel_strength"]
        self.A64 = []
        for g in grids:
            A = sp.csr_matrix(g.A, dtype=np.float64)
            A.sort_indices()
            self.A64.append(A)
        self.items = len(self.A64)
        hc = config["hierarchy"]
        self.k = [max(1, math.ceil(hc["alpha"] * A.shape[0])) for A in self.A64]
        self.steps = hc["pre_smoothing_steps"], hc["post_smoothing_steps"]
        self.max_cycles = config["request"]["max_cycles"]
        self.weights = {k: v.detach().to("cpu", torch.float64)
                        for k, v in self.net.state_dict().items()}
        self._rhs = [self._sparse(A.astype(np.float32)) for A in self.A64]

    def _sparse(self, A) -> torch.Tensor:
        with warnings.catch_warnings():  # torch's note that sparse CSR is in beta
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                torch.from_numpy(A.indptr.astype(np.int64)),
                torch.from_numpy(A.indices.astype(np.int64)),
                torch.from_numpy(A.data), size=A.shape, check_invariants=False).to(self.device)

    def n_of(self, item: int) -> int:
        return self.A64[item].shape[0]

    def start(self) -> None:
        """Builds and solves every grid once: the warm-up requests cover two
        of the items, and each grid's sizes are its own."""
        for item in range(self.items):
            b = self.rhs(torch.ones(self.n_of(item), device=self.device), 1.0, item)
            self.solve(self.build(self.operator(1.0, item)), b,
                       1e-6 * float(torch.linalg.vector_norm(b)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def operator(self, scale: float, item: int):
        """The item's float32 operator on the card, a new one each call (no
        slot table of an earlier request carried over)."""
        A = self.A64[item] if scale == 1.0 else self.A64[item] * scale
        return item, CSR.from_scipy(A, dtype=torch.float32, device=self.device)

    def rhs(self, x_true: torch.Tensor, scale: float, item: int) -> torch.Tensor:
        b = self._rhs[item] @ x_true
        return b if scale == 1.0 else b * scale

    def build(self, A):
        item, A = A
        return item, build_learned_twolevel(self.net, A, self.k[item])

    def solve(self, hh, b: torch.Tensor, tol: float):
        _, h = hh
        x, _, err, iters = learned_solve(h, b, res_tol=tol, max_iter=self.max_cycles,
                                         pre_smoothing_steps=self.steps[0],
                                         post_smoothing_steps=self.steps[1])
        converged = iters < self.max_cycles or float(err[iters - 1]) <= tol
        return x, iters, converged

    def coarse_state(self, hh):
        """The item and the build itself: references, no copy."""
        return hh

    # the check

    def _pattern(self, item: int):
        A = self.A64[item].tocoo()
        return torch.from_numpy(A.row.astype(np.int64)), torch.from_numpy(A.col.astype(np.int64))

    def _outputs(self, h) -> dict:
        """The build's outputs the check reads, on the host, per stored
        entry of A where they live on its pattern."""
        p, n = h.parts, h.A.shape[0]
        live = (h.A.row < n).cpu()

        def host(t):
            return t.detach().cpu()

        return {"scores": [host(s) for s in p.scores], "masks": [host(m) for m in p.masks],
                "centers": host(p.centers), "C": host(p.C.data)[live],
                "agg_id": host(p.agg_id), "p_hat": host(p.p_hat)[live], "A_H": host(h.A_H)}

    def _forced(self, h):
        """The InstanceNorm outputs at the forced sites from the program's
        net run again on the build's operator, or None where that run's
        outputs are not the build's bit for bit."""
        net = self.net
        modules = {"aggnet.layer_0": net.AggNetM.layer_0.norm, "cnet": net.CNet.norm,
                   "pnet": net.PNet.norm}
        seen = {site: [] for site in FORCED_SITES}
        hooks = [m.register_forward_hook(lambda _m, _i, out, s=site: seen[s].append(out))
                 for site, m in modules.items()]
        try:
            with torch.no_grad():
                again = net.parts(h.A, h.P.shape[1])
        finally:
            for hook in hooks:
                hook.remove()
        p = h.parts
        pairs = [*zip(again.scores, p.scores), *zip(again.masks, p.masks),
                 (again.centers, p.centers), (again.C.data, p.C.data),
                 (again.agg_id, p.agg_id), (again.p_hat, p.p_hat)]
        if not all(a.shape == b.shape and torch.equal(a, b) for a, b in pairs):
            return None
        return {site: [t.detach().cpu() for t in ts] for site, ts in seen.items()}

    def _reference(self, item: int, scale: float, out: dict, forced: dict, dtype):
        row, col = self._pattern(item)
        a = torch.from_numpy(self.A64[item].data) * scale
        n, k = self.n_of(item), self.k[item]
        return ref.fullaggnet(self.weights, row, col, a, n, k, iterations=self.iterations,
                              rel_strength=self.rel_strength, dtype=dtype,
                              forced={"norms": forced, "mask0": out["masks"][0],
                                      "centers": out["centers"], "agg_id": out["agg_id"]})

    def check_coarse(self, state, scale: float) -> dict:
        item, h = state
        if isinstance(h, dict):  # the control: outputs and forced values given
            out, forced = h, h["forced"]
        else:
            out, forced = self._outputs(h), self._forced(h)
        n, k = self.n_of(item), self.k[item]
        row, col = self._pattern(item)
        g = ref.graph_of(row, col, torch.from_numpy(self.A64[item].data) * scale, n)

        centers = 0
        for scores, mask in zip(out["scores"], out["masks"]):
            want = ref.mask_of(ref.topk(scores, k), n, torch.float32)
            centers += int((mask.float() != want).sum())
        centers += int((out["centers"] != ref.topk(out["scores"][-1], k)).sum())

        _, near, _ = ref.bellman_ford(g, out["C"], out["centers"])
        aggregation = int((ref.agg_of(out["centers"], near, n) != out["agg_id"]).sum())

        P = ref.prolongator(g, out["p_hat"].double(), out["agg_id"], k)
        A = torch.from_numpy((self.A64[item] * scale).toarray())
        want = ref.galerkin(A, P)
        coarse_op = float((out["A_H"].double() - want).abs().max() / want.abs().max())

        gnn = math.inf
        if forced is not None:
            r = self._reference(item, scale, out, forced, torch.float64)
            pairs = [*zip(out["scores"], r["scores"]), (out["C"], r["C"]),
                     (out["p_hat"], r["p_hat"])]
            gnn = max(_gap(mine.double(), theirs.double()) for mine, theirs in pairs)
        return {"centers": float(centers), "aggregation": float(aggregation), "gnn": gnn,
                "coarse_op": coarse_op}

    def control_state(self, state, scale: float):
        """The reference in bfloat16 in the program's place, forced at the
        same points: its scores, C, P-hat and P^T A P, with the program's
        discrete decisions."""
        item, h = state
        out, forced = self._outputs(h), self._forced(h)
        low = self._reference(item, scale, out, forced, torch.bfloat16)
        A = torch.from_numpy((self.A64[item] * scale).toarray()).to(torch.bfloat16)
        masks = [out["masks"][0], low["masks"][1]]
        return item, {"scores": low["scores"], "masks": masks, "centers": out["centers"],
                      "C": low["C"], "agg_id": out["agg_id"], "p_hat": low["p_hat"],
                      "A_H": ref.galerkin(A, low["P"]), "forced": forced}

    def residual(self, x, b, scale: float, item: int) -> float:
        x64 = x.double().cpu().numpy()
        b64 = b.double().cpu().numpy()
        r = b64 - scale * (self.A64[item] @ x64)
        return float(np.linalg.norm(r) / np.linalg.norm(b64))


def _gap(mine: torch.Tensor, theirs: torch.Tensor) -> float:
    """max |mine - theirs| over max |mine|; 0 where both are zero."""
    diff = float((mine - theirs).abs().max())
    if diff == 0.0:
        return 0.0
    scale = float(mine.abs().max())
    return diff / scale if scale > 0 else math.inf

