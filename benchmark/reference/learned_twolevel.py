"""The plain reference of the learned two-level solver: FullAggNet
(ml-amg's ``ns/model/agg_interp.py``: AggNet's iterated top-k, CNet's
Bellman-Ford weights, PNet's P-hat), the aggregation, P = P-hat Agg, the
Galerkin product P^T A P and the two-level multicolour Gauss-Seidel
cycle, written from the layer equations in plain ``torch``.

It imports nothing of the measured package.  It runs in float64 (or the
dtype asked for) with TF32 off, on the host unless the tensors it is given
live elsewhere.  The weights are a dict of tensors under the measured
package's ``state_dict()`` names (``AggNetM.layer_0.tag_0.Dense_0.weight``,
...): a Dense is ``x @ weight.T + bias``.

**The layers.**  Every graph is A's stored pattern, entry e = (i, j) an
edge i -> j whose message adds into node j.

- InstanceNorm: (x - mean) / sqrt(var + 1e-5) over the nodes, population
  variance.
- LayerNorm: (h - mean) / sqrt(var + 1e-6) * weight + bias over the
  features.
- TAGConv (K = 3): h_0 = x, h_k = sum over edges of w_e * h_{k-1}[i] into
  j with w_e = a_e / sqrt(d_i d_j), d the sum of |a| into a node (at least
  1e-12); out = Dense_0(h_0) + sum_k Dense_k(h_k), bias on Dense_0 only.
- NNConv: an edge MLP (ReLU after each of its Denses) makes an (in, out)
  matrix W_e per edge; out = root(x) + sum over edges of x[i] W_e into j.
- EdgeModel: Dense_1(LayerNorm(ReLU(Dense_0([x_i, x_j, e])))).
- MLP: Denses with ReLU after every one, the last too.
- MPNN: x = 1/n, e = the edge features; per block x = ReLU(NNConv(
  InstanceNorm(x), e_in)) + x, e = ReLU(EdgeModel(x_i, x_j, e)) + e (the
  first block reads |e| and lifts e to 2 features); then the node head
  x = ReLU(NNConv_out(InstanceNorm(x), e)) and the edge head
  e = ReLU(EdgeModel_out(x_i, x_j, e)), whose first feature is the output.
- AggNet: per layer, per conv, x = MLP(ReLU(TAGConv(InstanceNorm(x),
  last edge feature))); the scores x[:, 0]; the 0/1 mask of the k largest
  (a stable descending sort: ties to the earlier node) feeds the next
  layer; the last layer's k largest are the centers.
- CNet's graph: edge features |a_ij| and, with ``rel_strength``,
  |a_ij| / max_{j' != i} |a_ij'| (0 on the diagonal); PNet's: |a_ij| and 1
  where i and j lie in different aggregates.
- Bellman-Ford from the centers on CNet's weights, in float32: each sweep
  relaxes every edge, dist_j = min(dist_j, min_i dist_i + C_ij), until no
  distance falls; a node whose distance fell takes the smallest center id
  among the edges that reach its new distance.  agg_id[j] is the index of
  node j's center among the centers (k where none reaches it).
- P = P-hat Agg: P[i, agg_id[j]] += P-hat_ij; entries whose column has no
  aggregate drop.  A_H = P^T A P.  The cycle: one multicolour
  Gauss-Seidel sweep (colours in order, each colour's rows at once), the
  coarse correction by A_H's LU, one sweep after.

**Departures from ml-amg** (they are the measured package's, which this
reference is held to): ml-amg builds the layers from torch_geometric and
torch.nn; here LayerNorm uses eps 1e-6 (flax's) where torch's default is
1e-5; NNConv sums its messages (with a root weight) and its edge MLP has
widths (4, 16); the node features start at 1/n; CNet may read the
row-relative strength as a second edge feature; Bellman-Ford is this
file's float32 sweep with its tie rule, where ml-amg calls pyamg's C++
``bellman_ford`` in float64; top-k is a stable sort (ml-amg's argsort
leaves ties to the sort); the cycle's smoother is the greedy-colour
Gauss-Seidel of the measured package's evaluation.

**Teacher forcing.**  Every network starts from the constant feature 1/n,
so each InstanceNorm of a node feature that descends from it normalises a
vector that is constant but for rounding residue, multiplied by
1/sqrt(1e-5) ~ 316: an independent float64 forward cannot be held to the
float32 program there.  :func:`fullaggnet` therefore takes, in
``forced``:

- ``norms``: for the sites ``"aggnet.layer_0"``, ``"cnet"`` and
  ``"pnet"``, the program's own output of every InstanceNorm there, in
  call order (2, 7 and 6 calls for the configuration's widths), used in
  place of this file's InstanceNorm;
- the discrete decisions: ``mask0`` (AggNet layer 0's top-k mask, the next
  layer's input), ``centers`` and ``agg_id``.

Everything else, every Dense, TAGConv, NNConv, EdgeModel and LayerNorm,
AggNet layer 1 with its own InstanceNorms (its input is the forced 0/1
mask, which is no constant), and the heads, it computes itself.  Forcing
only each network's first InstanceNorm is not enough: the next block adds
a float32 rounding of ~1e-7 to a node feature that is again constant but
for residue of that size, and the next InstanceNorm amplifies it to the
same order as the signal.  A site left out, or the calls past the end of
its list, are computed here.
"""

from __future__ import annotations

import contextlib

import torch

NORM_EPS = 1e-5
LAYER_NORM_EPS = 1e-6
TAG_K = 3


@contextlib.contextmanager
def exact_matmul():
    """TF32 off for matmuls and cuDNN inside the block, restored after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


class Graph:
    """A's pattern as edges (src i, dst j) with the values ``a`` (E,)."""

    def __init__(self, row: torch.Tensor, col: torch.Tensor, a: torch.Tensor, n: int):
        self.src, self.dst, self.a, self.n = row, col, a, n

    def into_dst(self, m: torch.Tensor) -> torch.Tensor:
        """Sum of edge messages (E, F) into their destination nodes."""
        out = torch.zeros((self.n,) + tuple(m.shape[1:]), dtype=m.dtype, device=m.device)
        return out.index_add_(0, self.dst, m)


class Net:
    """The weights and the forced values of one forward pass."""

    def __init__(self, w: dict, dtype, forced: dict | None):
        self.w, self.dtype = w, dtype
        forced = forced or {}
        self.forced = {k: list(v) for k, v in forced.get("norms", {}).items()}

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w[name + ".weight"].T
        b = self.w.get(name + ".bias")
        return y if b is None else y + b

    def norm(self, site: str, x: torch.Tensor) -> torch.Tensor:
        """InstanceNorm over the nodes, or the program's next output at a
        forced site while its list lasts."""
        if self.forced.get(site):
            return self.forced[site].pop(0).to(self.dtype)
        d = x - x.mean(0, keepdim=True)
        return d / torch.sqrt((d * d).mean(0, keepdim=True) + NORM_EPS)

    def layer_norm(self, name: str, h: torch.Tensor) -> torch.Tensor:
        d = h - h.mean(-1, keepdim=True)
        var = (d * d).mean(-1, keepdim=True)
        scale = self.w[name + ".weight"] / torch.sqrt(var + LAYER_NORM_EPS)
        return d * scale + self.w[name + ".bias"]

    def mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        i = 0
        while f"{name}.Dense_{i}.weight" in self.w:
            x = torch.relu(self.dense(f"{name}.Dense_{i}", x))
            i += 1
        return x

    def tag(self, name: str, g: Graph, x: torch.Tensor, ew: torch.Tensor) -> torch.Tensor:
        deg = g.into_dst(ew.abs()[:, None])[:, 0]
        s = 1.0 / torch.sqrt(deg.clamp(min=1e-12))
        w = ew * s[g.src] * s[g.dst]
        h, out = x, self.dense(f"{name}.Dense_0", x)
        for k in range(1, TAG_K + 1):
            h = g.into_dst(w[:, None] * h[g.src])
            out = out + self.dense(f"{name}.Dense_{k}", h)
        return out

    def nnconv(self, name: str, g: Graph, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        i, h = 0, e
        while f"{name}.Dense_{i + 1}.weight" in self.w:
            h = torch.relu(self.dense(f"{name}.Dense_{i}", h))
            i += 1
        d_in, d_out = x.shape[1], self.w[f"{name}.Dense_{i}.weight"].shape[0]
        W = h.reshape(-1, d_in, d_out)
        msg = (x[g.src][:, :, None] * W).sum(1)
        return self.dense(f"{name}.Dense_{i}", x) + g.into_dst(msg)

    def edge_model(self, name: str, g: Graph, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x[g.src], x[g.dst], e], 1)
        h = self.layer_norm(f"{name}.LayerNorm_0", torch.relu(self.dense(f"{name}.Dense_0", h)))
        return self.dense(f"{name}.Dense_1", h)

    def mpnn(self, name: str, site: str, g: Graph, e: torch.Tensor) -> torch.Tensor:
        """The MPNN's edge head, (E,)."""
        x = torch.full((g.n, 1), 1.0 / g.n, dtype=self.dtype, device=e.device)
        blocks = [("node_conv_in", "edge_conv_in")]
        i = 0
        while f"{name}.node_conv_{i}.Dense_0.weight" in self.w:
            blocks.append((f"node_conv_{i}", f"edge_conv_{i}"))
            i += 1
        for b, (node, edge) in enumerate(blocks):
            x = torch.relu(self.nnconv(f"{name}.{node}", g, self.norm(site, x),
                                       e.abs() if b == 0 else e)) + x
            e = torch.relu(self.edge_model(f"{name}.{edge}", g, x, e)) + e
        x = torch.relu(self.nnconv(f"{name}.node_conv_out", g, self.norm(site, x), e))
        return torch.relu(self.edge_model(f"{name}.edge_conv_out", g, x, e))[:, 0]


def topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest, ties to the earlier index (stable descending sort)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def mask_of(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    m = torch.zeros(n, dtype=dtype, device=idx.device)
    m[idx] = 1.0
    return m


def bellman_ford(g: Graph, C: torch.Tensor, centers: torch.Tensor, dtype=torch.float32):
    """(distance, nearest center's node id, sweeps) from ``centers`` on the
    edge weights ``C`` (E,), summed in ``dtype`` (see the module
    docstring); n where no center reaches a node."""
    n, dev = g.n, C.device
    w = C.to(dtype)
    dist = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    near = torch.full((n,), n, dtype=torch.int64, device=dev)
    dist[centers], near[centers] = 0.0, centers
    sweeps = 0
    while sweeps < n:
        sweeps += 1
        cand = dist[g.src] + w
        best = torch.full((n,), float("inf"), dtype=dtype, device=dev).scatter_reduce(
            0, g.dst, cand, "amin")
        fell = best < dist
        new = torch.where(fell, best, dist)
        reach = torch.where(cand <= new[g.dst], near[g.src], torch.full_like(near[g.src], n))
        nearest = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
            0, g.dst, reach, "amin")
        near = torch.where(fell, nearest, near)
        dist = new
        if not bool(fell.any()):
            break
    return dist, near, sweeps


def agg_of(centers: torch.Tensor, near: torch.Tensor, n: int) -> torch.Tensor:
    k = centers.shape[0]
    index = torch.full((n + 1,), k, dtype=torch.int64, device=near.device)
    index[centers] = torch.arange(k, device=near.device)
    return index[near]


def prolongator(g: Graph, p_hat: torch.Tensor, agg_id: torch.Tensor, k: int) -> torch.Tensor:
    """Dense P = P-hat Agg, (n, k)."""
    col = agg_id[g.dst]
    keep = col < k
    P = torch.zeros((g.n, k), dtype=p_hat.dtype, device=p_hat.device)
    return P.index_put_((g.src[keep], col[keep]), p_hat[keep], accumulate=True)


def galerkin(A: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """P^T A P of a dense A and P."""
    with exact_matmul():
        return P.T @ (A @ P)


def graph_of(row, col, a, n: int) -> Graph:
    return Graph(row.long(), col.long(), a, n)


def fullaggnet(w: dict, row, col, a, n: int, k: int, *, iterations: int, rel_strength: bool,
               forced: dict | None = None, dtype=torch.float64,
               bf_dtype=torch.float32) -> dict:
    """FullAggNet on the matrix with entries (row, col, a) (E,) of n rows
    and k aggregates, weights ``w``; ``forced`` as the module docstring
    says; Bellman-Ford sums in ``bf_dtype`` (the program's precision).
    Returns ``scores`` and ``masks`` (one per AggNet layer), ``centers``,
    ``C`` (E,), ``agg_id``, ``p_hat`` (E,) and ``P`` (n, k)."""
    forced = forced or {}
    with exact_matmul():
        w = {key: v.to(dtype) for key, v in w.items()}
        net = Net(w, dtype, forced)
        a = a.to(dtype)
        g = graph_of(row, col, a, n)
        absa = a.abs()
        feats = [absa]
        if rel_strength:
            off = torch.where(g.src == g.dst, torch.zeros_like(absa), absa)
            rowmax = torch.zeros(n, dtype=dtype, device=a.device).scatter_reduce(
                0, g.src, off, "amax")
            feats.append(torch.where(g.src == g.dst, torch.zeros_like(absa),
                                     absa / rowmax[g.src].clamp(min=1e-30)))
        e1 = torch.stack(feats, 1)
        x = torch.full((n, 1), 1.0 / n, dtype=dtype, device=a.device)
        scores, masks = [], []
        for layer in range(iterations):
            site = f"aggnet.layer_{layer}"
            name = f"AggNetM.layer_{layer}"
            conv = 0
            while f"{name}.tag_{conv}.Dense_0.weight" in w:
                x = net.tag(f"{name}.tag_{conv}", g, net.norm(site, x), e1[:, -1])
                x = net.mlp(f"{name}.mlp_{conv}", torch.relu(x))
                conv += 1
            scores.append(x[:, 0])
            if layer == 0 and "mask0" in forced:
                mask = forced["mask0"].to(dtype)
            else:
                mask = mask_of(topk(x[:, 0], k), n, dtype)
            masks.append(mask)
            x = mask[:, None]
        centers = forced["centers"].long() if "centers" in forced else topk(scores[-1], k)
        C = net.mpnn("CNet", "cnet", g, e1)
        if "agg_id" in forced:
            agg_id = forced["agg_id"].long()
        else:
            agg_id = agg_of(centers, bellman_ford(g, C, centers, bf_dtype)[1], n)
        differ = (agg_id[g.src] != agg_id[g.dst]).to(dtype)
        p_hat = net.mpnn("PNet", "pnet", g, torch.stack([absa, differ], 1))
        return {"scores": scores, "masks": masks, "centers": centers, "C": C,
                "agg_id": agg_id, "p_hat": p_hat, "P": prolongator(g, p_hat, agg_id, k)}


def greedy_colors(row, col, n: int) -> torch.Tensor:
    """Each row takes the smallest colour that none of its lower-numbered
    neighbours holds."""
    nbrs = [[] for _ in range(n)]
    for i, j in zip(row.tolist(), col.tolist()):
        if j < i:
            nbrs[i].append(j)
    colors = [0] * n
    for i in range(n):
        used = {colors[j] for j in nbrs[i]}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return torch.tensor(colors, dtype=torch.int64)


def twolevel_cycle(A: torch.Tensor, P: torch.Tensor, A_H: torch.Tensor, colors: torch.Tensor,
                   b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One two-level cycle on dense A: a multicolour Gauss-Seidel sweep, the
    coarse correction P A_H^-1 P^T (b - A x), a sweep."""
    dinv = 1.0 / torch.diagonal(A)
    num_colors = int(colors.max()) + 1

    def sweep(x):
        for c in range(num_colors):
            x = torch.where(colors == c, x + dinv * (b - A @ x), x)
        return x

    with exact_matmul():
        x = sweep(x)
        x = x + P @ torch.linalg.solve(A_H, P.T @ (b - A @ x))
        return sweep(x)
