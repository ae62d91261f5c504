"""Aggregate figures (counterpart of ``mlamg_tpu/viz/aggplot.py``).

A 2D aggregate is drawn as its intra-aggregate triangles and fat edges
(matplotlib collections); a spider plot draws lines from each aggregate's
|P|-weighted centroid to its members; a 3D grid is a scatter coloured by
aggregate.  :class:`AsyncPlotter` draws in a spawned process fed by a
queue, so a training loop never waits on rendering.  matplotlib is
imported only inside the drawing functions.
"""

from __future__ import annotations

import multiprocessing as mp

import numpy as np


def _require_plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_grid(grid, ax=None, node_size: float = 20.0):
    """Nodes and edges of the matrix graph."""
    plt = _require_plt()
    from matplotlib.collections import LineCollection

    if ax is None:
        ax = plt.gca()
    A = grid.A.tocoo()
    x = grid.x
    mask = A.row != A.col
    segs = np.stack([x[A.row[mask], :2], x[A.col[mask], :2]], axis=1)
    ax.add_collection(LineCollection(segs, colors="0.7", linewidths=0.5, zorder=1))
    ax.scatter(x[:, 0], x[:, 1], s=node_size, c="k", zorder=2)
    ax.autoscale()
    return ax


def plot_agg(grid, agg_id, ax=None, alpha: float = 0.6, lw: float = 3.0):
    """Filled aggregate regions: intra-aggregate triangles and fat edges,
    coloured per aggregate (tab20)."""
    plt = _require_plt()
    from matplotlib.collections import LineCollection, PolyCollection

    if ax is None:
        ax = plt.gca()
    A = grid.A.tocsr()
    x = np.asarray(grid.x)[:, :2]
    agg = np.asarray(agg_id)
    cmap = plt.get_cmap("tab20")

    tris, tri_colors, segs, seg_colors = [], [], [], []
    indptr, indices = A.indptr, A.indices
    for i in range(A.shape[0]):
        nbrs = indices[indptr[i]:indptr[i + 1]]
        nbrs = nbrs[(nbrs != i) & (agg[nbrs] == agg[i])]
        color = cmap(agg[i] % 20)
        for j1 in nbrs:
            if j1 <= i:
                continue
            segs.append([x[i], x[j1]])
            seg_colors.append(color)
            # triangles i-j1-j2 inside the aggregate
            j2s = indices[indptr[j1]:indptr[j1 + 1]]
            j2s = j2s[(j2s > j1) & (agg[j2s] == agg[i]) & np.isin(j2s, nbrs)]
            for j2 in j2s:
                tris.append([x[i], x[j1], x[j2]])
                tri_colors.append(color)

    if tris:
        ax.add_collection(PolyCollection(tris, facecolors=tri_colors, alpha=alpha,
                                         edgecolors="none"))
    if segs:
        ax.add_collection(LineCollection(segs, colors=seg_colors, linewidths=lw, alpha=alpha,
                                         capstyle="round"))
    ax.scatter(x[:, 0], x[:, 1], s=8, c="k", zorder=3)
    ax.autoscale()
    return ax


def plot_spider_agg(grid, agg_id, P=None, ax=None, lw: float = 2.0):
    """Lines from each aggregate's centroid (weighted by |P| of its
    members) to its members, opacity by |P| over the aggregate's largest
    (tab10)."""
    plt = _require_plt()
    from matplotlib.collections import LineCollection

    if ax is None:
        ax = plt.gca()
    x = np.asarray(grid.x)[:, :2]
    agg = np.asarray(agg_id)
    k = int(agg.max()) + 1
    cmap = plt.get_cmap("tab10")
    if P is not None:
        w = np.abs(np.asarray(P))[np.arange(len(agg)), agg]
    else:
        w = np.ones(len(agg))

    centers = np.zeros((k, 2))
    for j in range(k):
        members = agg == j
        if members.any():
            weights = w[members]
            weights = weights / max(weights.sum(), 1e-12)
            centers[j] = (x[members] * weights[:, None]).sum(0)

    segs, colors = [], []
    for i in range(len(agg)):
        j = agg[i]
        wmax = max(w[agg == j].max(), 1e-12)
        c = list(cmap(j % 10))
        c[3] = float(np.clip(w[i] / wmax, 0.05, 1.0))
        segs.append([centers[j], x[i]])
        colors.append(tuple(c))
    ax.add_collection(LineCollection(segs, colors=colors, linewidths=lw))
    ax.plot(centers[:, 0], centers[:, 1], "r*", markersize=8, zorder=4)
    ax.autoscale()
    return ax


def plot_agg_3d(grid, agg_id, ax=None, s: float = 30.0):
    """3D scatter of the nodes coloured by aggregate (tab20)."""
    plt = _require_plt()
    if ax is None:
        ax = plt.gcf().add_subplot(projection="3d")
    x = np.asarray(grid.x)
    ax.scatter(x[:, 0], x[:, 1], x[:, 2], c=np.asarray(agg_id), cmap="tab20", s=s)
    return ax


def _plotter_worker(queue) -> None:
    plt = _require_plt()
    handlers = {"grid": plot_grid, "agg": plot_agg, "spider": plot_spider_agg,
                "agg3d": plot_agg_3d}
    while True:
        item = queue.get()
        if item is None:
            return
        kind, args, kwargs, out_path = item
        try:
            plt.figure(figsize=(6, 6))
            handlers[kind](*args, **kwargs)
            plt.savefig(out_path, dpi=120, bbox_inches="tight")
        except Exception as e:  # a failed figure must not stop the caller's loop
            print(f"AsyncPlotter: {kind} failed: {e!r}", flush=True)
        finally:
            plt.close("all")


class AsyncPlotter:
    """Render figures in a spawned process; the caller never waits.

        with AsyncPlotter() as ap:
            ap.plot("agg", grid, agg_id, out_path="gen_001.png")
    """

    def __init__(self):
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue()
        self._proc = ctx.Process(target=_plotter_worker, args=(self._queue,), daemon=True)

    def __enter__(self):
        self._proc.start()
        return self

    def plot(self, kind: str, *args, out_path: str, **kwargs) -> None:
        self._queue.put((kind, args, kwargs, out_path))

    def __exit__(self, *exc):
        self._queue.put(None)
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.terminate()
        return False
