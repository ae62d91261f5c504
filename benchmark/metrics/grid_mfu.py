"""grid_mfu: the learned requests' share of the card's peak: their least
bytes at the HBM rate over the window's time, in %.  The work is small
sparse products and elementwise network layers, so bandwidth bounds it.

A request's least bytes (:func:`request_bytes`), 4 bytes a value:

- the build: the weights read once; each network layer's output written
  once (every Dense's, node or edge rows by where it acts; each
  InstanceNorm's; each TAGConv hop's; each NNConv's messages; each
  EdgeModel's LayerNorm); the operator read (nnz * 8 + n * 4);
- the solve, per cycle: nnz * 8 + 2 n * 4 for each product with A (one
  per colour in each of the two sweeps, the residual, the stopping test),
  nnz * 8 + (n + k) * 4 for the restriction and the interpolation, and
  the k x k LU factors read.

The colour count is the plain reference's greedy colouring of the grid's
pattern; the cycle count is each request's own."""


def read(run):
    if run.device.type != "cuda" or not run.requests or not hasattr(run.system, "items"):
        return None
    cache: dict = {}
    total = sum(request_bytes(run.system, q["item"], q["cycles"], cache) for q in run.requests)
    return 100.0 * total / run.hbm_bytes_per_s() / run.window_s


def request_bytes(system, item: int, cycles: int, cache: dict) -> int:
    if item not in cache:
        cache[item] = (build_bytes(system, item), cycle_bytes(system, item))
    build, cycle = cache[item]
    return build + cycles * cycle


def build_bytes(system, item: int) -> int:
    A = system.A64[item]
    n, E = A.shape[0], A.nnz
    shapes = {name: tuple(w.shape) for name, w in system.weights.items()}
    values = sum(_prod(s) for s in shapes.values())
    roots = {}  # each NNConv's root Dense: its highest index
    for name in shapes:
        conv, dense = _dense_of(name)
        if ".node_conv_" in conv:
            roots[conv] = max(roots.get(conv, -1), dense)
    for name, s in shapes.items():
        if not name.endswith(".weight"):
            continue
        conv, dense = _dense_of(name)
        if dense < 0:
            if "LayerNorm" in name:
                values += E * s[0]
            continue
        out, d_in = s
        if name.startswith("AggNetM."):
            values += n * out
            if dense == 0:  # the TAGConv's InstanceNorm and its three hops
                values += 4 * n * d_in
        elif ".node_conv_" in conv and dense == roots[conv]:
            values += n * out + n * d_in + E * out  # node output, InstanceNorm, messages
        else:
            values += E * out
    return 4 * values + 8 * E + 4 * n


def cycle_bytes(system, item: int) -> int:
    import torch
    from reference import learned_twolevel as ref

    A = system.A64[item].tocoo()
    n, nnz, k = A.shape[0], A.nnz, system.k[item]
    colors = ref.greedy_colors(torch.from_numpy(A.row), torch.from_numpy(A.col), n)
    products = 2 * (int(colors.max()) + 1) + 2
    return (products * (nnz * 8 + 2 * n * 4) + 2 * (nnz * 8 + (n + k) * 4) + 4 * k * k)


def _dense_of(name: str):
    """(module path, Dense index or -1) of a weight's name."""
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.startswith("Dense_"):
            return ".".join(parts[:i]), int(p[6:])
    return ".".join(parts[:-1]), -1


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out
