"""The learned two-level path of ``mlamg_torch`` (``mg/learned.py``) against
the benchmark's plain reference (``benchmark/reference/learned_twolevel.py``),
its spans and host-read counters, ``evaluate_dataset``'s route through it,
and the benchmark's driver of it (``benchmark/systems/learned_twolevel.py``)
on a two-grid dataset.

The reference is teacher-forced as its docstring says: it takes the
program's InstanceNorm outputs wherever the node features descend from the
constant 1/n, and computes everything else itself."""

import math
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from mlamg_torch.cli.common import dataset_bf_width
from mlamg_torch.cli.evaluate_dataset import evaluate, load_model
from mlamg_torch.data.grid import Grid
from mlamg_torch.mg.learned import build_learned_twolevel, learned_solve, pattern_coloring
from mlamg_torch.models.agg_interp import FullAggNet
from mlamg_torch.models.gnn import init_flax_
from mlamg_torch.ops.sparse import CSR
from mlamg_torch.train import GridBundle, SolveOptions, bundle_conv
from mlamg_torch.utils import prng
from mlamg_torch.utils.profiler import SYNCS, Profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
for _p in (REPO, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from reference import learned_twolevel as ref  # noqa: E402

TEST_DIR = os.path.join(REPO, "data_out", "2d_iso", "test")
CKPT = os.path.join(REPO, "runs_iso_r5", "grad_best.ckpt")
GRIDS = Grid.load_dir(TEST_DIR)
SMALL = sorted(range(len(GRIDS)), key=lambda i: GRIDS[i].A.shape[0])[:2]  # n 80 and 85
SITES = ("aggnet.layer_0", "cnet", "pnet")


def norm_modules(net):
    return {"aggnet.layer_0": net.AggNetM.layer_0.norm, "cnet": net.CNet.norm,
            "pnet": net.PNet.norm}


def build_with_norms(net, A, k, **kw):
    """The build and the InstanceNorm outputs at the forced sites."""
    seen = {s: [] for s in SITES}
    hooks = [m.register_forward_hook(lambda _m, _i, o, s=s: seen[s].append(o.detach().clone()))
             for s, m in norm_modules(net).items()]
    try:
        h = build_learned_twolevel(net, A, k, **kw)
    finally:
        for hook in hooks:
            hook.remove()
    return h, seen


def entries(g, dtype):
    A = g.A.tocsr().astype(np.float64)
    A.sort_indices()
    coo = A.tocoo()
    return (torch.from_numpy(coo.row.astype(np.int64)), torch.from_numpy(coo.col.astype(np.int64)),
            torch.from_numpy(A.data).to(dtype), A)


def live(h, t):
    return t[h.A.row < h.A.shape[0]]


def gap(mine, theirs):
    mine, theirs = mine.double(), theirs.double()
    diff = float((mine - theirs).abs().max())
    return 0.0 if diff == 0 else diff / float(mine.abs().max())


@pytest.fixture(scope="module")
def random_net():
    """A float64 FullAggNet at dim 4 with flax's initial weights (seed 5)."""
    net = FullAggNet(dim=4, num_conv=2, iterations=2,
                     bf_width=dataset_bf_width([GRIDS[i] for i in SMALL]), rel_strength=True)
    init_flax_(net, prng.PRNGKey(5))
    return net.to(torch.float64).eval()


@pytest.mark.parametrize("which", [0, 1])
def test_port_matches_the_reference_in_float64(random_net, which):
    """Forced at the InstanceNorms of the constant feature only, the
    reference's own top-k, centers and float64 Bellman-Ford give the
    program's discrete stages, and its scores, C, P-hat, P and P^T A P agree
    to 1e-9."""
    g = GRIDS[SMALL[which]]
    row, col, a, A64 = entries(g, torch.float64)
    n = A64.shape[0]
    k = math.ceil(0.1 * n)
    A = CSR.from_scipy(A64, dtype=torch.float64, device="cpu")
    h, seen = build_with_norms(random_net, A, k)
    w = {key: v.detach() for key, v in random_net.state_dict().items()}
    r = ref.fullaggnet(w, row, col, a, n, k, iterations=2, rel_strength=True,
                       forced={"norms": seen}, bf_dtype=torch.float64)
    p = h.parts
    for mine, theirs in zip(p.masks, r["masks"]):
        assert torch.equal(mine, theirs)
    assert torch.equal(p.centers, r["centers"]) and torch.equal(p.agg_id, r["agg_id"])
    assert any(float(s.abs().max()) > 0 for s in p.scores)  # the scores decide, not a tie
    for mine, theirs in [*zip(p.scores, r["scores"]), (live(h, p.C.data), r["C"]),
                         (live(h, p.p_hat), r["p_hat"]), (p.P.todense(), r["P"]),
                         (h.A_H, ref.galerkin(torch.from_numpy(A64.toarray()), r["P"]))]:
        assert gap(mine, theirs) < 1e-9


def test_port_cycles_match_the_reference_cycle_in_float64(random_net):
    """Three of the program's two-level cycles equal the reference's on the
    program's P, with the reference's greedy colouring."""
    g = GRIDS[SMALL[0]]
    row, col, _, A64 = entries(g, torch.float64)
    n = A64.shape[0]
    A = CSR.from_scipy(A64, dtype=torch.float64, device="cpu")
    h = build_learned_twolevel(random_net, A, math.ceil(0.1 * n))
    colors = ref.greedy_colors(row, col, n)
    assert torch.equal(h.colors, colors)
    b = torch.from_numpy(np.random.RandomState(3).randn(n))
    x, _, _, iters = learned_solve(h, b, res_tol=0.0, max_iter=3)
    Ad, P = torch.from_numpy(A64.toarray()), h.P.todense()
    want = torch.zeros(n, dtype=torch.float64)
    for _ in range(3):
        want = ref.twolevel_cycle(Ad, P, ref.galerkin(Ad, P), colors, b, want)
    assert iters == 3 and gap(x, want) < 1e-9


def test_trained_checkpoint_against_the_reference_on_one_grid():
    """The float32 program with the trained weights: the teacher-forced
    float64 reference within 1e-5 (its CPU reading is ~8e-7), Bellman-Ford
    and P^T A P as the reference's.  The trained AggNet's last scores are 0
    on every node (its last ReLU), so a tie decides the centers: the
    stable top-k takes the first k nodes."""
    grids = [GRIDS[SMALL[1]]]
    net, config = load_model(CKPT, GRIDS, device="cpu")
    row, col, a, A64 = entries(grids[0], torch.float64)
    n = A64.shape[0]
    k = math.ceil(0.1 * n)
    h, seen = build_with_norms(net, CSR.from_scipy(A64, device="cpu"), k)
    p = h.parts
    assert float(p.scores[-1].abs().max()) == 0.0
    assert torch.equal(p.centers, torch.arange(k))
    w = {key: v.detach().double() for key, v in net.state_dict().items()}
    r = ref.fullaggnet(w, row, col, a, n, k, iterations=config["iterations"],
                       rel_strength=config["rel_strength"],
                       forced={"norms": seen, "mask0": p.masks[0], "centers": p.centers,
                               "agg_id": p.agg_id})
    worst = max(gap(m, t) for m, t in [*zip(p.scores, r["scores"]), (live(h, p.C.data), r["C"]),
                                       (live(h, p.p_hat), r["p_hat"])])
    assert worst < 1e-5
    _, near, _ = ref.bellman_ford(ref.graph_of(row, col, a, n), live(h, p.C.data), p.centers)
    assert torch.equal(ref.agg_of(p.centers, near, n), p.agg_id)
    P = ref.prolongator(ref.graph_of(row, col, a, n), live(h, p.p_hat).double(), p.agg_id, k)
    assert gap(h.A_H, ref.galerkin(torch.from_numpy(A64.toarray()), P)) < 1e-6


def test_evaluate_dataset_ml_convs_are_the_direct_forwards():
    """``evaluate``'s ``ml`` run, through the build, gives the conv factors
    of the network's forward and ``bundle_conv`` bit for bit."""
    grids = [GRIDS[i] for i in SMALL]
    net, _ = load_model(CKPT, GRIDS, device="cpu")
    got, _ = evaluate(grids, net, device="cpu", log=lambda *_: None)
    opts = SolveOptions(smoother="multicolor_gs")
    want = []
    for g in grids:
        b = GridBundle.from_grid(g, 0.1, device="cpu")
        with torch.no_grad():
            want.append(bundle_conv(b, net(b.A, b.k)[1], opts))
    assert np.array_equal(got["ml"], np.asarray(want))


def test_build_spans_and_host_read_counts(random_net):
    """The fenced root ``build`` span holds the stages in order; the solve's
    ``cycle`` spans hold one ``level`` of five stages; ``SYNCS`` counts a
    stopping test a cycle and a sweep a Bellman-Ford sweep."""
    g = GRIDS[SMALL[0]]
    row, col, a, A64 = entries(g, torch.float64)
    n = A64.shape[0]
    k = math.ceil(0.1 * n)
    A = CSR.from_scipy(A64, dtype=torch.float64, device="cpu")
    before = dict(SYNCS)
    Profiler.reset()
    with Profiler.recording():
        h = build_learned_twolevel(random_net, A, k)
        spans = list(Profiler.spans())
        Profiler.reset()
        b = torch.from_numpy(np.random.RandomState(1).randn(n))
        _, _, _, iters = learned_solve(h, b, res_tol=1e-8 * float(b.norm()), max_iter=40)
        solve = list(Profiler.spans())
    Profiler.reset()
    root = spans[0]
    assert root.name == "build" and root.parent is None and root._fence
    children = [s for s in spans if s.parent is root]
    assert [s.name for s in children] == [
        "coloring", "graph", "aggnet", "aggnet", "topk", "cnet", "bellman_ford", "pnet", "remap",
        "galerkin", "coarse_factor"]
    assert all(s._fence and s.end_ns >= s.start_ns for s in children)
    assert [s.attrs.get("layer") for s in children if s.name == "aggnet"] == [0, 1]
    assert all(s.parent in children for s in spans[1:] if s.parent is not root)
    cycles = [s for s in solve if s.name == "cycle"]
    assert len(cycles) == iters == len([s for s in solve if s.name == "residual_norm"])
    for c in cycles:
        (level,) = [s for s in solve if s.parent is c]
        assert level.name == "level" and level.attrs == {"level": 0}
        assert [s.name for s in solve if s.parent is level] == [
            "pre_smooth", "restrict", "coarse_solve", "interp", "post_smooth"]
    counted = {key: v - before.get(key, 0) for key, v in SYNCS.items()}
    _, _, sweeps = ref.bellman_ford(ref.graph_of(row, col, a, n), live(h, h.parts.C.data),
                                    h.parts.centers, torch.float64)
    assert counted["bellman_ford.sweep"] == sweeps and counted["bellman_ford.width"] == 1
    assert counted["twolevel.residual"] == iters and counted["conv_factor"] == 3 and iters >= 6
    # five slot tables: the two graphs', A's rows, P's rows in the build, P's columns in the solve
    assert counted["coloring"] == 2 and counted["segment_slots"] == 5
    assert set(counted) - {k for k, v in counted.items() if v == 0} == {
        "coloring", "segment_slots", "bellman_ford.width", "bellman_ford.sweep",
        "twolevel.residual", "conv_factor"}
    colors, num = pattern_coloring(A)
    assert torch.equal(colors, h.colors) and num == h.num_colors


@pytest.fixture
def two_grid_cell(tmp_path):
    """The cell's configuration on a dataset of two grids (n 80 and 85)."""
    from harness import core

    data = tmp_path / "test"
    data.mkdir()
    names = sorted(f for f in os.listdir(TEST_DIR) if f.endswith(".grid"))
    for i in SMALL:
        shutil.copy(os.path.join(TEST_DIR, names[i]), data / names[i])
    spec = core.load_cell("iso2d_learned.grid")
    spec["config"] = dict(spec["config"], dataset=dict(spec["config"]["dataset"], dir=str(data)))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield spec
    torch.set_num_threads(threads)


def test_driver_runs_the_cell_on_two_grids(two_grid_cell):
    """The driver's contract under the ``grid`` mix on the CPU: every
    request one of the two items, every number of the check within its
    limit, the span and counter metrics read, and pass A of
    ``harness/spans.py`` finds a root ``build`` span on each build."""
    from harness import core, spans

    # a 2-s window: a request takes ~80 ms alone but over 0.5 s on a CPU
    # that six test workers share, and the window must hold two
    result, lines = core.run("iso2d_learned.grid", 2**31 + 77, 2.0, True, time.perf_counter(),
                             device="cpu", loaded=two_grid_cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["check"]) == {"residual", "unconverged", "centers", "aggregation", "gnn",
                                    "coarse_op"}
    assert result["check"]["gnn"]["value"] < 1e-5
    assert {"gnn_ms.build", "bellman_ford_ms.build", "host_syncs.request"} <= set(result["metrics"])
    System = core.load_module(core.BENCH / "systems" / "learned_twolevel.py", "s").System
    system = System(two_grid_cell["config"], torch.device("cpu"), "")
    assert system.items == 2 and sorted(system.n_of(i) for i in range(2)) == [80, 85]
    run = core.Run(system, torch.device("cpu"), "cpu")
    read = spans.read(run)
    assert len(read["builds"]) == 3 and read["galerkin_ms.request"] > 0
    assert all(0 < b["covered"] <= 1 for b in read["builds"])
    # the control: the reference in bfloat16 in the program's place fails the check
    state = system.coarse_state(system.build(system.operator(1.0, 1)))
    low = system.check_coarse(system.control_state(state, 1.0), 1.0)
    assert low["gnn"] > two_grid_cell["config"]["limits"]["gnn"]
    assert low["coarse_op"] > two_grid_cell["config"]["limits"]["coarse_op"]
