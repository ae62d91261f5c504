"""A configuration that holds a dataset of operators, one item a request
(``traffic/grid.json``), driven whole at tiny sizes on the CPU; and the
cells without items, whose draws and calls are pinned to the values the
harness drew before items existed.

The item system here holds three one-dimensional operators of different
sizes.  Its build is a two-level hierarchy (pairwise aggregates, the
Galerkin product in float32), its solve a direct float32 solve, and its
check holds each answer and each coarse operator against the float64
product of the item's own operator."""

import hashlib
import json
import time
import types

import numpy as np
import pytest
import torch

import control
from harness import core, spans

SIZES = (40, 57, 73)


def operator64(n: int, scale: float) -> np.ndarray:
    """A shifted 1-D Laplacian (4.1 on the diagonal, -1 beside it) times
    ``scale``: well conditioned, so a float32 solve reads ~1e-7, and its
    coarse entries (6.2, -1) are not all exact in bfloat16."""
    return scale * (4.1 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1))


def aggregates(n: int) -> np.ndarray:
    P = np.zeros((n, (n + 1) // 2))
    P[np.arange(n), np.arange(n) // 2] = 1.0
    return P


class ItemSystem:
    """Three operators of different sizes; records what the harness asks
    of it."""

    items = len(SIZES)
    spans = True  # the build opens a root ``build`` span with ``galerkin`` in it

    def __init__(self, config, device, cache_dir):
        self.device = device
        self.max_cycles = config["request"]["max_cycles"]
        self.log = []

    def n_of(self, item: int) -> int:
        return SIZES[item]

    def operator(self, scale, item):
        self.log.append(("operator", item))
        A = torch.tensor(operator64(SIZES[item], scale), dtype=torch.float32)
        return item, A.to(self.device)

    def rhs(self, x_true, scale, item):
        self.log.append(("rhs", item, x_true.shape[0]))
        return scale * (torch.tensor(operator64(SIZES[item], 1.0), dtype=torch.float32)
                        @ x_true)

    def build(self, A):
        from mlamg_torch.utils.profiler import Profiler

        item, A = A
        self.log.append(("build", item))
        P = torch.tensor(aggregates(A.shape[0]), dtype=torch.float32)
        if not self.spans:
            return item, A, P.T @ A @ P
        with Profiler("build"):
            with Profiler("galerkin"):
                return item, A, P.T @ A @ P

    def solve(self, h, b, tol):
        item, A, _ = h
        self.log.append(("solve", item, b.shape[0]))
        return torch.linalg.solve(A, b), 1, True

    def coarse_state(self, h):
        item, _, A1 = h
        return item, A1

    def check_coarse(self, state, scale):
        item, A1 = state
        self.log.append(("check_coarse", item))
        P = aggregates(SIZES[item])
        want = P.T @ operator64(SIZES[item], scale) @ P
        if tuple(A1.shape) != want.shape:
            return {"coarse_op": float("inf")}
        return {"coarse_op": float(np.abs(A1.double().numpy() - want).max() / np.abs(want).max())}

    def control_state(self, state, scale):
        item, _ = state
        P = aggregates(SIZES[item])
        want = torch.tensor(P.T @ operator64(SIZES[item], scale) @ P)
        return item, want.to(torch.bfloat16).double()

    def residual(self, x, b, scale, item):
        self.log.append(("residual", item, x.shape[0]))
        if x.shape[0] != SIZES[item]:
            return float("inf")
        A = operator64(SIZES[item], scale)
        b64 = b.double().numpy()
        return float(np.linalg.norm(b64 - A @ x.double().numpy()) / np.linalg.norm(b64))


def mix(name: str) -> dict:
    return json.loads((core.BENCH / "traffic" / f"{name}.json").read_text())


def grid_spec() -> dict:
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    return {
        "cell": {"name": "tiny.grid", "config": "tiny_items", "traffic": "grid", "chips": 1},
        "config": {"name": "tiny_items", "system": "tiny_items",
                   "request": {"tol": 1e-6, "max_cycles": 40},
                   "limits": {"residual": 1e-5, "unconverged": 0, "coarse_op": 1e-5}},
        "traffic": mix("grid"),
        "end_to_end": [metrics[k] for k in ("solve_ms", "solve_p90_ms", "setup_s")],
        "per_layer": [metrics[k] for k in ("cycle_ms", "cycles_per_solve",
                                           "hierarchy_ms.request", "galerkin_ms.request")],
    }


@pytest.fixture
def systems(monkeypatch):
    """Serves the harness the test's system class in place of the
    configuration's file; returns the instances it made."""
    made, load = [], core.load_module

    def loader(path, name):
        if name != "bench_system":
            return load(path, name)

        def make(*a):
            made.append(loaders["System"](*a))
            return made[-1]
        return types.SimpleNamespace(System=make)

    loaders = {"System": ItemSystem}
    monkeypatch.setattr(core, "load_module", loader)
    return made, loaders


def run_grid(seconds=0.3, trace=False, seed=2**31 + 17):
    return core.run("tiny.grid", seed, seconds, trace, time.perf_counter(), device="cpu",
                    loaded=grid_spec())


def window_items(system) -> list:
    """The items of the window's requests: the rhs calls after the warm-up."""
    rhs = [e for e in system.log if e[0] == "rhs"]
    return [e[1] for e in rhs[grid_spec()["traffic"]["warmup_requests"]:]]


def test_grid_mix_runs_correct_with_one_sized_item_a_request(systems):
    result, lines = run_grid()
    (system,) = systems[0]
    assert result["correct"] and result["attempted"] >= 3 and result["failed"] == 0
    assert set(result["metrics"]) == {"solve_ms", "solve_p90_ms", "setup_s"}
    assert {"residual", "unconverged", "coarse_op"} == set(result["check"])
    # every request's x_true has its item's size, and its b is solved on its build
    rhs = [e for e in system.log if e[0] == "rhs"]
    assert rhs and all(n == SIZES[item] for _, item, n in rhs)
    solves = [e for e in system.log if e[0] == "solve"]
    assert [(item, n) for _, item, n in solves] == [(item, n) for _, item, n in rhs]
    # the check read each kept answer and coarse operator against its own item
    residuals = [e for e in system.log if e[0] == "residual"]
    assert residuals and all(n == SIZES[item] for _, item, n in residuals)
    assert len([e for e in system.log if e[0] == "check_coarse"]) == len(residuals)


def test_window_holds_a_permutation_of_the_items_each_pass(systems):
    run_grid(seconds=0.4)
    items = window_items(systems[0][0])
    k = len(SIZES)
    assert len(items) >= 2 * k
    passes = [items[i:i + k] for i in range(0, len(items) - k + 1, k)]
    assert all(sorted(p) == list(range(k)) for p in passes)
    counts = np.bincount(items, minlength=k)
    assert counts.max() - counts.min() <= 1


def test_a_seed_always_draws_the_same_order_and_the_scales_of_a_plain_client():
    system = ItemSystem({"request": {"max_cycles": 40}}, torch.device("cpu"), "")
    traffic = mix("grid")
    plain = types.SimpleNamespace(n=8)
    setup = mix("setup")
    orders = set()
    for seed in (3, 2**31 + 5, 3160100001):
        draws = [core.Client(traffic, seed, system, torch.device("cpu")).draw(core.WINDOW, i)
                 for i in range(30)]
        again = [core.Client(traffic, seed, system, torch.device("cpu")).draw(core.WINDOW, i)
                 for i in range(30)]
        items = [d[2] for d in draws]
        assert items == [d[2] for d in again]
        assert all(torch.equal(a[1], b[1]) for a, b in zip(draws, again))
        assert all(x.shape[0] == SIZES[item] for _, x, item in draws)
        for p in range(10):
            assert sorted(items[3 * p:3 * p + 3]) == [0, 1, 2]
        orders.add(tuple(items))
        # the scale draw does not change because items exist
        with_items = dict(setup, items="seeded_order")
        a = core.Client(with_items, seed, system, torch.device("cpu"))
        b = core.Client(setup, seed, plain, torch.device("cpu"))
        for stream in (core.WINDOW, core.WARMUP, core.TRACED):
            assert [a.draw(stream, i)[0] for i in range(5)] == [
                b.draw(stream, i)[0] for i in range(5)]
    assert len(orders) == 3
    # each pass draws its own order: over 30 passes not all are the same
    many = [core.Client(traffic, 7, system, torch.device("cpu")).draw(core.WINDOW, i)[2]
            for i in range(90)]
    assert len({tuple(many[i:i + 3]) for i in range(0, 90, 3)}) > 1


def test_a_mix_and_a_system_disagreeing_on_items_are_refused():
    system = ItemSystem({"request": {"max_cycles": 40}}, torch.device("cpu"), "")
    plain = types.SimpleNamespace(n=8)
    for traffic, s in ((mix("grid"), plain), (mix("setup"), system), (mix("rhs"), system),
                       (dict(mix("rhs"), items="seeded_order"), system),
                       (dict(mix("grid"), items="sorted"), system)):
        with pytest.raises(ValueError):
            core.Client(traffic, 1, s, torch.device("cpu"))


@pytest.mark.parametrize("bad", range(len(SIZES)))
def test_an_answer_altered_on_one_item_reads_incorrect(systems, monkeypatch, bad):
    monkeypatch.setattr(core, "CHECK_SAMPLE", 10**6)  # every answer kept

    class Altered(ItemSystem):
        def solve(self, h, b, tol):
            x, cycles, converged = super().solve(h, b, tol)
            if h[0] == bad:
                x = x.clone()
                x[SIZES[bad] // 2] += 1e-2
            return x, cycles, converged

    systems[1]["System"] = Altered
    result, _ = run_grid(seconds=0.2)
    assert result["failed"] == 0 and not result["correct"]
    assert result["check"]["residual"]["value"] > result["check"]["residual"]["limit"]
    assert result["check"]["coarse_op"]["value"] <= result["check"]["coarse_op"]["limit"]


@pytest.mark.parametrize("bad", range(len(SIZES)))
def test_a_coarse_operator_altered_on_one_item_reads_incorrect(systems, monkeypatch, bad):
    monkeypatch.setattr(core, "CHECK_SAMPLE", 10**6)

    class Altered(ItemSystem):
        def build(self, A):
            item, A0, A1 = super().build(A)
            if item == bad:
                A1 = A1.clone()
                A1[1, 1] *= 1.001
            return item, A0, A1

    systems[1]["System"] = Altered
    result, _ = run_grid(seconds=0.2)
    assert result["failed"] == 0 and not result["correct"]
    assert result["check"]["coarse_op"]["value"] > result["check"]["coarse_op"]["limit"]
    assert result["check"]["residual"]["value"] <= result["check"]["residual"]["limit"]


@pytest.mark.parametrize("with_spans", [True, False])
def test_traced_run_passes_a_and_b_on_an_item_system(systems, with_spans):
    systems[1]["System"] = type("S", (ItemSystem,), {"spans": with_spans})
    result, _ = run_grid(seconds=0.2, trace=True)
    (system,) = systems[0]
    assert result["correct"]
    assert {"cycle_ms", "cycles_per_solve", "hierarchy_ms.request"} <= set(result["metrics"])
    # pass A builds the first three items of the fixed-seed order; without a
    # root build span it reads nothing
    order = [int(i) for i in core.item_order(spans.SEED, core.TRACED, 0, len(SIZES))]
    builds = [e[1] for e in system.log if e[0] == "build"]
    assert builds[-3:] == order
    assert ("galerkin_ms.request" in result["metrics"]) == with_spans
    # pass B (on the card in a run; here called on the CPU): three solves,
    # each b sized to pass A's last item, on its build
    from mlamg_torch.utils import profiler

    run = types.SimpleNamespace(system=system, device=torch.device("cpu"))
    _, h, item = spans._pass_a(run, profiler.Profiler, 3)
    assert item == order[-1] and h[0] == item
    del system.log[:]
    assert spans._pass_b(run, profiler.Profiler, profiler.LAUNCHES, h, item) == {}
    assert [e for e in system.log if e[0] == "solve"] == [("solve", item, SIZES[item])] * 3


def test_control_fails_on_the_drawn_items_where_the_program_passes(systems):
    spec = grid_spec()
    limits = spec["config"]["limits"]
    out = control.readings("tiny.grid", [3, 2**31 + 3, 11, 12], device="cpu", loaded=spec)
    assert len({r["item"] for r in out}) > 1
    for r in out:
        assert r["program"]["residual"] <= limits["residual"] < r["control"]["residual"]
        assert r["program"]["coarse_op"] <= limits["coarse_op"] < r["control"]["coarse_op"]


# --- the cells without items: the draws and calls of the harness before
# items existed, printed by its Client on this CPU (seed, stream, index,
# setup's scale, sha256 of x_true's bytes at n 64, its first two entries)
PINNED = [
    (3, 0, 0, 1.354316234588623, "271693130b4c9b13", 0.18695169687271118, -0.9267095923423767),
    (3, 0, 7, 0.7680964469909668, "20cfda5e1abe57f1", 0.2404656857252121, -1.8127816915512085),
    (3, 1, 1, 1.1604586839675903, "b14c6e0346a08710", 0.3906506597995758, -0.3246545195579529),
    (3, 2, 2, 0.6849687695503235, "b6b599c015454154", -1.7643426656723022, -0.7940972447395325),
    (2**31 + 11, 0, 0, 1.9359159469604492, "dce2d51c6436acb1", 1.1231435537338257,
     -0.2717812657356262),
    (2**31 + 11, 0, 7, 1.005120873451233, "ee1425186c9be5d7", -1.9578118324279785,
     1.0382393598556519),
    (2**31 + 11, 1, 1, 1.1562070846557617, "f6bf381de534006f", 1.5157924890518188,
     -1.2558574676513672),
    (2**31 + 11, 2, 2, 0.5591486692428589, "75842b397380077a", 1.7865618467330933,
     0.9961245059967041),
    (3160100001, 0, 0, 0.7734846472740173, "6aa46a71d62b6dbd", 0.5940892100334167,
     0.0722169578075409),
    (3160100001, 0, 7, 1.3623113632202148, "bb6a32fa2a467059", -0.4256154000759125,
     -1.810397744178772),
    (3160100001, 1, 1, 0.9507418870925903, "428713b5817472f1", 1.547255277633667,
     0.6660123467445374),
    (3160100001, 2, 2, 1.8664047718048096, "b4382cb856ba18da", -0.5208472609519958,
     0.46972420811653137),
]


def sha(x: torch.Tensor) -> str:
    return hashlib.sha256(x.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name", ["rhs", "setup"])
def test_cells_without_items_draw_what_they_drew_before(name):
    traffic = mix(name)
    plain = types.SimpleNamespace(n=64)
    for seed, stream, index, scale, digest, x0, x1 in PINNED:
        got_scale, x, item = core.Client(traffic, seed, plain, torch.device("cpu")).draw(
            stream, index)
        assert item is None and got_scale == (1.0 if name == "rhs" else scale)
        assert sha(x) == digest and (float(x[0]), float(x[1])) == (x0, x1)


# the tiny Poisson cell's first four requests (warm-up 0, 1, window 0, 1)
# at seed 2**31 + 11, n 128^2: setup's scale and x_true's sha256
FIRST_FOUR = [(0.6776703000068665, "967224642d9baefa"), (1.1562070846557617, "273e02ecbdb608be"),
              (1.9359159469604492, "7c2531c05e43c12d"), (1.4375988245010376, "9e66b8ac155fe889")]
ARITY = {"operator": 1, "rhs": 2, "build": 1, "solve": 3, "coarse_state": 1,
         "check_coarse": 2, "residual": 3, "start": 0}


@pytest.mark.parametrize("cell", ["poisson4096.rhs", "poisson4096.setup"])
def test_cells_without_items_make_the_same_calls(tiny, monkeypatch, cell):
    """The real tiny Poisson system, each call recorded: the arguments of
    every call are those of the harness before items, and the first four
    requests' draws are the pinned ones."""
    calls, load = [], core.load_module

    def loader(path, name):
        module = load(path, name)
        if name != "bench_system":
            return module

        class Recorded(module.System):
            pass

        def recorder(method):
            def call(self, *a, **kw):
                calls.append((method, a, kw))
                return getattr(module.System, method)(self, *a, **kw)
            return call

        for method in ARITY:
            setattr(Recorded, method, recorder(method))
        return types.SimpleNamespace(System=Recorded)

    monkeypatch.setattr(core, "load_module", loader)
    result, _ = core.run(cell, 2**31 + 11, 0.2, False, time.perf_counter(), device="cpu",
                         loaded=tiny(cell))
    assert result["correct"]
    assert all(len(a) == ARITY[m] and not kw for m, a, kw in calls), [
        (m, len(a), sorted(kw)) for m, a, kw in calls if len(a) != ARITY[m] or kw]
    rhs = [a for m, a, _ in calls if m == "rhs"][:4]
    setup = cell.endswith(".setup")
    assert [(s, sha(x)) for x, s in rhs] == [(s if setup else 1.0, d) for s, d in FIRST_FOUR]
    operators = [a[0] for m, a, _ in calls if m == "operator"]
    assert operators[:4] == ([s for s, _ in FIRST_FOUR] if setup else [1.0])
