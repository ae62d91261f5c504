"""One run of one cell: set-up, warm-up, the measured window, the traced
requests of a ``--trace 1`` run, the check against the plain reference,
and the result line.

Everything particular to a configuration, a traffic mix or a metric is
found by name: ``BENCHMARK.json`` names the cell's configuration and
traffic; the configuration's file names its ``system`` (a module that drives the
measured package in ``systems/``); the mix is ``traffic/<name>.json``;
each metric is read by ``metrics/<name>.py``'s ``read(run)``, which
returns None where it finds nothing to read.

A request is one linear system A x = b solved from x0 = 0 to the
configuration's relative residual, with b = A x_true and x_true standard
normal float32, drawn on the device from the run's seed and the request's
index.  The client is one, in a closed loop: it makes its next system
(and, where the mix changes the operator, its operator) before the
request's clock starts, and sends it when the last answer is back.

A system drives the measured package through ``operator(scale)``,
``rhs(x_true, scale)``, ``build(A)``, ``solve(h, b, tol)``,
``coarse_state(h)``, ``check_coarse(state, scale)`` and ``residual(x, b,
scale)``, with ``n`` the operator's rows.  A system may instead hold a
dataset of operators: it declares ``items`` (their count) and
``n_of(item)`` (their rows) in place of ``n``, and is called as
``operator(scale, item)``, ``rhs(x_true, scale, item)`` and ``residual(x,
b, scale, item)``; its ``coarse_state(h)`` carries the item.  Such a
system runs under a mix with ``"items": "seeded_order"``: each request
solves one item, in an order that is a permutation of the items drawn
from the seed's own stream, anew for each pass over the dataset, so a
window holds every item equally often to within one.  The item changes
neither the request's scale nor its x_true's draw, only x_true's length.
A system without ``items`` is called as above, with no item.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from harness import timing, trace as tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CACHE = BENCH / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "mlamg_tpu")
CHECK_SAMPLE = 12  # answers kept for the check, a uniform sample drawn from the seed
WINDOW, WARMUP, TRACED, SAMPLE, ITEMS = 0, 1, 2, 3, 4  # seed streams


@dataclasses.dataclass
class Run:
    """What a metric reader sees."""

    system: object
    device: torch.device
    device_name: str
    setup_s: float = math.nan
    hierarchy_s: float | None = None
    requests: list = dataclasses.field(default_factory=list)
    window_s: float = math.nan
    hierarchy: object = None
    setup_parts: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None

    def hbm_bytes_per_s(self) -> float:
        return timing.hbm_bytes_per_s(self.device_name)

    def cold_ms(self, fn) -> float:
        return timing.cold_ms(fn)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str) -> dict:
    """The cell's entry, configuration, traffic mix and metrics from
    ``BENCHMARK.json`` and the files it names."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())

    def listed(metric, e2e_names):
        if "workloads" in metric:
            return name in metric["workloads"]
        return metric.get("moves", metric["name"]) in e2e_names

    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if listed(m, names)]
    return {"cell": cell, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer}


def _seed(seed: int, *keys: int) -> int:
    return int(np.random.SeedSequence([seed % 2**64, *keys]).generate_state(1, np.uint64)[0] >> 1)


def item_order(seed: int, stream: int, rounds: int, items: int) -> np.ndarray:
    """The items in the order of pass ``rounds`` over the dataset on one
    request stream: a permutation drawn from the seed's item stream."""
    return np.random.default_rng(_seed(seed, ITEMS, stream, rounds)).permutation(items)


def item_args(item) -> tuple:
    """The trailing arguments of a system's calls: the item, or none."""
    return () if item is None else (item,)


def rows(system, item) -> int:
    return system.n if item is None else system.n_of(item)


class Client:
    """The closed-loop client: the request's operator scale, x_true and,
    where the mix draws items, the dataset item."""

    def __init__(self, traffic: dict, seed: int, system, device):
        lo, hi = traffic["scale"]
        self.lo, self.hi = math.log2(lo), math.log2(hi)
        self.seed, self.system, self.device = seed, system, device
        drawn = traffic.get("items")
        if drawn not in (None, "seeded_order"):
            raise ValueError(f"unknown item order {drawn!r}")
        self.items = getattr(system, "items", None)
        if (drawn is None) != (self.items is None):
            raise ValueError("a mix draws items exactly where the system holds a dataset")
        if drawn and traffic["operator"] == "fixed":
            raise ValueError("a mix that draws items builds each request's operator")

    def draw(self, stream: int, index: int):
        """(scale, x_true, item) of request ``index`` on ``stream``; the
        item is None where the mix draws none."""
        s = _seed(self.seed, stream, index)
        u = np.random.default_rng(s).random()
        scale = float(np.float32(2.0 ** (self.lo + (self.hi - self.lo) * u)))
        item = None
        if self.items is not None:
            rounds, k = divmod(index, self.items)
            item = int(item_order(self.seed, stream, rounds, self.items)[k])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(s)
        x_true = torch.randn(rows(self.system, item), generator=gen, device=self.device,
                             dtype=torch.float32)
        return scale, x_true, item


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cache_files() -> set:
    """The files of the benchmark's cache and the package's build
    directory: what a checkout's first run writes (the hull's mesh, the
    compiled kernels)."""
    found = set()
    for top in (CACHE, ROOT / "mlamg_torch" / "_build"):
        found.update(str(p.relative_to(ROOT)) for p in top.rglob("*") if p.is_file())
    return found


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", loaded: dict | None = None) -> tuple:
    """One run; returns (result line as a dict, the check's lines).
    ``loaded`` replaces :func:`load_cell` (the tests' tiny cells)."""
    spec = loaded or load_cell(cell_name)
    config, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    parts, cached = {"start_s": time.perf_counter() - t_start}, _cache_files()
    tick = time.perf_counter()

    def part(key: str) -> None:
        nonlocal tick
        _sync(dev)
        now = time.perf_counter()
        parts[key] = now - tick
        tick = now

    torch.zeros(1, device=dev)
    part("card_s")
    System = load_module(BENCH / "systems" / f"{config['system']}.py", "bench_system").System
    system = System(config, dev, str(CACHE))
    part("system_s")
    # what the first build would start inside its clock (libraries, the
    # package's kernels) starts here, so the build's time is the build's
    if hasattr(system, "start"):
        system.start()
    part("libraries_s")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    r = Run(system, dev, name, setup_parts=parts)
    req = config["request"]
    fixed = traffic["operator"] == "fixed"
    client = Client(traffic, seed, system, dev)

    def request(stream: int, index: int, h_fixed):
        scale, x_true, item = client.draw(stream, index)
        b = system.rhs(x_true, scale, *item_args(item))
        A = None if fixed else system.operator(scale, *item_args(item))
        tol = req["tol"] * float(torch.linalg.vector_norm(b))
        _sync(dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.request"):
            if fixed:
                h, t_built = h_fixed, t0
            else:
                with torch.profiler.record_function("bench.build"):
                    h = system.build(A)
                    _sync(dev)
                t_built = time.perf_counter()
            with torch.profiler.record_function("bench.solve"):
                x, cycles, converged = system.solve(h, b, tol)
                _sync(dev)
        t1 = time.perf_counter()
        rec = {"ms": (t1 - t0) * 1e3, "solve_ms": (t1 - t_built) * 1e3,
               "build_ms": None if fixed else (t_built - t0) * 1e3,
               "cycles": int(cycles), "converged": bool(converged), "item": item}
        return rec, h, (x, b, scale, item)

    h = None
    if fixed:
        A = system.operator(1.0)
        part("operator_s")
        h = system.build(A)
        part("hierarchy_s")
        r.hierarchy_s = parts["hierarchy_s"]
    for i in range(traffic["warmup_requests"]):
        rec, h_last, _ = request(WARMUP, i, h)
    r.hierarchy = h_last
    part("warmup_s")
    written = sorted(_cache_files() - cached)

    rng = np.random.default_rng(_seed(seed, SAMPLE, 0))
    sample, worst = [], None
    t_win = time.perf_counter()
    r.setup_s = t_win - t_start
    i = 0
    while time.perf_counter() - t_win < seconds:
        rec, h_i, answer = request(WINDOW, i, h)
        keep = (rec["cycles"], answer, None if fixed else system.coarse_state(h_i))
        r.requests.append(rec)
        if len(sample) < CHECK_SAMPLE:
            sample.append(keep)
        else:
            j = int(rng.integers(0, i + 1))
            if j < CHECK_SAMPLE:
                sample[j] = keep
        if worst is None or rec["cycles"] > worst[0]:
            worst = keep
        r.hierarchy = h_i
        i += 1
    r.window_s = time.perf_counter() - t_win
    del h_i, answer, keep

    if trace:
        def traced_requests():
            return [request(TRACED, j, h)[0] for j in range(traffic["trace_requests"])]
        r.trace = tracing.traced(traced_requests)
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py", "bench_metric")
        value = reader.read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name,
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else 0}
    if trace:
        dev_info.update(busy_s=r.trace["busy_s"], window_s=r.trace["window_s"])

    # the check: the program's state freed first, the reference after it
    coarse_fixed = system.coarse_state(h) if fixed else None
    r.hierarchy = h = h_last = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    keeps = sample + ([] if any(k is worst for k in sample) else [worst])
    numbers = check(system, keeps, coarse_fixed, r.requests)
    limits = config["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = bool(r.requests) and all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": len(r.requests),
              "failed": sum(not q["converged"] for q in r.requests),
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = r.trace["breakdown"]
    # set-up by its parts, and the cache files this run wrote (a first run
    # meshes and compiles, so its set-up is no other run's)
    result["setup"] = {"parts_s": parts, "written": len(written), "first_written": written[:8]}
    result["check"] = compared
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in compared.items()]
    return result, lines


def check(system, keeps: list, coarse_fixed, requests: list) -> dict:
    """The numbers compared: the worst float64 relative residual of the
    kept answers (each against its own item's operator), the requests that
    hit the cycle cap, and the worst of the first coarse operators' checks
    (the set-up's, or each kept request's, whose state carries its item).
    A number that is not finite reads as infinite."""
    out = {"residual": _worst(system.residual(x, b, scale, *item_args(item))
                              for _, (x, b, scale, item), _ in keeps),
           "unconverged": float(sum(not q["converged"] for q in requests))}
    states = [(coarse_fixed, 1.0)] if coarse_fixed is not None else [
        (state, scale) for _, (_, _, scale, _), state in keeps]
    readings = [system.check_coarse(state, scale) for state, scale in states]
    for k in readings[0]:
        out[k] = _worst(r[k] for r in readings)
    return out


def _worst(values) -> float:
    return max(v if math.isfinite(v) else math.inf for v in values)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="One run of one benchmark cell on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = load_cell(a.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, lines = run(a.workload, a.seed, a.seconds, bool(a.trace), t_start, loaded=spec)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0
