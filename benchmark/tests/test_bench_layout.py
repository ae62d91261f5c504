"""BENCHMARK.json against its required shape (keys, names, units, bounds), and every
configuration, traffic mix and metric found by name from it."""

import json
import pathlib
import re

from harness import core

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.fullmatch(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_finds_its_files_and_reports_enough():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        spec = core.load_cell(w["name"])
        assert spec["config"]["name"] == w["config"]
        assert (core.BENCH / "systems" / f"{spec['config']['system']}.py").is_file()
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            reader = core.load_module(core.BENCH / "metrics" / f"{m['name']}.py", "m")
            assert callable(reader.read)
        for m in spec["per_layer"]:
            assert m["moves"] in e2e


def test_config_files_state_their_limits():
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["assumed"]
        assert {"residual", "unconverged", "coarse_op"} <= set(config["limits"])
