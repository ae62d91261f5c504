"""The benchmark's command as a checker runs it: no result and a non-zero
exit without the card, and a whole short run on the card."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def command(*args, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_without_a_card_no_result_and_a_nonzero_exit():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = command("--workload", "poisson4096.rhs", "--seed", str(2**31 + 7), "--seconds", "1",
                  "--trace", "0", timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_an_unknown_workload_is_refused():
    out = command("--workload", "no.such", "--seed", "1", "--seconds", "1", timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = command("--workload", "poisson4096.rhs", "--seed", str(2**31 + 9), "--seconds", "2",
                  "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"solve_ms", "solve_p90_ms", "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
