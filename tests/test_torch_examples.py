"""The seven ``examples_torch/`` scripts against the JAX package's
``examples/`` scripts, on the CPU.

Each JAX script runs unchanged, in process (``runpy.run_path(...,
run_name="__main__")``), under the tests' ``jax_enable_x64``; the port's
``main([..., "--device", "cpu", "--dtype", "float64"])`` runs beside it.
The printed lines must be equal, string for string.  Where a script prints
more than is held, both runs are stopped once the held lines are in: a
``print`` patched into each script's namespace raises after them.

How many lines are held, and why (``CASES``):

- ``ga_smoke``, ``diff_topk_training``: every line.
- ``learn_p_r``, ``poisson1d_differentiable``: under x64 the JAX script
  raises ``TypeError`` at its two-level solves (its ``jnp.zeros(n)`` is
  float64, x0 float32, and the solve's loop refuses the carry's change of
  type), after its training lines, so those are held: all five of
  ``learn_p_r``'s; ``poisson1d_differentiable``'s first two.  From step
  100 on its loss is set by rounding: the float32 loss (test vectors, A
  and P are float32) drives 200 Adam steps on a stochastic loss, and JAX's
  own runs with and without x64 print 0.5428 and 0.5403 at step 100.
  ``test_example_float32_solves`` holds ``learn_p_r``'s solve lines,
  which the JAX script reaches without x64.
- ``matconv_ga``: the first three generations.  The 9x9 grid is
  symmetric, so node scores tie in exact arithmetic, and which tied node
  the top-k takes is set by float32 rounding: JAX's ``jit(vmap)`` fitness,
  the same fitness run op by op and the port pick different centers for
  4 of the 16 first individuals (conv 0.7342 / 0.7330 / 0.7405 for the
  first).
- ``reinforce_centers``: the first line.  At step 0 the baseline is the
  batch's mean reward, so every logit outside the picked centers gets a
  gradient of rounding size (the float32 convs of JAX's jitted solve and
  of the port differ by 1.2e-7), and Adam's first step divides by the
  gradient's size: those logits move by up to the learning rate either
  way, and the later centers follow.
- ``edge_removal_aggregation``: the first two of ten generations (the
  JAX script compiles each new aggregation's solve, ~3.7 s a generation;
  all ten agree, 45 s in all).
"""

import importlib.util
import runpy
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

# name -> (lines held, what the JAX script raises after printing them, or None)
CASES = {
    "ga_smoke": (None, None),
    "poisson1d_differentiable": (2, TypeError),
    "learn_p_r": (5, TypeError),
    "diff_topk_training": (None, None),
    "matconv_ga": (3, None),
    "edge_removal_aggregation": (2, None),
    "reinforce_centers": (1, None),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Enough(Exception):
    """Raised by the patched ``print`` once the held lines are in."""


def recorder(lines: list, limit):
    def fake_print(*args, sep=" ", end="\n", **_):
        lines.extend((sep.join(map(str, args)) + end).splitlines())
        if limit is not None and len(lines) >= limit:
            raise Enough

    return fake_print


def run_jax(name: str, limit, monkeypatch) -> tuple[list, BaseException | None]:
    lines: list = []
    monkeypatch.setattr(sys, "argv", [f"examples/{name}.py"])
    monkeypatch.syspath_prepend(str(REPO))
    try:
        runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                       init_globals={"print": recorder(lines, limit)}, run_name="__main__")
    except Enough:
        return lines, None
    except Exception as e:  # noqa: BLE001  (the reference's own failure is recorded)
        return lines, e
    return lines, None


def port_module(name: str):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  REPO / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(name: str, limit, dtype: str) -> list:
    lines: list = []
    mod = port_module(name)
    mod.print = recorder(lines, limit)
    try:
        mod.main(["--device", "cpu", "--dtype", dtype])
    except Enough:
        pass
    return lines


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_prints_the_jax_scripts_lines(name, monkeypatch):
    held, raises = CASES[name]
    # a JAX script that raises runs to its error, which stops it
    jax_lines, error = run_jax(name, None if raises else held, monkeypatch)
    if raises is None:
        assert error is None, error
    else:
        assert isinstance(error, raises), error
        assert len(jax_lines) == 5
        jax_lines = jax_lines[:held]
    port_lines = run_port(name, held, "float64")
    assert len(jax_lines) > 0
    assert port_lines[:len(jax_lines)] == jax_lines


def test_example_float32_solves(monkeypatch):
    """``learn_p_r`` whole in float32 in both packages: its two-level solve
    lines, which the JAX script prints only without x64."""
    import jax

    with jax.enable_x64(False):
        jax_lines, error = run_jax("learn_p_r", None, monkeypatch)
    assert error is None, error
    assert len(jax_lines) == 7 and sum("conv" in line for line in jax_lines) == 2
    assert run_port("learn_p_r", None, "float32") == jax_lines


def test_examples_import_nothing_of_jax():
    sys.path.insert(0, str(Path(__file__).parent))
    try:
        from test_torch_port_rules import FORBIDDEN, imported_roots
    finally:
        sys.path.pop(0)
    scripts = sorted((REPO / "examples_torch").glob("*.py"))
    assert sorted(p.stem for p in scripts) == sorted(CASES)
    for p in scripts:
        assert not set(imported_roots(p)) & set(FORBIDDEN), p
        assert {"main"} <= set(vars(port_module(p.stem)))
