"""The control of each cell at a tiny size on the CPU: the reference put in
the program's place in bfloat16 reads above the limits the program reads
below.  (On the card, at the cells' sizes: ``python3 benchmark/control.py``.)"""

import pytest

import control

CELLS = ("poisson4096.rhs", "poisson4096.setup", "hull600k.rhs")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(tiny, cell):
    spec = tiny(cell)
    limits = spec["config"]["limits"]
    for r in control.readings(cell, [3, 2**31 + 3], device="cpu", loaded=spec):
        assert r["program"]["residual"] <= limits["residual"] < r["control"]["residual"]
        assert r["program"]["coarse_op"] <= limits["coarse_op"]
        if cell != "poisson4096.rhs":  # the unscaled Poisson's coarse stencil is exact in bfloat16
            assert r["control"]["coarse_op"] > limits["coarse_op"]
