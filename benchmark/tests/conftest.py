import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# the CPU sizes of the cells: a 128^2 Poisson (two levels and the coarse
# inverse) and an 8,000-dof hull (one SA level and the coarse inverse)
TINY = {"structured_dia": {"ny": 128, "nx": 128}, "unstructured_sa": {"n_interior": 8000}}


def tiny_spec(cell: str) -> dict:
    from harness import core

    spec = core.load_cell(cell)
    spec["config"] = copy.deepcopy(spec["config"])
    spec["config"]["operator"].update(TINY[spec["config"]["system"]])
    return spec


@pytest.fixture
def tiny():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny_spec
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
