"""The structured all-DIA hierarchy of ``mlamg_torch`` on a five-point
Poisson operator.

The harness makes the operator's diagonals itself (``reference/poisson2d``)
and hands ``mlamg_torch.ops.dia.DIA`` to ``build_structured_hierarchy``.
The package's ``vcycle_solve`` is Jacobi-only, so ``solve`` loops
``vcycle`` with the configuration's smoother in ``vcycle_solve``'s shape:
a cycle, then the residual norm through the package's operator product,
read on the host, until it meets the tolerance or the cycle cap.
"""

from __future__ import annotations

import torch
from mlamg_torch.mg.cycle import vcycle
from mlamg_torch.mg.structured import build_structured_hierarchy
from mlamg_torch.ops import matmul
from mlamg_torch.ops.dia import DIA

from reference import poisson2d


class System:
    def __init__(self, config: dict, device: torch.device, cache_dir: str):
        op = config["operator"]
        self.ny, self.nx = op["ny"], op["nx"]
        self.n = self.ny * self.nx
        self.hierarchy = config["hierarchy"]
        self.cycle = config["cycle"]
        self.max_cycles = config["request"]["max_cycles"]
        self.device = device
        self.offsets = poisson2d.offsets(self.nx)
        self.base = poisson2d.diagonals(self.ny, self.nx, device)

    def start(self) -> None:
        """Starts what the first build would start in its clock, by a build
        on a 64x64 grid: cuBLAS and cuSOLVER, the DIA kernel and the
        package's other kernels (on an H100, the first 4096^2 build takes
        0.9 s after the libraries alone, 0.14 s after this, against
        0.07-0.09 s for a later one)."""
        hc = self.hierarchy
        small = DIA(poisson2d.diagonals(64, 64, self.device), poisson2d.offsets(64), (4096, 4096))
        build_structured_hierarchy(small, 64, 64, sides=tuple(hc["sides"]),
                                   min_coarse=hc["min_coarse"], kind=hc["kind"],
                                   coarse_method=hc["coarse_method"])

    def operator(self, scale: float) -> DIA:
        data = self.base if scale == 1.0 else self.base * scale
        return DIA(data, self.offsets, (self.n, self.n))

    def rhs(self, x_true: torch.Tensor, scale: float) -> torch.Tensor:
        return poisson2d.apply(x_true, self.ny, self.nx, scale)

    def build(self, A: DIA):
        hc = self.hierarchy
        return build_structured_hierarchy(A, self.ny, self.nx, sides=tuple(hc["sides"]),
                                          min_coarse=hc["min_coarse"], kind=hc["kind"],
                                          coarse_method=hc["coarse_method"])

    def solve(self, h, b: torch.Tensor, tol: float):
        A = h.As[0]
        x = torch.zeros_like(b)
        for cycles in range(1, self.max_cycles + 1):
            x = vcycle(h, b, x, **self.cycle)
            if float(torch.linalg.vector_norm(matmul.spmv_affine(A, x, c=b, alpha=-1.0))) <= tol:
                return x, cycles, True
        return x, self.max_cycles, False

    def level0(self, h):
        return h.As[0]

    def spmv_bytes(self) -> int:
        """Least bytes of one product: the stored diagonals, x and y."""
        return 4 * (len(self.offsets) * self.n + 2 * self.n)

    def coarse_state(self, h):
        A1 = h.As[1]
        return A1.offsets, A1.data

    def check_coarse(self, state, scale: float) -> dict:
        offsets, data = state
        return {"coarse_op": poisson2d.coarse_error(offsets, data, self.ny, self.nx, scale)}

    def control_state(self, state, scale: float):
        """``state`` with the program's coarse operator replaced by the
        reference's in bfloat16 (the control)."""
        dev = state[1].device
        return poisson2d.coarse_dia(self.ny, self.nx, scale, dev, torch.bfloat16)

    def residual(self, x, b, scale: float) -> float:
        return poisson2d.relative_residual(x, b, self.ny, self.nx, scale)
