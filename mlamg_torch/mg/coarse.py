"""Dense coarse-level solver (counterpart of ``mlamg_tpu/mg/coarse.py``).

Singular (Neumann) systems use the Lagrange bordering
[[A, 1], [1^T, 0]] to pin the nullspace.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CoarseSolver:
    """Factorized dense coarse operator.

    ``method="lu"`` stores the LU factors and LAPACK's 1-based pivots (JAX
    and scipy keep 0-based ones; ``convert`` adds 1).  ``method="inverse"``
    stores the explicit inverse in ``lu`` and an empty ``piv``; each solve
    is then one (k, k) matvec.
    """

    lu: torch.Tensor
    piv: torch.Tensor
    singular: bool
    method: str = "lu"

    @staticmethod
    def factor(A_H: torch.Tensor, singular: bool = False,
               method: str = "lu") -> "CoarseSolver":
        if singular:
            k = A_H.shape[0]
            one = torch.ones((k, 1), dtype=A_H.dtype, device=A_H.device)
            zero = torch.zeros((1, 1), dtype=A_H.dtype, device=A_H.device)
            A_H = torch.cat([torch.cat([A_H, one], 1), torch.cat([one.T, zero], 1)], 0)
        if method == "inverse":
            empty = torch.zeros(0, dtype=torch.int32, device=A_H.device)
            return CoarseSolver(torch.linalg.inv(A_H), empty, singular, method)
        if method != "lu":
            raise ValueError(f"unknown coarse method: {method}")
        # no pivot check (it would wait for the card): a singular operator
        # gives inf/NaN in the solve, as JAX's LU does
        lu, piv, _ = torch.linalg.lu_factor_ex(A_H)
        return CoarseSolver(lu, piv, singular, method)

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        """Solve A_H e = r (r may be (k,) or (k, t))."""
        if self.singular:
            r = torch.cat([r, r.new_zeros((1,) + tuple(r.shape[1:]))], 0)
        if self.method == "inverse":
            e = self.lu @ r
        else:
            rr = r[:, None] if r.ndim == 1 else r
            e = torch.linalg.lu_solve(self.lu, self.piv, rr)
            if r.ndim == 1:
                e = e[:, 0]
        if self.singular:
            e = e[:-1]
        return e
