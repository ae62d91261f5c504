"""Smoothers, interpolation, cycles and Krylov solvers (counterpart of
``mlamg_tpu/mg``)."""

from mlamg_torch.mg.smoothers import (  # noqa: F401
    jacobi,
    l1_jacobi,
    chebyshev,
    multicolor_gauss_seidel,
    greedy_coloring,
)
from mlamg_torch.mg.interp import (  # noqa: F401
    tentative_dense,
    smoothed_aggregation,
    sa_interpolation_dense,
)
from mlamg_torch.mg.coarse import CoarseSolver  # noqa: F401
from mlamg_torch.mg.factored import (  # noqa: F401
    FactoredSA,
    BoxAgg2D,
    AggOp,
    factored_sa,
    coarse_operator_factored,
    dia_transpose,
)
from mlamg_torch.mg.cycle import twolevel_solve, Hierarchy, build_hierarchy, vcycle_solve  # noqa: F401
from mlamg_torch.mg.krylov import pcg, fgmres  # noqa: F401
