from mlamg_torch.deploy.options import Options
from mlamg_torch.deploy.preconditioners import (
    LearnedAMGPreconditioner,
    PCDRPreconditioner,
    SAPreconditioner,
)
from mlamg_torch.deploy.fieldsplit import SchurFieldsplitSolver

__all__ = ["Options", "LearnedAMGPreconditioner", "PCDRPreconditioner", "SAPreconditioner",
           "SchurFieldsplitSolver"]
