"""dia_spmv_roofline: the least bytes of one product with the level-0
operator (its stored diagonals, x read, y written, 4 bytes each, counted
from the harness's matrix) at the card's HBM rate, over the L2-cold time
of one ``dia_spmv`` launch, in %."""


def read(run):
    import torch
    from mlamg_torch.ops.dia import DIA, dia_spmv

    A = run.system.level0(run.hierarchy)
    if run.device.type != "cuda" or not isinstance(A, DIA):
        return None
    x = torch.randn(A.shape[0], device=run.device)
    ms = run.cold_ms(lambda: dia_spmv(A, x))
    return 100.0 * run.system.spmv_bytes() / run.hbm_bytes_per_s() / (ms * 1e-3)
