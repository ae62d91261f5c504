"""well_spmv_roofline: the least bytes of one product with the level-0
operator (nnz values and columns, 8 bytes a nonzero, x read and y
written, counted from the harness's matrix and not the program's pack) at
the card's HBM rate, over the L2-cold time of one ``well_spmv`` launch,
in %."""


def read(run):
    import torch
    from mlamg_torch.ops.unstructured import WindowedELL, well_spmv

    A = run.system.level0(run.hierarchy)
    if run.device.type != "cuda" or not isinstance(A, WindowedELL):
        return None
    x = torch.randn(A.shape[0], device=run.device)
    ms = run.cold_ms(lambda: well_spmv(A, x))
    return 100.0 * run.system.spmv_bytes() / run.hbm_bytes_per_s() / (ms * 1e-3)
