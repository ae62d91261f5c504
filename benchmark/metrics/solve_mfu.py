"""solve_mfu: the whole request's share of the card's peak: its least
bytes (the operator's stored entries, b read and x written, the count of
the cell's kernel) at the HBM rate, over this run's solve_ms, in %.  The
work is sparse, so the bandwidth bounds it."""


def read(run):
    if run.device.type != "cuda" or not run.requests:
        return None
    solve_s = run.window_s / len(run.requests)
    return 100.0 * run.system.spmv_bytes() / run.hbm_bytes_per_s() / solve_s
