"""solve_ms: the window's wall time over the requests it completed."""


def read(run):
    return run.window_s * 1e3 / len(run.requests) if run.requests else None
