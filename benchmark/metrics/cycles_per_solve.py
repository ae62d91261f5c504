"""cycles_per_solve: the mean of the cycle counts the solve returned."""


def read(run):
    return sum(q["cycles"] for q in run.requests) / len(run.requests) if run.requests else None
