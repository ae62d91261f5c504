"""cycle_ms: the requests' solve time (without a request's own build) over
all the cycles they ran."""


def read(run):
    cycles = sum(q["cycles"] for q in run.requests)
    return sum(q["solve_ms"] for q in run.requests) / cycles if cycles else None
