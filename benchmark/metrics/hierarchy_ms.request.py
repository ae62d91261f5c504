"""hierarchy_ms.request: the mean of the requests' hierarchy builds, host
clock ended by a synchronise; None where the set-up builds the only one."""


def read(run):
    builds = [q["build_ms"] for q in run.requests if q["build_ms"] is not None]
    return sum(builds) / len(builds) if builds else None
