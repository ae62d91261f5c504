"""setup_s: from the process's start to the first timed request: loading
the operator, building the hierarchy, the warm-up requests, and on a
checkout's first run the builds and the hull's meshing."""


def read(run):
    return run.setup_s
