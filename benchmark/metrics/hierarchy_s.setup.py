"""hierarchy_s.setup: the set-up's hierarchy build, host clock ended by a
synchronise; None where the mix builds a hierarchy per request."""


def read(run):
    return run.hierarchy_s
