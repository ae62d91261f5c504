"""galerkin_s.setup: the fenced ``galerkin`` spans of ``harness/spans.py``'s
pass-A build, summed, in s; read where set-up builds the only hierarchy."""

from harness import spans


def read(run):
    return spans.read(run).get("galerkin_s.setup")
