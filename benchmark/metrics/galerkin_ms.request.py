"""galerkin_ms.request: the fenced ``galerkin`` spans of one hierarchy
build, summed, in ms, the mean over ``harness/spans.py``'s pass-A builds;
read where the mix builds a hierarchy per request."""

from harness import spans


def read(run):
    return spans.read(run).get("galerkin_ms.request")
