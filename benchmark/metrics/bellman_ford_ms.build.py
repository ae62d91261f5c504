"""bellman_ford_ms.build: the fenced ``bellman_ford`` span of one learned
build (the sweeps and the aggregate ids), in ms, the mean over
``harness/learned_pass.py``'s three builds."""

from harness import learned_pass


def read(run):
    return learned_pass.read(run).get("bellman_ford_ms.build")
