"""gnn_ms.build: the fenced ``aggnet``, ``cnet`` and ``pnet`` spans of one
learned build, summed, in ms, the mean over ``harness/learned_pass.py``'s
three builds."""

from harness import learned_pass


def read(run):
    return learned_pass.read(run).get("gnn_ms.build")
