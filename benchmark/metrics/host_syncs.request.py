"""host_syncs.request: the host reads the program counted in ``SYNCS``
over ``harness/learned_pass.py``'s three builds and three solves, over 3:
the reads of one request."""

from harness import learned_pass


def read(run):
    return learned_pass.read(run).get("host_syncs.request")
