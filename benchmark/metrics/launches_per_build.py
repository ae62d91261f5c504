"""launches_per_build: the device operations (kernels, copies, sets) that
start between a learned build's start and the synchronise that ends it,
under a device-only profiler pass with the recorder off, the mean over
``harness/learned_pass.py``'s three builds; on the card only."""

from harness import learned_pass


def read(run):
    return learned_pass.read(run).get("launches_per_build")
