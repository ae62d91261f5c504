"""launches_per_cycle: the device operations (kernels, copies, sets) of
``harness/spans.py``'s pass B, each solve's from its first ``cycle`` span's
start to the synchronise that ends it, over the ``cycle`` spans."""

from harness import spans


def read(run):
    return spans.read(run).get("launches_per_cycle")
