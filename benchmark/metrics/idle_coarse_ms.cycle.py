"""idle_coarse_ms.cycle: pass B's device idle (``harness/spans.py``) in
gaps whose middle lies in a ``level`` span of level 1 or deeper or in a
``coarse_solve``, in ms over the ``cycle`` spans."""

from harness import spans


def read(run):
    return spans.read(run).get("idle_coarse_ms.cycle")
