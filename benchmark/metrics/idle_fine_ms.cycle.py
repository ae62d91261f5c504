"""idle_fine_ms.cycle: pass B's device idle (``harness/spans.py``) in gaps
whose middle lies in a level-0 ``level`` span and in no deeper one, in ms
over the ``cycle`` spans."""

from harness import spans


def read(run):
    return spans.read(run).get("idle_fine_ms.cycle")
