"""cycle_graph_share: the share of ``uvcycle_solve``'s cycles in this
process that replayed a CUDA graph, from the program's counter
(``GRAPHS["uvcycle.replay"]`` over its eager, captured and replayed
cycles), read in the process as ``harness/spans.py`` reads ``LAUNCHES``.
None where the program has no such counter or counted no cycle."""

KEYS = ("uvcycle.eager", "uvcycle.capture", "uvcycle.replay")


def read(run):
    from mlamg_torch.utils import profiler

    return share(getattr(profiler, "GRAPHS", None))


def share(graphs):
    if graphs is None:
        return None
    total = sum(graphs[k] for k in KEYS)
    return graphs["uvcycle.replay"] / total if total else None
