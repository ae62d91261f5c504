"""vcycle_graph_share: the share of ``vcycle``'s graphed calls in this
process that replayed a CUDA graph, from the program's counter
(``GRAPHS["vcycle.replay"]`` over its eager, captured and replayed
cycles), read in the process as ``harness/spans.py`` reads ``LAUNCHES``.
None where the program has no such counter or counted no cycle."""

KEYS = ("vcycle.eager", "vcycle.capture", "vcycle.replay")


def read(run):
    from mlamg_torch.utils import profiler

    return share(getattr(profiler, "GRAPHS", None))


def share(graphs):
    if graphs is None:
        return None
    total = sum(graphs[k] for k in KEYS)
    return graphs["vcycle.replay"] / total if total else None
