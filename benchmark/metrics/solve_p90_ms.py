"""solve_p90_ms: the 90th percentile of the window's request times, each
from the request's start to the synchronise after its last cycle."""

import numpy as np


def read(run):
    return float(np.percentile([q["ms"] for q in run.requests], 90)) if run.requests else None
