"""Median host time (ms) inside ``dispatch_batch``: the eager text encode
and the graph launches that block the batcher's worker."""

import numpy as np


def read(run):
    rows = getattr(run.load, "window_dispatches", None)
    if not rows:
        return None
    return float(np.median([b - a for a, b, _ in rows])) * 1e3
