"""90th percentile (ms) of the wait from a served request's due time to
the start of its batch's ``dispatch_batch``, from the benchmark's clock
around the callable it hands the batcher."""

import numpy as np


def read(run):
    waits = getattr(run.load, "queue_waits", lambda: [])()
    return float(np.percentile(waits, 90)) * 1e3 if waits else None
