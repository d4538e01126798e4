"""Real rows over the batch size (%) over every batch the window
dispatched (the batcher pads a short group with its last request)."""


def read(run):
    rows = getattr(run.load, "window_dispatches", None)
    if not rows:
        return None
    return 100.0 * sum(r for _, _, r in rows) / (len(rows)
                                                 * run.load.batch)
