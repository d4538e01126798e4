"""Mean host time (ms) a batch in ``sdt.fetch.host``: the copy of the
images to the host and their uint8 conversion there, over a batch cell's
steady window batches (``harness/spans.py``). Logs the median of
``sdt.fetch.wait`` and of every ``sdt.dispatch.*`` child, and the traced
stretch's idle by the innermost program span (``spans.log_idle``)."""

from benchmark.harness import spans as sp


def read(run):
    sp.log_idle(run)
    chosen = sp.batch_cell_batches(run)
    if chosen is None:
        return None
    sp.log_stages(run, chosen)
    host = [sp.ms(b["sdt.fetch.host"]) for b in chosen.values()
            if b["sdt.fetch.host"]]
    return sum(host) / len(host) if host else None
