"""Median (ms) over the serve window's batches of the host's time in
``sdt.graph.replay_loop`` + ``sdt.graph.replay_decode``: the graph
launches that block the batcher's worker inside ``dispatch_block_ms.serve``.
Logs the median of every ``sdt.dispatch.*`` child and of
``sdt.batcher.fill`` / ``join`` / ``wait``, the p90 of the window's
``sdt.request`` spans (submit to dispatch, the batcher's own queueing),
and in a traced run the stretch's idle by the innermost program span
(``spans.log_idle``)."""

import numpy as np

from benchmark.harness import spans as sp


def read(run):
    sp.log_idle(run)
    found = sp.serve_window(run)
    if found is None:
        return None
    chosen, inside = found
    sp.log_stages(run, chosen, [s for s in inside
                                if s.name.startswith("sdt.batcher.")])
    queued = [sp.ms([r]) for b in chosen.values() for r in b["sdt.request"]]
    if queued:
        run.log(f"sdt.request over {len(queued)} requests: p90 "
                f"{np.percentile(queued, 90):.3f} ms, median "
                f"{np.median(queued):.3f} ms")
    blocks = [sp.ms(b["sdt.graph.replay_loop"] + b["sdt.graph.replay_decode"])
              for b in chosen.values() if b["sdt.graph.replay_loop"]]
    return sp.median_ms(blocks)
