"""Helpers the readers of the program's own spans share
(``safe_denoiser_tpu_torch/utils/profiling.py``: ``span``, ``spans()``,
``chrome_events``). A batch is an ``sdt.dispatch`` root and every span
whose chain of parents leads to it: its ``sdt.dispatch.*`` children, its
``sdt.graph.*`` replays, its ``sdt.fetch`` (made on another thread, linked
by id) with ``.wait`` and ``.host``, and in serving its ``sdt.request``s.
Where the program has no recorder (a commit before it) or recorded
nothing, every helper returns None and so does each reader."""

from __future__ import annotations

import collections
import json
import os
import time

import numpy as np

from .spec import ROOT
from .trace import _DEVICE_CATS, _merge

# where harness/trace.py::traced writes the traced stretch's trace
TRACE = ROOT / "build" / "bench" / "trace.json"
WAIT = "sdt.batcher.wait"

Span = collections.namedtuple(
    "Span", "id parent name tid start end")


def recorded():
    """The program's recorded spans, or None."""
    try:
        from safe_denoiser_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    out = [Span(*s) for s in read()] if read else []
    return out or None


def batches(spans: list) -> dict:
    """{root id: {"dispatch": span, name: [descendant spans]}} of every
    ``sdt.dispatch`` root."""
    by_id = {s.id: s for s in spans}
    out = {s.id: collections.defaultdict(list, dispatch=s)
           for s in spans if s.name == "sdt.dispatch"}
    for s in spans:
        p = s.parent
        while p is not None and p not in out:
            p = by_id[p].parent if p in by_id else None
        if p is not None:
            out[p][s.name].append(s)
    return out


def ms(spans: list) -> float:
    """Their summed duration in ms."""
    return sum(s.end - s.start for s in spans) / 1e6


def median_ms(values: list):
    return float(np.median(values)) if values else None


def serve_window(run):
    """(batches, spans) of the serve window: the batches whose
    ``sdt.dispatch`` overlaps the span from the first start to the last end
    of ``run.load.window_dispatches`` (the recorder's clock, in seconds),
    and every span inside that stretch; None without them."""
    spans = recorded()
    rows = getattr(run.load, "window_dispatches", None)
    if not spans or not rows:
        return None
    lo = int(min(a for a, _, _ in rows) * 1e9)
    hi = int(max(b for _, b, _ in rows) * 1e9)
    chosen = {k: b for k, b in batches(spans).items()
              if b["dispatch"].start <= hi and b["dispatch"].end >= lo}
    inside = [s for s in spans if s.start >= lo and s.end <= hi]
    return (chosen, inside) if chosen else None


def log_stages(run, chosen: dict, extra: list = ()) -> None:
    """The median host ms a batch of each of its span names, and of the
    ``extra`` spans (by name, each one a sample)."""
    names = sorted({n for b in chosen.values() for n, v in b.items()
                    if n not in ("dispatch", "sdt.request") and v})
    med = {n: median_ms([ms(b[n]) for b in chosen.values() if b[n]])
           for n in names}
    med["sdt.dispatch"] = median_ms([ms([b["dispatch"]])
                                     for b in chosen.values()])
    for n in sorted({s.name for s in extra}):
        med[n] = median_ms([ms([s]) for s in extra if s.name == n])
    run.log(f"program spans over {len(chosen)} batches, median host ms: "
            + json.dumps({k: round(v, 3) for k, v in med.items()}))


_CACHE: dict = {}


def chrome_trace():
    """The traced stretch's Chrome trace (read once a file version), or
    None."""
    try:
        stamp = (str(TRACE), os.stat(TRACE).st_mtime_ns)
    except OSError:
        return None
    if _CACHE.get("stamp") != stamp:
        with open(TRACE) as f:
            _CACHE.update(stamp=stamp, data=json.load(f))
    return _CACHE["data"]


def traced_window(data: dict):
    """(start, end) in us of the trace's ``bench.traced`` span, or None."""
    for e in data["traceEvents"]:
        if e.get("name") == "bench.traced" and e.get("ph") == "X" \
                and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def to_recorder_ns(data: dict, ts_us: float) -> int:
    """A trace time (us) on the recorder's clock (``perf_counter_ns``)."""
    anchor = time.time_ns() - time.perf_counter_ns()
    return int(ts_us * 1e3 + int(data.get("baseTimeNanoseconds", 0))
               - anchor)


def batch_cell_batches(run):
    """The batch cell's steady batches: those that captured no graph and
    whose ``sdt.fetch`` ended before the traced stretch began; None
    without them."""
    spans, data = recorded(), chrome_trace()
    if not spans or data is None or not (run.trace or {}).get("window_s"):
        return None
    window = traced_window(data)
    if window is None:
        return None
    began = to_recorder_ns(data, window[0])
    chosen = {k: b for k, b in batches(spans).items()
              if not b["sdt.graph.capture"] and b["sdt.fetch"]
              and max(s.end for s in b["sdt.fetch"]) < began}
    return chosen or None


def log_idle(run):
    """Logs the traced stretch's idle seconds (nothing on the device), the
    part of them while some ``sdt.*`` span other than ``sdt.batcher.wait``
    is open on any thread (idle the program holds, not idle waiting for
    requests), and the idle by the innermost open span (the shortest),
    under ``sdt.batcher.wait`` alone and under no span. ``sdt.request`` is
    left out: it times a queue, not a thread's work, and the worker's own
    spans cover the time a request waits. Returns ``{"idle_s", "held_s",
    "window_s", "by_span"}``, or None without a traced stretch or spans."""
    if not (run.trace or {}).get("window_s") or not recorded():
        return None
    data = chrome_trace()
    window = traced_window(data) if data else None
    if window is None:
        return None
    from safe_denoiser_tpu_torch.utils import profiling
    lo, hi = window
    mine = [e for e in profiling.chrome_events(
        int(data.get("baseTimeNanoseconds", 0)))
        if e["name"].startswith("sdt.") and e["name"] != "sdt.request"
        and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    if not mine:
        return None
    busy = _merge([[max(float(e["ts"]), lo),
                    min(float(e["ts"]) + float(e["dur"]), hi)]
                   for e in data["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS
                   and float(e["ts"]) < hi
                   and float(e["ts"]) + float(e["dur"]) > lo])
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    names = [e["name"] for e in mine]
    start = np.array([e["ts"] for e in mine], dtype=np.float64)
    end = start + np.array([e["dur"] for e in mine], dtype=np.float64)
    held = np.array([n != WAIT for n in names])
    by_span: dict = collections.defaultdict(float)
    program = 0.0
    for a, b in gaps:
        over = np.flatnonzero((start < b) & (end > a))
        cuts = sorted({a, b} | {x for i in over for x in (start[i], end[i])
                                if a < x < b})
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            open_ = over[(start[over] <= mid) & (end[over] >= mid)]
            if open_.size == 0:
                by_span["(no span)"] += y - x
                continue
            inner = open_[np.argmin(end[open_] - start[open_])]
            by_span[names[inner]] += y - x
            if held[open_].any():
                program += y - x
    out = {"idle_s": sum(b - a for a, b in gaps) * 1e-6,
           "held_s": program * 1e-6, "window_s": (hi - lo) * 1e-6,
           "by_span": {k: v * 1e-6 for k, v in
                       sorted(by_span.items(), key=lambda kv: -kv[1])}}
    run.log(f"idle {out['idle_s']:.6f} s of {out['window_s']:.6f}, "
            f"{out['held_s']:.6f} while the program holds it, by innermost "
            "program span (s): " + json.dumps(
                {k: round(v, 6) for k, v in out["by_span"].items()}))
    return out
