"""Profiling & tracing utilities.

Counterpart of ``safe_denoiser_tpu/utils/profiling.py`` on
``torch.profiler``. The reference has no profiling beyond wall-clock prints
(SURVEY.md §5). The port keeps two hooks and one recorder:
  * ``span(name, parent=None)`` — the span recorder: one tuple
    ``(id, parent id, name, native thread id, start_ns, end_ns)`` a span
    on ``time.perf_counter_ns()``, kept in a process-wide flight
    recorder of the last :data:`CAPACITY` spans (``spans()``). Always on,
    on every thread: ``torch.profiler.record_function`` reaches only the
    profiler's own thread, and the batcher dispatches on a worker and
    fetches on a finisher. ``record`` adds a span that began on another
    thread (a request, from its submit to its dispatch);
  * ``chrome_events(base_ns)`` — the recorded spans as Chrome-trace
    events on a ``torch.profiler`` trace's clock, on the tracks of the
    threads that made them;
  * ``trace(dir)`` — context manager around ``torch.profiler.profile``
    (CPU and, where a GPU is visible, CUDA activity) that writes a Chrome
    trace (``trace.json``), with the spans recorded in its interval, that
    TensorBoard or Perfetto loads; ``annotate(name)`` is ``span(name)``.

The pipelines' spans: ``sdt.dispatch`` (a batch's root: ``.text``,
``.inputs``, ``sdt.graph.capture``, ``sdt.graph.replay_loop``,
``sdt.graph.replay_decode``), ``sdt.fetch`` (its parent the batch's
``sdt.dispatch``: ``.wait``, ``.host``); the batcher's ``sdt.batcher.wait``,
``sdt.batcher.fill``, ``sdt.batcher.join`` and ``sdt.request``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Optional

TRACE_FILE = "trace.json"
CAPACITY = 65536

# Process-wide on purpose, like the kernels' launch counters: a batch's
# spans come from several threads (worker, finisher, callers) and are read
# by whoever traces the process. deque.append and next() on a count are
# single C calls under the interpreter lock, so threads need no lock here.
_SPANS: collections.deque = collections.deque(maxlen=CAPACITY)
_IDS = itertools.count(1)


class _Thread(threading.local):
    """A thread's open spans and its native id (read once: it is a
    system call)."""

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()


_LOCAL = _Thread()


class span:
    """``with span(name) as s:`` records one span of this thread. Its
    parent is ``parent`` (a span id, for a span whose cause lies on another
    thread) or else the innermost span open on this thread. ``s.id`` and
    ``s.start_ns`` are set on entry."""

    __slots__ = ("name", "parent", "id", "start_ns")

    def __init__(self, name: str, parent: Optional[int] = None):
        self.name = name
        self.parent = parent
        self.id = None
        self.start_ns = 0

    def __enter__(self) -> "span":
        stack = _LOCAL.stack
        if self.parent is None and stack:
            self.parent = stack[-1].id
        self.id = next(_IDS)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        local = _LOCAL
        local.stack.pop()
        _SPANS.append((self.id, self.parent, self.name, local.tid,
                       self.start_ns, end))
        return False


def record(name: str, start_ns: int, end_ns: int,
           parent: Optional[int] = None) -> int:
    """Record a span that began on another thread (``start_ns`` from
    ``time.perf_counter_ns()`` there), on this thread's track; its id."""
    sid = next(_IDS)
    _SPANS.append((sid, parent, name, _LOCAL.tid, start_ns, end_ns))
    return sid


def enclosing(name: str) -> Optional[span]:
    """The innermost span named ``name`` open on this thread, or None."""
    for s in reversed(_LOCAL.stack):
        if s.name == name:
            return s
    return None


def spans() -> list:
    """A snapshot of the recorder, oldest first."""
    return list(_SPANS)


def chrome_events(base_ns: int, lo_ns: Optional[int] = None,
                  hi_ns: Optional[int] = None) -> list:
    """The recorded spans that overlap ``[lo_ns, hi_ns]`` (recorder
    clock; either None leaves that side open) as Chrome-trace "X" events
    on the clock of a trace whose ``ts`` are microseconds after the Unix
    time ``base_ns`` (``torch.profiler``'s ``baseTimeNanoseconds``):
    ``ts = (start_ns + anchor - base_ns) / 1e3`` with the anchor
    ``time.time_ns() - time.perf_counter_ns()`` taken now. ``pid`` is this
    process, ``tid`` the thread that recorded the span."""
    anchor = time.time_ns() - time.perf_counter_ns()
    pid = os.getpid()
    out = []
    for sid, parent, name, tid, a, b in spans():
        if (lo_ns is not None and b < lo_ns) or \
                (hi_ns is not None and a > hi_ns):
            continue
        out.append({"ph": "X", "cat": "sdt", "name": name, "pid": pid,
                    "tid": tid, "ts": (a + anchor - base_ns) / 1e3,
                    "dur": (b - a) / 1e3,
                    "args": {"id": sid, "parent": parent}})
    return out


def annotate(name: str) -> span:
    """A named region of host code, on any thread (``span``)."""
    return span(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``log_dir/trace.json`` with the
    recorder's spans of the block appended (``chrome_events``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof = profile(activities=activities)
    prof.start()
    lo = time.perf_counter_ns()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        hi = time.perf_counter_ns()
        prof.stop()
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
        # a trace without the field has absolute microseconds
        data["traceEvents"].extend(chrome_events(
            int(data.get("baseTimeNanoseconds", 0)), lo, hi))
        with open(path, "w") as f:
            json.dump(data, f)
