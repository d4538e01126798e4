"""The port's span recorder (``utils/profiling.py``) on the CPU: nesting and
parent ids on one thread and across threads, cross-thread ``record``, the
flight recorder's bound, the merge into ``trace(dir)``'s Chrome trace on
the profiler's clock for a span ``record_function`` would miss (a worker
thread's), the spans of a pipeline's ``dispatch_batch`` and ``fetch`` and
of the batcher's worker, and the benchmark's two readers of those spans
and their logs (``benchmark/metrics``, loaded through
``benchmark.harness.spec``) on synthetic runs and traces with known values.
"""

import collections
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from benchmark.harness import spans as bench_spans
from benchmark.harness import spec
from safe_denoiser_tpu_torch.serving import DynamicBatcher, GenRequest
from safe_denoiser_tpu_torch.utils import profiling
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

MS = 1_000_000          # ns


@pytest.fixture
def recorder(monkeypatch):
    """An empty recorder of the real bound, for this test alone."""
    fresh = collections.deque(maxlen=profiling.CAPACITY)
    monkeypatch.setattr(profiling, "_SPANS", fresh)
    return fresh


def _by_name(rows):
    out = collections.defaultdict(list)
    for r in rows:
        out[r[2]].append(r)
    return out


# ---------------------------------------------------------------- recorder
def test_spans_nest_on_one_thread(recorder):
    with profiling.span("outer") as outer:
        assert profiling.enclosing("outer") is outer
        with profiling.span("inner"):
            pass
        with profiling.span("second"):
            pass
    assert profiling.enclosing("outer") is None
    got = _by_name(profiling.spans())
    (o,), (i,), (s,) = got["outer"], got["inner"], got["second"]
    me = threading.get_native_id()
    assert o[0] == outer.id and o[1] is None and o[3] == me
    assert i[1] == outer.id and s[1] == outer.id and len(o) == 6
    assert o[4] <= i[4] <= i[5] <= s[4] <= s[5] <= o[5]
    assert len({o[0], i[0], s[0]}) == 3
    assert o[4] == outer.start_ns


def test_cross_thread_parent_and_record(recorder):
    submitted = time.perf_counter_ns()
    with profiling.span("root") as root:
        rid = profiling.record("queued", submitted, root.start_ns, root.id)
    seen = {}

    def finisher():
        seen["tid"] = threading.get_native_id()
        with profiling.span("fetch", parent=root.id):
            with profiling.span("fetch.wait"):
                pass

    t = threading.Thread(target=finisher)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    got = _by_name(profiling.spans())
    (q,), (f,), (w,) = got["queued"], got["fetch"], got["fetch.wait"]
    assert q[:2] == (rid, root.id) and q[4:6] == (submitted, root.start_ns)
    assert f[1] == root.id and f[3] == seen["tid"] != got["root"][0][3]
    assert w[1] == f[0] and w[3] == seen["tid"]


def test_recorder_keeps_the_last_65536_spans(recorder):
    assert profiling.CAPACITY == 65536
    first = profiling.record("x", 0, 1)
    for k in range(profiling.CAPACITY + 4):
        profiling.record("x", k, k + 1)
    rows = profiling.spans()
    assert len(rows) == profiling.CAPACITY
    assert rows[-1][4] == profiling.CAPACITY + 3
    assert rows[0][4] == 4 and all(r[0] != first for r in rows)


def test_chrome_events_window_and_clock(recorder):
    a = profiling.record("early", 100 * MS, 200 * MS)
    profiling.record("late", 300 * MS, 400 * MS, parent=a)
    anchor = time.time_ns() - time.perf_counter_ns()
    base = anchor - 5_000 * MS
    (ev,) = profiling.chrome_events(base, lo_ns=250 * MS)
    assert ev["name"] == "late" and ev["ph"] == "X" and ev["cat"] == "sdt"
    assert ev["args"] == {"id": a + 1, "parent": a}
    assert ev["ts"] == pytest.approx(5_300_000, abs=1e3)
    assert ev["dur"] == pytest.approx(100_000)
    assert [e["name"] for e in profiling.chrome_events(
        base, hi_ns=250 * MS)] == ["early"]


def test_trace_merges_a_worker_threads_span(tmp_path):
    """A span opened on a worker thread reaches ``trace.json`` (which a
    ``record_function`` there does not), on the worker's track and inside
    the main thread's ``record_function`` around it within 1 ms; a span of
    the main thread inside that ``record_function`` lies inside it within
    1 ms too (the clocks agree: ``sdt.fetch`` against ``bench.fetch``)."""
    seen = {}

    def work():
        seen["tid"] = threading.get_native_id()
        with profiling.span("worker-span"):
            torch.ones(16, 16) @ torch.ones(16, 16)
            time.sleep(0.005)

    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("main-anchor"):
            time.sleep(0.005)
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            with profiling.span("main-span"):
                time.sleep(0.005)
    assert not t.is_alive()
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text()
                        )["traceEvents"]
    (anchor,) = [e for e in events if e.get("name") == "main-anchor"]
    (mine,) = [e for e in events if e.get("name") == "worker-span"]
    (main,) = [e for e in events if e.get("name") == "main-span"]
    assert mine["tid"] == seen["tid"] != anchor["tid"] == main["tid"]
    for e in (mine, main):
        assert anchor["ts"] - 1e3 <= e["ts"]
        assert e["ts"] + e["dur"] <= anchor["ts"] + anchor["dur"] + 1e3


# ------------------------------------------------------- pipeline, batcher
@pytest.mark.parametrize("family", ["sd1", "sd3"])
def test_dispatch_and_fetch_spans_of_a_pipeline(
        family, recorder, one_torch_thread):  # noqa: F811
    """One tiny batch on the CPU: ``sdt.dispatch`` with its text and
    inputs children, ``sdt.fetch`` (its parent that dispatch) with its
    wait and host children; the stage times keep their keys; an open
    ``sdt.dispatch`` (the batcher's) is joined, not nested; ``_launch``
    alone (the AOT bundles) opens one."""
    from benchmark.tests import tiny
    cfg = tiny.sd1_config() if family == "sd1" else tiny.sd3_config()
    mix = tiny.traffic("batch4-512-ddpm50" if family == "sd1"
                       else "batch1-1024-flow50")
    system = tiny.cell(cfg, mix).family().System(cfg, mix, 3,
                                                 torch.device("cpu"))
    pipe, kw = system.pipe, system.dispatch_kwargs()
    pending = pipe.dispatch_batch(["a cat", "a dog"], [1, 2], [7.5, 5.0],
                                  **kw)
    images = pending.fetch()
    assert len(images) == 2 and set(pending.stage_ms) == {
        "encode", "loop", "decode"}
    got = _by_name(profiling.spans())
    (root,) = got["sdt.dispatch"]
    assert root[1] is None
    for name in ("sdt.dispatch.text", "sdt.dispatch.inputs", "sdt.fetch"):
        (s,) = got[name]
        assert s[1] == root[0], name
    for name in ("sdt.fetch.wait", "sdt.fetch.host"):
        (s,) = got[name]
        assert s[1] == got["sdt.fetch"][0][0], name
    text, inputs = got["sdt.dispatch.text"][0], got["sdt.dispatch.inputs"][0]
    assert root[4] <= text[4] <= text[5] <= inputs[4] <= inputs[5] <= root[5]
    assert not [n for n in got if n.startswith("sdt.graph.")]   # eager

    recorder.clear()
    with profiling.span("sdt.dispatch") as outer:
        pipe.dispatch_batch(["a cat", "a dog"], [1, 2], [7.5, 5.0],
                            **kw).fetch()
    got = _by_name(profiling.spans())
    assert len(got["sdt.dispatch"]) == 1
    assert got["sdt.dispatch.text"][0][1] == outer.id
    assert got["sdt.fetch"][0][1] == outer.id

    recorder.clear()
    program, bufs = pipe._prepare_batch(["a cat", "a dog"], [1, 2],
                                        [7.5, 5.0], **kw)
    pipe._launch(program, bufs).fetch()
    got = _by_name(profiling.spans())
    (root,) = got["sdt.dispatch"]
    assert got["sdt.fetch"][0][1] == root[0]


class _Stub:
    """A two-phase dispatch that notes the ``sdt.dispatch`` it runs in."""

    def __init__(self):
        self.roots = []

    def dispatch(self, reqs):
        self.roots.append(profiling.enclosing("sdt.dispatch").id)
        results = [r.seed for r in reqs]
        return types.SimpleNamespace(fetch=lambda: results)


@pytest.mark.parametrize("two_phase", [True, False])
def test_batcher_spans_wait_fill_join_and_requests(two_phase, recorder):
    """Batches of 2 from 3 requests (the last alone, after the deadline):
    each dispatched group has its wait and fill spans before its
    ``sdt.dispatch`` (and, two-phase, its join after it); one ``sdt.request`` a request, under its batch's dispatch, ending at or
    before that dispatch's start."""
    stub = _Stub()
    if two_phase:
        b = DynamicBatcher(lambda reqs: [r.seed for r in reqs], 2,
                           max_delay_s=0.05, dispatch_batch=stub.dispatch)
    else:
        b = DynamicBatcher(lambda reqs: stub.dispatch(reqs).fetch(), 2,
                           max_delay_s=0.05)
    futs = [b.submit(GenRequest("p", seed=i)) for i in range(2)]
    assert [f.result(timeout=10) for f in futs] == [0, 1]
    time.sleep(0.1)
    futs.append(b.submit(GenRequest("p", seed=2)))
    assert futs[-1].result(timeout=10) == 2
    b.close()
    got = _by_name(profiling.spans())
    roots = sorted(got["sdt.dispatch"], key=lambda s: s[4])
    assert [s[0] for s in roots] == stub.roots and len(roots) == 2
    worker = {s[3] for s in roots}
    fills = sorted(got["sdt.batcher.fill"], key=lambda s: s[4])
    waits = sorted(got["sdt.batcher.wait"], key=lambda s: s[4])
    joins = sorted(got["sdt.batcher.join"], key=lambda s: s[4])
    assert len(fills) == len(waits) - 1 == 2     # the last wait: the close
    assert len(joins) == (2 if two_phase else 0)
    for k, root in enumerate(roots):
        assert waits[k][5] <= fills[k][4] <= fills[k][5] <= root[4]
        if two_phase:
            assert root[5] <= joins[k][4]
        reqs = [r for r in got["sdt.request"] if r[1] == root[0]]
        assert len(reqs) == (2, 1)[k]
        assert all(r[5] == root[4] and r[4] <= r[5] for r in reqs)
    assert len(got["sdt.request"]) == 3
    assert {s[3] for s in fills + waits + joins} == worker


# ------------------------------------------------------------------ readers
def _reader(name: str):
    cell = next(n for n in ("sd14-serve-ddim10", "sd14-batch")
                if name in [m["name"] for m in spec.load_cell(n).per_layer])
    metric = next(m for m in spec.load_cell(cell).per_layer
                  if m["name"] == name)
    return spec.load_cell(cell).reader(metric)


def _run(load=None, trace=None):
    logs = []
    return types.SimpleNamespace(load=load, trace=trace, log=logs.append,
                                 logs=logs)


def _write_trace(path, base, window, busy, extra=()):
    """A Chrome trace of ``bench.traced`` over ``window`` (ms), kernels
    over ``busy`` (ms), and ``extra`` events, at ``base`` (ns)."""
    us = 1e3
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.traced",
               "ts": window[0] * us, "dur": (window[1] - window[0]) * us,
               "pid": 1, "tid": 1}]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a * us,
                "dur": (b - a) * us, "pid": 0, "tid": 7} for a, b in busy]
    events += list(extra)
    path.write_text(json.dumps({"baseTimeNanoseconds": base,
                                "traceEvents": events}))


@pytest.fixture
def trace_file(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    monkeypatch.setattr(bench_spans, "TRACE", path)
    # the recorder's clock is the trace's, less 0 ms: ts (us) = ns / 1e3
    base = time.time_ns() - time.perf_counter_ns()
    return path, base


def _serve_batches(queued_ms: list, replay_ms: list, t0: int = 10_000 * MS):
    """A batch every 500 ms from ``t0``: its ``sdt.dispatch`` (400 ms) with
    a loop replay, a 10 ms decode replay, a text child, and one request a
    queued time; the window's dispatch times in seconds."""
    rows = []
    for k, (queued, replay) in enumerate(zip(queued_ms, replay_ms)):
        a = t0 + k * 500 * MS
        root = profiling.record("sdt.dispatch", a, a + 400 * MS)
        profiling.record("sdt.dispatch.text", a, a + 5 * MS, root)
        profiling.record("sdt.graph.replay_loop", a + 10 * MS,
                         a + (10 + replay) * MS, root)
        profiling.record("sdt.graph.replay_decode", a + 300 * MS,
                         a + 310 * MS, root)
        for q in queued:
            profiling.record("sdt.request", a - int(q * MS), a, root)
        rows.append(((a + MS) / 1e9, (a + 399 * MS) / 1e9, len(queued)))
    return rows


def test_replay_block_ms_serve_logs_the_window_requests_p90(recorder):
    _serve_batches([[9000.0]], [1.0], t0=8_000 * MS)   # before the window
    queued = [[12.0, 50.0], [3.0], [400.0, 7.5, 80.0], [20.0]]
    rows = _serve_batches(queued, [300.0] * 4)
    run = _run(types.SimpleNamespace(window_dispatches=rows))
    assert _reader("replay_block_ms.serve").read(run) == pytest.approx(310.0)
    (line,) = [s for s in run.logs if s.startswith("sdt.request")]
    assert line.startswith("sdt.request over 7 requests")
    want = np.percentile([q for b in queued for q in b], 90)
    assert float(line.split("p90 ")[1].split(" ms")[0]) == pytest.approx(
        want, abs=1e-3)


def test_replay_block_ms_serve_is_the_median_replay(recorder):
    _serve_batches([[1.0]], [900.0], t0=8_000 * MS)
    rows = _serve_batches([[1.0]] * 5, [300.0, 310.0, 250.0, 330.0, 290.0])
    fill = profiling.record("sdt.batcher.fill", 10_450 * MS, 10_470 * MS)
    run = _run(types.SimpleNamespace(window_dispatches=rows))
    assert fill
    assert _reader("replay_block_ms.serve").read(run) == pytest.approx(
        300.0 + 10.0)
    (line,) = [s for s in run.logs if s.startswith("program spans")]
    med = json.loads(line.split("median host ms: ")[1])
    assert med["sdt.dispatch"] == pytest.approx(400.0)
    assert med["sdt.dispatch.text"] == pytest.approx(5.0)
    assert med["sdt.batcher.fill"] == pytest.approx(20.0)


def _idle_line(run):
    (line,) = [s for s in run.logs if s.startswith("idle ")]
    return line, json.loads(line.split("(s): ")[1])


def test_idle_log_of_the_serve_cell_separates_waiting(recorder, trace_file):
    """Over a 1000 ms stretch busy in [0,100], [300,500], [900,1000]:
    idle under wait [100,200] and [700,800], under fill, dispatch and a
    finisher's fetch 300 ms in all, under nothing [800,900]; a request's
    span over the wait does not count. The serve reader logs it."""
    path, base = trace_file
    t = 5_000 * MS
    profiling.record("sdt.batcher.wait", t + 100 * MS, t + 200 * MS)
    profiling.record("sdt.request", t + 150 * MS, t + 250 * MS)
    profiling.record("sdt.batcher.fill", t + 200 * MS, t + 250 * MS)
    root = profiling.record("sdt.dispatch", t + 250 * MS, t + 600 * MS)
    profiling.record("sdt.fetch", t + 550 * MS, t + 700 * MS, root)
    profiling.record("sdt.batcher.wait", t + 700 * MS, t + 800 * MS)
    _write_trace(path, base, (5000, 6000),
                 [(5000, 5100), (5300, 5500), (5900, 6000)])
    run = _run(trace={"window_s": 1.0, "busy_s": 0.4})
    got = bench_spans.log_idle(run)
    assert got["idle_s"] == pytest.approx(0.6, abs=1e-5)
    assert got["held_s"] == pytest.approx(0.3, abs=1e-5)
    assert got["window_s"] == pytest.approx(1.0, abs=1e-5)
    run = _run(trace={"window_s": 1.0, "busy_s": 0.4})
    assert _reader("replay_block_ms.serve").read(run) is None   # no window
    line, by = _idle_line(run)
    assert "0.300000 while the program holds it" in line
    assert by["sdt.batcher.wait"] == pytest.approx(0.2, abs=1e-5)
    assert by["(no span)"] == pytest.approx(0.1, abs=1e-5)
    assert by["sdt.fetch"] == pytest.approx(0.15, abs=1e-5)


def test_idle_log_of_a_batch_cell(recorder, trace_file):
    """Idle [80,100] under the dispatch, [450,480] under the fetch,
    [480,500] under nothing; the batch reader logs it."""
    path, base = trace_file
    t = 20_000 * MS
    root = profiling.record("sdt.dispatch", t + 50 * MS, t + 120 * MS)
    profiling.record("sdt.fetch", t + 400 * MS, t + 480 * MS, root)
    _write_trace(path, base, (20_000, 20_500),
                 [(20_000, 20_080), (20_100, 20_450)])
    run = _run(trace={"window_s": 0.5, "busy_s": 0.43})
    assert _reader("fetch_host_ms").read(run) is None   # fetched in stretch
    line, by = _idle_line(run)
    assert line.startswith("idle 0.070000 s of 0.500000, 0.050000 while")
    assert by == pytest.approx({"sdt.fetch": 0.03, "(no span)": 0.02,
                                "sdt.dispatch": 0.02}, abs=1e-5)


def test_fetch_host_ms_reads_the_window_batches(recorder, trace_file):
    """The warm-up (it captured) and a batch fetched inside the traced
    stretch are left out; the rest's mean host ms."""
    path, base = trace_file
    t = 30_000 * MS

    def batch(a, host_ms, capture=False):
        root = profiling.record("sdt.dispatch", a, a + 50 * MS)
        if capture:
            profiling.record("sdt.graph.capture", a, a + 40 * MS, root)
        fetch = profiling.record("sdt.fetch", a + 100 * MS,
                                 a + int((150 + host_ms) * MS), root)
        profiling.record("sdt.fetch.wait", a + 100 * MS, a + 150 * MS, fetch)
        profiling.record("sdt.fetch.host", a + 150 * MS,
                         a + int((150 + host_ms) * MS), fetch)

    batch(t, 500.0, capture=True)
    for k, host in enumerate((30.0, 34.0, 41.0)):
        batch(t + (k + 1) * 1000 * MS, host)
    batch(t + 5000 * MS, 900.0)           # fetched in the traced stretch
    _write_trace(path, base, (30_000 + 5100, 30_000 + 6000),
                 [(35_100, 35_200)])
    run = _run(trace={"window_s": 0.9, "busy_s": 0.1})
    got = _reader("fetch_host_ms").read(run)
    assert got == pytest.approx((30.0 + 34.0 + 41.0) / 3)
    (line,) = [s for s in run.logs if s.startswith("program spans")]
    assert "over 3 batches" in line and '"sdt.fetch.wait": 50.0' in line


@pytest.mark.parametrize("name", ["replay_block_ms.serve", "fetch_host_ms"])
def test_readers_return_none_without_spans(name, recorder, trace_file,
                                           monkeypatch):
    """As on a commit without the recorder: no ``profiling.spans``; and
    neither logs an idle line."""
    path, base = trace_file
    _write_trace(path, base, (0, 10), [(0, 5)])
    run = _run(types.SimpleNamespace(window_dispatches=[(0.0, 1.0, 1)]),
               {"window_s": 0.01, "busy_s": 0.005})
    assert _reader(name).read(run) is None       # an empty recorder
    monkeypatch.delattr(profiling, "spans")
    profiling.record("sdt.dispatch", 0, MS)
    assert _reader(name).read(run) is None
    assert not run.logs
