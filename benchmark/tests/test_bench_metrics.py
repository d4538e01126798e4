"""The metric arithmetic on synthetic timings: a rate over whole batches,
percentiles over all requests with failures counted as misses, roofline
and idle shares, and the trace reader."""

import json
import types
from concurrent.futures import Future

import numpy as np
import pytest

from benchmark.harness import device as dev
from benchmark.harness import readers
from benchmark.harness import trace as tracing
from benchmark.harness.loads import batch, open as open_loop


class FakePending:
    def __init__(self, clock, n, loop_ms):
        self.clock, self.n, self.loop_ms = clock, n, loop_ms
        import torch
        self.latents = torch.zeros(n, 1)
        self.stage_ms = None

    def fetch(self):
        self.clock.t += self.loop_ms / 1e3
        self.stage_ms = {"encode": 1.0, "loop": self.loop_ms, "decode": 2.0}
        return [np.zeros((2, 2, 3), np.uint8)] * self.n


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def test_rate_counts_whole_batches_over_time_to_last_fetch(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(batch.time, "perf_counter", clock)
    pipe = types.SimpleNamespace(dispatch_batch=lambda p, s, g, **kw:
                                 FakePending(clock, len(p), 500.0))
    system = types.SimpleNamespace(pipe=pipe, dispatch_kwargs=dict)
    mix = {"batch": 4, "pool": 16, "prompt_words": [1, 2], "words": ["a"],
           "guidance": [7.5]}
    drv = batch.Load(system, mix, seed=3)
    out = drv.window(1.2)
    # dispatched at 0.0, 0.0 (ahead), 0.5, 1.0; fetched at .5, 1, 1.5, 2
    assert out["attempted"] == 16
    assert out["images_per_s"] == pytest.approx(16 / 2.0)
    assert len(drv.records) == 4
    run = types.SimpleNamespace(load=drv)
    assert readers.stage_mean(run, "loop") == pytest.approx(500.0)


def _offered(latencies, failed_at=()):
    rows = []
    for i, lat in enumerate(latencies):
        fut = Future()
        box = []
        if i not in failed_at:
            fut.set_result(np.zeros((1, 1, 3), np.uint8))
            box.append(10.0 + i + lat)
        rows.append((None, None, 10.0 + i, fut if i not in failed_at
                     else None, box))
    return rows


def test_percentiles_count_failures_as_misses():
    drv = open_loop.Load.__new__(open_loop.Load)
    lat = [0.5] * 18 + [1.0, 2.0]
    out = drv._stats(_offered(lat), start=10.0, give_up=100.0)
    assert out["failed"] == 0 and out["attempted"] == 20
    assert out["latency_p50_s"] == pytest.approx(0.5)
    assert out["latency_p90_s"] == pytest.approx(np.percentile(lat, 90))
    # three of twenty never served: their latency runs to the give-up
    out = drv._stats(_offered(lat, failed_at=(0, 1, 2)), start=10.0,
                     give_up=100.0)
    assert out["failed"] == 3
    assert out["latency_p90_s"] > 80.0
    assert out["images_per_s"] == pytest.approx(17 / (10.0 + 19 + 2.0 - 10.0))


def test_trace_roofline_weights_the_stretchs_launches():
    kernels = {"void sdt_attn::attn_kernel<48, false>(int)": [30, 0.06],
               "void sdt_attn::attn_kernel<80, false>(int)": [10, 0.02],
               "void other_kernel(int)": [5, 1.0]}
    calls = [(1.0, 3), (0.5, 1)]         # a batch: 3 of 1 ms, 1 of 0.5 ms

    def share(launches, found=kernels):
        run = types.SimpleNamespace(
            trace={"launches": {"attention": launches}, "kernels": found},
            log=lambda msg: None)
        return dev.trace_roofline(run, "attention", "attn_kernel<", calls)

    # 10 whole batches: 35 ms of bound over 80 ms on the device
    assert share(40) == pytest.approx(100 * 35 / 80)
    assert share(0) is None                      # nothing launched
    assert share(44) is None                     # the kernel is not the op's
    assert share(40, {"void other_kernel(int)": [40, 1.0]}) is None
    assert dev.bound_ms(3.35e12, 0.0) == pytest.approx(1e3)
    assert dev.bound_ms(0.0, 989e12) == pytest.approx(1e3)
    assert dev.attention_ops(8, 4096, 8, 40) == 4 * 8 * 8 * 4096 ** 2 * 40
    assert dev.conv3x3_bytes(1, 2, 2, 128, 128, True) == 2 * (
        4 * 128 + 9 * 128 * 128 + 2 * 4 * 128)


def test_trace_reader(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.traced",
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "bench.dispatch",
           "ts": 100, "dur": 300},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
           "ts": 150, "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 400, "dur": 600},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.traced",
           "ts": 0, "dur": 5000}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    out = tracing.read(str(path))
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx(750e-6)
    assert out["device_ops"][0] == ["k1", pytest.approx(700e-6)]
    assert out["idle_gaps"] == [["bench.dispatch/cudaGraphLaunch",
                                 pytest.approx(250e-6)]]
    run = types.SimpleNamespace(trace=out)
    assert readers.idle_share(run) == pytest.approx(25.0)
