"""The traced sub-window: ``torch.profiler`` over a stretch of the cell's
own traffic, its Chrome trace read back for the device's busy time, the
operations that took most of it and the longest idle gaps by what the
host was doing (the benchmark's ``bench.*`` spans and the innermost host
call at each gap)."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TOP = 10
_GAPS = 100        # the longest idle gaps labelled by the host's work


def _merge(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Host:
    """Host spans of a trace, for asking what the host did at a time."""

    def __init__(self, spans: list):
        self.names = [n for n, _, _, _ in spans]
        self.bench = np.array([n.startswith("bench.") for n in self.names],
                              dtype=bool)
        self.start = np.array([a for _, _, a, _ in spans], dtype=np.float64)
        self.end = np.array([b for _, _, _, b in spans], dtype=np.float64)

    def at(self, t: float) -> str:
        """The innermost benchmark span and the innermost other host call
        over time ``t`` (us), as "span/call"."""
        over = (self.start <= t) & (self.end >= t)
        label = []
        for kind in (self.bench, ~self.bench):
            idx = np.flatnonzero(over & kind)
            if idx.size:
                inner = idx[np.argmin(self.end[idx] - self.start[idx])]
                label.append(self.names[inner])
        return "/".join(label) or "(no host span)"


def read(path: str) -> dict:
    """busy_s, window_s and the breakdown of a Chrome trace whose window
    is its "bench.traced" span, and "kernels": {name: [launches, seconds]}
    of every device operation in it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window, device, spans = None, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in _DEVICE_CATS:
            device.append((a, b, name))
        elif name == "bench.traced" and cat == "user_annotation":
            window = (a, b)
        else:
            spans.append((name, cat, a, b))
    if window is None or not device:
        return {}
    lo, hi = window
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device
              if b > lo and a < hi]
    merged = _merge([[a, b] for a, b, _ in inside])
    busy = sum(b - a for a, b in merged)
    by_op: dict = defaultdict(float)
    kernels: dict = defaultdict(lambda: [0, 0.0])
    for a, b, n in inside:
        by_op[n[:160]] += (b - a) * 1e-6
        kernels[n][0] += 1
        kernels[n][1] += (b - a) * 1e-6
    gaps = [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]
    if merged:
        gaps = [(lo, merged[0][0])] + gaps + [(merged[-1][1], hi)]
    host = _Host([s for s in spans if s[1] in (
        "cpu_op", "user_annotation", "cuda_runtime")])
    by_host: dict = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:_GAPS]:
        if b > a:
            by_host[host.at((a + b) / 2)[:160]] += (b - a) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:_TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:_TOP]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle],
            "kernels": dict(kernels)}


def traced(fn, path: str) -> dict:
    """Run ``fn()`` under the profiler inside a "bench.traced" span and
    read its trace (written to ``path``)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.traced"):
            fn()
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.export_chrome_trace(path)
    out = read(path)
    out["read_s"] = time.perf_counter() - t0
    return out
