"""One run of one cell: set-up, the measured window, the traced stretch and
per-layer metrics (``--trace 1``), the check against the reference, and
the result line. Device-agnostic below ``run.py``'s look for a GPU, so the
CPU tests drive it at tiny sizes."""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import torch

from . import check
from . import trace as tracing
from .spec import ROOT


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """nvidia-smi's name, power limit, clocks, draw and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launch_line(cell, system, load) -> None:
    records = getattr(load, "records", None)
    if not records:
        return
    seen = {}
    for rec in records:
        for k, v in rec["launches"].items():
            lo, hi = seen.get(k, (v, v))
            seen[k] = (min(lo, v), max(hi, v))
    got = {k: (lo if lo == hi else f"{lo}..{hi}")
           for k, (lo, hi) in seen.items() if hi}
    log(f"launches per batch over {len(records)} batches: {got}; expected "
        f"{system.expected_launches()}")


def _launches() -> dict:
    from safe_denoiser_tpu_torch import ops
    return dict(ops.launch_counts())


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             started=None) -> dict:
    started = started or (lambda t0=time.perf_counter():
                          time.perf_counter() - t0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
    t0 = time.perf_counter()
    system = cell.family().System(cell.config, cell.traffic, seed, device)
    _sync(device)
    built = time.perf_counter() - t0
    load = cell.load().Load(system, cell.traffic, seed)
    t0 = time.perf_counter()
    load.warm_up()
    _sync(device)
    setup_s = started()
    log(f"set-up {setup_s:.3f} s: pipeline and weights {built:.3f} s, "
        f"warm-up batch {time.perf_counter() - t0:.3f} s")

    e2e = load.window(seconds)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    _launch_line(cell, system, load)
    shown = {k: v for k, v in e2e.items() if k != "latencies"}
    log(f"window: {json.dumps(shown)}")
    if getattr(load, "records", None):
        log(f"stage ms of the window's batches: "
            f"{[r['stage_ms'] for r in load.records[:3]]} ...")

    metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
               for m in cell.end_to_end if m["name"] != "setup_s"}
    metrics["setup_s"] = {"value": float(setup_s), "unit": "s"}
    traced = None
    if trace:
        traced = {}
        if cuda:
            before = _launches()
            traced = tracing.traced(
                lambda: load.traced(float(cell.traffic["trace_seconds"])),
                str(ROOT / "build" / "bench" / "trace.json"))
            after = _launches()
            traced["launches"] = {k: after[k] - before.get(k, 0)
                                  for k in after}
        log(f"traced stretch: busy_s {traced.get('busy_s')} window_s "
            f"{traced.get('window_s')} read in {traced.get('read_s')} s")
        run = types.SimpleNamespace(cell=cell, system=system, load=load,
                                    e2e=e2e, trace=traced, device=device,
                                    log=log)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}

    t0 = time.perf_counter()
    correct, compared, found = check.compare(load, system, cell.limits,
                                             seed)
    log(f"check: candidate numbers {found}, reference "
        f"{time.perf_counter() - t0:.1f} s")
    result = {"correct": bool(correct), "attempted": int(e2e["attempted"]),
              "failed": int(e2e["failed"]), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device) if cuda
                                  else "cpu"),
                         "count": int(cell.entry["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if traced:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["candidates"] = found
    result["checked"] = compared
    return result


def print_checked(result: dict) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for name, c in result["checked"].items():
        log(f"checked {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")

