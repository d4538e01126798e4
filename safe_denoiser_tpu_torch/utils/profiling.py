"""Profiling & tracing utilities.

Counterpart of ``safe_denoiser_tpu/utils/profiling.py`` on
``torch.profiler``. The reference has no profiling beyond wall-clock prints
(SURVEY.md §5); the port keeps the JAX package's three hooks:
  * ``trace(dir)`` — context manager around ``torch.profiler.profile``
    (CPU and, where a GPU is visible, CUDA activity) that writes a Chrome
    trace (``trace.json``) TensorBoard or Perfetto loads;
  * ``StepTimer`` — wall-clock timing with device sync, replacing the
    reference's raw time.time() pairs (run_nudity.py:414-464): ``stop``
    synchronizes the GPUs its ``result``'s tensors lie on before it reads
    the clock (JAX's ``jax.block_until_ready``); CPU tensors need nothing;
  * ``annotate`` — ``torch.profiler.record_function`` for named regions
    inside host code.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _devices(result) -> set:
    """The CUDA devices of the tensors in a (nested) result."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        out = set()
        for r in result:
            out |= _devices(r)
        return out
    latents = getattr(result, "latents", None)    # a PendingGeneration
    return _devices(latents) if latents is not None else set()


def block_until_ready(result):
    """Wait for the devices ``result``'s tensors lie on; returns it."""
    for dev in _devices(result):
        torch.cuda.synchronize(dev)
    return result


@dataclass
class StepTimer:
    """Accumulates per-step wall-clock with device synchronization."""

    sync: bool = True
    times: list[float] = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if self.sync and result is not None:
            block_until_ready(result)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self) -> dict:
        if not self.times:
            return {"n": 0}
        ts = sorted(self.times)
        return {"n": len(ts), "mean_s": self.mean, "min_s": ts[0],
                "max_s": ts[-1], "p50_s": ts[len(ts) // 2]}
