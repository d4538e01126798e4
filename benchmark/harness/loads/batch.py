"""Closed-loop batches, as the offline runners send them: fixed batches of
the mix's requests, batch k+1 dispatched before batch k is fetched
(``dispatch_batch`` then ``fetch``, the overlap of
``runners/common.run_cases``). The window runs whole batches: it
dispatches while its time lasts and ends at the last fetch.

End-to-end: ``images_per_s``, the images of all the window's batches over
the time from the window's start to its last fetch.
"""

from __future__ import annotations

import time

import torch

from .. import traffic as gen
from ..check import Served


class Load:
    def __init__(self, system, traffic: dict, seed: int):
        self.system, self.traffic, self.seed = system, traffic, seed
        self.batch = traffic["batch"]
        self.pool = gen.requests(traffic, seed)
        self._next = 0
        self.records: list = []

    def _requests(self, k: int) -> list:
        """Batch k's requests: the k-th slice of the mix's stream."""
        n = len(self.pool)
        return [self.pool[(k * self.batch + i) % n]
                for i in range(self.batch)]

    def _dispatch(self, reqs: list):
        from safe_denoiser_tpu_torch import ops
        before = ops.launch_counts()
        with torch.profiler.record_function("bench.dispatch"):
            pending = self.system.pipe.dispatch_batch(
                [r.prompt for r in reqs], [r.seed for r in reqs],
                [r.guidance for r in reqs], **self.system.dispatch_kwargs())
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        return pending, reqs, launches

    def _fetch(self, item, keep: bool) -> None:
        pending, reqs, launches = item
        with torch.profiler.record_function("bench.fetch"):
            images = pending.fetch()
        if keep:
            self.records.append({
                "requests": reqs, "images": images,
                "latents": pending.latents.float().cpu(),
                "stage_ms": dict(pending.stage_ms), "launches": launches})

    def warm_up(self) -> None:
        """One batch of the window's shapes: the first dispatch captures
        the loop's and the decode's CUDA graphs."""
        self._fetch(self._dispatch(self._requests(0)), keep=False)

    def _loop(self, seconds: float, keep: bool) -> tuple:
        """Batches while ``seconds`` last; (images, seconds to the last
        fetch)."""
        start = time.perf_counter()
        item = self._dispatch(self._requests(self._take()))
        n = 0
        while True:
            nxt = None
            if time.perf_counter() - start < seconds:
                nxt = self._dispatch(self._requests(self._take()))
            self._fetch(item, keep)
            n += len(item[1])
            if nxt is None:
                return n, time.perf_counter() - start
            item = nxt

    def _take(self) -> int:
        k = self._next
        self._next += 1
        return k

    def window(self, seconds: float) -> dict:
        images, elapsed = self._loop(seconds, keep=True)
        self.elapsed = elapsed
        return {"images_per_s": images / elapsed, "attempted": images,
                "failed": 0}

    def traced(self, seconds: float) -> None:
        """The same loop for ``seconds`` more (under the profiler)."""
        self._loop(seconds, keep=False)

    def served(self) -> list:
        """``check.Served`` of everything the window served."""
        return [Served(r, im, rec["latents"][i], i)
                for rec in self.records
                for i, (r, im) in enumerate(zip(rec["requests"],
                                                rec["images"]))]

    def release(self) -> None:
        self.system.release()
