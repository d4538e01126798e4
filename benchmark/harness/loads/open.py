"""An open loop of independent users: single-prompt requests with their own
seeds and guidance, due on the mix's seeded schedule at its fixed rate
(``traffic.arrivals``, the same for every run seed), submitted to the
port's ``DynamicBatcher`` over the pipeline's two-phase ``dispatch_batch``,
as ``runners/serve.py`` wires them (HTTP and PNG encoding left out).

Each request is timed from its due time to the moment its future
resolved. A request refused by the batcher (``queue.Full``) or not served
by ``grace_s`` after the window's end counts as failed, its latency the
time from its due time to that give-up. Load goes on being offered after
the window until every request due in it has resolved, so the last ones
see the same load as the first.

End-to-end: ``latency_p90_s`` and ``latency_p50_s`` over every request
due in the window, and ``images_per_s``, the window's requests served
over the time from its start to the last of them.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .. import traffic as gen
from ..check import Served


def percentile(values, q: float) -> float:
    """The q-th percentile (linear interpolation, numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Load:
    def __init__(self, system, traffic: dict, seed: int):
        from safe_denoiser_tpu_torch.serving import DynamicBatcher
        self.system, self.traffic, self.seed = system, traffic, seed
        self.batch = traffic["batch"]
        self.pool = gen.requests(traffic, seed)
        self._taken = 0
        self.run_batch = system.serve_fn(self.batch)
        self.dispatches: list = []          # (start, end, real rows)
        self.started: dict = {}             # id(GenRequest) -> start
        self.rows: dict = {}                # id(GenRequest) -> its row
        self._lock = threading.Lock()
        inner = self.run_batch.dispatch_batch

        def timed_dispatch(reqs):
            # the real rows: the batcher pads with the last one, repeated
            real = next(i for i, r in enumerate(reqs) if r is reqs[-1]) + 1
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.dispatch"):
                handle = inner(reqs)
            t1 = time.perf_counter()
            with self._lock:
                self.dispatches.append((t0, t1, real))
                for i, r in enumerate(reqs[:real]):
                    self.started[id(r)] = t0
                    self.rows[id(r)] = i
            return handle

        self.batcher = DynamicBatcher(
            self.run_batch, self.batch,
            max_delay_s=traffic["max_delay_ms"] / 1000.0,
            max_queue=traffic["max_queue"], dispatch_batch=timed_dispatch)

    def _gen_request(self):
        from safe_denoiser_tpu_torch.serving import GenRequest
        r = self.pool[self._taken % len(self.pool)]
        self._taken += 1
        return r, GenRequest(prompt=r.prompt, seed=r.seed,
                             guidance_scale=r.guidance)

    def warm_up(self) -> None:
        """A full padded batch through the two-phase hook: captures the
        graphs every later batch replays."""
        from safe_denoiser_tpu_torch.serving import GenRequest
        r = self.pool[0]
        self.run_batch.dispatch_batch(
            [GenRequest(prompt=r.prompt, seed=r.seed,
                        guidance_scale=r.guidance)] * self.batch).fetch()

    def _offer(self, due: np.ndarray, start: float, until) -> list:
        """Submit a request at each due time (s after ``start``) while
        ``until()`` is false; [(request, GenRequest, due, future or None,
        done box)]."""
        out = []
        for d in due:
            if until():
                break
            wait = start + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            mine, req = self._gen_request()
            box: list = []
            try:
                fut = self.batcher.submit(req, timeout=0)
            except queue.Full:
                fut = None
            else:
                fut.add_done_callback(
                    lambda f, box=box: box.append(time.perf_counter()))
            out.append((mine, req, start + d, fut, box))
        return out

    def _run(self, seconds: float, keep: bool) -> dict:
        grace = float(self.traffic["grace_s"])
        start = time.perf_counter()
        offered = self._offer(gen.arrivals(self.traffic, seconds), start,
                              lambda: False)
        end = start + seconds
        give_up = end + grace

        def settled():
            return (all(f is None or f.done() for _, _, _, f, _ in offered)
                    or time.perf_counter() > give_up)

        # keep the load on until the window's requests have resolved
        more = self._offer(end - start + gen.arrivals(
            self.traffic, grace, "after"), start, settled)
        while not settled():
            time.sleep(0.01)
        # let the batcher drain what was offered after the window, so the
        # next phase finds the card idle
        limit = time.perf_counter() + grace
        while (time.perf_counter() < limit
               and not all(f is None or f.done() for _, _, _, f, _ in more)):
            time.sleep(0.01)
        if keep:
            self.offered = offered
        return self._stats(offered, start, give_up)

    def _stats(self, offered: list, start: float, give_up: float) -> dict:
        lat, done_at, failed = [], [], 0
        for _, _, due, fut, box in offered:
            ok = (fut is not None and fut.done() and not fut.cancelled()
                  and fut.exception() is None and box)
            if ok:
                lat.append(box[0] - due)
                done_at.append(box[0])
            else:
                failed += 1
                lat.append(give_up - due)
        last = max(done_at) if done_at else give_up
        return {"latency_p90_s": percentile(lat, 90),
                "latency_p50_s": percentile(lat, 50),
                "images_per_s": len(done_at) / (last - start),
                "attempted": len(offered), "failed": failed,
                "latencies": lat}

    def window(self, seconds: float) -> dict:
        self.dispatches.clear()
        self.started.clear()
        self.rows.clear()
        self.result = self._run(seconds, keep=True)
        self.window_dispatches = list(self.dispatches)
        return self.result

    def traced(self, seconds: float) -> None:
        self._run(seconds, keep=False)

    def served(self) -> list:
        """``check.Served`` of every request due in the window that was
        served."""
        out = []
        for mine, req, _, fut, box in self.offered:
            if fut is not None and fut.done() and not fut.cancelled() \
                    and fut.exception() is None and box:
                out.append(Served(mine, fut.result(), None,
                                  self.rows[id(req)]))
        return out

    def queue_waits(self) -> list:
        """Seconds from each served window request's due time to the start
        of its batch's dispatch."""
        return [self.started[id(req)] - due
                for _, req, due, fut, box in self.offered
                if box and id(req) in self.started]

    def release(self) -> None:
        self.batcher.close(drain=False)
        self.__dict__.pop("batcher", None)
        self.__dict__.pop("run_batch", None)
        self.system.release()
