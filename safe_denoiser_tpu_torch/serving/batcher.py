"""Dynamic request batcher for serving the sampling pipelines.

Counterpart of ``safe_denoiser_tpu/serving/batcher.py`` (a copy, on the
standard library and the port's span recorder). The reference is a
one-prompt-at-a-time research loop; a deployment wants concurrent requests
grouped onto the GPU. The pipelines capture one CUDA graph per static
batch size (``pipeline/graph.py``), so the batcher runs a FIXED batch B
and pads short groups by replicating the final request (per-sample seeds
and guidance scales are graph inputs --
``SafeDiffusionPipeline.generate_batch`` -- so padding never recaptures;
pad-slot outputs are dropped). A partial group launches after
``max_delay_s`` so a lone request is never stuck waiting for neighbors.

One worker thread owns the device and makes every dispatch; callers get
``concurrent.futures.Future``s. Errors in a batch propagate to exactly the
futures of that batch; the worker keeps serving.

Spans (``utils.profiling``): the worker's ``sdt.batcher.wait`` (idle for
want of a request), ``sdt.batcher.fill`` (a group forming),
``sdt.dispatch`` (the batch's root, which the pipeline's ``dispatch_batch``
joins), ``sdt.batcher.join`` (waiting for the previous finisher), and one
``sdt.request`` a request, from its submit to the start of its batch's
dispatch, under that dispatch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class GenRequest:
    """One generation request (the per-sample traced inputs)."""

    prompt: str
    seed: int = 42
    guidance_scale: float = 7.5


class DynamicBatcher:
    """Groups submitted requests into fixed-size batches.

    Args:
      run_batch: ``(requests: list[GenRequest]) -> list[result]`` — called
        with EXACTLY ``batch_size`` requests (padded by replication); must
        return one result per request, same order.
      batch_size: the graphed batch size B.
      max_delay_s: max time the first request of a group waits for the
        group to fill before a padded partial batch launches.
      max_queue: backpressure bound; ``submit`` raises ``queue.Full`` beyond
        it (a serving layer must fail fast, not buffer unboundedly).
    """

    def __init__(self, run_batch: Callable[[List[GenRequest]], Sequence[Any]],
                 batch_size: int, max_delay_s: float = 0.05,
                 max_queue: int = 256,
                 dispatch_batch: Optional[Callable[[List[GenRequest]],
                                                   Any]] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._run_batch = run_batch
        # optional two-phase protocol: dispatch_batch(reqs) -> handle with
        # .fetch() -> results. When provided, the worker enqueues batch
        # k+1's device work BEFORE fetching batch k (same overlap the
        # runners use -- CUDA launches are asynchronous), so under sustained
        # load the GPU never idles on the host's transfer/PNG/base64 work.
        self._dispatch_batch = dispatch_batch
        self.batch_size = batch_size
        self.max_delay_s = max_delay_s
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._closed = threading.Event()
        # serializes the closed-flag transition against submit()'s
        # check-then-put, so no future can land after close() drained
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="sdt-batcher")
        self._worker.start()

    # -- client side --------------------------------------------------------
    def submit(self, request: GenRequest, timeout: Optional[float] = None
               ) -> Future:
        """Enqueue one request; the Future resolves to its result."""
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("batcher is closed")
            fut: Future = Future()
            self._q.put((request, fut, time.perf_counter_ns()),
                        timeout=timeout)
        return fut

    def close(self, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` (default) queued requests finish
        first, otherwise they fail with ``RuntimeError("batcher closed")``."""
        with self._submit_lock:
            self._closed.set()
        self._q.put(None)            # wake the worker
        self._worker.join()
        # leftovers: items enqueued after the sentinel (incl. a submit()
        # racing close()) — finish or fail them here, never dangle a Future
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            req, fut, _ = item
            if not drain:
                fut.set_exception(RuntimeError("batcher closed"))
                continue
            try:
                fut.set_result(
                    self._run_batch([req] * self.batch_size)[0])
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

    # -- worker side ---------------------------------------------------------
    def _take_group(self):
        """Collect up to batch_size items; first item starts the deadline."""
        with profiling.span("sdt.batcher.wait"):
            item = self._q.get()
        if item is None:
            return None
        group = [item]
        with profiling.span("sdt.batcher.fill"):
            t_end = time.monotonic() + self.max_delay_s
            while len(group) < self.batch_size:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)    # re-post the sentinel for the loop
                    break
                group.append(nxt)
        return group

    @staticmethod
    def _dispatch(fn, padded, submitted):
        """``fn(padded)`` inside the batch's ``sdt.dispatch`` span, each
        request's ``sdt.request`` (its submit to this start) under it."""
        with profiling.span("sdt.dispatch") as root:
            for t in submitted:
                profiling.record("sdt.request", t, root.start_ns, root.id)
            return fn(padded)

    def _resolve(self, futs, results_or_exc) -> None:
        # a client may have cancelled its Future (e.g. an HTTP handler
        # timing out); set_result on a cancelled Future raises
        # InvalidStateError, which must never kill the worker thread
        from concurrent.futures import InvalidStateError

        if isinstance(results_or_exc, Exception):
            for f in futs:
                try:
                    f.set_exception(results_or_exc)
                except InvalidStateError:
                    pass
            return
        for f, r in zip(futs, results_or_exc):
            try:
                f.set_result(r)
            except InvalidStateError:
                pass

    def _finish(self, pending) -> None:
        futs, handle = pending
        try:
            results = handle.fetch()
            if len(results) != self.batch_size:
                raise RuntimeError(
                    f"dispatch_batch handle returned {len(results)} results "
                    f"for batch_size {self.batch_size}")
        except Exception as e:  # noqa: BLE001 -- propagate to callers
            self._resolve(futs, e)
            return
        self._resolve(futs, results)

    def _loop(self) -> None:
        # Two-phase mode resolves each dispatched batch on a short-lived
        # finisher thread: batch k's futures resolve as soon as its device
        # work + transfer completes, even while the worker blocks in
        # _take_group waiting for batch k+1's group to fill (fetching only
        # reads device buffers -- all DISPATCHES stay on this worker, which
        # is the thread-safety contract that matters). At most one finisher
        # is alive: the worker joins it before starting the next, so there
        # is never more than one batch in flight plus one being fetched.
        finisher: Optional[threading.Thread] = None
        while True:
            group = self._take_group()
            if group is None:
                if finisher is not None:
                    finisher.join()
                break
            reqs = [r for r, _, _ in group]
            futs = [f for _, f, _ in group]
            submitted = [t for _, _, t in group]
            padded = reqs + [reqs[-1]] * (self.batch_size - len(reqs))
            if self._dispatch_batch is not None:
                try:
                    handle = self._dispatch(self._dispatch_batch, padded,
                                            submitted)
                except Exception as e:  # noqa: BLE001
                    self._resolve(futs, e)
                    continue
                with profiling.span("sdt.batcher.join"):
                    if finisher is not None:
                        finisher.join()
                finisher = threading.Thread(
                    target=self._finish, args=((futs, handle),),
                    daemon=True, name="sdt-batcher-finish")
                finisher.start()
                continue
            try:
                results = self._dispatch(self._run_batch, padded, submitted)
                if len(results) != self.batch_size:
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"batch_size {self.batch_size}")
            except Exception as e:  # noqa: BLE001 -- propagate to callers
                self._resolve(futs, e)
                continue
            self._resolve(futs, results)
        # leftovers after the close() sentinel are handled by close() itself
