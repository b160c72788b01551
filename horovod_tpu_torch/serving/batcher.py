"""Continuous batcher — coalesces queued requests into padded device batches.

The scheduling model is Orca-style continuous batching (Yu et al., OSDI
2022) restated for whole-request inference: there is no fixed batching
clock. A replica that becomes free *pulls* a batch — it takes whatever is
queued right now (up to ``HOROVOD_SERVE_MAX_BATCH``), waiting at most
``HOROVOD_SERVE_MAX_WAIT_MS`` for companions when the queue is shallow.
Under load, batches therefore form exactly as fast as replicas can retire
them (coalescing grows with queue depth); at low load a request pays at
most one ``max_wait`` of batching latency.

Padding buckets: device batches are padded up to a power-of-two bucket
size (``bucket_sizes``), so XLA sees a bounded set of batch shapes —
recompiles are bounded by ``log2(max_batch)`` per example shape and
counted by the replica (``horovod_serve_recompiles_total``), the same
shape-discipline as the training side's fusion buckets.

Requests whose deadline expires while queued are failed with 504 at
dispatch time (they never waste a device slot); the SLO-aware *admission*
decision that keeps the queue from growing past the SLO in the first
place lives in admission.py.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from ..metrics import registry as _registry

_rid = itertools.count(1)


class Request:
    """One in-flight inference request. Thread-safe single-assignment
    terminal state: the FIRST ``finish``/``fail`` wins (returns True) and
    later transitions are ignored — a request abandoned by the frontend at
    its deadline must not be double-counted when a replica later completes
    it, and a replica completing a batch must not overwrite a 504."""

    __slots__ = ("rid", "x", "enqueue_t", "deadline_t", "retries",
                 "event", "code", "output", "error", "_lock", "tid")

    def __init__(self, x: np.ndarray, deadline_t: Optional[float] = None):
        self.rid = next(_rid)
        self.x = x
        self.tid = f"req:infer:{self.rid}"  # serving trace ID (tracing/serve)
        self.enqueue_t = time.monotonic()
        self.deadline_t = deadline_t
        self.retries = 0
        self.event = threading.Event()
        self.code = 0
        self.output: Optional[np.ndarray] = None
        self.error = ""
        self._lock = threading.Lock()

    def finish(self, output: np.ndarray) -> bool:
        with self._lock:
            if self.event.is_set():
                return False
            self.code, self.output = 200, output
            self.event.set()
            return True

    def fail(self, code: int, error: str) -> bool:
        with self._lock:
            if self.event.is_set():
                return False
            self.code, self.error = code, error
            self.event.set()
            return True

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline_t is not None and \
            (now if now is not None else time.monotonic()) >= self.deadline_t


# -- padding buckets ---------------------------------------------------------


def bucket_sizes(max_batch: int) -> tuple:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself — the
    complete set of device batch shapes the server will ever compile."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = set()
    b = 1
    while b < max_batch:
        sizes.add(b)
        b *= 2
    sizes.add(max_batch)
    return tuple(sorted(sizes))


def bucket_for(n: int, sizes: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` requests."""
    for s in sizes:
        if s >= n:
            return s
    raise ValueError(f"batch of {n} exceeds the largest bucket {sizes[-1]}")


def pad_batch(xs: Sequence[np.ndarray], bucket: int) -> np.ndarray:
    """Stack ``xs`` along a new leading batch dim, zero-padded to
    ``bucket`` rows (padding rows are dead compute the replica slices
    away; n_valid travels with the batch)."""
    arr = np.stack(xs)
    if len(xs) > bucket:
        raise ValueError(f"{len(xs)} examples exceed bucket {bucket}")
    if len(xs) < bucket:
        pad = np.zeros((bucket - len(xs),) + arr.shape[1:], arr.dtype)
        arr = np.concatenate([arr, pad])
    return arr


class ContinuousBatcher:
    """The shared request queue + the pull-side coalescing policy."""

    def __init__(self, cfg, reg=None):
        self.cfg = cfg
        reg = reg or _registry()
        self._q: deque[Request] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._depth_gauge = reg.gauge(
            "horovod_serve_queue_depth",
            help="requests queued awaiting a device batch")
        self._batch_hist = reg.histogram(
            "horovod_serve_batch_size",
            help="valid requests per dispatched device batch "
                 "(mean = sum/count is the coalescing figure)",
            buckets=tuple(float(b) for b in bucket_sizes(max(cfg.max_batch,
                                                            128))))
        self._batches_c = reg.counter(
            "horovod_serve_batches_total",
            help="device batches dispatched to replicas")
        self._expired_504 = reg.counter(
            "horovod_serve_requests_total",
            help="terminal request outcomes by HTTP-style code", code="504")

    # -- producer side -------------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def submit(self, req: Request) -> bool:
        """Enqueue; False when the queue is at ``queue_cap`` or the server
        is shutting down (callers translate to 429/503)."""
        with self._cond:
            if self._closed or len(self._q) >= self.cfg.queue_cap:
                return False
            self._q.append(req)
            self._depth_gauge.set(len(self._q))
            self._cond.notify_all()
            return True

    def requeue_front(self, reqs: Sequence[Request]) -> None:
        """Put retried requests back at the FRONT (they have been waiting
        longest; a replica death must not also cost them their queue
        position)."""
        with self._cond:
            for r in reversed(list(reqs)):
                self._q.appendleft(r)
            self._depth_gauge.set(len(self._q))
            self._cond.notify_all()

    # -- consumer side (replica workers) ------------------------------------

    def take_batch(self, timeout: float) -> Optional[list]:
        """Block up to ``timeout`` for work; once the first request is in
        hand, coalesce for at most ``max_wait_ms`` or until ``max_batch``
        are available, then take min(queued, max_batch). Returns None when
        the wait timed out (callers re-check drain/shutdown flags) and []
        only if every taken request had already expired."""
        arm_deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                self._drop_expired_locked()
                if self._q:
                    break
                remaining = arm_deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return None
                self._cond.wait(remaining)
            coalesce_deadline = time.monotonic() \
                + self.cfg.max_wait_ms / 1000.0
            while len(self._q) < self.cfg.max_batch and not self._closed:
                remaining = coalesce_deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            now = time.monotonic()
            batch: list[Request] = []
            while self._q and len(batch) < self.cfg.max_batch:
                r = self._q.popleft()
                if r.expired(now):
                    if r.fail(504, "deadline exceeded while queued"):
                        self._expired_504.inc()
                    continue
                batch.append(r)
            self._depth_gauge.set(len(self._q))
        if batch:
            self._batch_hist.observe(float(len(batch)))
            self._batches_c.inc()
        return batch

    def _drop_expired_locked(self) -> None:
        now = time.monotonic()
        while self._q and self._q[0].expired(now):
            r = self._q.popleft()
            if r.fail(504, "deadline exceeded while queued"):
                self._expired_504.inc()
        self._depth_gauge.set(len(self._q))

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Fail everything still queued with 503 and wake all waiters."""
        with self._cond:
            self._closed = True
            while self._q:
                self._q.popleft().fail(503, "server shutting down")
            self._depth_gauge.set(0)
            self._cond.notify_all()
