"""Generation request plumbing: the router-side request object and
queues, and the replica-side engine thread that drives the scheduler (the
port's own copy of ``horovod_tpu.serving.llm.generator``).

``GenRequest`` is the LLM analog of ``batcher.Request`` — same
single-assignment terminal-state discipline (the first ``finish``/
``fail`` wins; a frontend 504 must never be overwritten by a late decode
completion, and a request requeued after a decode-replica death may be
completed by BOTH the old in-flight poll and the retried copy — the
deterministic model makes the results identical, the lock makes the
accounting count once).

``DecodeEngine`` runs inside a decode/both-role replica process: a
daemon thread calling :meth:`~.scheduler.IterationScheduler.step` in a
loop under one lock shared with the ``BasicService`` handler threads
(submit/poll/stats). Between productive iterations it spins hot; when
idle it backs off to a short sleep — the wake-on-enqueue shape of the
eager engine's adaptive cycle, sized for a serving loop. The engine thread
runs model code, so it makes the cache's device its current CUDA device
first.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Optional

from .kv_cache import blocks_for
from .scheduler import IterationScheduler, Sequence

_rid = itertools.count(1)


class GenRequest:
    """One generate request in flight through the router."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "enqueue_t",
                 "deadline_t", "retries", "event", "code", "tokens",
                 "error", "ttft_s", "done_t", "_lock", "tid",
                 "prefilled_t", "partial", "_cond")

    def __init__(self, prompt, max_new_tokens: int,
                 deadline_t: Optional[float] = None) -> None:
        self.rid = next(_rid)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.enqueue_t = time.monotonic()
        self.deadline_t = deadline_t
        self.retries = 0
        self.event = threading.Event()
        self.code = 0
        self.tokens: list[int] = []
        self.error = ""
        self.ttft_s: Optional[float] = None   # set once, first-writer wins
        self.done_t = 0.0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.partial: list[int] = []   # streamed prefix (poll-fed, monotone)
        self.tid = f"req:gen:{self.rid}"   # serving trace ID (tracing/serve)
        self.prefilled_t = 0.0             # handoff-span start (router clock)

    def blocks_needed(self, block_size: int) -> int:
        return blocks_for(len(self.prompt) + self.max_new_tokens,
                          block_size)

    def mark_first_token(self, now: Optional[float] = None) -> None:
        with self._lock:
            if self.ttft_s is None and not self.event.is_set():
                self.ttft_s = (now if now is not None
                               else time.monotonic()) - self.enqueue_t

    def finish(self, tokens) -> bool:
        with self._lock:
            if self.event.is_set():
                return False
            self.code = 200
            self.tokens = [int(t) for t in tokens]
            self.done_t = time.monotonic()
            if self.ttft_s is None:
                self.ttft_s = self.done_t - self.enqueue_t
            self.event.set()
            self._cond.notify_all()
            return True

    def fail(self, code: int, error: str) -> bool:
        with self._lock:
            if self.event.is_set():
                return False
            self.code, self.error = code, error
            self.done_t = time.monotonic()
            self.event.set()
            self._cond.notify_all()
            return True

    def push_tokens(self, tokens) -> bool:
        """Streaming feed (poll-driven): extend the visible token prefix.
        Monotone — an update that does not strictly extend the current
        prefix is dropped, which is what makes a post-retry replay (the
        respawned replica re-decodes the same deterministic tokens from
        the start) invisible to a streaming reader. Ignored once the
        request reached a terminal state."""
        with self._lock:
            if self.event.is_set():
                return False
            toks = [int(t) for t in tokens]
            if len(toks) <= len(self.partial) or \
                    toks[:len(self.partial)] != self.partial:
                return False
            self.partial = toks
            self._cond.notify_all()
            return True

    def wait_tokens(self, seen: int, timeout: float) -> tuple:
        """Block until more than ``seen`` tokens are visible or the
        request is terminal; returns ``(token_prefix, done)``. The
        streaming frontend loops on this to flush chunks."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while len(self.partial) <= seen and not self.event.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            return list(self.partial), self.event.is_set()

    def tpot_s(self) -> Optional[float]:
        """Time-per-output-token over the decode phase (excludes TTFT);
        None until finished or with fewer than two tokens."""
        if self.code != 200 or len(self.tokens) < 2 or self.ttft_s is None:
            return None
        decode_s = (self.done_t - self.enqueue_t) - self.ttft_s
        return max(decode_s, 0.0) / (len(self.tokens) - 1)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline_t is not None and \
            (now if now is not None else time.monotonic()) >= self.deadline_t


class GenQueue:
    """Bounded FIFO of pending work with blocking take — the prefill
    queue and the prefill->decode handoff queue (items are requests or
    (request, payload) tuples; the queue does not care)."""

    def __init__(self, cap: int = 4096) -> None:
        self.cap = cap
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def put(self, item) -> bool:
        with self._cond:
            if self._closed or len(self._q) >= self.cap:
                return False
            self._q.append(item)
            self._cond.notify()
            return True

    def put_front(self, items) -> None:
        """Requeue retried work at the FRONT (same rationale as the
        batcher: a replica death must not also cost queue position)."""
        with self._cond:
            for it in reversed(list(items)):
                self._q.appendleft(it)
            self._cond.notify_all()

    def take(self, timeout: float):
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._q:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return None
                self._cond.wait(remaining)
            return self._q.popleft()

    def items(self) -> list:
        """Locked snapshot (admission's queued-demand accounting)."""
        with self._cond:
            return list(self._q)

    def drain(self) -> list:
        with self._cond:
            items = list(self._q)
            self._q.clear()
            return items

    def close(self) -> list:
        with self._cond:
            self._closed = True
            items = list(self._q)
            self._q.clear()
            self._cond.notify_all()
            return items


class DecodeEngine:
    """The replica-side engine: one thread, one scheduler, one lock."""

    _IDLE_SLEEP_S = 0.002
    _METRICS_NOTE_EVERY = 64   # flight-ring metric-delta cadence (iters)

    def __init__(self, scheduler: IterationScheduler) -> None:
        self._sched = scheduler
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._finished: dict[int, dict] = {}   # rid -> completion record
        # Observability chaos knobs: delay every
        # decode iteration by DELAY_MS once DELAY_AFTER iterations have
        # run — a deterministic mid-load slowdown injection, the decode
        # analog of HOROVOD_FAULT_INJECT_STEP's kill.
        self._delay_s = float(os.environ.get(
            "HOROVOD_FAULT_DECODE_DELAY_MS", "") or 0.0) / 1000.0
        self._delay_after = int(os.environ.get(
            "HOROVOD_FAULT_DECODE_DELAY_AFTER", "") or 0)
        self._iters = 0

    def start(self) -> "DecodeEngine":
        self._thread = threading.Thread(target=self._run,
                                        name="hvd_llm_decode_engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        from ...tracing import flight as _flight
        from ..model import bind_device

        bind_device(self._sched.cache.device)
        while not self._stop.is_set():
            with self._lock:
                decoded = self._sched.step()
                self._collect_locked()
            if decoded:
                self._iters += 1
                if self._iters % self._METRICS_NOTE_EVERY == 0:
                    _flight.get_flight().note_metrics()
                if self._delay_s > 0 and self._iters > self._delay_after:
                    time.sleep(self._delay_s)
            else:
                time.sleep(self._IDLE_SLEEP_S)

    def stall_infos(self) -> list:
        """Stall-watchdog source (metrics/watchdog.py): when the decode
        loop has sequences RUNNING but has not completed an iteration
        since ``last_progress_t``, every stuck sequence is reported by id
        — the watchdog applies the HOROVOD_STALL_CHECK_TIME threshold."""
        from ...metrics import StallInfo

        with self._lock:
            running = list(self._sched.running)
            age = time.monotonic() - self._sched.last_progress_t
        if not running:
            return []
        return [StallInfo(name=f"seq:{s.seq_id}", op="decode", age_s=age)
                for s in running]

    def _collect_locked(self) -> None:
        while self._sched.finished:
            seq = self._sched.finished.pop()
            self._finished[seq.seq_id] = {
                "rid": seq.seq_id,
                "tokens": list(seq.out),
                "ok": seq.state == "finished",
                "error": seq.error,
                "ttft_rel_s": seq.first_token_rel_s,
                "preemptions": seq.preemptions,
            }

    # -- service-handler API (called from BasicService threads) ---------------

    def submit(self, rid: int, prompt, max_new_tokens: int, eos_id: int,
               first_token: Optional[int] = None,
               handoff: Optional[tuple] = None, front: bool = False) -> None:
        seq = Sequence(rid, prompt, max_new_tokens, eos_id=eos_id,
                       first_token=first_token, handoff=handoff)
        seq.submit_t = time.monotonic()
        with self._lock:
            self._sched.submit(seq, front=front)
            self._collect_locked()   # capacity rejections land immediately

    def poll(self) -> dict:
        with self._lock:
            self._collect_locked()
            finished = list(self._finished.values())
            self._finished.clear()
            # Token LISTS, not counts: the router pushes them into each
            # GenRequest's streaming prefix (frontend chunked flush) and
            # still derives first-token progress from the length.
            progress = {s.seq_id: list(s.out) for s in self._sched.running}
            stats = self._sched.stats()
            sequences = self._sched.sequences()
        return {"finished": finished, "progress": progress, "stats": stats,
                "sequences": sequences}

    def stats(self) -> dict:
        with self._lock:
            return self._sched.stats()
