"""Per-rank span recorder, the write side of pod-wide distributed tracing:
the port's own copy of ``horovod_tpu.tracing.recorder``.

Every rank appends one JSON object per line to
``$HOROVOD_TRACE_DIR/spans-rank<k>.jsonl``. The first line is a *meta*
record carrying the rank, the clock used, and this rank's estimated offset
to the coordinator clock (tracing/clock.py); every later line is a span:

    {"tid": "grad.0#3", "rank": 1, "name": "grad.0", "op": "allreduce",
     "phase": "wire", "t0": <ns>, "t1": <ns>, ...attrs}

Timestamps are RAW local ``time.monotonic_ns()`` readings; the port's
collectives map the CUDA events they time a collective with onto that
clock (``parallel/collectives.py``). The collector applies the meta line's
offset when merging, never the writer. Trace IDs are
``<name>#<submission-seq>``: deterministic per rank *and identical across
ranks*, because every rank issues the same collectives in the same order,
so the ID needs no wire bytes to agree.

The hot path never blocks on file IO (buffered writes under one lock,
bounded by ``HOROVOD_TRACE_MAX_SPANS``) and sheds and counts on failure
(``horovod_trace_dropped_total``) instead of taking the job down.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

# Per-rank span cap (HOROVOD_TRACE_MAX_SPANS): tracing is a diagnostic
# capture, not a permanent log — a week-long job must not fill the disk.
DEFAULT_MAX_SPANS = 1 << 20


def trace_id(name: str, seq: int) -> str:
    """The canonical trace ID: k-th submission of tensor ``name``."""
    return f"{name}#{seq}"


class TraceRecorder:
    """Appends span records for ONE process to a JSONL file. Training
    ranks are identified by ``rank``; other processes pass ``proc``, a
    stable label the collector turns into its own Perfetto process row
    (the JAX package's serving plane does so). Every record is also retained
    in the process flight ring (tracing/flight.py) — the ring is the
    always-on recent-history capture, the file is the opt-in full trace."""

    def __init__(self, path: str, rank: int, clock_offset_ns: int = 0,
                 max_spans: Optional[int] = None,
                 proc: Optional[str] = None,
                 buffering: int = 1 << 16) -> None:
        self.path = path
        self.rank = int(rank)
        self.proc = proc
        self._buffering = buffering
        self.clock_offset_ns = int(clock_offset_ns)
        self._lock = threading.Lock()
        self._f = None
        self._failed = False
        self._count = 0
        self._meta_written = False
        self._max = max_spans if max_spans is not None else int(
            os.environ.get("HOROVOD_TRACE_MAX_SPANS", "")
            or DEFAULT_MAX_SPANS)
        from ..metrics import registry as _metrics_registry

        self._dropped = _metrics_registry().counter(
            "horovod_trace_dropped_total",
            help="trace spans dropped (writer failure or span cap)")

    # -- clock ---------------------------------------------------------------

    @staticmethod
    def now_ns() -> int:
        return time.monotonic_ns()

    def set_clock_offset(self, offset_ns: int) -> None:
        """Late offset update (the estimate runs after the recorder exists;
        re-written into the meta line is not possible, so the offset is
        re-announced as a meta record — the collector takes the last one)."""
        self.clock_offset_ns = int(offset_ns)
        self._write(self._meta())

    # -- emission ------------------------------------------------------------

    def span(self, tid: str, name: str, op: str, phase: str,
             t0_ns: int, t1_ns: Optional[int] = None, **attrs) -> None:
        """Record one span; ``t1_ns=None`` makes it a point event."""
        rec = {"tid": tid, "rank": self.rank, "name": name, "op": op,
               "phase": phase, "t0": int(t0_ns),
               "t1": int(t1_ns if t1_ns is not None else t0_ns)}
        if attrs:
            rec.update(attrs)
        self._write(rec)

    def point(self, tid: str, name: str, op: str, phase: str, **attrs) -> None:
        self.span(tid, name, op, phase, self.now_ns(), None, **attrs)

    def emit_raw(self, rec: dict) -> None:
        """Record a pre-built span dict."""
        if "rank" not in rec:
            rec["rank"] = self.rank
        self._write(rec)

    def _meta(self) -> dict:
        meta = {"meta": 1, "rank": self.rank, "clock": "monotonic_ns",
                "clock_offset_ns": self.clock_offset_ns,
                "pid": os.getpid(), "time_unix_s": time.time()}
        if self.proc:
            meta["proc"] = self.proc
        return meta

    def _write(self, rec: dict) -> None:
        from . import flight as _flight

        _flight.get_flight().retain(rec)
        with self._lock:
            if self._failed or self._count >= self._max:
                self._dropped.inc()
                return
            try:
                if self._f is None:
                    os.makedirs(os.path.dirname(self.path) or ".",
                                exist_ok=True)
                    self._f = open(self.path, "a",
                                   buffering=self._buffering)
                if not self._meta_written:
                    self._meta_written = True
                    self._f.write(json.dumps(self._meta()) + "\n")
                self._f.write(json.dumps(rec) + "\n")
                self._count += 1
            except (OSError, ValueError):
                # Unwritable dir / disk full / closed file: telemetry never
                # takes the job down — degrade to counted drops.
                self._failed = True
                self._dropped.inc()

    @property
    def dropped(self) -> int:
        return int(self._dropped.value)

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except OSError:
                    pass
                self._f = None


def span_path(trace_dir: str, rank: int) -> str:
    return os.path.join(trace_dir, f"spans-rank{int(rank)}.jsonl")


def proc_span_path(trace_dir: str, proc: str) -> str:
    """Span file for a serving-plane process. ``proc`` must not start
    with ``rank`` — the collector tells the two families apart by name."""
    return os.path.join(trace_dir, f"spans-{proc}.jsonl")
