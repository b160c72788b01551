"""Serving-plane tracing — request lifecycles across router and replicas
(the port's own copy of ``horovod_tpu.tracing.serve``).

Every ``/v1/infer`` and ``/v1/generate`` request gets a trace ID at the
frontend and carries it through the batcher, the replica RPCs and the LLM
plane's admit/prefill/handoff/decode/retire lifecycle. The ID scheme is
``req:<kind>:<rid>`` (requests) and ``it:<proc>:<n>`` (decode-iteration /
batch spans) — colon-separated, never containing ``#``, so serving IDs
can NEVER collide with the training planes' ``<tensor>#<seq>`` scheme and
the two families merge into one trace safely.

:class:`ServeTracer` is the per-process emission point: it writes spans
through a :class:`~.recorder.TraceRecorder` when ``HOROVOD_TRACE_DIR`` is
set (file ``spans-<proc>.jsonl``; the collector gives each proc its own
Perfetto process row) and ALWAYS retains them in the process flight ring
(tracing/flight.py) — with tracing off the cost is one dict build plus a
ring memcpy, which is what keeps the per-iteration decode span cheap.

Replica clocks align to the router over the authenticated ``BasicService``
channels: the router runs the NTP exchange against the replica's built-in
``clock_probe`` responder (runner/network.py) and pushes the resulting
offset back with a ``clock_align`` RPC; the replica re-announces it in its
span file's meta line, exactly like a training rank's coordinator offset.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from . import flight as _flight
from .recorder import TraceRecorder, proc_span_path


def serve_trace_id(kind: str, rid) -> str:
    """The canonical serving trace ID: request ``rid`` of plane ``kind``
    (``gen`` for /v1/generate, ``infer`` for /v1/infer)."""
    return f"req:{kind}:{rid}"


class ServeTracer:
    """One serving process's span emitter (router or replica)."""

    def __init__(self, proc: str) -> None:
        self.proc = str(proc)
        self.flight = _flight.init_flight(self.proc)
        self._rec: Optional[TraceRecorder] = None
        trace_dir = os.environ.get("HOROVOD_TRACE_DIR", "")
        if trace_dir:
            # Line-buffered: serving span rates are modest (an iteration,
            # not a token, is the unit) and a SIGKILL'd replica must leave
            # its spans on disk for the debug bundle's merged trace.
            self._rec = TraceRecorder(
                proc_span_path(trace_dir, self.proc), rank=-1,
                proc=self.proc, buffering=1)

    @staticmethod
    def now_ns() -> int:
        return time.monotonic_ns()

    @property
    def enabled(self) -> bool:
        """True when full-trace capture is on (flight retention always is)."""
        return self._rec is not None

    def span(self, tid: str, phase: str, t0_ns: int,
             t1_ns: Optional[int] = None, **attrs) -> None:
        rec = {"tid": str(tid), "proc": self.proc, "name": str(tid),
               "op": "serve", "phase": str(phase), "t0": int(t0_ns),
               "t1": int(t1_ns if t1_ns is not None else t0_ns)}
        if attrs:
            rec.update(attrs)
        if self._rec is not None:
            self._rec.emit_raw(rec)   # recorder retains into the ring too
        else:
            self.flight.retain(rec)

    def point(self, tid: str, phase: str, **attrs) -> None:
        self.span(tid, phase, self.now_ns(), None, **attrs)

    def set_clock_offset(self, offset_ns: int) -> None:
        """The router-measured offset to ITS clock (clock_align RPC)."""
        if self._rec is not None:
            self._rec.set_clock_offset(int(offset_ns))

    def flush(self) -> None:
        if self._rec is not None:
            self._rec.flush()

    def close(self) -> None:
        if self._rec is not None:
            self._rec.close()
            self._rec = None


# -- the process singleton ----------------------------------------------------

_lock = threading.Lock()
_tracer: Optional[ServeTracer] = None


def init_serve_tracer(proc: str) -> ServeTracer:
    """Open (or return) this process's serving tracer. Idempotent per
    proc name; a later call with a different name re-points it."""
    global _tracer
    with _lock:
        if _tracer is not None and _tracer.proc == proc:
            return _tracer
        if _tracer is not None:
            _tracer.close()
        _tracer = ServeTracer(proc)
        return _tracer


def get_serve_tracer() -> Optional[ServeTracer]:
    """The process serving tracer, or None before init_serve_tracer."""
    return _tracer
