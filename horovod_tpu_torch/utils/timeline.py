"""Horovod Timeline: Chrome-tracing (catapult) JSON of per-tensor
collective phases, and ``trace(log_dir)``, both panes of a step. The
port of ``horovod_tpu/utils/timeline.py`` (``Timeline`` ``:32-160``,
``trace`` ``:167``).

``Timeline`` is the JAX package's, copied: events go into a queue drained
by a writer thread, so the caller never blocks on file IO; a full queue or
a failed write drops the event and counts it in
``horovod_timeline_dropped_total`` of the port's metrics registry. Phases
per tensor: NEGOTIATE_<OP> (with an instant event per ready rank), then
<OP> with nested activity spans; optional CYCLE_START markers. With a
``tid`` (a trace ID) an event carries ``args.trace_id``. ``close()``
drains the queue and closes the JSON array.

``trace(log_dir)`` records the device pane: a ``torch.profiler`` Chrome
trace of everything in its scope (host ops, and the card's kernels where
there is one) in ``<log_dir>/device_trace.json``; and, when the eager
engine is attached (``common/engine.py``), its host pane, this
``Timeline`` of the engine's collectives, in
``<log_dir>/host_timeline.json`` (rank 0 writes it).
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time

import torch

DEVICE_TRACE = "device_trace.json"
HOST_TIMELINE = "host_timeline.json"


class Timeline:
    def __init__(self, path: str, mark_cycles: bool = False) -> None:
        self.path = path
        self.mark_cycles_enabled = mark_cycles
        self._q: queue.Queue = queue.Queue(maxsize=1 << 20)  # capacity mirrors timeline.h:66-68
        self._stop = threading.Event()
        self._t0 = time.monotonic()
        self._tensor_pids: dict[str, int] = {}
        self._next_pid = 1
        self._lock = threading.Lock()
        # Backpressure policy: the hot path never blocks on file IO — a full
        # queue sheds the event and COUNTS the shed (docs/timeline.md), so a
        # gappy trace is diagnosable instead of silently incomplete.
        from ..metrics import registry as _metrics_registry

        self._dropped = _metrics_registry().counter(
            "horovod_timeline_dropped_total",
            help="timeline events dropped because the writer queue was "
                 "full or the writer failed")
        self._thread = threading.Thread(target=self._writer_loop, name="hvd_timeline", daemon=True)
        self._thread.start()

    @property
    def dropped(self) -> int:
        return int(self._dropped.value)

    # -- event emission (Timeline::NegotiateStart/Start/ActivityStart/End, timeline.h:83-93)

    def _ts_us(self) -> int:
        return int((time.monotonic() - self._t0) * 1e6)

    def _pid(self, name: str) -> int:
        with self._lock:
            if name not in self._tensor_pids:
                pid = self._next_pid
                self._next_pid += 1
                self._tensor_pids[name] = pid
                self._emit({"name": "process_name", "ph": "M", "pid": pid,
                            "args": {"name": name}})
            return self._tensor_pids[name]

    def _emit(self, ev: dict) -> None:
        try:
            self._q.put_nowait(ev)
        except queue.Full:  # drop rather than block the hot path
            self._dropped.inc()

    @staticmethod
    def _with_tid(ev: dict, tid) -> dict:
        if tid is not None:
            ev["args"] = {"trace_id": tid}
        return ev

    def negotiate_start(self, name: str, op: str, tid=None) -> None:
        pid = self._pid(name)
        self._emit(self._with_tid(
            {"name": f"NEGOTIATE_{op}", "ph": "B", "pid": pid, "tid": 0,
             "ts": self._ts_us()}, tid))

    def negotiate_rank_ready(self, name: str, rank: int) -> None:
        pid = self._pid(name)
        self._emit({"name": str(rank), "ph": "i", "pid": pid, "tid": 0,
                    "ts": self._ts_us(), "s": "p"})

    def negotiate_end(self, name: str) -> None:
        pid = self._pid(name)
        self._emit({"name": "", "ph": "E", "pid": pid, "tid": 0, "ts": self._ts_us()})

    def start(self, name: str, op: str, tid=None) -> None:
        self.negotiate_end(name)
        pid = self._pid(name)
        self._emit(self._with_tid(
            {"name": op, "ph": "B", "pid": pid, "tid": 0,
             "ts": self._ts_us()}, tid))

    def activity_start(self, name: str, activity: str) -> None:
        pid = self._pid(name)
        self._emit({"name": activity, "ph": "B", "pid": pid, "tid": 1, "ts": self._ts_us()})

    def activity_end(self, name: str) -> None:
        pid = self._pid(name)
        self._emit({"name": "", "ph": "E", "pid": pid, "tid": 1, "ts": self._ts_us()})

    def end(self, name: str) -> None:
        pid = self._pid(name)
        self._emit({"name": "", "ph": "E", "pid": pid, "tid": 0, "ts": self._ts_us()})

    def mark_cycle(self) -> None:
        if self.mark_cycles_enabled:
            self._emit({"name": "CYCLE_START", "ph": "i", "pid": 0, "tid": 0,
                        "ts": self._ts_us(), "s": "g"})

    # -- writer thread

    def _writer_loop(self) -> None:
        # An unwritable path (bad HOROVOD_TIMELINE, disk full) must not kill
        # the thread silently: the trace degrades to counted drops and the
        # engine keeps running — telemetry never takes the job down.
        try:
            f = open(self.path, "w")
        except OSError:
            while not (self._stop.is_set() and self._q.empty()):
                try:
                    self._q.get(timeout=0.1)
                    self._dropped.inc()
                except queue.Empty:
                    continue
            return
        with f:
            f.write("[\n")
            first = True
            while not (self._stop.is_set() and self._q.empty()):
                try:
                    ev = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    if not first:
                        f.write(",\n")
                    f.write(json.dumps(ev))
                    first = False
                    f.flush()
                except OSError:  # disk full mid-trace: shed and count
                    self._dropped.inc()
            f.write("\n]\n")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)



@contextlib.contextmanager
def trace(log_dir: str, mark_cycles: bool = False):
    """Both panes of "where did the step go" in one directory:

    - device pane: ``<log_dir>/device_trace.json``, the ``torch.profiler``
      Chrome trace of everything in the scope (the card's kernels where
      there is one; open it with Perfetto or chrome://tracing);
    - host pane: ``<log_dir>/host_timeline.json``, the attached eager
      engine's timeline of the same interval (``mark_cycles`` adds its
      cycle markers). If the engine already writes one
      (HOROVOD_TIMELINE), that file keeps recording and is left alone;
      otherwise a timeline is attached for the scope (rank 0 writes, as
      in the reference). Without an engine there is no host pane.

    Usage::

        with timeline.trace("/tmp/step_profile"):
            for _ in range(10):
                loss = step(x, y)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    from ..common import basics

    os.makedirs(log_dir, exist_ok=True)
    eng = basics._state.engine if basics.is_initialized() else None
    owned = 0
    if eng is not None:
        owned = eng.timeline_start(os.path.join(log_dir, HOST_TIMELINE),
                                   mark_cycles)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=activities) as prof:
            yield log_dir
        prof.export_chrome_trace(os.path.join(log_dir, DEVICE_TRACE))
    finally:
        if owned:
            eng.timeline_stop()
