"""Stall / straggler watchdog with the reference's ``HOROVOD_STALL_CHECK``
semantics: the port's own copy of ``horovod_tpu.metrics.watchdog``.

The reference's CheckForStalledTensors warns when a tensor has been
submitted by a subset of ranks for longer than
``HOROVOD_STALL_CHECK_TIME``, naming the tensor and the missing ranks, and
``HOROVOD_STALL_SHUTDOWN_TIME`` escalates to aborting the job. Here that
logic lives on its own thread so it keeps reporting while the training
thread is blocked in a wait:

- **sources** are callbacks returning the current in-flight set
  (:class:`StallInfo` per tensor). ``init`` registers the port's
  collectives in flight (``parallel/collectives.py``: the end event has
  not completed, or, on gloo, the work has not). No rank knows which
  ranks are missing, so ``missing_ranks`` stays None.
- every poll, tensors older than ``check_time_s`` produce a warning (rate
  limited to one per tensor per window) and refresh the structured
  **report** published at ``registry().get_info("stall_report")``.
- past ``shutdown_time_s`` (0 disables, the default) the ``on_abort``
  callback fires once per tensor: the port aborts the communicators, so
  the training loop gets ``HorovodInternalError`` instead of an eternal
  hang.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .registry import MetricsRegistry, registry
from ..utils.logging import log


@dataclass
class StallInfo:
    name: str
    op: str
    age_s: float
    missing_ranks: Optional[list] = None   # None = unknown (non-coordinator)


@dataclass
class StallReport:
    time_unix_s: float
    rank: int
    text: str
    stalled: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "time_unix_s": self.time_unix_s,
            "rank": self.rank,
            "text": self.text,
            "stalled": [
                {"name": s.name, "op": s.op, "age_s": round(s.age_s, 3),
                 "missing_ranks": s.missing_ranks}
                for s in self.stalled
            ],
        }


def format_report(stalled: list, check_time_s: float) -> str:
    parts = []
    for s in stalled:
        missing = ("missing ranks: " +
                   ", ".join(str(r) for r in s.missing_ranks)
                   if s.missing_ranks else "missing ranks unknown on this rank")
        parts.append(f"{s.name} ({s.op}, waiting {s.age_s:.1f}s, {missing})")
    return (
        "One or more tensors were submitted to be reduced, gathered or "
        "broadcasted by subset of ranks and are waiting for the remainder "
        f"for more than {check_time_s:g} seconds. Stalled ops: "
        + "; ".join(parts)
    )


class StallWatchdog:
    def __init__(self, check_time_s: float, shutdown_time_s: float = 0.0,
                 rank: int = 0,
                 on_abort: Optional[Callable[[StallInfo], None]] = None,
                 reg: Optional[MetricsRegistry] = None,
                 poll_interval_s: Optional[float] = None,
                 on_warn: Optional[Callable[[list], None]] = None,
                 event_sink: Optional[Callable[[dict], None]] = None) -> None:
        self.check_time_s = float(check_time_s)
        self.shutdown_time_s = float(shutdown_time_s)
        self.rank = rank
        self.on_abort = on_abort
        # Optional escalation hook fired once per fresh warning batch.
        self.on_warn = on_warn
        # Telemetry-tree forwarding: fresh warn batches are also handed to
        # this sink as the structured flight-style event dict; the rank's
        # telemetry client (telemetry/agent.py RankTelemetryClient
        # .event_sink) batches them to the host leader instead of every
        # rank opening its own connection to the root.
        self.event_sink = event_sink
        self.reg = reg or registry()
        # Poll a few times per warning window so a stall is reported within
        # ~1.25x of check_time even for sub-second test configurations.
        self.poll_interval_s = poll_interval_s or max(
            0.05, min(1.0, self.check_time_s / 4.0))
        # (source, its abort hook or None for on_abort)
        self._sources: list[tuple] = []
        self._source_aborts: dict = {}
        self._last_warned: dict[str, float] = {}
        self._aborted: set[str] = set()
        self._stop = threading.Event()
        self._warn_counter = self.reg.counter(
            "horovod_stall_warnings_total",
            help="stall-watchdog warning reports emitted")
        self._abort_counter = self.reg.counter(
            "horovod_stall_aborts_total",
            help="collectives failed by the stall watchdog past "
                 "HOROVOD_STALL_SHUTDOWN_TIME")
        self._stalled_gauge = self.reg.gauge(
            "horovod_stalled_tensors",
            help="tensors currently past HOROVOD_STALL_CHECK_TIME")
        self._thread = threading.Thread(
            target=self._loop, name="hvd_stall_watchdog", daemon=True)
        self._thread.start()

    def add_source(self, fn: Callable[[], list],
                   on_abort: Optional[Callable[[StallInfo], None]] = None
                   ) -> None:
        """``fn() -> list[StallInfo]`` describing the caller's in-flight set
        (any age; the watchdog applies the thresholds). ``on_abort``, when
        given, fails this source's stalled entries in place of the
        watchdog's own hook (the eager engine's queue and the collectives
        of ``init`` share one watchdog)."""
        self._sources.append((fn, on_abort))

    def remove_source(self, fn: Callable[[], list]) -> None:
        """Drop a source given to :meth:`add_source` (equal callables
        match: a bound method fetched twice)."""
        self._sources = [s for s in self._sources if s[0] != fn]

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def report(self) -> Optional[dict]:
        """Latest structured stall report (None when healthy)."""
        return self.reg.get_info("stall_report")

    # -- internals -----------------------------------------------------------

    def _collect(self) -> list:
        infos: list = []
        aborts: dict = {}
        for fn, on_abort in list(self._sources):
            try:
                got = list(fn() or [])
            except Exception:   # a dying source must not kill its watchdog
                continue
            infos.extend(got)
            if on_abort is not None:
                aborts.update((id(s), on_abort) for s in got)
        self._source_aborts = aborts
        return infos

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self._scan()

    def _scan(self) -> None:
        now = time.monotonic()
        stalled = [s for s in self._collect() if s.age_s > self.check_time_s]
        self._stalled_gauge.set(len(stalled))
        if not stalled:
            return
        fresh = [s for s in stalled
                 if now - self._last_warned.get(s.name, 0.0) > self.check_time_s]
        if fresh:
            for s in fresh:
                self._last_warned[s.name] = now
            text = format_report(stalled, self.check_time_s)
            log("warning", text, rank=self.rank)
            self._warn_counter.inc()
            if self.event_sink is not None:
                try:
                    self.event_sink({
                        "kind": "stall", "rank": self.rank,
                        "time_unix_s": round(time.time(), 3),
                        "stalled": [{"name": s.name, "op": s.op,
                                     "age_s": round(s.age_s, 3)}
                                    for s in stalled[:16]]})
                except Exception:   # forwarding must not kill the watchdog
                    pass
            try:
                # Always retained in the process flight ring:
                # a stall that later becomes a crash has its onset on
                # record even when nobody wired an escalation hook.
                from ..tracing import flight as _flight

                _flight.get_flight().event(
                    "stall", rank=self.rank,
                    stalled=[{"name": s.name, "op": s.op,
                              "age_s": round(s.age_s, 3)}
                             for s in stalled[:16]])
            except Exception:
                pass
            if self.on_warn is not None:
                try:
                    self.on_warn(stalled)
                except Exception:   # escalation must not kill the watchdog
                    pass
        # Publish/refresh the structured report every scan while stalled, so
        # a reader always sees current ages.
        rep = StallReport(time_unix_s=time.time(), rank=self.rank,
                          text=format_report(stalled, self.check_time_s),
                          stalled=stalled)
        rep_d = rep.to_dict()
        # Critical-path enrichment (tracing/critical_path.py): when
        # a trace analysis has published an attribution, attach it — the
        # report then says not just WHO is missing but WHERE the blocked
        # time has been going (compute skew vs negotiation vs wire vs
        # reduce) for the ranks that are present.
        attribution = self.reg.get_info("straggler_attribution")
        if attribution:
            rep_d["straggler_attribution"] = attribution
        self.reg.set_info("stall_report", rep_d)
        if self.shutdown_time_s > 0:
            for s in stalled:
                on_abort = self._source_aborts.get(id(s), self.on_abort)
                if on_abort is None:
                    continue
                if s.age_s > self.shutdown_time_s and s.name not in self._aborted:
                    self._aborted.add(s.name)
                    log("error",
                        f"stall watchdog: aborting {s.name} after "
                        f"{s.age_s:.1f}s (> HOROVOD_STALL_SHUTDOWN_TIME="
                        f"{self.shutdown_time_s:g}s)", rank=self.rank)
                    try:
                        # Escalation is a flight-dump trigger: capture
                        # the ring before failing the collective.
                        from ..tracing import flight as _flight

                        _flight.get_flight().dump(
                            f"stall-abort-{s.name}")
                    except Exception:
                        pass
                    # An abort hook may return False to signal "not handled
                    # yet": retry on the next scan instead of marking the
                    # tensor dealt with forever.
                    try:
                        handled = on_abort(s)
                    except Exception:
                        handled = False
                    if handled is False:
                        self._aborted.discard(s.name)
                    else:
                        self._abort_counter.inc()
