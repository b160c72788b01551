"""Live anomaly detection over the well-known series: the port's own copy
of ``horovod_tpu.metrics.anomaly``. The serving kinds (``ttft_slo``,
``drain_collapse``, ``shed_spike``, ``preempt_storm``) read the series the
serving routers set (``serving/``), whose ``start`` calls
:meth:`AnomalyDetector.start_from_env`.

A pull-driven watcher: every ``HOROVOD_ANOMALY_INTERVAL_S`` it snapshots
the process registry, folds per-tick counter deltas into EWMA baselines,
and applies DETERMINISTIC threshold rules — no learned models, the same
inputs always produce the same verdict, which is what lets the unit tests
drive every kind by hand and the nominal-load smokes assert zero firings.

Kinds (the sensors of the runtime controller, ``control/``):

- ``ttft_slo``      — TTFT p99 over the SLO, or the admission controller's
  *projected* wait already past it (Clipper framing: the breach is judged
  against the deadline the system itself projects at admission);
- ``drain_collapse`` — decode/serve throughput per tick collapses below
  ``baseline / factor`` for ``CONSEC_TICKS`` ticks while demand is queued;
- ``shed_spike``    — 429 sheds per tick spike past ``factor x (baseline+1)``;
- ``preempt_storm`` — KV preemptions per tick at/above ``PREEMPT_STORM``
  (watermark thrash: admissions and growth fighting over the same blocks);
- ``demotion_storm`` — eager plane demotions summed over the trailing
  window at/above ``DEMOTION_STORM``;
- ``wire_drift``    — wire bytes per tick drifting past ``factor x`` the
  established baseline (a compression/policy regression showing up live);
- ``telemetry_lag`` — a host's telemetry snapshot at the tree root is older
  than ``TELEMETRY_LAG_TICKS`` collection intervals (the telemetry tree's
  ``horovod_telemetry_snapshot_age_ticks{host}`` gauge): the pod view is
  STALE for the named hosts, so the controller and humans must stop
  trusting those numbers instead of acting on them.

Every firing increments ``horovod_anomaly_total{kind=...}``, drops a
structured event into the process flight ring and trips a flight dump —
so the seconds BEFORE the anomaly are already captured when the operator
runs ``python -m horovod_tpu_torch.tracing.bundle``. Per-kind refires are rate
limited by ``HOROVOD_ANOMALY_COOLDOWN_S``.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Callable, Optional

from .registry import MetricsRegistry, registry
from ..utils.logging import log

#: deterministic rule constants (kept as constants, not knobs: the knob
#: surface is the factor/cooldown/interval; these encode rule shape)
WARMUP_TICKS = 6          # baseline samples before a rule may judge
CONSEC_TICKS = 3          # collapse must persist this many ticks
PREEMPT_STORM = 10        # preemptions per tick that count as a storm
DEMOTION_STORM = 3        # demotions over the trailing window
DEMOTION_WINDOW = 20      # ticks in that trailing window
MIN_DRAIN_BASELINE = 4.0  # tokens/requests per tick a collapse needs
TELEMETRY_LAG_TICKS = 3   # host snapshot age (collection intervals) = stale

_EWMA_ALPHA = 0.2


def _series_sum(table: dict, name: str) -> float:
    """Sum every series of ``name`` across label combinations (snapshot
    keys are ``name`` or ``name{k="v",...}``)."""
    total = 0.0
    for key, v in table.items():
        if key == name or key.startswith(name + "{"):
            total += float(v)
    return total


def _series_items(table: dict, name: str):
    """Yield ``(series_key, value)`` for every label combination of
    ``name`` — rules that must NAME the offending label (which host is
    stale) need the per-series values, not the sum."""
    for key, v in table.items():
        if key == name or key.startswith(name + "{"):
            yield key, float(v)


_HOST_LABEL_RE = re.compile(r'host="([^"]*)"')


class AnomalyDetector:
    KINDS = ("ttft_slo", "drain_collapse", "shed_spike", "preempt_storm",
             "demotion_storm", "wire_drift", "telemetry_lag")

    def __init__(self, reg: Optional[MetricsRegistry] = None,
                 slo_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 factor: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 on_fire: Optional[Callable[[str, dict], None]] = None,
                 flight=None) -> None:
        self.reg = reg or registry()
        self.slo_s = float(slo_s) if slo_s is not None else None
        self.interval_s = float(interval_s if interval_s is not None else
                                os.environ.get("HOROVOD_ANOMALY_INTERVAL_S",
                                               "") or 0.5)
        self.factor = float(factor if factor is not None else
                            os.environ.get("HOROVOD_ANOMALY_FACTOR", "")
                            or 4.0)
        self.cooldown_s = float(cooldown_s if cooldown_s is not None else
                                os.environ.get("HOROVOD_ANOMALY_COOLDOWN_S",
                                               "") or 30.0)
        self.on_fire = on_fire
        # Multi-subscriber fan-out: the runtime controller (and
        # anything else) attaches with subscribe() without displacing the
        # constructor's on_fire callback.
        self._subscribers: list[Callable[[str, dict], None]] = []
        self._flight = flight
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last: dict[str, float] = {}       # counter absolute values
        self._baseline: dict[str, float] = {}   # per-tick delta EWMAs
        self._samples: dict[str, int] = {}
        self._low_ticks = 0                     # consecutive collapse ticks
        self._demote_window: list[float] = []
        self._last_fired: dict[str, float] = {}
        self.history: list[dict] = []           # fired events, oldest first
        self._c = {k: self.reg.counter(
            "horovod_anomaly_total",
            help="anomaly-detector firings by kind (metrics/anomaly.py)",
            kind=k) for k in self.KINDS}

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def start_from_env(cls, reg=None, slo_s=None) -> Optional[
            "AnomalyDetector"]:
        """The serving routers' entry point: a started detector thread,
        or None when ``HOROVOD_ANOMALY=0`` disables the watcher."""
        if (os.environ.get("HOROVOD_ANOMALY", "") or "1") == "0":
            return None
        det = cls(reg=reg, slo_s=slo_s)
        det.start()
        return det

    def start(self) -> "AnomalyDetector":
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd_anomaly", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:   # telemetry must never take the router down
                pass

    # -- the deterministic rules ---------------------------------------------

    def _delta(self, counters: dict, name: str) -> float:
        cur = _series_sum(counters, name)
        d = cur - self._last.get(name, cur)   # first tick reads delta 0
        self._last[name] = cur
        return max(d, 0.0)

    def _ewma(self, key: str, value: float) -> tuple:
        """-> (baseline BEFORE folding in value, warmed?)."""
        base = self._baseline.get(key)
        n = self._samples.get(key, 0)
        self._baseline[key] = value if base is None else \
            (1 - _EWMA_ALPHA) * base + _EWMA_ALPHA * value
        self._samples[key] = n + 1
        return (base if base is not None else value), n >= WARMUP_TICKS

    def tick(self, now: Optional[float] = None) -> list:
        """One evaluation pass; returns the kinds fired this tick."""
        now = now if now is not None else time.monotonic()
        snap = self.reg.snapshot()
        counters, gauges = snap["counters"], snap["gauges"]
        fired: list[str] = []

        # ttft_slo — observed p99 or the projected admission wait
        if self.slo_s is not None:
            ttft = snap["histograms"].get(
                "horovod_serve_llm_ttft_seconds", {})
            p99 = float(ttft.get("p99", 0.0))
            projected = float(_series_sum(
                gauges, "horovod_serve_projected_wait_seconds"))
            if p99 > self.slo_s or projected > self.slo_s:
                if self._fire("ttft_slo", now,
                              {"ttft_p99_s": round(p99, 4),
                               "projected_wait_s": round(
                                   min(projected, 1e9), 4),
                               "slo_s": self.slo_s}):
                    fired.append("ttft_slo")

        # drain_collapse — tokens (LLM plane) + served requests (stateless)
        drained = self._delta(counters,
                              "horovod_serve_llm_tokens_total") \
            + self._delta(counters, "horovod_serve_requests_total")
        demand = _series_sum(gauges, "horovod_serve_llm_waiting_sequences") \
            + _series_sum(gauges, "horovod_serve_llm_active_sequences") \
            + _series_sum(gauges, "horovod_serve_queue_depth")
        base, warmed = self._ewma("drain", drained) if demand > 0 or \
            drained > 0 else (0.0, False)
        if warmed and demand > 0 and base >= MIN_DRAIN_BASELINE \
                and drained < base / self.factor:
            self._low_ticks += 1
        else:
            self._low_ticks = 0
        if self._low_ticks >= CONSEC_TICKS:
            if self._fire("drain_collapse", now,
                          {"per_tick": round(drained, 2),
                           "baseline": round(base, 2),
                           "demand": demand}):
                fired.append("drain_collapse")
            self._low_ticks = 0

        # shed_spike
        shed = self._delta(counters, "horovod_serve_shed_total")
        shed_base, _ = self._ewma("shed", shed)
        if shed > self.factor * (shed_base + 1.0):
            if self._fire("shed_spike", now,
                          {"per_tick": shed,
                           "baseline": round(shed_base, 2)}):
                fired.append("shed_spike")

        # preempt_storm
        preempts = self._delta(counters,
                               "horovod_serve_llm_preemptions_total")
        if preempts >= PREEMPT_STORM:
            if self._fire("preempt_storm", now, {"per_tick": preempts}):
                fired.append("preempt_storm")

        # demotion_storm — trailing-window sum
        self._demote_window.append(
            self._delta(counters, "horovod_plane_demotions_total"))
        del self._demote_window[:-DEMOTION_WINDOW]
        if sum(self._demote_window) >= DEMOTION_STORM:
            if self._fire("demotion_storm", now,
                          {"window": sum(self._demote_window),
                           "ticks": len(self._demote_window)}):
                fired.append("demotion_storm")
            self._demote_window.clear()

        # wire_drift
        wire = self._delta(counters, "horovod_wire_bytes_total")
        if wire > 0:
            wire_base, wire_warm = self._ewma("wire", wire)
            if wire_warm and wire_base > 0 and \
                    wire > self.factor * wire_base:
                if self._fire("wire_drift", now,
                              {"per_tick": wire,
                               "baseline": round(wire_base, 1)}):
                    fired.append("wire_drift")

        # telemetry_lag — a stale host partial at the telemetry-tree root.
        # The root publishes per-host snapshot ages (in collection ticks);
        # any host past the threshold means the POD VIEW is stale for that
        # host, which must be surfaced, not silently averaged over.
        stale: list[str] = []
        max_age = 0.0
        for key, age in _series_items(
                gauges, "horovod_telemetry_snapshot_age_ticks"):
            if age > TELEMETRY_LAG_TICKS:
                m = _HOST_LABEL_RE.search(key)
                stale.append(m.group(1) if m else key)
                max_age = max(max_age, age)
        if stale:
            if self._fire("telemetry_lag", now,
                          {"hosts": sorted(stale),
                           "max_age_ticks": round(max_age, 1),
                           "threshold_ticks": TELEMETRY_LAG_TICKS}):
                fired.append("telemetry_lag")
        return fired

    # -- firing --------------------------------------------------------------

    def _fire(self, kind: str, now: float, detail: dict) -> bool:
        with self._lock:
            if now - self._last_fired.get(kind, -1e18) < self.cooldown_s:
                return False
            self._last_fired[kind] = now
        self._c[kind].inc()
        event = {"kind": kind, "time_unix_s": round(time.time(), 3)}
        event.update(detail)
        self.history.append(event)
        log("warning", f"anomaly detector: {kind} fired ({detail}); "
                       f"flight dump + bundle capture tripped "
                       f"(docs/debugging.md)")
        try:
            from ..tracing import flight as _flight

            fl = self._flight or _flight.get_flight()
            fl.event("anomaly", **event)
            fl.dump(f"anomaly-{kind}")
        except Exception:   # the dump is best-effort, the counter is not
            pass
        if self.on_fire is not None:
            try:
                self.on_fire(kind, detail)
            except Exception:
                pass
        with self._lock:
            subs = list(self._subscribers)
        for cb in subs:
            try:
                cb(kind, dict(detail))
            except Exception:   # a broken subscriber must not mute others
                pass
        return True

    def subscribe(self, cb: Callable[[str, dict], None]) -> None:
        """Attach a firing subscriber: ``cb(kind, detail)`` runs (after the
        counter/flight capture and the constructor ``on_fire``) on every
        firing. Exceptions are swallowed per subscriber."""
        with self._lock:
            self._subscribers.append(cb)

    def unsubscribe(self, cb: Callable[[str, dict], None]) -> None:
        with self._lock:
            if cb in self._subscribers:
                self._subscribers.remove(cb)
