"""Root of the telemetry tree — the coordinator-side aggregator: the port's
own copy of ``horovod_tpu.telemetry.root``.

:class:`RootAggregator` is transport-free bookkeeping: the runner's
DriverService routes its ``host_metrics`` requests here (one per host per
collection tick — O(hosts) connections and bytes at the root), and
``pod_metrics`` merges the stored host partials with any directly-pushed
rank snapshots through the same associative merge, so the pod view is
bitwise what the flat O(world) fan-in would have produced.

Staleness is first-class: every ingest refreshes per-host ages, published
as ``horovod_telemetry_snapshot_age_ticks{host=...}`` (in collection
intervals). The anomaly detector's ``telemetry_lag`` rule reads that gauge
and fires when any host's snapshot is older than TELEMETRY_LAG_TICKS
intervals — stale observability is an alarm, not something to silently
average over (Monarch's freshness framing).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from ..metrics.aggregate import apply_snapshot_delta
from ..metrics.registry import MetricsRegistry, registry
from .tree import interval_s_from_env

#: batched events retained at the root until drained (bounded).
EVENT_BUFFER_LIMIT = 4096


class RootAggregator:
    def __init__(self, interval_s: Optional[float] = None,
                 reg: Optional[MetricsRegistry] = None,
                 now=time.monotonic) -> None:
        self.interval_s = float(interval_s) if interval_s is not None \
            else interval_s_from_env()
        self.reg = reg or registry()
        self._now = now
        self._lock = threading.Lock()
        # host -> {partial, seq, t, expected, ages_s, pushes}
        self._hosts: dict[str, dict] = {}
        self._events: deque = deque(maxlen=EVENT_BUFFER_LIMIT)
        self._push_c = self.reg.counter(
            "horovod_telemetry_pushes_total",
            help="telemetry-tree snapshot pushes received, by hop "
                 "(rank→leader on agents, leader→root at the root)",
            hop="host")
        self._hosts_g = self.reg.gauge(
            "horovod_telemetry_hosts",
            help="hosts currently reporting through the telemetry tree")

    # -- ingest (DriverService `host_metrics` requests land here) ------------

    def ingest(self, req: dict, now: Optional[float] = None) -> dict:
        """One leader push: full host partial or a delta against the last
        acked one. A sequence gap (root restart, dropped push) answers
        ``need_full`` — the stored partial keeps serving until the resend."""
        now = now if now is not None else self._now()
        host = str(req.get("host", "?"))
        seq = int(req.get("seq", 0))
        with self._lock:
            st = self._hosts.get(host)
            if req.get("full"):
                partial = req["body"]
            else:
                if st is None or seq != st["seq"] + 1:
                    return {"ok": True, "need_full": True}
                partial = apply_snapshot_delta(st["partial"], req["body"])
            self._hosts[host] = {
                "partial": partial, "seq": seq, "t": now,
                "expected": list(req.get("expected") or []),
                "ages_s": dict(req.get("ages_s") or {}),
                # staleness is judged in the PUSHING leader's collection
                # intervals — the tick every hop of that host agreed on
                "interval_s": float(req.get("interval_s") or
                                    self.interval_s),
                "pushes": (st["pushes"] + 1) if st else 1,
            }
            for e in req.get("events") or []:
                self._events.append(dict(e, _host=host))
        self._push_c.inc()
        self.publish(now)
        return {"ok": True, "need_full": False}

    # -- views ---------------------------------------------------------------

    def hosts(self) -> list:
        with self._lock:
            return sorted(self._hosts)

    def partials(self) -> list:
        """Stored host partials in sorted host order — the order the
        driver's rank assignment sorts hosts, so the combine order matches
        the flat merge's rank order."""
        with self._lock:
            return [self._hosts[h]["partial"] for h in sorted(self._hosts)]

    def covered_ranks(self) -> set:
        """Ranks whose snapshots already live inside a host partial — the
        driver must not double-count a direct push from the same rank."""
        with self._lock:
            out: set = set()
            for st in self._hosts.values():
                out.update(int(r) for r in st["partial"].get("rank_ids", []))
            return out

    def ages_ticks(self, now: Optional[float] = None) -> dict:
        """Per-host snapshot age in collection intervals."""
        now = now if now is not None else self._now()
        with self._lock:
            return {h: (now - st["t"])
                    / st.get("interval_s", self.interval_s)
                    for h, st in self._hosts.items()}

    def staleness(self, now: Optional[float] = None) -> dict:
        """Coverage summary for callers that report on the pod (elastic
        driver events, debug tooling): per-host age + expected ranks."""
        now = now if now is not None else self._now()
        with self._lock:
            return {h: {"age_ticks": round(
                            (now - st["t"])
                            / st.get("interval_s", self.interval_s), 2),
                        "expected": list(st["expected"]),
                        "pushes": st["pushes"]}
                    for h, st in sorted(self._hosts.items())}

    def drain_events(self) -> list:
        with self._lock:
            out = list(self._events)
            self._events.clear()
        return out

    # -- publication (feeds the telemetry_lag anomaly rule) ------------------

    def publish(self, now: Optional[float] = None) -> None:
        """Refresh the root's own gauges: host count + per-host snapshot
        age in ticks. Call it right before reading the registry (ingest
        calls it too, but a SILENT host only goes stale through a reader's
        refresh — the dead host is exactly the one that stops pushing)."""
        ages = self.ages_ticks(now)
        self._hosts_g.set(len(ages))
        for host, age in ages.items():
            self.reg.gauge(
                "horovod_telemetry_snapshot_age_ticks",
                help="age of each host's latest telemetry push, in "
                     "collection intervals (telemetry_lag fires past "
                     "TELEMETRY_LAG_TICKS)",
                host=host).set(round(age, 3))

    # -- membership ----------------------------------------------------------

    def forget_host(self, host: str) -> None:
        """Drop a host's partial and its staleness gauge — an elastic
        membership change that removed the host must not leave a gauge
        aging toward a spurious ``telemetry_lag`` firing."""
        with self._lock:
            self._hosts.pop(host, None)
        try:
            self.reg.remove("horovod_telemetry_snapshot_age_ticks",
                            host=host)
        except Exception:
            pass
        self._hosts_g.set(len(self.hosts()))

    def keep_only(self, hosts) -> None:
        """Forget every host not in ``hosts`` (the new membership)."""
        keep = {str(h) for h in hosts}
        for h in self.hosts():
            if h not in keep:
                self.forget_host(h)
