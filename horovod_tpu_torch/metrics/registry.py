"""Lock-cheap in-process metrics registry — counters, gauges, histograms:
the port's own copy of ``horovod_tpu.metrics.registry``.

The telemetry core the port reports through: the background checkpoint
writer (``ckpt_async/writer.py``) times its commits and the training
steps it blocks here, ``callbacks.MetricsCallback`` counts epochs and
steps per second, and ``snapshot()`` / ``render_prometheus()`` give the
JSON snapshot that ``aggregate.merge_snapshots`` merges pod-wide and the
Prometheus text.

Design constraints, in order:
- one uncontended per-metric lock per observation (CPython dict/int ops
  are already serialized by the GIL; the explicit lock makes histograms
  and free-threaded builds correct);
- registration is get-or-create and idempotent, so feed points never
  coordinate (the reference's GlobalState counters are the same shape:
  always-on, owner-less);
- everything is process-local. Cross-rank aggregation happens on
  SNAPSHOTS (aggregate.py), never on live objects.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Optional, Sequence

# Default histogram boundaries. Seconds: 100 µs .. ~100 s, log-spaced —
# covers a same-host psum tick through a cross-pod straggler. Bytes:
# 1 KiB .. 4 GiB in powers of 4 — gradient shards through fused buckets.
DEFAULT_TIME_BUCKETS = tuple(1e-4 * (4.0 ** i) for i in range(11))
DEFAULT_BYTE_BUCKETS = tuple(float(1 << k) for k in range(10, 33, 2))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _series_name(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter (Prometheus counter semantics)."""

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Point-in-time value (Prometheus gauge semantics)."""

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Fixed-boundary histogram with percentile estimation.

    Observations land in cumulative-style buckets (Prometheus ``le``
    semantics, +Inf implicit). Percentiles are estimated by linear
    interpolation inside the bucket where the cumulative count crosses the
    target — the standard exposition-side ``histogram_quantile`` estimate,
    computed here so JSON snapshots carry ready-to-read p50/p90/p99.
    """

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        bs = tuple(sorted(buckets or DEFAULT_TIME_BUCKETS))
        if not bs:
            raise ValueError("histogram needs at least one bucket boundary")
        self.boundaries = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)   # last slot = +Inf
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.boundaries, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Estimate the p-th percentile (p in [0, 100]) from the buckets."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            if self._count == 0:
                return 0.0
            target = self._count * p / 100.0
            cum = 0
            for i, c in enumerate(self._counts):
                prev_cum = cum
                cum += c
                if cum >= target and c > 0:
                    lo = self.boundaries[i - 1] if i > 0 else self._min
                    hi = self.boundaries[i] if i < len(self.boundaries) else self._max
                    # interpolate within the observed range only: estimates
                    # must never exceed the true max or undercut the min
                    lo = max(lo, self._min)
                    hi = min(hi, self._max)
                    if hi <= lo:
                        return float(hi)
                    frac = (target - prev_cum) / c
                    return float(lo + (hi - lo) * frac)
            return float(self._max)

    def to_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
        cum = 0
        buckets = []
        for b, c in zip(self.boundaries, counts):
            cum += c
            buckets.append([b, cum])
        buckets.append(["+Inf", cum + counts[-1]])
        return {
            "count": count,
            "sum": total,
            "buckets": buckets,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Registry of named series. get-or-create; safe from any thread."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}
        self._info: dict[str, object] = {}
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []

    # -- registration (get-or-create) --------------------------------------

    def _get(self, kind: str, cls, name: str, help: str,
             labels: dict, **kw):
        key = (kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", Histogram, name, help, labels,
                         buckets=buckets)

    def remove(self, name: str, **labels) -> bool:
        """Drop one series (any kind) from the registry; True when it
        existed. Label-keyed series whose subject can LEAVE — the telemetry
        tree's per-host staleness gauges when an elastic reset removes the
        host — must be removable, or the orphaned series keeps aging and
        alarms on a host that is legitimately gone."""
        lk = _label_key(labels)
        with self._lock:
            removed = False
            for kind in ("counter", "gauge", "histogram"):
                removed |= self._metrics.pop((kind, name, lk),
                                             None) is not None
            return removed

    def set_info(self, name: str, value) -> None:
        """Attach a non-numeric annotation (e.g. the latest stall report) to
        snapshots. Not a Prometheus series; JSON-only."""
        with self._lock:
            self._info[name] = value

    def get_info(self, name: str):
        with self._lock:
            return self._info.get(name)

    # -- collectors: pull-model sources (native engine counters) ------------

    def register_collector(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """``fn(registry)`` runs right before every snapshot/render — the
        pull hook for sources that keep their own counters (the native C++
        engine exports atomics through the c_api; a collector copies them
        into gauges here)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:   # a broken collector must not kill exposition
                pass

    # -- exposition ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able snapshot of every series (the unit of pod aggregation,
        aggregate.merge_snapshots)."""
        self._run_collectors()
        out = {
            "schema": "horovod_tpu.metrics.v1",
            "time_unix_s": time.time(),
            "counters": {},
            "gauges": {},
            "histograms": {},
            "info": {},
        }
        with self._lock:
            metrics = list(self._metrics.items())
            out["info"] = dict(self._info)
        for (kind, name, _), m in metrics:
            sname = _series_name(name, m.labels)
            if kind == "counter":
                out["counters"][sname] = m.value
            elif kind == "gauge":
                out["gauges"][sname] = m.value
            else:
                out["histograms"][sname] = m.to_dict()
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.items())
        by_name: dict[str, list] = {}
        kinds: dict[str, str] = {}
        helps: dict[str, str] = {}
        for (kind, name, _), m in metrics:
            by_name.setdefault(name, []).append(m)
            kinds[name] = kind
            if m.help:
                helps[name] = m.help
        lines = []
        for name in sorted(by_name):
            kind = kinds[name]
            if name in helps:
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} {kind}")
            for m in by_name[name]:
                if kind in ("counter", "gauge"):
                    lines.append(f"{_series_name(name, m.labels)} {m.value}")
                    continue
                d = m.to_dict()
                for le, cum in d["buckets"]:
                    lb = dict(m.labels)
                    lb["le"] = le if le == "+Inf" else repr(float(le))
                    lines.append(f"{_series_name(name + '_bucket', lb)} {cum}")
                lines.append(f"{_series_name(name + '_sum', m.labels)} {d['sum']}")
                lines.append(f"{_series_name(name + '_count', m.labels)} {d['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every series, info entry, and collector (tests; re-init)."""
        with self._lock:
            self._metrics.clear()
            self._info.clear()
            self._collectors.clear()


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry every feed point reports to."""
    return _default
