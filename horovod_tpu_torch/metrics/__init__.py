"""Telemetry of the port: the process-local registry of counters, gauges
and histograms (``registry``), its JSON snapshot and Prometheus text,
served over local HTTP at ``HOROVOD_METRICS_PORT`` (``exposition``), the
pod-wide merge of per-rank snapshots (``aggregate``), the snapshot schema
check (``schema``), the stall watchdog (``watchdog``), the anomaly
detector (``anomaly``), and the measurements and plan gauges of the data
plane (``overlap``). The framework-free modules are the port's own copies
of ``horovod_tpu.metrics``'s."""

from __future__ import annotations

from .aggregate import merge_snapshots  # noqa: F401
from .anomaly import AnomalyDetector  # noqa: F401
from .exposition import MetricsServer, start_metrics_server  # noqa: F401
from .overlap import (  # noqa: F401
    last_plan,
    last_shard_plan,
    last_tier_plan,
    last_wire_plan,
    measure_overlap,
    record_plan,
    record_shard_plan,
    record_sharded_state_bytes,
    record_tier_plan,
    record_wire_plan,
)
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
)
from .schema import validate_snapshot  # noqa: F401
from .watchdog import StallInfo, StallReport, StallWatchdog  # noqa: F401


def snapshot() -> dict:
    """JSON-able snapshot of this process's registry."""
    return registry().snapshot()


def render_prometheus() -> str:
    """Prometheus text exposition of this process's registry."""
    return registry().render_prometheus()
