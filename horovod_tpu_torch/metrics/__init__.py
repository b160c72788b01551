"""Telemetry of the port: the process-local registry of counters, gauges
and histograms (``registry``), its JSON snapshot and Prometheus text,
the pod-wide merge of per-rank snapshots (``aggregate``), the snapshot
schema check (``schema``), and the measurements of the data plane
(``overlap``). The framework-free modules are the port's own copies of
``horovod_tpu.metrics``'s."""

from __future__ import annotations

from .aggregate import merge_snapshots  # noqa: F401
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
)
from .schema import validate_snapshot  # noqa: F401


def snapshot() -> dict:
    """JSON-able snapshot of this process's registry."""
    return registry().snapshot()


def render_prometheus() -> str:
    """Prometheus text exposition of this process's registry."""
    return registry().render_prometheus()
