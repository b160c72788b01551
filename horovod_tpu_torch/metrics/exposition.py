"""Metrics exposition: Prometheus text + JSON snapshots over local HTTP.
The port's own copy of ``horovod_tpu.metrics.exposition``; ``/snapshot``
serves the same JSON as ``/metrics.json``.

Set ``HOROVOD_METRICS_PORT`` and ``hvd.init()`` starts one server per rank
(rank *r* on a host listens at ``port + local_rank`` so co-located workers
never collide; docs/metrics.md). Endpoints:

- ``GET /metrics``       → Prometheus text format 0.0.4 (scrape target);
- ``GET /metrics.json``  → the JSON snapshot (what the runner aggregates
  pod-wide, aggregate.merge_snapshots);
- ``GET /metrics.json?host=1`` → on a telemetry-tree LEADER, the host-merged
  snapshot (aggregate finalize of every local rank's latest push) — one
  scrape per host replaces one per rank (docs/metrics.md). Ranks and
  leaders without a host view answer 404 so a scraper misconfigured
  against a non-leader port fails loudly instead of silently halving
  coverage;
- ``GET /healthz``       → 200 ok (liveness probe for the stall watchdog:
  a rank whose exposition stops answering is itself the straggler).

The server binds 127.0.0.1 by default (HOROVOD_METRICS_HOST overrides for
scrapers on another machine): metrics are unauthenticated by design — same
posture as every Prometheus exporter — so the default exposes them to the
local host only.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import MetricsRegistry, registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # type: ignore[assignment]
    # Telemetry-tree leaders bind this to TelemetryAgent.host_view — a
    # zero-arg callable returning the host-merged snapshot (or None while
    # no rank has pushed yet). Stays None on plain per-rank exporters.
    host_view = None

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            body = self.registry.render_prometheus().encode()
            ctype = PROMETHEUS_CONTENT_TYPE
        elif path == "/metrics.json" and "host=1" in query.split("&"):
            if self.host_view is None:
                self.send_error(
                    404, "no host view: this port is a per-rank exporter, "
                         "not a telemetry-tree leader (docs/metrics.md)")
                return
            view = self.host_view()
            if view is None:
                self.send_error(503, "host view empty: no rank has pushed "
                                     "a snapshot to this leader yet")
                return
            body = json.dumps(view).encode()
            ctype = "application/json"
        elif path in ("/metrics.json", "/snapshot"):
            body = json.dumps(self.registry.snapshot()).encode()
            ctype = "application/json"
        elif path == "/healthz":
            body, ctype = b"ok\n", "text/plain"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr spam
        pass


class MetricsServer:
    """Daemon-thread HTTP exposition server; ``port=0`` picks a free port
    (read the bound one back from ``.port``).

    A requested port that is busy (EADDRINUSE) slides up through a small
    window (``HOROVOD_METRICS_PORT_WINDOW``, default 16 ports) instead of
    failing: an elastic respawn lands a fresh worker on a host where the
    previous generation's exporter — or an unrelated process — still holds
    ``port + local_rank``, and a metrics port must never crash ``hvd.init``
    (same shape as the coordinator's bind retry). The bound port is always
    read back from ``.port``."""

    def __init__(self, port: int, reg: Optional[MetricsRegistry] = None,
                 host: Optional[str] = None, host_view=None) -> None:
        from ..common.resilience import bind_with_retry

        reg = reg or registry()
        host = host or os.environ.get("HOROVOD_METRICS_HOST", "127.0.0.1")
        handler = type("BoundHandler", (_Handler,),
                       {"registry": reg,
                        "host_view": staticmethod(host_view)
                        if host_view is not None else None})
        window = 1 if port == 0 else max(
            int(os.environ.get("HOROVOD_METRICS_PORT_WINDOW", "") or 16), 1)
        self._httpd, _ = bind_with_retry(
            lambda p: ThreadingHTTPServer((host, p), handler),
            port, window=window)
        if port and self._httpd.server_address[1] != port:
            from ..utils.logging import log

            log("warning",
                f"metrics port {port} busy; exposition moved to "
                f"{self._httpd.server_address[1]} "
                "(HOROVOD_METRICS_PORT_WINDOW)")
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd_metrics_http",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_metrics_server(port: int, reg: Optional[MetricsRegistry] = None,
                         host: Optional[str] = None,
                         host_view=None) -> MetricsServer:
    return MetricsServer(port, reg, host, host_view=host_view)
