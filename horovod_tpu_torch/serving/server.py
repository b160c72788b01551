"""The inference server — router composition root (the port's counterpart
of ``horovod_tpu.serving.server``).

``InferenceServer`` wires the four serving parts together in one process;
none of them touches a device — the router creates no CUDA context, and
only the replica subprocesses put tensors on their cards:

    frontend (HTTP) -> admission (SLO shed) -> batcher (coalesce/pad)
        -> replica workers (dispatch) -> replica processes (K-step forward)
                 ^ replica manager (supervise / autoscale / drain)

Replicas run on the card unless the caller asks for the CPU:
``InferenceServer(..., device=None)`` resolves the device through
``common.basics.resolve_device`` (raising where there is no card), and
the manager gives replica ``i`` card ``i % torch.cuda.device_count()``.

Programmatic use (tests, benchmarks, embedding in a training job for mixed
train+serve pods)::

    server = InferenceServer(checkpoint="/ckpts/serve",
                             builder="my_project.serving:build").start()
    server.wait_ready(60)
    out = server.infer(np.zeros(32, np.float32))   # sync convenience
    server.stop()

``python -m horovod_tpu_torch.serving --checkpoint ... --builder ...``
runs the same thing as a standalone process.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from ..metrics import registry as _registry
from ..control.serving import maybe_start_serving_controller
from ..metrics.anomaly import AnomalyDetector
from ..tracing.serve import init_serve_tracer
from ..utils.logging import log
from .admission import AdmissionController
from .batcher import ContinuousBatcher, Request
from .config import ServeConfig
from .frontend import ServeFrontend
from .manager import ReplicaManager

DEFAULT_BUILDER = "horovod_tpu_torch.serving.model:mlp_builder"


class InferenceServer:
    def __init__(self, checkpoint: str = "",
                 builder: str = DEFAULT_BUILDER,
                 config: Optional[ServeConfig] = None,
                 replica_env: Optional[dict] = None,
                 device=None) -> None:
        from ..common.basics import resolve_device

        self.device = resolve_device(device)
        self.cfg = config or ServeConfig.from_env()
        self.reg = _registry()
        self.batcher = ContinuousBatcher(self.cfg, self.reg)
        self.admission = AdmissionController(self.cfg, self.reg)
        self.manager = ReplicaManager(self.cfg, self.batcher, self.admission,
                                      checkpoint=checkpoint, builder=builder,
                                      replica_env=replica_env, reg=self.reg,
                                      device=self.device)
        self._frontend: Optional[ServeFrontend] = None
        self.port: Optional[int] = None
        self._example_shape: Optional[tuple] = None
        self._started_t: Optional[float] = None
        self.tracer = None          # set by start() (tracing/serve.py)
        self.anomaly = None         # set by start() (metrics/anomaly.py)
        self.controller = None      # set by start() (control/serving.py)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "InferenceServer":
        self._started_t = time.time()
        self.tracer = init_serve_tracer("serve-router")
        self.anomaly = AnomalyDetector.start_from_env(
            reg=self.reg, slo_s=self.cfg.slo_ms / 1000.0)
        self.controller = maybe_start_serving_controller(
            self.cfg, admission=self.admission, anomaly=self.anomaly,
            reg=self.reg)
        self.manager.start()
        self._frontend = ServeFrontend(self)
        self.port = self._frontend.port
        log("info", f"serving: router listening on "
                    f"http://{self.cfg.host}:{self.port} "
                    f"(max_batch={self.cfg.max_batch}, "
                    f"max_wait={self.cfg.max_wait_ms}ms, "
                    f"slo={self.cfg.slo_ms}ms, replicas "
                    f"{self.cfg.min_replicas}..{self.cfg.max_replicas} on "
                    f"{self.device.type})")
        return self

    def ready_count(self) -> int:
        """Replicas currently serving — the /healthz readiness figure
        (the LLM server overrides this with its per-pool gating)."""
        return self.manager.serving_count()

    def wait_ready(self, timeout: float = 120.0) -> bool:
        """Block until at least one replica serves (torch import + restore
        in the replica bounds this; see replica_start_timeout_s)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.manager.serving_count() >= 1:
                return True
            time.sleep(0.05)
        return False

    def stop(self) -> None:
        if self._frontend is not None:
            self._frontend.stop()
            self._frontend = None
        if self.controller is not None:
            self.controller.stop()
        if self.anomaly is not None:
            self.anomaly.stop()
        self.batcher.close()
        self.manager.stop()
        if self.tracer is not None:
            self.tracer.flush()

    # -- request path --------------------------------------------------------

    def submit(self, x: np.ndarray,
               deadline_ms: Optional[float] = None) -> Tuple[Request, float]:
        """Admission-check and enqueue ONE example. Returns the request
        (already failed when shed/rejected) and the projected queue wait
        the decision saw."""
        x = np.asarray(x, dtype=np.float32)
        if self._example_shape is None:
            self._example_shape = x.shape
        elif x.shape != self._example_shape:
            req = Request(x)
            req.fail(400, f"example shape {x.shape} != the service's "
                          f"{self._example_shape} (one shape per server; "
                          f"batching pads the batch dim only)")
            return req, 0.0
        deadline_s = (deadline_ms if deadline_ms is not None
                      else self.cfg.slo_ms) / 1000.0
        req = Request(x, deadline_t=time.monotonic() + deadline_s)
        admitted, wait = self.admission.admit(self.batcher.depth(),
                                              self.manager.serving_count(),
                                              budget_s=deadline_s)
        if not admitted:
            req.fail(429, f"shed: projected queue wait {wait * 1e3:.0f}ms "
                          f"exceeds the {self.cfg.slo_ms:.0f}ms SLO")
        elif not self.batcher.submit(req):
            if req.fail(429, "queue full"):
                self.count_code(429)
        if self.tracer is not None:
            self.tracer.span(req.tid, "admit", int(req.enqueue_t * 1e9),
                             self.tracer.now_ns(), rid=req.rid,
                             decision="ok" if req.code == 0 else "shed",
                             projected_wait_ms=round(wait * 1e3, 3))
        return req, wait

    def infer(self, x: np.ndarray, deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: submit + wait; raises RuntimeError with
        the HTTP-style code on anything but 200."""
        req, _ = self.submit(x, deadline_ms=deadline_ms)
        budget = timeout if timeout is not None else \
            ((deadline_ms or self.cfg.slo_ms) / 1000.0 + 0.05)
        if not req.event.wait(timeout=budget):
            if req.fail(504, "deadline exceeded"):
                self.count_code(504)
        if req.code != 200:
            raise RuntimeError(f"inference failed ({req.code}): {req.error}")
        return req.output

    def count_code(self, code: int) -> None:
        self.reg.counter("horovod_serve_requests_total",
                         help="terminal request outcomes by HTTP-style code",
                         code=str(code)).inc()

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        snap = self.reg.snapshot()
        lat = snap["histograms"].get("horovod_serve_latency_seconds", {})
        bsz = snap["histograms"].get("horovod_serve_batch_size", {})
        return {
            "serving": {
                "uptime_s": round(time.time() - (self._started_t or
                                                 time.time()), 1),
                "queue_depth": self.batcher.depth(),
                "admission": self.admission.report(),
                "mean_batch_size": round(
                    bsz.get("sum", 0.0) / max(bsz.get("count", 0), 1), 3),
                "latency_p50_ms": round(lat.get("p50", 0.0) * 1e3, 3),
                "latency_p99_ms": round(lat.get("p99", 0.0) * 1e3, 3),
                **self.manager.describe(),
            },
            "metrics": snap,
        }


def serve(checkpoint: str = "", builder: str = DEFAULT_BUILDER,
          config: Optional[ServeConfig] = None, device=None) -> None:
    """Run a server until interrupted (the ``python -m`` entry)."""
    server = InferenceServer(checkpoint, builder, config,
                             device=device).start()
    try:
        if not server.wait_ready(server.cfg.replica_start_timeout_s):
            raise RuntimeError(
                "no replica became ready within "
                f"{server.cfg.replica_start_timeout_s:.0f}s — check the "
                "replica logs (spawn dir in the error above) and the "
                "checkpoint path")
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log("info", "serving: interrupted; draining")
    finally:
        server.stop()
