"""HTTP frontend — the router's public face (the port's own copy of
``horovod_tpu.serving.frontend``: the same routes, HMAC and bodies).

Reuses the metrics-exposition server pattern (metrics/exposition.py:
``ThreadingHTTPServer`` + daemon thread, localhost-bound by default,
``port=0`` picks a free port read back from ``.port``). Endpoints:

- ``POST /v1/infer`` — body ``{"inputs": [...], "deadline_ms": 250}``;
  authenticated (``HOROVOD_SERVE_TOKEN`` -> ``Authorization: Bearer``),
  admission-checked, enqueued, and answered when the batch completes:
  ``{"outputs": [...], "latency_ms": ..}``. Error codes: 400 malformed,
  401 unauthenticated, 429 shed (projected queue wait over the SLO, with
  a ``Retry-After``), 503 failed after retries / shutting down, 504
  deadline exceeded.
- ``POST /v1/generate`` with ``"stream": true`` (or the
  ``HOROVOD_SERVE_LLM_STREAM=1`` default) — chunked transfer encoding,
  one JSONL object ``{"token": t, "i": n}`` per generated token flushed
  as the decode pool reports it, terminated by the EXACT object the
  non-streaming path would have returned (so reassembly is trivially
  byte-equal and errors/timeouts surface in-band as its ``"error"``).
  Clients see TTFT instead of total latency; the TTFT histogram itself
  is engine-measured (submit -> first token) either way, so the
  ``ttft_slo`` anomaly rule watches the same number.
- ``GET /healthz`` — 200 once at least one replica is serving (readiness
  probe for load balancers and the smoke), 503 before.
- ``GET /stats`` — ``{"serving": {...}, "metrics": <registry snapshot>}``
  where ``metrics`` is the standard per-rank snapshot shape
  (``metrics.validate_snapshot`` checks it — same contract as
  ``/metrics.json`` on the training side).

One request-handler thread parks per in-flight request (the threading
server's thread-per-connection model); the wait is bounded by the
request's deadline, so a wedged replica cannot accumulate parked threads
past the SLO horizon.
"""

from __future__ import annotations

import hmac
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


class _Handler(BaseHTTPRequestHandler):
    server_ref = None  # type: ignore[assignment]  # the InferenceServer
    # Chunked transfer encoding (the streaming /v1/generate path) is an
    # HTTP/1.1 feature; Content-Length replies keep working unchanged.
    protocol_version = "HTTP/1.1"

    # -- helpers -------------------------------------------------------------

    def _reply(self, status: int, obj: dict,
               headers: Optional[dict] = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gave up; nothing to salvage

    def _authenticated(self) -> bool:
        token = self.server_ref.cfg.token
        if not token:
            return True
        header = self.headers.get("Authorization", "")
        supplied = header[len("Bearer "):] if header.startswith("Bearer ") \
            else ""
        return hmac.compare_digest(supplied, token)

    # -- routes --------------------------------------------------------------

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        path = self.path.split("?")[0]
        srv = self.server_ref
        if path == "/healthz":
            n = srv.ready_count()
            self._reply(200 if n >= 1 else 503,
                        {"ok": n >= 1, "replicas": n})
        elif path == "/stats":
            self._reply(200, srv.stats())
        elif path == "/debug/sequences":
            # Token-level plane only (LLMServer mirrors the decode pools'
            # per-sequence scheduler state).
            fn = getattr(srv, "debug_sequences", None)
            if fn is None:
                self._reply(404, {"error": "/debug/sequences requires the "
                                           "LLM serving plane (LLMServer)"})
            else:
                self._reply(200, fn())
        else:
            self._reply(404, {"error": f"no route {path}"})

    def do_POST(self):  # noqa: N802
        path = self.path.split("?")[0]
        if path not in ("/v1/infer", "/v1/generate"):
            self._reply(404, {"error": f"no route {path}"})
            return
        if not self._authenticated():
            self._reply(401, {"error": "missing or wrong bearer token "
                                       "(HOROVOD_SERVE_TOKEN)"})
            return
        if path == "/v1/generate":
            # Token-level plane (serving/llm/): the LLM server owns the
            # whole request lifecycle; stateless servers have no route.
            fn = getattr(self.server_ref, "handle_generate_http", None)
            if fn is None:
                self._reply(404, {"error": "/v1/generate requires the "
                                           "LLM serving plane (LLMServer)"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"malformed request: {e}"})
                return
            srv = self.server_ref
            if getattr(srv, "stream_requested", None) and \
                    srv.stream_requested(body):
                self._stream_generate(body)
                return
            status, obj, headers = fn(body)
            self._reply(status, obj, headers=headers)
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            x = np.asarray(body["inputs"], dtype=np.float32)
            deadline_ms = body.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError("deadline_ms must be > 0")
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"error": f"malformed request: {e}"})
            return
        t0 = time.monotonic()
        req, shed_wait = self.server_ref.submit(x, deadline_ms=deadline_ms)
        if req.code == 429:
            self._reply(429, {"error": req.error},
                        headers={"Retry-After":
                                 f"{max(shed_wait, 0.001):.3f}"})
            return
        budget = (req.deadline_t - t0) if req.deadline_t else \
            self.server_ref.cfg.slo_ms / 1000.0
        if not req.event.wait(timeout=budget + 0.05):
            req.fail(504, "deadline exceeded awaiting a batch slot")
            self.server_ref.count_code(504)
        if req.code == 200:
            self._reply(200, {
                "outputs": np.asarray(req.output).tolist(),
                "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
            })
        else:
            self._reply(req.code, {"error": req.error})

    def _stream_generate(self, body: dict) -> None:
        """Chunked /v1/generate: flush one JSONL object per token as the
        decode pool reports progress, then the exact non-streaming
        response object as the final line. Admission rejections (400/429)
        stay plain Content-Length replies — there is nothing to stream."""
        srv = self.server_ref
        t0 = time.monotonic()
        status, obj, headers, req = srv.submit_generate_http(body)
        if req is None:
            self._reply(status, obj, headers=headers)
            return
        srv.count_stream()
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj: dict) -> None:
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode()
                             + data + b"\r\n")
            self.wfile.flush()

        sent, done = 0, False
        deadline = (req.deadline_t or t0) + 0.05
        try:
            while not done and time.monotonic() < deadline:
                toks, done = req.wait_tokens(
                    sent, timeout=min(0.25, deadline - time.monotonic()))
                for t in toks[sent:]:
                    chunk({"token": int(t), "i": sent})
                    sent += 1
            # completion may outrun the last poll's streamed prefix: the
            # remaining tokens still flush as per-token lines before the
            # terminal object
            for t in (req.tokens or [])[sent:]:
                chunk({"token": int(t), "i": sent})
                sent += 1
            status, obj = srv.finish_generate_http(req, t0)
            chunk(obj)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gave up mid-stream; the request resolves anyway
        # chunked framing has an explicit terminator, but the handler
        # cannot know whether the client saw it if the pipe broke — drop
        # the connection rather than risk a desynced keep-alive reuse
        self.close_connection = True

    def log_message(self, *args):  # silence per-request stderr spam
        pass


class ServeFrontend:
    """Daemon-thread HTTP server bound to (cfg.host, cfg.port); ``port=0``
    picks a free port — read the bound one back from ``.port``."""

    def __init__(self, server) -> None:
        handler = type("BoundHandler", (_Handler,), {"server_ref": server})
        self._httpd = ThreadingHTTPServer((server.cfg.host, server.cfg.port),
                                          handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd_serve_http",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
