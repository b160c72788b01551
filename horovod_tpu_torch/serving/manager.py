"""Elastic replica manager — the serving-plane repurposing of the elastic
driver's slot-pool/supervision loop (elastic/driver.py); the port's own
copy of ``horovod_tpu.serving.manager``.

One router process owns N replica subprocesses. The supervision loop does
three jobs on one cadence:

- **bring-up**: a spawned replica publishes ``{port, pid}`` through its
  ready file; the manager connects an authenticated client, pings it, and
  starts a dispatch worker thread (one per replica — each worker *pulls*
  batches from the shared :class:`~.batcher.ContinuousBatcher`, which is
  what makes the batching continuous).
- **supervision**: a dead replica (crashed process, reset connection,
  timed-out request) is detected by its worker OR the process poll,
  whichever first. Its in-flight requests are requeued at the front and
  retried on survivors (``HOROVOD_SERVE_MAX_RETRIES``), its id is
  blacklisted (ids are never reused — :class:`~..elastic.discovery.
  Blacklist`, same policy object as the elastic trainer), and the repair
  path respawns a replacement immediately, cooldown notwithstanding.
- **autoscaling**: a deterministic decision function
  (:func:`autoscale_decision`) moves the desired replica count toward the
  offered load — scale up when queue depth per replica exceeds the
  ``HOROVOD_SERVE_TARGET_QUEUE`` setpoint, scale down toward
  ``min_replicas`` after the queue has been empty a full cooldown —
  with ``HOROVOD_SERVE_COOLDOWN_S`` hysteresis between actions. Scale-down
  DRAINS: the newest replica stops taking batches, finishes its in-flight
  work, and only then is its process reaped — no request is ever dropped
  by a scale action.

Devices: the manager hands each replica its device in the
``HVD_SERVE_DEVICE`` entry of the replica envelope. On the card, replica
``i`` takes card ``i % torch.cuda.device_count()`` (or the one card the
caller named, ``cuda:<k>``), and a replacement for a replica that died or
drained takes the freed card, so a respawned replica keeps the dead one's
card. The router itself never creates a CUDA context: it only counts the
cards.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import torch

from ..elastic.discovery import Blacklist
from ..metrics import registry as _registry
from ..runner.network import BasicClient, make_secret
from ..tracing import flight as _flight
from ..tracing.clock import estimate_offset_ns
from ..tracing.serve import get_serve_tracer
from ..utils.logging import log
from .batcher import bucket_for, bucket_sizes, pad_batch

_POLL_S = 0.1
_TAKE_TIMEOUT_S = 0.25


def autoscale_decision(depth: int, desired: int, cfg, now: float,
                       last_scale_t: float, last_busy_t: float) -> int:
    """Pure scale decision: +1, -1, or 0. ``last_busy_t`` is the last time
    the queue was non-empty (idle time drives scale-down); both timestamps
    share ``now``'s clock. Cooldown gates BOTH directions so a bursty
    queue cannot flap the fleet."""
    if now - last_scale_t < cfg.cooldown_s:
        return 0
    if depth > cfg.target_queue * max(desired, 1) and \
            desired < cfg.max_replicas:
        return +1
    if desired > cfg.min_replicas and depth == 0 and \
            now - last_busy_t >= cfg.cooldown_s:
        return -1
    return 0


class _Replica:
    __slots__ = ("rid", "proc", "port", "pid", "client", "state", "worker",
                 "spawned_t", "ready_file", "log_path", "log_file",
                 "requests_done", "last_recompiles", "drained", "device")

    def __init__(self, rid: int, proc, ready_file: str, log_path: str,
                 log_file, device: str = "cpu") -> None:
        self.rid = rid
        self.device = device
        self.proc = proc
        self.port: Optional[int] = None
        self.pid: Optional[int] = None
        self.client: Optional[BasicClient] = None
        self.state = "starting"   # starting -> serving -> draining/dead
        self.worker: Optional[threading.Thread] = None
        self.spawned_t = time.monotonic()
        self.ready_file = ready_file
        self.log_path = log_path
        self.log_file = log_file
        self.requests_done = 0
        self.last_recompiles = 0
        self.drained = threading.Event()


class ReplicaManager:
    #: module spawned as ``python -m <replica_module>`` — subclasses
    #: (the LLM plane's PoolManager) point this at their own worker.
    replica_module = "horovod_tpu_torch.serving.replica"

    def __init__(self, cfg, batcher, admission, checkpoint: str = "",
                 builder: str = "horovod_tpu_torch.serving.model:mlp_builder",
                 replica_env: Optional[dict] = None, reg=None,
                 device=None) -> None:
        from ..common.basics import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self._next_card = 0
        self._free_devices: list = []   # cards of dead/drained replicas
        self.batcher = batcher
        self.admission = admission
        self.checkpoint = checkpoint
        self.builder = builder
        self.replica_env = dict(replica_env or {})
        reg = reg or _registry()
        self._secret = make_secret()
        self._dir = tempfile.mkdtemp(prefix="hvd_serve_")
        self._lock = threading.Lock()
        self._replicas: dict[int, _Replica] = {}
        self._next_id = 0
        self._desired = cfg.min_replicas
        self._closed = threading.Event()
        self._last_scale_t = 0.0
        self._last_busy_t = time.monotonic()
        # Startup-failure budget: a replica that dies BEFORE serving its
        # first request points at a config problem (bad checkpoint path,
        # builder typo, missing dep) that a respawn cannot fix — back off
        # and, past the budget, stop respawning instead of fork-bombing
        # the host. Any successful bring-up resets the streak.
        self._startup_failures = 0
        self._startup_budget = max(3 * cfg.max_replicas, 6)
        self._next_spawn_t = 0.0
        self.degraded_reason = ""
        self.blacklist = Blacklist(threshold=cfg.blacklist_threshold)
        self._supervisor: Optional[threading.Thread] = None
        # -- serving telemetry (the JAX package's serving series) ---------
        self._replicas_gauge = reg.gauge(
            "horovod_serve_replicas", help="replicas currently serving")
        self._ok_c = reg.counter(
            "horovod_serve_requests_total",
            help="terminal request outcomes by HTTP-style code", code="200")
        self._fail_c = reg.counter(
            "horovod_serve_requests_total",
            help="terminal request outcomes by HTTP-style code", code="503")
        self._latency_h = reg.histogram(
            "horovod_serve_latency_seconds",
            help="end-to-end request latency (enqueue -> response)")
        self._recompile_c = reg.counter(
            "horovod_serve_recompiles_total",
            help="replica forward retraces (bounded by padding buckets x "
                 "example shapes)")
        self._deaths_c = reg.counter(
            "horovod_serve_replica_deaths_total",
            help="replicas lost to crashes or faults")
        self._respawn_c = reg.counter(
            "horovod_serve_replica_respawns_total",
            help="replacement replicas spawned by the repair path")
        self._retry_c = reg.counter(
            "horovod_serve_retries_total",
            help="requests re-dispatched after a replica death")
        self._scale_up_c = reg.counter(
            "horovod_serve_scale_events_total",
            help="autoscaler actions", dir="up")
        self._scale_down_c = reg.counter(
            "horovod_serve_scale_events_total",
            help="autoscaler actions", dir="down")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicaManager":
        self._prefetch_checkpoint()
        for _ in range(self.cfg.min_replicas):
            self._spawn()
        self._supervisor = threading.Thread(
            target=self._supervise, name="hvd_serve_supervisor", daemon=True)
        self._supervisor.start()
        return self

    def _prefetch_checkpoint(self) -> None:
        """Streaming cold start: a fresh serving host whose checkpoint path
        does not exist locally fetches the latest committed copy from a
        peer host leader (``HOROVOD_CKPT_STREAM_FROM``, authenticated by
        ``HOROVOD_SECRET``) BEFORE the first replica spawns — otherwise
        every replica would fail bring-up against a missing path and burn
        the startup-failure budget. Best-effort: with no sources configured
        or the path already present, this is a no-op; a failed fetch
        degrades to the old behavior (spawn fails loudly against the
        missing path)."""
        if not self.checkpoint or os.path.exists(self.checkpoint):
            return
        from ..ckpt_async.stream import fetch_from_peer, stream_sources_from_env

        sources = stream_sources_from_env()
        key_hex = os.environ.get("HOROVOD_SECRET", "")
        if not sources or not key_hex:
            return
        try:
            fetch_from_peer(sources, bytes.fromhex(key_hex), self.checkpoint)
        except Exception as e:  # noqa: BLE001 - spawn reports the real miss
            log("warning", f"serving: checkpoint streaming from "
                           f"{sources} failed ({e}); replicas will try the "
                           f"local path {self.checkpoint!r} as-is")

    def stop(self) -> None:
        self._closed.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=10)
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            self._reap(rep)
        self._replicas_gauge.set(0)

    # -- views ---------------------------------------------------------------

    def serving_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.state == "serving")

    def describe(self) -> dict:
        with self._lock:
            reps = {r.rid: {"state": r.state, "pid": r.pid, "port": r.port,
                            "requests_done": r.requests_done,
                            "device": r.device}
                    for r in self._replicas.values()}
        return {"replicas": reps, "desired": self._desired,
                "blacklisted": self.blacklist.blacklisted()}

    def replica_stats(self) -> dict:
        """Each serving replica's own ``stats`` reply (its device, counts
        and numerics settings), by replica id; a replica that does not
        answer is left out."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state == "serving" and r.client is not None]
        out = {}
        for rep in reps:
            try:
                out[rep.rid] = rep.client.request({"kind": "stats"})
            except (OSError, ConnectionError, AttributeError):
                continue
        return out

    def scale_to(self, n: int) -> None:
        """Pin the desired replica count (tests; manual override). The
        supervisor converges to it on its next tick."""
        with self._lock:
            self._desired = max(self.cfg.min_replicas,
                                min(int(n), self.cfg.max_replicas))

    # -- spawning ------------------------------------------------------------

    def _device_for(self) -> str:
        """The device of the next replica: a card freed by a dead or
        drained replica first, else the next card in turn."""
        if self.device.type != "cuda":
            return "cpu"
        if self.device.index is not None:
            return str(self.device)
        with self._lock:
            if self._free_devices:
                return self._free_devices.pop(0)
            card = self._next_card % max(torch.cuda.device_count(), 1)
            self._next_card += 1
        return f"cuda:{card}"

    def _free_device(self, rep: _Replica) -> None:
        if self.device.type == "cuda" and self.device.index is None:
            with self._lock:
                self._free_devices.append(rep.device)

    def _spawn(self) -> None:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        device = self._device_for()
        ready = os.path.join(self._dir, f"replica-{rid}.json")
        log_path = os.path.join(self._dir, f"replica-{rid}.log")
        env = dict(os.environ)
        # The replica must import horovod_tpu_torch exactly as the router
        # did — including a repo checkout that was put on sys.path rather
        # than installed (tests, smoke runs).
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env.update(self.replica_env)
        env.update({
            "HVD_SERVE_REPLICA_ID": str(rid),
            "HVD_SERVE_DEVICE": device,
            "HVD_SERVE_SECRET": self._secret.hex(),
            "HVD_SERVE_READY_FILE": ready,
            "HVD_SERVE_CHECKPOINT": self.checkpoint,
            "HVD_SERVE_BUILDER": self.builder,
            "HVD_SERVE_DECODE_STEPS": str(self.cfg.decode_steps),
            # elastic/fault.py targets workers by HOROVOD_TASK_INDEX; a
            # replica's id plays that role (chaos hooks for free).
            "HOROVOD_TASK_INDEX": str(rid),
        })
        env.update(self._replica_env_extra(rid))
        log_file = open(log_path, "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", self.replica_module],
            env=env, stdout=log_file, stderr=subprocess.STDOUT)
        rep = _Replica(rid, proc, ready, log_path, log_file, device)
        with self._lock:
            self._replicas[rid] = rep
        log("info", f"serving: spawned replica {rid} (pid {proc.pid}, "
                    f"{device})")

    # -- supervision loop ----------------------------------------------------

    def _supervise(self) -> None:
        while not self._closed.is_set():
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 - supervision must survive
                log("warning", f"serving supervisor tick failed: {e}")
            time.sleep(_POLL_S)

    def _tick(self) -> None:
        now = time.monotonic()
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            if rep.state == "starting":
                self._check_ready(rep, now)
                if rep.state == "dead":
                    self._startup_failures += 1
                    self._next_spawn_t = now + min(
                        0.5 * self._startup_failures, 5.0)
            elif rep.state in ("serving", "draining") \
                    and rep.proc.poll() is not None:
                self._mark_dead(rep, f"process exited "
                                     f"rc={rep.proc.returncode}")
            if rep.state == "draining" and rep.drained.is_set():
                self._finish_drain(rep)
            if rep.state == "dead":
                self._reap(rep)
                with self._lock:
                    self._replicas.pop(rep.rid, None)
                self._free_device(rep)
        # -- autoscale + repair ---------------------------------------------
        depth = self._queue_depth()
        if depth > 0:
            self._last_busy_t = now
        decision = autoscale_decision(depth, self._desired,
                                      self.autoscale_cfg(), now,
                                      self._last_scale_t, self._last_busy_t)
        if decision:
            self._desired += decision
            self._last_scale_t = now
            (self._scale_up_c if decision > 0 else self._scale_down_c).inc()
            log("info", f"serving autoscaler: depth={depth} -> desired="
                        f"{self._desired} ({'+1' if decision > 0 else '-1'})")
        with self._lock:
            live = [r for r in self._replicas.values()
                    if r.state in ("starting", "serving")]
            draining = [r for r in self._replicas.values()
                        if r.state == "draining"]
        if len(live) < self._desired:
            if self._startup_failures >= self._startup_budget:
                if not self.degraded_reason:
                    self.degraded_reason = (
                        f"{self._startup_failures} consecutive replica "
                        f"startup failures — not respawning; read the "
                        f"replica logs under {self._dir}")
                    log("error", f"serving DEGRADED: {self.degraded_reason}")
            elif now >= self._next_spawn_t:
                # Repair/scale-up: cooldown never blocks replacing the
                # dead (the startup-failure backoff above still does).
                for _ in range(self._desired - len(live)):
                    self._respawn_c.inc()
                    self._spawn()
        elif len(live) > self._desired and not draining:
            self._start_drain(max(
                (r for r in live if r.state == "serving"),
                key=lambda r: r.rid, default=None))
        self._replicas_gauge.set(self.serving_count())

    def _check_ready(self, rep: _Replica, now: float) -> None:
        if rep.proc.poll() is not None:
            self._mark_dead(rep, f"died during startup "
                                 f"rc={rep.proc.returncode}")
            return
        if not os.path.exists(rep.ready_file):
            if now - rep.spawned_t > self.cfg.replica_start_timeout_s:
                self._mark_dead(rep, "startup timeout")
            return
        try:
            with open(rep.ready_file) as f:
                info = json.load(f)
            client = BasicClient([("127.0.0.1", int(info["port"]))],
                                 self._secret,
                                 timeout=self.cfg.replica_timeout_s,
                                 connect_retry_s=5.0)
            pong = client.request({"kind": "ping"})
            if not pong.get("ok"):
                raise ConnectionError(f"bad ping response: {pong}")
        except (OSError, ValueError, ConnectionError) as e:
            log("warning", f"serving replica {rep.rid} ready-check failed: "
                           f"{e}")
            self._mark_dead(rep, f"ready-check failed: {e}")
            return
        rep.port, rep.pid = int(info["port"]), int(info["pid"])
        rep.client = client
        rep.state = "serving"
        self._align_replica_clock(rep)
        self._startup_failures = 0
        rep.worker = threading.Thread(
            target=self._worker, args=(rep,),
            name=f"hvd_serve_worker_{rep.rid}", daemon=True)
        rep.worker.start()
        log("info", f"serving replica {rep.rid} live on port {rep.port} "
                    f"after {now - rep.spawned_t:.1f}s")

    def _align_replica_clock(self, rep: _Replica) -> None:
        """NTP exchange over the replica's authenticated channel (built-in
        ``clock_probe`` responder, runner/network.py), pushed back as a
        ``clock_align`` RPC so the replica's spans merge onto the router
        clock (tracing/serve.py). Trace-time only; never fatal."""
        tracer = get_serve_tracer()
        if tracer is None or not tracer.enabled:
            return
        try:
            offset, err = estimate_offset_ns(
                lambda: rep.client.request({"kind": "clock_probe"})["t"],
                rounds=4)
            # offset maps router->replica; the replica needs replica->router
            rep.client.request({"kind": "clock_align",
                                "offset_ns": -offset})
        except Exception as e:  # noqa: BLE001 - alignment is best-effort
            log("warning", f"serving replica {rep.rid} clock align "
                           f"failed: {e}")

    # -- subclass hooks ------------------------------------------------------

    def _replica_env_extra(self, rid: int) -> dict:
        """Extra env for a spawning replica (role tags, plane-specific
        config contracts); the base plane needs none."""
        return {}

    def _queue_depth(self) -> int:
        """The pending-work figure the autoscaler steers on."""
        return self.batcher.depth()

    def autoscale_cfg(self):
        """The config the scale decision reads. The base manager holds the
        router's live ServeConfig, so a committed controller retune of
        ``target_queue``/``max_replicas`` (control/serving.py) moves the
        scale-out threshold on the next tick without a restart; pool
        subclasses that pin a copied config override this to splice the
        live steering knobs back in."""
        return self.cfg

    # -- dispatch worker (one per live replica) ------------------------------

    def _worker(self, rep: _Replica) -> None:
        buckets = bucket_sizes(self.cfg.max_batch)
        tracer = get_serve_tracer()
        batches = 0
        while not self._closed.is_set() and rep.state == "serving":
            batch = self.batcher.take_batch(_TAKE_TIMEOUT_S)
            if not batch:
                continue
            n = len(batch)
            arr = pad_batch([r.x for r in batch], bucket_for(n, buckets))
            t0 = time.monotonic()
            batches += 1
            if tracer:
                # queue wait per request, then ONE dispatch span per
                # device batch with the member request ids in args — the
                # batch is the stateless plane's unit of work, like the
                # decode iteration on the token-level plane.
                now_ns = tracer.now_ns()
                for r in batch:
                    tracer.span(r.tid, "queue", int(r.enqueue_t * 1e9),
                                now_ns, replica=rep.rid)
            try:
                resp = rep.client.request(
                    {"kind": "infer", "inputs": arr, "n_valid": n,
                     "trace": f"it:serve-{rep.rid}:{batches}"})
            except Exception as e:  # noqa: BLE001 - any wire fault = death
                self._requeue_failed(batch)
                self._mark_dead(rep, f"infer dispatch failed: {e}")
                break
            service_s = time.monotonic() - t0
            if tracer:
                tracer.span(f"it:serve-{rep.rid}:{batches}", "infer",
                            int(t0 * 1e9), tracer.now_ns(),
                            rids=[r.rid for r in batch], n=n,
                            replica=rep.rid, ok=bool(resp.get("ok")))
            if not resp.get("ok"):
                # The model itself raised: deterministic per-batch failure,
                # retrying elsewhere would fail the same way. Replica lives.
                for r in batch:
                    if r.fail(503, f"model error: {resp.get('error')}"):
                        self._fail_c.inc()
                continue
            outputs = resp["outputs"][:n]
            done_t = time.monotonic()
            for i, r in enumerate(batch):
                if r.finish(outputs[i]):
                    self._ok_c.inc()
                    self._latency_h.observe(done_t - r.enqueue_t)
            rep.requests_done += n
            self.admission.observe_batch(n, service_s)
            rec = int(resp.get("recompiles", 0))
            if rec > rep.last_recompiles:
                self._recompile_c.inc(rec - rep.last_recompiles)
                rep.last_recompiles = rec
        if rep.state == "draining":
            rep.drained.set()

    def _requeue_failed(self, batch) -> None:
        """Replica died mid-batch: retry everyone on the survivors, up to
        ``max_retries``; the rest fail 503 (the smoke's zero-failed-
        requests bar holds because retries land on live replicas)."""
        keep = []
        for r in batch:
            r.retries += 1
            if r.retries > self.cfg.max_retries:
                if r.fail(503, "replica died; retries exhausted"):
                    self._fail_c.inc()
            else:
                self._retry_c.inc()
                keep.append(r)
        if keep:
            self.batcher.requeue_front(keep)

    # -- death / drain -------------------------------------------------------

    def _mark_dead(self, rep: _Replica, reason: str) -> None:
        if rep.state == "dead":
            return
        was = rep.state
        rep.state = "dead"
        self._deaths_c.inc()
        self.blacklist.record_failure(f"replica:{rep.rid}")
        log("warning", f"serving replica {rep.rid} dead ({was}): {reason}; "
                       f"in-flight requests retry on survivors")
        # Flight-recorder escalation: the router's ring gets a
        # structured death event and dumps — the replica's own ring file
        # survives in HOROVOD_FLIGHT_DIR for the bundle to collect.
        fl = _flight.get_flight()
        fl.event("replica_death", replica=rep.rid, pid=rep.pid,
                 state_was=was, reason=str(reason)[:200])
        fl.dump(f"replica-death-{rep.rid}")

    def _start_drain(self, rep: Optional[_Replica]) -> None:
        if rep is None:
            return
        rep.state = "draining"
        log("info", f"serving: draining replica {rep.rid} (scale-down)")

    def _finish_drain(self, rep: _Replica) -> None:
        self._reap(rep)
        with self._lock:
            self._replicas.pop(rep.rid, None)
        self._free_device(rep)
        log("info", f"serving: replica {rep.rid} drained and reaped")

    def _reap(self, rep: _Replica) -> None:
        if rep.client is not None:
            try:
                rep.client.close()
            except OSError:
                pass
            rep.client = None
        if rep.proc.poll() is None:
            rep.proc.kill()
        try:
            rep.proc.wait(timeout=10)
        except Exception:  # noqa: BLE001
            pass
        try:
            rep.log_file.close()
        except OSError:
            pass
