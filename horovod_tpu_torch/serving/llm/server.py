"""The LLM inference server — token-level router composition root (the
port's counterpart of ``horovod_tpu.serving.llm.server``).

Wires the generation plane together in one process (replica subprocesses
do all the model math on their cards; the router holds host state only and
creates no CUDA context):

    frontend (POST /v1/generate)
        -> KV admission (shed on projected BLOCK availability)
        -> prefill queue -> prefill pool (TTFT = this round trip)
        -> handoff queue (serialized KV pages)
        -> decode pool (iteration-level scheduler per replica)
        -> poll loop -> request completion + llm telemetry mirrors

Colocated mode (``HOROVOD_SERVE_LLM_COLOCATED=1``) folds the middle out:
one ``both``-role pool, prompts go straight into the decode engine and
the handoff never serializes (``horovod_serve_llm_handoffs_total{
path="local"}`` vs ``{path="wire"}``).

Replicas run on the card unless the caller asks for the CPU:
``LLMServer(..., device=None)`` resolves the device through
``common.basics.resolve_device`` (raising where there is no card), and
each pool gives its replica ``i`` card ``i % torch.cuda.device_count()``.

Programmatic use (tests, benchmarks, ``chip_smoke.py``)::

    server = llm.LLMServer().start()      # TinyLM from the seed knobs
    server.wait_ready(60)
    req, _ = server.submit_generate([3, 17, 5], max_new_tokens=16)
    req.event.wait(30)

``python -m horovod_tpu_torch.serving --llm`` runs the same thing
standalone.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from ...metrics import registry as _registry
from ...control.serving import maybe_start_serving_controller
from ...metrics.anomaly import AnomalyDetector
from ...tracing.serve import init_serve_tracer
from ...utils.logging import log
from ..admission import KVAdmission
from ..config import LLMConfig, ServeConfig
from ..frontend import ServeFrontend
from .generator import GenQueue, GenRequest
from .handoff import handoff_nbytes
from .kv_cache import blocks_for
from .manager import PoolManager

DEFAULT_LM_BUILDER = "horovod_tpu_torch.serving.model:lm_builder"


class LLMServer:
    def __init__(self, checkpoint: str = "",
                 builder: str = DEFAULT_LM_BUILDER,
                 config: Optional[ServeConfig] = None,
                 llm_config: Optional[LLMConfig] = None,
                 replica_env: Optional[dict] = None,
                 device=None) -> None:
        from ...common.basics import resolve_device

        self.device = resolve_device(device)
        self.cfg = config or ServeConfig.from_env()
        self.llm = llm_config or LLMConfig.from_env()
        self.checkpoint = checkpoint
        self.builder = builder
        self.replica_env = dict(replica_env or {})
        self.reg = _registry()
        self.admission = KVAdmission(self.llm, self.reg)
        self.prefill_q = GenQueue(cap=self.cfg.queue_cap)
        self.handoff_q = GenQueue(cap=self.cfg.queue_cap)
        if self.llm.colocated:
            self.pools = {"both": PoolManager(
                self.cfg, self, "both", self.llm.decode_replicas,
                reg=self.reg)}
        else:
            self.pools = {
                "prefill": PoolManager(self.cfg, self, "prefill",
                                       self.llm.prefill_replicas,
                                       reg=self.reg),
                "decode": PoolManager(self.cfg, self, "decode",
                                      self.llm.decode_replicas,
                                      reg=self.reg),
            }
        self._frontend: Optional[ServeFrontend] = None
        self.port: Optional[int] = None
        self._started_t: Optional[float] = None
        # -- per-decode-replica stat mirrors (rep key -> last snapshot) ----
        self._stats_lock = threading.Lock()
        self._rep_stats: dict[int, dict] = {}
        self._rep_sequences: dict[int, list] = {}
        self.tracer = None          # set by start() (tracing/serve.py)
        self.anomaly = None         # set by start() (metrics/anomaly.py)
        self.controller = None      # set by start() (control/serving.py)
        # -- llm telemetry (the JAX package's serving_llm_* series) --------
        self._active_g = self.reg.gauge(
            "horovod_serve_llm_active_sequences",
            help="sequences in decode batches across the decode pool")
        self._waiting_g = self.reg.gauge(
            "horovod_serve_llm_waiting_sequences",
            help="sequences queued inside decode replicas awaiting "
                 "admission (router queues not included)")
        self._blocks_used_g = self.reg.gauge(
            "horovod_serve_llm_kv_blocks_used",
            help="KV blocks allocated across the decode pool")
        self._blocks_free_g = self.reg.gauge(
            "horovod_serve_llm_kv_blocks_free",
            help="KV blocks free across the decode pool")
        self._occupancy_g = self.reg.gauge(
            "horovod_serve_llm_mean_batch_occupancy",
            help="mean sequences per decode iteration (iterations with "
                 "work only) — the token-level coalescing figure")
        self._preempt_c = self.reg.counter(
            "horovod_serve_llm_preemptions_total",
            help="sequences preempted-and-requeued on KV exhaustion or "
                 "fairness force-admission")
        self._tok_prefill_c = self.reg.counter(
            "horovod_serve_llm_tokens_total",
            help="tokens processed by phase", phase="prefill")
        self._tok_decode_c = self.reg.counter(
            "horovod_serve_llm_tokens_total",
            help="tokens processed by phase", phase="decode")
        self._handoff_bytes_c = self.reg.counter(
            "horovod_serve_llm_handoff_bytes_total",
            help="KV page bytes moved prefill->decode over the wire")
        self._handoff_wire_c = self.reg.counter(
            "horovod_serve_llm_handoffs_total",
            help="prefill->decode sequence handoffs", path="wire")
        self._handoff_local_c = self.reg.counter(
            "horovod_serve_llm_handoffs_total",
            help="prefill->decode sequence handoffs", path="local")
        self._spec_proposed_c = self.reg.counter(
            "horovod_serve_llm_spec_tokens_total",
            help="speculative-decoding draft tokens by verify outcome",
            kind="proposed")
        self._spec_accepted_c = self.reg.counter(
            "horovod_serve_llm_spec_tokens_total",
            help="speculative-decoding draft tokens by verify outcome",
            kind="accepted")
        self._prefix_hit_c = self.reg.counter(
            "horovod_serve_llm_prefix_tokens_total",
            help="radix prefix-cache admission tokens by lookup outcome",
            kind="hit")
        self._prefix_lookup_c = self.reg.counter(
            "horovod_serve_llm_prefix_tokens_total",
            help="radix prefix-cache admission tokens by lookup outcome",
            kind="lookup")
        self._recovered_c = self.reg.counter(
            "horovod_serve_llm_kv_blocks_recovered_total",
            help="trie-retained KV blocks evicted back to the free list "
                 "under allocation pressure")
        self._cow_c = self.reg.counter(
            "horovod_serve_llm_cow_copies_total",
            help="KV blocks copy-on-write-split before a write into a "
                 "shared block")
        self._streams_c = self.reg.counter(
            "horovod_serve_llm_streams_total",
            help="generate requests served as chunked streaming responses")
        self._ttft_h = self.reg.histogram(
            "horovod_serve_llm_ttft_seconds",
            help="time to first token (submit -> first generated token)")
        self._tpot_h = self.reg.histogram(
            "horovod_serve_llm_tpot_seconds",
            help="time per output token over the decode phase")
        self._ok_c = self.reg.counter(
            "horovod_serve_requests_total",
            help="terminal request outcomes by HTTP-style code", code="200")
        self._retry_c = self.reg.counter(
            "horovod_serve_retries_total",
            help="requests re-dispatched after a replica death")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "LLMServer":
        self._started_t = time.time()
        self.tracer = init_serve_tracer("serve-router")
        self.anomaly = AnomalyDetector.start_from_env(
            reg=self.reg, slo_s=self.llm.ttft_slo_ms / 1000.0)
        self.controller = maybe_start_serving_controller(
            self.cfg, admission=self.admission, anomaly=self.anomaly,
            reg=self.reg)
        for pool in self.pools.values():
            pool.start()
        self._frontend = ServeFrontend(self)
        self.port = self._frontend.port
        pools = {r: p.cfg.min_replicas for r, p in self.pools.items()}
        log("info", f"llm serving: router on http://{self.cfg.host}:"
                    f"{self.port} — pools {pools}, KV "
                    f"{self.llm.num_blocks}x{self.llm.block_size} "
                    f"tokens/replica, max_active={self.llm.max_active}")
        return self

    def ready_count(self) -> int:
        """/healthz figure: 0 until EVERY pool has a serving replica (a
        prefill pool with no decode pool cannot answer anything)."""
        counts = [p.serving_count() for p in self.pools.values()]
        return 0 if min(counts) < 1 else sum(counts)

    def wait_ready(self, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ready_count() >= 1:
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
        for q in (self.prefill_q, self.handoff_q):
            for item in q.close():
                req = item[0] if isinstance(item, tuple) else item
                if req.fail(503, "server shutting down"):
                    self.count_code(503)
        for pool in self.pools.values():
            pool.stop()
        if self.tracer is not None:
            self.tracer.flush()

    # -- request path --------------------------------------------------------

    def submit_generate(self, prompt, max_new_tokens: Optional[int] = None,
                        deadline_ms: Optional[float] = None
                        ) -> Tuple[GenRequest, float]:
        """Validate, admission-check and enqueue ONE generation. Returns
        the request (already failed when rejected/shed) and the projected
        block wait the decision saw."""
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.llm.max_new_tokens)
        deadline_s = (deadline_ms if deadline_ms is not None
                      else self.llm.slo_ms) / 1000.0
        req = GenRequest(prompt, max_new,
                         deadline_t=time.monotonic() + deadline_s)
        err = self._validate(req)
        if err:
            req.fail(400, err)
            return req, 0.0
        free, queued = self._block_availability(req)
        admitted, wait = self.admission.admit(
            req.blocks_needed(self.llm.block_size), free, queued,
            budget_s=min(deadline_s, self.admission.ttft_budget_s))
        if not admitted:
            req.fail(429, f"shed: projected KV-block wait "
                          f"{wait * 1e3:.0f}ms exceeds the "
                          f"{self.llm.ttft_slo_ms:.0f}ms TTFT SLO")
        elif not self.prefill_q.put(req):
            if req.fail(429, "queue full"):
                self.count_code(429)
        if self.tracer is not None:
            self.tracer.span(
                req.tid, "admit", int(req.enqueue_t * 1e9),
                self.tracer.now_ns(), rid=req.rid,
                decision="ok" if req.code == 0 else "shed",
                projected_wait_ms=round(min(wait, 1e9) * 1e3, 3),
                blocks_needed=req.blocks_needed(self.llm.block_size))
        return req, wait

    def _validate(self, req: GenRequest) -> str:
        if not req.prompt:
            return "prompt must be a non-empty list of token ids"
        if any(not 0 <= t < self.llm.vocab for t in req.prompt):
            return f"token ids must be in [0, {self.llm.vocab})"
        if req.max_new_tokens < 1 or \
                req.max_new_tokens > self.llm.max_new_tokens:
            return (f"max_tokens must be in [1, "
                    f"{self.llm.max_new_tokens}] (HOROVOD_SERVE_LLM_"
                    f"MAX_TOKENS)")
        total = len(req.prompt) + req.max_new_tokens
        if total > self.llm.max_context:
            return (f"prompt+max_tokens={total} exceeds max_context="
                    f"{self.llm.max_context}")
        if blocks_for(total, self.llm.block_size) > \
                self.llm.usable_blocks():
            return (f"prompt+max_tokens={total} needs more KV blocks "
                    f"than a replica's usable pool "
                    f"({self.llm.usable_blocks()}x"
                    f"{self.llm.block_size} tokens)")
        return ""

    def _block_availability(self, req: GenRequest) -> Tuple[int, int]:
        """(free blocks across the decode pool, blocks demanded by work
        queued ahead of this request — router queues plus the replicas'
        own waiting sequences)."""
        with self._stats_lock:
            free = sum(s.get("blocks_free", 0)
                       for s in self._rep_stats.values())
            rep_waiting = sum(s.get("waiting_blocks_needed", 0)
                              for s in self._rep_stats.values())
        bs = self.llm.block_size
        queued = rep_waiting + sum(
            (it[0] if isinstance(it, tuple) else it).blocks_needed(bs)
            for q in (self.prefill_q, self.handoff_q)
            for it in q.items())
        if not self._rep_stats:
            # No decode stats yet (cold start): report the configured
            # pool as free so nothing sheds before the first poll.
            n_dec = self.llm.decode_replicas
            free = self.llm.num_blocks * n_dec
        return free, queued

    def submit_generate_http(self, body: dict):
        """Parse + admit one POST /v1/generate body. Returns ``(status,
        error_payload, headers, req)`` — ``req`` is None exactly when the
        request already terminated (400/429) and the error triple is the
        response; otherwise the caller waits on ``req`` (blocking or
        streaming) and finishes with :meth:`finish_generate_http`."""
        try:
            prompt = body["prompt"]
            if not isinstance(prompt, (list, tuple)):
                raise ValueError("prompt must be a list of token ids")
            prompt = [int(t) for t in prompt]
            max_new = body.get("max_tokens")
            if max_new is not None:
                max_new = int(max_new)
            deadline_ms = body.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError("deadline_ms must be > 0")
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"malformed request: {e}"}, None, None
        req, wait = self.submit_generate(prompt, max_new, deadline_ms)
        if req.code == 429:
            return 429, {"error": req.error}, \
                {"Retry-After": f"{max(wait, 0.001):.3f}"}, None
        if req.code == 400:
            return 400, {"error": req.error}, None, None
        return 0, None, None, req

    def finish_generate_http(self, req: GenRequest, t0: float):
        """(status, payload) once ``req.event`` is set (or its deadline
        passed): the terminal /v1/generate response body. The streaming
        path sends exactly this object as its final chunk, which is what
        makes chunk reassembly == the non-streaming body."""
        if not req.event.is_set():
            if req.fail(504, "deadline exceeded awaiting generation"):
                self.count_code(504)
        if req.code != 200:
            return req.code, {"error": req.error}
        tpot = req.tpot_s()
        return 200, {
            "tokens": req.tokens,
            "n_tokens": len(req.tokens),
            "ttft_ms": round((req.ttft_s or 0.0) * 1e3, 3),
            "tpot_ms": round(tpot * 1e3, 3) if tpot is not None else None,
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
        }

    def handle_generate_http(self, body: dict):
        """(status, payload, headers) for POST /v1/generate — the hook
        frontend._Handler dispatches to (non-streaming path)."""
        t0 = time.monotonic()
        status, payload, headers, req = self.submit_generate_http(body)
        if req is None:
            return status, payload, headers
        budget = (req.deadline_t or t0) - t0
        req.event.wait(timeout=budget + 0.05)
        status, payload = self.finish_generate_http(req, t0)
        return status, payload, None

    def stream_requested(self, body: dict) -> bool:
        """Per-request ``"stream"`` wins; HOROVOD_SERVE_LLM_STREAM sets
        the default."""
        flag = body.get("stream") if isinstance(body, dict) else None
        if flag is None:
            return bool(self.llm.stream)
        return bool(flag)

    def count_stream(self) -> None:
        self._streams_c.inc()

    # -- pool-worker hooks ---------------------------------------------------

    def take_decode_feed(self):
        """Next (request, payload|None) for a decode worker: serialized
        handoffs from the prefill pool, or raw prompts in colocated mode
        (payload None -> the replica prefills in-engine)."""
        if self.llm.colocated:
            req = self.prefill_q.take(0)
            return None if req is None else (req, None)
        return self.handoff_q.take(0)

    def on_prefilled(self, req: GenRequest, payload: dict) -> None:
        req.mark_first_token()
        req.prefilled_t = time.monotonic()
        self._tok_prefill_c.inc(len(req.prompt))
        if not self.handoff_q.put((req, payload)):
            if req.fail(503, "handoff queue full or shutting down"):
                self.count_code(503)

    def count_handoff(self, req: GenRequest, payload) -> None:
        if payload is None:
            self._handoff_local_c.inc()
        else:
            self._handoff_wire_c.inc()
            self._handoff_bytes_c.inc(handoff_nbytes(payload))

    def on_finished(self, req: Optional[GenRequest], rec: dict) -> None:
        """A decode replica finished sequence ``rec``; ``req`` is None
        when the request was already resolved (late completion after a
        requeue — the single-assignment state absorbs it)."""
        if req is None:
            return
        if not rec.get("ok"):
            if req.fail(503, rec.get("error") or "generation failed"):
                self.count_code(503)
            return
        # Colocated TTFT refinement: the replica measured submit->first
        # token locally; poll-granularity marking may have missed it.
        if req.ttft_s is None and rec.get("ttft_rel_s") is not None:
            req.mark_first_token(req.enqueue_t + rec["ttft_rel_s"])
        if req.finish(rec["tokens"]):
            self._ok_c.inc()
            self._ttft_h.observe(req.ttft_s or 0.0)
            tpot = req.tpot_s()
            if tpot is not None:
                self._tpot_h.observe(tpot)
            if self.tracer is not None:
                self.tracer.point(
                    req.tid, "retire", rid=req.rid, ok=True,
                    tokens=len(req.tokens),
                    ttft_ms=round((req.ttft_s or 0.0) * 1e3, 3),
                    preemptions=rec.get("preemptions", 0))

    def retry_or_fail(self, reqs) -> None:
        """Replica died holding these: requeue at the prefill-queue FRONT
        (re-prefill regenerates identical KV) up to ``max_retries``."""
        keep = []
        for req in reqs:
            req.retries += 1
            if req.retries > self.cfg.max_retries:
                if req.fail(503, "replica died; retries exhausted"):
                    self.count_code(503)
            else:
                self._retry_c.inc()
                keep.append(req)
        if keep:
            self.prefill_q.put_front(keep)

    def mirror_stats(self, rep_key: int, stats: dict, dt_s: float) -> None:
        """Fold one decode replica's scheduler stats into the router's
        gauges/counters and the admission block-release EWMA."""
        if not stats:
            return
        with self._stats_lock:
            last = self._rep_stats.get(rep_key, {})
            self._rep_stats[rep_key] = stats
            agg = {k: sum(s.get(k, 0) for s in self._rep_stats.values())
                   for k in ("active", "waiting", "blocks_used",
                             "blocks_free", "iterations_total",
                             "occupancy_sum")}
        for counter, key in ((self._preempt_c, "preemptions_total"),
                             (self._tok_decode_c, "tokens_decode_total"),
                             (self._spec_proposed_c, "spec_proposed_total"),
                             (self._spec_accepted_c, "spec_accepted_total"),
                             (self._prefix_hit_c, "prefix_hit_tokens_total"),
                             (self._prefix_lookup_c,
                              "prefix_lookup_tokens_total"),
                             (self._recovered_c, "recovered_blocks_total"),
                             (self._cow_c, "cow_copies_total")):
            delta = stats.get(key, 0) - last.get(key, 0)
            if delta > 0:
                counter.inc(delta)
        if self.llm.colocated:
            delta = stats.get("tokens_prefill_total", 0) \
                - last.get("tokens_prefill_total", 0)
            if delta > 0:
                self._tok_prefill_c.inc(delta)
        freed = stats.get("blocks_freed_total", 0) \
            - last.get("blocks_freed_total", 0)
        self.admission.observe_release(max(freed, 0), dt_s)
        free, queued = self._block_availability(None)
        self.admission.refresh_projection(free, queued)
        self._active_g.set(agg["active"])
        self._waiting_g.set(agg["waiting"])
        self._blocks_used_g.set(agg["blocks_used"])
        self._blocks_free_g.set(agg["blocks_free"])
        if agg["iterations_total"]:
            self._occupancy_g.set(
                agg["occupancy_sum"] / agg["iterations_total"])

    def drop_replica_stats(self, rep_key: int) -> None:
        """A decode replica died: forget its last scheduler snapshot. Its
        sequences are requeued through re-prefill, so leaving the mirror
        in place would double-count them (gauges AND the autoscaler's
        decode_demand would see phantom waiting/active sequences)."""
        with self._stats_lock:
            self._rep_stats.pop(rep_key, None)
            self._rep_sequences.pop(rep_key, None)

    def decode_demand(self) -> int:
        """Pending decode work the pool autoscaler steers on: the router
        handoff queue PLUS sequences queued inside decode replicas — the
        greedy feed loop hides the backlog in the replica schedulers, so
        the handoff queue alone under-reports a decode bottleneck."""
        with self._stats_lock:
            waiting = sum(s.get("waiting", 0)
                          for s in self._rep_stats.values())
        return self.handoff_q.depth() + int(waiting)

    def mirror_sequences(self, rep_key: int, sequences: list) -> None:
        """Latest per-sequence scheduler state from one decode replica —
        the GET /debug/sequences view."""
        with self._stats_lock:
            self._rep_sequences[rep_key] = sequences

    def count_code(self, code: int) -> None:
        self.reg.counter("horovod_serve_requests_total",
                         help="terminal request outcomes by HTTP-style code",
                         code=str(code)).inc()

    # -- introspection -------------------------------------------------------

    def debug_sequences(self) -> dict:
        """Live per-sequence state across the decode pool (poll-mirror
        freshness, one entry per sequence the schedulers hold)."""
        with self._stats_lock:
            reps = {str(k): list(v)
                    for k, v in sorted(self._rep_sequences.items())}
        return {"time_unix_s": time.time(), "replicas": reps,
                "prefill_queue_depth": self.prefill_q.depth(),
                "handoff_queue_depth": self.handoff_q.depth()}

    def stats(self) -> dict:
        snap = self.reg.snapshot()
        ttft = snap["histograms"].get("horovod_serve_llm_ttft_seconds", {})
        tpot = snap["histograms"].get("horovod_serve_llm_tpot_seconds", {})
        with self._stats_lock:
            agg = {k: sum(s.get(k, 0) for s in self._rep_stats.values())
                   for k in ("active", "waiting", "blocks_used",
                             "blocks_free", "iterations_total",
                             "occupancy_sum", "preemptions_total",
                             "tokens_decode_total", "finished_total",
                             "spec_proposed_total", "spec_accepted_total",
                             "prefix_hit_tokens_total",
                             "prefix_lookup_tokens_total",
                             "recovered_blocks_total", "cow_copies_total",
                             "decode_busy_s")}
        return {
            "serving": {
                "uptime_s": round(time.time() - (self._started_t or
                                                 time.time()), 1),
                "prefill_queue_depth": self.prefill_q.depth(),
                "handoff_queue_depth": self.handoff_q.depth(),
                "admission": self.admission.report(),
                "llm": {
                    **agg,
                    "mean_batch_occupancy": round(
                        agg["occupancy_sum"]
                        / max(agg["iterations_total"], 1), 3),
                    "spec_acceptance_rate": round(
                        agg["spec_accepted_total"]
                        / max(agg["spec_proposed_total"], 1), 4),
                    # engine decode throughput: tokens per second of
                    # decode-phase wall time, summed across replicas —
                    # the denominator client-side tok/s can't see (HTTP
                    # + polling dominate it).
                    "decode_tokens_per_busy_s": round(
                        agg["tokens_decode_total"]
                        / max(agg["decode_busy_s"], 1e-9), 1),
                    "prefix_hit_rate": round(
                        agg["prefix_hit_tokens_total"]
                        / max(agg["prefix_lookup_tokens_total"], 1), 4),
                    "ttft_p50_ms": round(ttft.get("p50", 0.0) * 1e3, 3),
                    "ttft_p99_ms": round(ttft.get("p99", 0.0) * 1e3, 3),
                    "tpot_p50_ms": round(tpot.get("p50", 0.0) * 1e3, 3),
                    "tpot_p99_ms": round(tpot.get("p99", 0.0) * 1e3, 3),
                },
                "pools": {role: pool.describe()
                          for role, pool in self.pools.items()},
            },
            "metrics": snap,
        }
