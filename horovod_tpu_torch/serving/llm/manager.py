"""Prefill/decode pool manager — the request-level plane's replica
supervision shell with role-specific dispatch workers (the port's own copy
of ``horovod_tpu.serving.llm.manager``; each pool gives its replicas their
cards as ``ReplicaManager`` does).

One :class:`PoolManager` supervises one POOL (prefill, decode, or the
colocated ``both``): the spawn/ready-file/ping bring-up, dead-replica
detection, blacklist and respawn machinery are inherited verbatim from
:class:`~..manager.ReplicaManager`; what changes per role is the worker
loop a live replica gets:

- **prefill worker**: pulls queued :class:`~.generator.GenRequest`\\ s,
  runs the ``prefill`` RPC (TTFT is this round trip — the first
  generated token rides the response), packs the KV pages and puts the
  handoff on the router's handoff queue;
- **decode worker**: feeds handed-off sequences (``submit_seq``, the
  wire handoff) — or raw prompts (``generate``) when this pool is the
  colocated fast path — into the replica's iteration scheduler, then
  ``poll``\\ s: finished sequences resolve their requests, per-sequence
  progress drives colocated TTFT observation, and scheduler stats feed
  the router's ``horovod_serve_llm_*`` mirrors and the block-release
  EWMA behind KV admission.

Death recovery is the serving plane's bar (zero failed client requests
across a SIGKILL): every sequence a decode replica holds is registered
here at submit; ``_mark_dead`` — reached from the worker's wire fault OR
the supervisor's process poll, whichever first, and idempotent — drains
the registry back to the PREFILL queue front. Re-prefill on survivors
(or the respawn) regenerates identical KV, so the retried generation is
token-for-token the one the dead replica was computing.
"""

from __future__ import annotations

import dataclasses
import time

from ...tracing.serve import get_serve_tracer
from ..manager import ReplicaManager, _Replica
from .handoff import handoff_nbytes, pack_kv, pack_kv_sharded

_FEED_BATCH = 16          # sequences fed to a decode replica per cycle
_POLL_IDLE_SLEEP_S = 0.02


class PoolManager(ReplicaManager):
    replica_module = "horovod_tpu_torch.serving.llm.replica"

    def __init__(self, cfg, server, role: str, n_replicas: int,
                 reg=None) -> None:
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"unknown pool role {role!r}")
        pool_cfg = dataclasses.replace(
            cfg, min_replicas=n_replicas, max_replicas=n_replicas)
        # The router's LIVE config (pool_cfg above is a pinned copy):
        # autoscale_cfg() splices its steering knobs back in when the
        # runtime controller owns the serving plane.
        self.shared_cfg = cfg
        super().__init__(pool_cfg, batcher=None, admission=None,
                         checkpoint=server.checkpoint,
                         builder=server.builder,
                         replica_env=server.replica_env, reg=reg,
                         device=server.device)
        self.server = server
        self.role = role
        # rep.rid -> {req.rid -> GenRequest}: sequences a decode replica
        # currently owns (guarded by the manager lock; the death path
        # drains it exactly once thanks to _mark_dead's idempotence)
        self._inflight: dict[int, dict] = {}

    # -- hooks into the base supervision loop --------------------------------

    def _replica_env_extra(self, rid: int) -> dict:
        env = {"HVD_SERVE_LLM_ROLE": self.role}
        env.update(self.server.llm.to_env())
        return env

    def _queue_depth(self) -> int:
        if self.role == "prefill":
            return self.server.prefill_q.depth()
        if self.role == "decode":
            # The greedy feed loop moves handed-off sequences straight
            # into the replica's iteration scheduler, so the router-side
            # handoff queue stays near-empty even when decode is the
            # bottleneck — the real pending-decode demand sits INSIDE the
            # replicas. Steer the autoscaler on both.
            return self.server.decode_demand()
        return self.server.handoff_q.depth()

    def autoscale_cfg(self):
        """Decode-pool scale-out under the runtime controller.

        By default every LLM pool is pinned to its configured replica
        count (min == max above) — the disaggregated topology is an
        operator decision. When the serving controller owns the plane
        (HOROVOD_CONTROLLER=1 started one on the router), the decode pool
        gains the job-level ``max_replicas`` ceiling and reads
        ``target_queue``/``cooldown_s`` LIVE from the router's shared
        config, so a committed ``target_queue`` cut (the drain_collapse
        mitigation) lowers the scale-out threshold on the next supervisor
        tick — that is how an injected decode slowdown's goodput recovers
        without human action."""
        if self.role != "decode" or self.server.controller is None:
            return self.cfg
        shared = self.shared_cfg
        return dataclasses.replace(
            self.cfg,
            max_replicas=max(self.cfg.max_replicas, shared.max_replicas),
            target_queue=shared.target_queue,
            cooldown_s=shared.cooldown_s)

    def _mark_dead(self, rep: _Replica, reason: str) -> None:
        if rep.state == "dead":
            return
        super()._mark_dead(rep, reason)
        with self._lock:
            lost = list(self._inflight.pop(rep.rid, {}).values())
        # Its sequences requeue below, so the dead replica's last stat
        # mirror (active/waiting/blocks) must not keep counting as live
        # demand in the gauges and the autoscaler's steering figure.
        self.server.drop_replica_stats(rep.rid)
        if lost:
            self.server.retry_or_fail(lost)

    # -- role workers --------------------------------------------------------

    def _worker(self, rep: _Replica) -> None:
        if self.role == "prefill":
            self._prefill_worker(rep)
        else:
            self._decode_worker(rep)
        if rep.state == "draining":
            rep.drained.set()

    def _prefill_worker(self, rep: _Replica) -> None:
        tracer = get_serve_tracer()
        while not self._closed.is_set() and rep.state == "serving":
            req = self.server.prefill_q.take(0.25)
            if req is None:
                continue
            if req.expired():
                if req.fail(504, "deadline exceeded awaiting prefill"):
                    self.server.count_code(504)
                continue
            t0 = time.monotonic()
            if tracer:
                # prefill-queue wait, then the prefill RPC — the first
                # two phases of the TTFT decomposition.
                tracer.span(req.tid, "queue", int(req.enqueue_t * 1e9),
                            int(t0 * 1e9), rid=req.rid)
            try:
                resp = rep.client.request(
                    {"kind": "prefill", "tokens": req.prompt,
                     "trace": req.tid})
            except Exception as e:  # noqa: BLE001 - any wire fault = death
                self.server.retry_or_fail([req])
                self._mark_dead(rep, f"prefill dispatch failed: {e}")
                break
            if not resp.get("ok"):
                # Deterministic model error: retrying elsewhere would
                # fail identically. The replica lives.
                if req.fail(503, f"prefill error: {resp.get('error')}"):
                    self.server.count_code(503)
                continue
            rep.requests_done += 1
            if tracer:
                tracer.span(req.tid, "prefill", int(t0 * 1e9),
                            tracer.now_ns(), rid=req.rid, replica=rep.rid,
                            n_tokens=len(req.prompt))
            if "k_shards" in resp:
                # Sharded prefill group: the pages arrive and travel
                # onward as per-model-shard slices.
                payload = pack_kv_sharded(req.prompt, resp["k_shards"],
                                          resp["v_shards"],
                                          resp["next_token"])
            else:
                payload = pack_kv(req.prompt, resp["k"], resp["v"],
                                  resp["next_token"])
            self.server.on_prefilled(req, payload)

    def _decode_worker(self, rep: _Replica) -> None:
        last_poll_t = time.monotonic()
        tracer = get_serve_tracer()
        # Per-replica feed backpressure: a saturated replica's worker loop
        # never idle-sleeps, so without a cap it would vacuum every
        # handed-off sequence into its OWN scheduler and starve a newly
        # scaled-out sibling (sequences cannot migrate once submitted).
        # Feed each replica only to max_active plus a small prefetch
        # buffer; the excess stays on the router queue where any idle
        # replica can take it.
        cap = self.server.llm.max_active + 2
        while not self._closed.is_set() and rep.state == "serving":
            in_hand = None
            try:
                with self._lock:
                    pending = len(self._inflight.get(rep.rid, {}))
                fed = 0
                while fed < min(_FEED_BATCH, cap - pending):
                    item = self.server.take_decode_feed()
                    if item is None:
                        break
                    req, payload = item
                    in_hand = req
                    if req.expired():
                        if req.fail(504,
                                    "deadline exceeded awaiting decode"):
                            self.server.count_code(504)
                        in_hand = None
                        continue
                    t0 = time.monotonic()
                    if payload is None:   # colocated: prompt straight in
                        resp = rep.client.request(
                            {"kind": "generate", "rid": req.rid,
                             "tokens": req.prompt,
                             "max_new_tokens": req.max_new_tokens,
                             "front": req.retries > 0})
                    else:                 # wire handoff from the prefill pool
                        resp = rep.client.request(
                            {"kind": "submit_seq", "rid": req.rid,
                             "payload": payload,
                             "max_new_tokens": req.max_new_tokens,
                             "front": req.retries > 0})
                    if not resp.get("ok"):
                        if req.fail(503,
                                    f"submit error: {resp.get('error')}"):
                            self.server.count_code(503)
                        in_hand = None
                        continue
                    with self._lock:
                        self._inflight.setdefault(rep.rid, {})[
                            req.rid] = req
                    in_hand = None
                    fed += 1
                    self.server.count_handoff(req, payload)
                    if tracer:
                        # KV handoff: prefill completion -> accepted by
                        # the decode scheduler (queue time + the
                        # serialized submit_seq RPC). Colocated requests
                        # skip prefill, so their queue wait is booked
                        # here instead of the prefill worker.
                        if payload is None:
                            tracer.span(req.tid, "queue",
                                        int(req.enqueue_t * 1e9),
                                        int(t0 * 1e9), rid=req.rid)
                        start = req.prefilled_t or t0
                        tracer.span(
                            req.tid, "handoff", int(start * 1e9),
                            tracer.now_ns(), rid=req.rid, replica=rep.rid,
                            path="local" if payload is None else "wire",
                            nbytes=0 if payload is None
                            else handoff_nbytes(payload))
                resp = rep.client.request({"kind": "poll"})
            except Exception as e:  # noqa: BLE001 - any wire fault = death
                if in_hand is not None:
                    self.server.retry_or_fail([in_hand])
                self._mark_dead(rep, f"decode dispatch failed: {e}")
                break
            if not resp.get("ok"):
                # A handler-level error with a live transport: log and
                # keep polling (the engine thread may still be healthy).
                from ...utils.logging import log

                log("warning", f"llm decode replica {rep.rid} poll error: "
                               f"{resp.get('error')}")
                time.sleep(_POLL_IDLE_SLEEP_S)
                continue
            now = time.monotonic()
            busy = self._handle_poll(rep, resp, now - last_poll_t)
            last_poll_t = now
            if not fed and not busy:
                time.sleep(_POLL_IDLE_SLEEP_S)

    def _handle_poll(self, rep: _Replica, resp: dict,
                     dt_s: float) -> bool:
        with self._lock:
            mine = self._inflight.get(rep.rid, {})
            finished = [(rec, mine.pop(rec["rid"], None))
                        for rec in resp.get("finished", [])]
            # progress values are token LISTS (generator.poll): length >= 1
            # is the TTFT observation, the tokens themselves feed each
            # request's streaming prefix for the chunked frontend flush.
            progressing = [(mine.get(rid), toks)
                           for rid, toks in resp.get("progress", {}).items()
                           if len(toks) >= 1]
        for rec, req in finished:
            self.server.on_finished(req, rec)
            if req is not None:
                rep.requests_done += 1
        for req, toks in progressing:
            if req is not None:
                req.mark_first_token()
                req.push_tokens(toks)
        self.server.mirror_stats(rep.rid, resp.get("stats", {}), dt_s)
        self.server.mirror_sequences(rep.rid, resp.get("sequences", []))
        stats = resp.get("stats", {})
        return bool(finished or resp.get("progress")
                    or stats.get("waiting"))
