"""Iteration-level scheduler — requests join and leave the batch at
TOKEN granularity (the actual Orca contribution; Yu et al., OSDI '22).
The port's counterpart of ``horovod_tpu.serving.llm.scheduler``: the same
scheduling, with the model and its verify buffers on the cache's device.

One :meth:`IterationScheduler.step` is one engine iteration:

1. **admit** — move waiting sequences into the running batch while slots
   (``max_active``) and KV blocks (above the allocator's watermark) allow.
   A handed-off sequence loads its prefilled K/V into freshly allocated
   blocks; a fresh or preempted sequence prefills locally. FAIRNESS: a
   waiting sequence that has sat out more than ``admission_window``
   iterations force-admits by preempting the newest running sequence —
   a long generation can never starve queued prefills indefinitely.
2. **decode** — one token for EVERY running sequence: gather its context
   through the block table, run the decode step, scatter the new K/V,
   append the token. A sequence crossing a block boundary extends its
   table (allowed to dip into the watermark reserve); if even the reserve
   is dry, the newest running sequence is preempted-and-requeued — memory
   pressure degrades to queueing, never to OOM.
3. **retire** — a sequence that emitted EOS or reached ``max_new_tokens``
   leaves the batch *this* iteration and frees its blocks immediately (no
   padded-batch head-of-line blocking: the freed slot and blocks are
   available to the very next admission).

Determinism: greedy decode over per-sequence state means the running
batch's composition cannot change any sequence's tokens — every output
must equal the sequential oracle (``serving/model.py:lm_generate``),
which is the cross-contamination check the tests and smoke enforce.

Preemption picks the NEWEST running sequence (most recent admission):
it has the least decode progress to re-prefill, and FCFS age ordering is
what makes the fairness window meaningful. A preempted sequence keeps
its generated tokens, drops its blocks, and re-enters the waiting queue
FRONT; on re-admission it re-prefills ``prompt + out[:-1]`` and
continues — bitwise identically, because the model is deterministic.

Single-threaded by design (the engine's lock lives in
``generator.DecodeEngine``); no metrics registry here — counters are
plain ints in :meth:`stats` and the ROUTER process mirrors them into the
``horovod_serve_llm_*`` series (the same split as the request-level
plane's recompile counter).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import torch

from ...tracing.serve import serve_trace_id
from ..model import lm_draft_chain, lm_prefill_from, lm_verify_chain
from .kv_cache import PagedKVCache, blocks_for

WAITING = "waiting"
RUNNING = "running"
PREEMPTED = "preempted"
FINISHED = "finished"
FAILED = "failed"


class Sequence:
    """One generation in flight inside the engine. ``out`` accumulates
    generated tokens; ``kv_len`` counts context positions with K/V
    materialized (= ``len(prompt) + len(out) - 1`` while running: the
    latest generated token is fed NEXT step, its K/V not yet written)."""

    __slots__ = ("seq_id", "prompt", "max_new_tokens", "eos_id", "out",
                 "state", "waited", "preemptions", "kv_len", "handoff",
                 "submit_t", "first_token_rel_s", "error", "admit_order")

    def __init__(self, seq_id, prompt, max_new_tokens: int,
                 eos_id: int = -1, first_token: Optional[int] = None,
                 handoff: Optional[tuple] = None) -> None:
        self.seq_id = seq_id
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = int(eos_id)
        self.out: list[int] = [] if first_token is None else [
            int(first_token)]
        self.state = WAITING
        self.waited = 0          # iterations spent waiting for admission
        self.preemptions = 0
        self.kv_len = 0
        self.handoff = handoff   # (K, V) arrays from a prefill replica
        self.submit_t = 0.0      # engine-local monotonic, set by the engine
        self.first_token_rel_s: Optional[float] = None
        self.error = ""
        self.admit_order = -1

    @property
    def tokens(self) -> list:
        return self.prompt + self.out

    def is_done(self) -> bool:
        return bool(self.out) and (self.out[-1] == self.eos_id
                                   or len(self.out) >= self.max_new_tokens)


class IterationScheduler:
    def __init__(self, cache: PagedKVCache, params: dict,
                 max_active: int = 8, admission_window: int = 64,
                 tracer=None, draft_params: Optional[dict] = None,
                 draft_k: int = 0) -> None:
        if max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        if draft_k < 0:
            raise ValueError(f"draft_k must be >= 0, got {draft_k}")
        self.cache = cache
        self.params = params
        self.max_active = max_active
        self.admission_window = admission_window
        # Speculative decoding (Leviathan et al. 2211.17192):
        # the draft proposes up to draft_k tokens per iteration which the
        # target verifies greedily — bitwise the sequential output. The
        # draft is the embedding path of the float16-rounded target
        # (model.lm_draft_chain): stateless, so it keeps NO K/V, touches
        # no paged blocks, and costs nothing to preempt or resume.
        self.draft_params = draft_params if draft_k > 0 else None
        self.draft_k = draft_k if draft_params is not None else 0
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        self.finished: list[Sequence] = []
        self._admit_seq = 0
        # Serving-plane tracer (tracing/serve.py; None in unit tests and
        # router-side oracles): ONE span per decode iteration carrying the
        # member sequence ids — the Orca unit of serving work — plus
        # admit/preempt/retire lifecycle points per sequence.
        self.tracer = tracer
        cache.alloc.tracer = tracer
        self.last_progress_t = time.monotonic()
        # plain-int telemetry, mirrored by the router (see module doc)
        self.tokens_prefill_total = 0
        self.tokens_decode_total = 0
        self.iterations_total = 0     # iterations that decoded >= 1 token
        self.occupancy_sum = 0        # sum of decode-batch sizes over those
        self.finished_total = 0
        self.blocks_freed_total = 0   # by RETIREMENT (feeds the release
        #                               EWMA behind KV admission; preempt
        #                               churn deliberately excluded)
        self.spec_proposed_total = 0  # draft tokens offered for verify
        self.spec_accepted_total = 0  # draft tokens the target confirmed
        self.decode_busy_ns = 0       # wall time inside decode phases
        #                               that emitted >= 1 token: the
        #                               denominator of ENGINE decode
        #                               throughput (client tok/s is
        #                               protocol-bound; the speculative
        #                               A/B gate needs the engine number)

    # -- intake ---------------------------------------------------------------

    def submit(self, seq: Sequence, front: bool = False) -> None:
        max_ctx = len(self.params["pos"])
        total = len(seq.prompt) + seq.max_new_tokens
        usable = self.cache.alloc.num_blocks - self.cache.alloc.reserve
        if total > max_ctx or blocks_for(
                total, self.cache.block_size) > usable:
            # The single-sequence-always-completes guarantee requires the
            # WORST case (a preempted resume re-prefilling nearly
            # prompt+max_tokens of context) to fit an admission-time
            # allocation, and admissions never touch the watermark
            # reserve — so the bound is against the usable pool.
            seq.state = FAILED
            seq.error = (f"prompt+max_tokens={total} exceeds capacity "
                         f"(max_context={max_ctx}, kv blocks="
                         f"{self.cache.alloc.num_blocks}x"
                         f"{self.cache.block_size})")
            self.finished.append(seq)
            return
        (self.waiting.appendleft if front else self.waiting.append)(seq)

    # -- the engine iteration -------------------------------------------------

    def step(self) -> int:
        """One iteration: admit -> decode (one token per running sequence,
        plus any draft tokens the target verified) -> retire. Returns the
        number of tokens decoded (0 = idle)."""
        self._admit_phase()
        t0 = time.monotonic_ns() if self.tracer else 0
        members = [s.seq_id for s in self.running] if self.tracer else ()
        t_dec = time.monotonic_ns()
        decoded, n_seqs = self._decode_phase()
        if decoded:
            self.decode_busy_ns += time.monotonic_ns() - t_dec
            self.iterations_total += 1
            # occupancy counts SEQUENCES per iteration (the Orca batch
            # size), not tokens — speculative acceptance must not inflate
            # mean_batch_occupancy.
            self.occupancy_sum += n_seqs
            self.last_progress_t = time.monotonic()
            if self.tracer:
                # ONE span per iteration, member sequence ids in args —
                # the iteration is the unit of serving work, so a request
                # under load is findable in every iteration it rode
                # without a span per sequence per token.
                self.tracer.span(
                    f"it:{self.tracer.proc}:{self.iterations_total}",
                    "decode", t0, time.monotonic_ns(), seqs=list(members),
                    n=decoded, waiting=len(self.waiting),
                    blocks_free=self.cache.alloc.free_count)
        for seq in self.waiting:
            seq.waited += 1
        return decoded

    def _admit_phase(self) -> None:
        while self.waiting and len(self.running) < self.max_active:
            seq = self.waiting[0]
            if not self._materialize(seq):
                # Not enough blocks above the watermark. Past the fairness
                # window, preempt the newest running sequence and retry;
                # otherwise the head keeps waiting.
                if seq.waited > self.admission_window and self.running:
                    self._preempt(self._preempt_victim())
                    # _preempt requeues the victim at the waiting FRONT,
                    # ahead of the starved sequence we are clearing room
                    # for — swap them so the head admits first (otherwise
                    # the victim re-takes its own blocks and the head
                    # starves forever).
                    if self.waiting[0] is not seq:
                        v = self.waiting.popleft()
                        self.waiting.insert(1, v)
                    continue
                break
            self.waiting.popleft()
            seq.state = RUNNING
            if self.tracer:
                self.tracer.point(
                    serve_trace_id("gen", seq.seq_id), "admit",
                    side="replica", waited_iters=seq.waited,
                    blocks=self.cache.alloc.owned(seq.seq_id),
                    preemptions=seq.preemptions)
            seq.waited = 0
            seq.admit_order = self._admit_seq
            self._admit_seq += 1
            self.running.append(seq)
            if seq.is_done():   # e.g. max_new_tokens=1: prefill said it all
                self._retire(seq)

    def _materialize(self, seq: Sequence) -> bool:
        """Give the sequence KV state: load the handed-off pages, or
        (re-)prefill locally. False = blocks unavailable, stay queued."""
        if seq.handoff is not None:
            # Full [n, dim] arrays or per-model-shard page-slice LISTS
            # (multi-chip handoff) — the cache normalizes either; stacking
            # a slice list here would mis-stack it into 3-D.
            k_arr, v_arr = seq.handoff
            if not self.cache.load(seq.seq_id, k_arr, v_arr,
                                   tokens=seq.prompt):
                return False
            seq.handoff = None
            seq.kv_len = self.cache.handoff_tokens(k_arr)
            self.cache.register_prefix(seq.seq_id, seq.prompt)
            return True
        # Local prefill: context is everything but the newest token (the
        # newest token is fed as the next decode step). For a fresh
        # sequence that is the prompt; for a preempted resume it is
        # prompt + out[:-1] — deterministic, so the resume is bitwise
        # identical to never having been preempted.
        ctx = seq.tokens[:-1] if seq.out else seq.prompt
        shared = self.cache.admit_prefix(seq.seq_id, ctx)
        if shared is None:
            return False
        # Prefill only the positions the radix trie did not already hold;
        # on a FULL hit recompute just the final position's step for its
        # next-token logits and skip the (bitwise redundant) write — the
        # cached row must stay shared, not COW-split.
        start = min(shared, len(ctx) - 1)
        k_pre, v_pre = self.cache.gather(seq.seq_id, start)
        k_new, v_new, nxt = lm_prefill_from(self.params, ctx, k_pre, v_pre)
        if shared < len(ctx):
            self.cache.write_span(seq.seq_id, max(start, shared),
                                  k_new[max(shared - start, 0):],
                                  v_new[max(shared - start, 0):])
        seq.kv_len = len(ctx)
        self.tokens_prefill_total += len(ctx) - start
        self.cache.register_prefix(seq.seq_id, seq.prompt)
        if not seq.out:
            seq.out.append(nxt)
            if seq.first_token_rel_s is None:
                seq.first_token_rel_s = time.monotonic() - seq.submit_t
        return True

    def _decode_phase(self) -> tuple:
        decoded = n_seqs = 0
        for seq in list(self.running):
            if seq.state is not RUNNING:
                continue   # preempted mid-iteration by a neighbor's growth
            emitted = self._decode_seq(seq)
            decoded += emitted
            n_seqs += 1 if emitted else 0
        return decoded, n_seqs

    def _decode_seq(self, seq: Sequence) -> int:
        """Decode for ONE sequence this iteration: the target always
        computes at least one token; with a draft attached, up to
        ``draft_k`` proposals are verified first-mismatch-wins, so a full
        acceptance emits ``draft_k + 1`` tokens (the bonus token falls
        out of the last verify step's own logits). Greedy argmax means
        every emitted token equals the sequential oracle's, whatever the
        draft proposed — mismatches only cost the speculation."""
        proposals = self._propose(seq) if self.draft_params else []
        emitted = 0
        pos0 = seq.kv_len
        # ONE block-table gather per iteration, sized for the whole
        # verify chain. The snapshot stays bitwise equal to a re-gather
        # (context rows are append-only and the chain's rows land in
        # both the buffer and the cache), so verifying k+1 tokens pays
        # the O(context) materialization once instead of once per token
        # — this is where speculation's net decode-throughput win
        # physically comes from.
        # The buffers live on the cache's device; the emitted tokens cross
        # to the host once per verify step (inside lm_verify_chain).
        buf_k = torch.empty((pos0 + len(proposals) + 1, self.params["dim"]),
                            dtype=torch.float32, device=self.cache.device)
        buf_v = torch.empty_like(buf_k)
        if pos0:
            k0, v0 = self.cache.gather(seq.seq_id, pos0)
            buf_k[:pos0] = k0
            buf_v[:pos0] = v0
        chain = lm_verify_chain(self.params, seq.tokens[-1], proposals,
                                pos0, buf_k, buf_v, seq.eos_id)
        # Commit phase: every chain token's K/V row is for a token the
        # target COMMITTED (the fed chain is feed + its own outputs), so
        # scatter each row as its block lands — stopping cleanly if
        # memory pressure preempts this very sequence mid-chain
        # (accepted tokens are kept; the resume re-prefills them).
        for nxt in chain:
            pos = seq.kv_len
            while not self.cache.alloc.extend(seq.seq_id, pos + 1):
                victim = self._preempt_victim()
                self._preempt(victim)
                if victim is seq:
                    break
            if seq.state is not RUNNING:
                break
            self.cache.write(seq.seq_id, pos, buf_k[pos], buf_v[pos])
            seq.kv_len = pos + 1
            seq.out.append(nxt)
            emitted += 1
            self.tokens_decode_total += 1
            if seq.first_token_rel_s is None:
                seq.first_token_rel_s = time.monotonic() - seq.submit_t
            if seq.is_done():
                self._retire(seq)
                break
        if proposals:
            self.spec_proposed_total += len(proposals)
            self.spec_accepted_total += max(emitted - 1, 0)
        return emitted

    def _propose(self, seq: Sequence) -> list:
        """Run the stateless draft ahead of the target: up to
        ``draft_k`` greedy embedding-path proposals starting from the
        sequence's newest token. Capped so a full acceptance plus bonus
        token never overshoots ``max_new_tokens`` or the position
        table."""
        dp = self.draft_params
        m_cap = min(self.draft_k,
                    seq.max_new_tokens - len(seq.out) - 1,
                    len(dp["pos"]) - 1 - seq.kv_len)
        if m_cap <= 0:
            return []
        return lm_draft_chain(dp, seq.tokens[-1], seq.kv_len, m_cap,
                              seq.eos_id)

    # -- transitions ----------------------------------------------------------

    def _preempt_victim(self) -> Sequence:
        """Newest admission loses its blocks first; the growing sequence
        itself is preempted only when it IS the newest (then its own
        retry re-prefills later — progress is guaranteed because the
        submit-time capacity check means a lone sequence always fits)."""
        return max(self.running, key=lambda s: s.admit_order)

    def _preempt(self, seq: Sequence) -> None:
        freed = self.cache.alloc.preempt(seq.seq_id)
        self.running.remove(seq)
        seq.state = WAITING
        seq.kv_len = 0
        seq.waited = 0
        seq.preemptions += 1
        self.waiting.appendleft(seq)
        if self.tracer:
            self.tracer.point(serve_trace_id("gen", seq.seq_id), "preempt",
                              blocks_freed=freed, tokens=len(seq.out),
                              preemptions=seq.preemptions)

    def _retire(self, seq: Sequence) -> None:
        self.blocks_freed_total += self.cache.alloc.free(seq.seq_id)
        self.running.remove(seq)
        seq.state = FINISHED
        self.finished.append(seq)
        self.finished_total += 1
        if self.tracer:
            self.tracer.point(serve_trace_id("gen", seq.seq_id), "retire",
                              side="replica", tokens=len(seq.out),
                              preemptions=seq.preemptions)

    # -- telemetry ------------------------------------------------------------

    def sequences(self) -> list:
        """Live per-sequence state for GET /debug/sequences: everything
        the scheduler already tracks, one dict per running-then-waiting
        sequence (slot = decode-batch position, -1 while waiting)."""
        now = time.monotonic()
        out = []
        for slot, seq in enumerate(self.running):
            out.append({"rid": seq.seq_id, "state": seq.state, "slot": slot,
                        "blocks": self.cache.alloc.owned(seq.seq_id),
                        "tokens_out": len(seq.out), "kv_len": seq.kv_len,
                        "waited_iters": seq.waited,
                        "preemptions": seq.preemptions,
                        "age_s": round(now - seq.submit_t, 3)})
        for seq in self.waiting:
            out.append({"rid": seq.seq_id, "state": seq.state, "slot": -1,
                        "blocks": 0, "tokens_out": len(seq.out),
                        "kv_len": 0, "waited_iters": seq.waited,
                        "preemptions": seq.preemptions,
                        "age_s": round(now - seq.submit_t, 3)})
        return out

    def stats(self) -> dict:
        alloc = self.cache.alloc
        return {
            "active": len(self.running),
            "waiting": len(self.waiting),
            "blocks_used": alloc.used_count,
            "blocks_free": alloc.free_count,
            "waiting_blocks_needed": sum(
                blocks_for(len(s.tokens) or 1, self.cache.block_size)
                for s in self.waiting),
            "preemptions_total": alloc.preemptions_total,
            "tokens_prefill_total": self.tokens_prefill_total,
            "tokens_decode_total": self.tokens_decode_total,
            "iterations_total": self.iterations_total,
            "occupancy_sum": self.occupancy_sum,
            "finished_total": self.finished_total,
            "blocks_freed_total": self.blocks_freed_total,
            "spec_proposed_total": self.spec_proposed_total,
            "spec_accepted_total": self.spec_accepted_total,
            "decode_busy_s": round(self.decode_busy_ns / 1e9, 6),
            **self.cache.prefix_stats(),
        }
