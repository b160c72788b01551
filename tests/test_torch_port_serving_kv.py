"""The port's token-level plane on the CPU: the paged KV cache, the radix
prefix cache, the iteration scheduler and the handoff wire format, each
held against the JAX package's (``horovod_tpu.serving.llm``) on the same
operation sequences, and the port's paged, preempted, speculative,
prefix-shared and sharded decode against its own sequential oracle.

Tolerances: the allocators and the trie are host logic, so tables, free
counts, refcounts and trie sizes must be equal after every operation, and
the pool's gathers bitwise (the pool only copies the rows it is given).
The scheduler's token streams must equal the JAX package's (greedy argmax
over float32 logits that differ from numpy's in the last bits; no top-2
gap at these sizes comes near that), and every counter of ``stats()`` but
the wall-clock ``decode_busy_s`` must be equal. Against the port's own
``lm_generate`` the tokens and the K/V read back before a sequence
retires are bitwise (the same torch operations on the same values).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu.serving import model as jm
from horovod_tpu.serving.llm import handoff as jh
from horovod_tpu.serving.llm import kv_cache as jkv
from horovod_tpu.serving.llm import scheduler as jsch
from horovod_tpu_torch.serving import model as pm
from horovod_tpu_torch.serving.llm import handoff as ph
from horovod_tpu_torch.serving.llm import kv_cache as pkv
from horovod_tpu_torch.serving.llm import scheduler as psch

JP = jm.tiny_lm_params(max_context=1024)
TP = pm.lm_params_to_torch(pm.tiny_lm_params(max_context=1024), "cpu")


# -- the allocator and the trie: one op stream, both packages ------------------


def _drive_allocator(mod, seed: int, ops: int = 1500) -> list:
    """A random stream of admit-with-sharing / extend / free / preempt /
    retain / release / cow against ``mod.BlockAllocator``; every decision
    reads only the allocator's own state, so two equal allocators see the
    same stream. Returns the trace of results and state."""
    rng = np.random.RandomState(seed)
    a = mod.BlockAllocator(num_blocks=24, block_size=2, watermark=0.1)
    tables, retained, trace, next_id = {}, {}, [], 0
    for _ in range(ops):
        op = rng.randint(6)
        if op == 0:
            n_tok = int(rng.randint(1, 16))
            shareable = sorted({b for t in tables.values() for b in t})
            rng.shuffle(shareable)
            shared = shareable[:int(rng.randint(0, mod.blocks_for(n_tok, 2) + 1))]
            got = a.admit(next_id, n_tok, tuple(shared))
            trace.append(("admit", got))
            if got is not None:
                tables[next_id] = got
                next_id += 1
        elif op == 1 and tables:
            sid = sorted(tables)[rng.randint(len(tables))]
            ok = a.extend(sid, (len(tables[sid]) + int(rng.randint(0, 3))) * 2)
            trace.append(("extend", ok))
            tables[sid] = a.table(sid)
        elif op == 2 and tables:
            sid = sorted(tables)[rng.randint(len(tables))]
            trace.append(("free", (a.preempt if rng.randint(2) else a.free)(sid)))
            del tables[sid]
        elif op == 3 and tables:
            sid = sorted(tables)[rng.randint(len(tables))]
            b = int(tables[sid][rng.randint(len(tables[sid]))])
            a.retain(b)
            retained[b] = retained.get(b, 0) + 1
        elif op == 4 and retained:
            b = sorted(retained)[rng.randint(len(retained))]
            trace.append(("release", a.release(b)))
            retained[b] -= 1
            if not retained[b]:
                del retained[b]
        elif op == 5 and tables:
            sid = sorted(tables)[rng.randint(len(tables))]
            idx = int(rng.randint(len(tables[sid])))
            if a.refs(tables[sid][idx]) >= 2:
                trace.append(("cow", a.cow(sid, idx)))
                tables[sid] = a.table(sid)
        a.check_invariants()
        trace.append((a.free_count, a.used_count, a.preemptions_total,
                      {s: a.table(s) for s in sorted(tables)},
                      {b: a.refs(b) for b in range(a.num_blocks)}))
    return trace


@pytest.mark.parametrize("seed", [0, 7, 0xBEEF])
def test_allocator_op_stream_equals_jax(seed):
    assert _drive_allocator(pkv, seed) == _drive_allocator(jkv, seed)


def test_allocator_views_and_errors_match_jax():
    for mod in (jkv, pkv):
        a = mod.BlockAllocator(8, 2, watermark=0.25)
        assert a.reserve == 2 and a.can_alloc(6) and not a.can_alloc(7)
        assert a.alloc("s", 5) == [0, 1, 2]
        assert a.capacity("s") == 6 and a.owned("s") == 3
        with pytest.raises(ValueError, match="already holds"):
            a.alloc("s", 1)
        assert a.free("s") == 3
        with pytest.raises(ValueError, match="double free"):
            a.free("s")
        with pytest.raises(ValueError):
            mod.BlockAllocator(0, 2)
    assert [pkv.blocks_for(n, 4) for n in range(10)] == \
        [jkv.blocks_for(n, 4) for n in range(10)]


def _drive_radix(mod, seed: int) -> list:
    rng = np.random.RandomState(seed)
    a = mod.BlockAllocator(20, 2, watermark=0.0)
    trie = mod.RadixPrefixCache(a)
    a.reclaimer = trie.evict
    trace, live, next_id = [], {}, 0
    stems = [[1, 2, 3, 4], [1, 2, 9, 9], [5, 6]]
    for _ in range(400):
        op = rng.randint(3)
        if op == 0:
            toks = list(stems[rng.randint(3)]) + \
                [int(t) for t in rng.randint(0, 8, rng.randint(0, 6))]
            blocks, partial = trie.lookup(toks)
            got = a.admit(next_id, len(toks), tuple(blocks))
            trace.append(("lookup", blocks, partial, got))
            if got is not None:
                trace.append(("register", trie.register(toks, got)))
                live[next_id] = toks
                next_id += 1
        elif op == 1 and live:
            sid = sorted(live)[rng.randint(len(live))]
            trace.append(("free", a.free(sid)))
            del live[sid]
        elif op == 2:
            trace.append(("evict", trie.evict(int(rng.randint(1, 4)))))
        a.check_invariants()
        trace.append((len(trie), a.free_count, trie.hit_tokens_total,
                      trie.lookup_tokens_total, trie.recovered_blocks_total))
    return trace


@pytest.mark.parametrize("seed", [1, 2])
def test_radix_prefix_cache_equals_jax(seed):
    assert _drive_radix(pkv, seed) == _drive_radix(jkv, seed)


# -- the paged pool ----------------------------------------------------------------


def _drive_pool(mod, seed: int, shards: int, prefix: bool, **kw) -> tuple:
    """Admit-with-prefix / write / load / register / gather / free against
    ``mod.PagedKVCache`` on the same rows; returns (trace, gathers)."""
    rng = np.random.RandomState(seed)
    cache = mod.PagedKVCache(16, 3, 8, watermark=0.0, model_shards=shards,
                             prefix_cache=prefix, **kw)
    trace, gathers, live, next_id = [], [], {}, 0
    stems = [[4, 4, 4, 1, 2, 3], [4, 4, 4, 7], [9]]
    for _ in range(120):
        op = rng.randint(4)
        if op == 0:
            toks = list(stems[rng.randint(3)]) + \
                [int(t) for t in rng.randint(0, 16, rng.randint(1, 6))]
            k = rng.uniform(-1, 1, (len(toks), 8)).astype(np.float32)
            v = rng.uniform(-1, 1, (len(toks), 8)).astype(np.float32)
            if rng.randint(2):
                ok = cache.load(next_id, k, v, tokens=toks)
                trace.append(("load", ok))
            else:
                shared = cache.admit_prefix(next_id, toks)
                trace.append(("admit_prefix", shared))
                ok = shared is not None
                if ok:
                    for pos in range(shared, len(toks)):
                        cache.write(next_id, pos, k[pos], v[pos])
            if ok:
                cache.register_prefix(next_id, toks)
                live[next_id] = len(toks)
                next_id += 1
        elif op == 1 and live:
            sid = sorted(live)[rng.randint(len(live))]
            pos = live[sid]
            if cache.alloc.extend(sid, pos + 1):
                row = rng.uniform(-1, 1, 8).astype(np.float32)
                cache.write(sid, pos, row, row * 2)
                live[sid] = pos + 1
        elif op == 2 and live:
            sid = sorted(live)[rng.randint(len(live))]
            trace.append(("free", cache.alloc.free(sid)))
            del live[sid]
        elif op == 3 and live:
            sid = sorted(live)[rng.randint(len(live))]
            k, v = cache.gather(sid, live[sid])
            gathers.append((np.asarray(k), np.asarray(v)))
        cache.alloc.check_invariants()
        trace.append((cache.alloc.free_count,
                      {s: cache.alloc.table(s) for s in sorted(live)},
                      cache.prefix_stats()))
    return trace, gathers


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("prefix", [False, True], ids=["noprefix", "prefix"])
@pytest.mark.parametrize("seed", [3, 4])
def test_paged_pool_equals_jax(seed, prefix, shards):
    jt, jg = _drive_pool(jkv, seed, shards, prefix)
    pt, pg = _drive_pool(pkv, seed, shards, prefix, device="cpu")
    assert pt == jt
    assert len(pg) == len(jg) and len(pg) > 0
    for (pk, pv), (k, v) in zip(pg, jg):
        assert np.array_equal(pk, k) and np.array_equal(pv, v)


def test_pool_lives_on_its_device_and_counts_like_jax():
    p = pkv.PagedKVCache(10, 4, 8, model_shards=2, device="cpu")
    j = jkv.PagedKVCache(10, 4, 8, model_shards=2)
    assert p.device.type == "cpu" and p.k_shards[0].dtype == torch.float32
    assert tuple(p.k_shards[0].shape) == j.k_shards[0].shape
    assert p.per_chip_nbytes() == j.per_chip_nbytes()
    p1 = pkv.PagedKVCache(10, 4, 8, device="cpu")
    assert p1.k is p1.k_shards[0]
    with pytest.raises(ValueError, match="divide dim"):
        pkv.PagedKVCache(10, 4, 8, model_shards=3, device="cpu")


def test_write_span_equals_row_writes_with_cow():
    rng = np.random.RandomState(5)
    rows = torch.from_numpy(rng.uniform(-1, 1, (11, 8)).astype(np.float32))
    a = pkv.PagedKVCache(12, 4, 8, watermark=0.0, prefix_cache=True,
                         device="cpu")
    b = pkv.PagedKVCache(12, 4, 8, watermark=0.0, prefix_cache=True,
                         device="cpu")
    for c in (a, b):          # a shared first block, as a prefix hit leaves it
        c.alloc.alloc("x", 4)
        c.alloc.retain(c.alloc.table("x")[0])
        c.alloc.extend("x", 11)
    a.write_span("x", 0, rows, rows * 3)
    for pos in range(11):
        b.write("x", pos, rows[pos], rows[pos] * 3)
    assert a.alloc.table("x") == b.alloc.table("x")
    assert a.cow_copies_total == b.cow_copies_total == 1
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


# -- handoff -----------------------------------------------------------------------


def test_handoff_payloads_equal_jax():
    jk, jv, jn = jm.lm_prefill(JP, [3, 17, 5])
    pk, pv, pn = pm.lm_prefill(TP, [3, 17, 5])
    jp = jh.pack_kv([3, 17, 5], jk, jv, jn)
    pp = ph.pack_kv([3, 17, 5], pk, pv, pn)
    assert isinstance(pp["k"], np.ndarray) and pp["k"].dtype == np.float32
    assert ph.handoff_nbytes(pp) == jh.handoff_nbytes(jp) == pk.numel() * 8
    tokens, k, v, first = ph.unpack_kv(pp, device="cpu")
    assert tokens == [3, 17, 5] and first == pn
    assert torch.equal(k, pk) and torch.equal(v, pv)
    js = jh.pack_kv_sharded([3, 17, 5], np.split(jk, 2, axis=1),
                            np.split(jv, 2, axis=1), jn)
    ps = ph.pack_kv_sharded([3, 17, 5], list(torch.chunk(pk, 2, dim=1)),
                            list(torch.chunk(pv, 2, dim=1)), pn)
    assert ph.is_sharded_payload(ps) and ph.handoff_nbytes(ps) == \
        jh.handoff_nbytes(js)
    tokens, ks, vs, _ = ph.unpack_kv_sharded(ps, device="cpu")
    assert torch.equal(torch.cat(ks, dim=1), pk)
    # the JAX decode side reads the port's wire payload, and back
    assert np.array_equal(jh.unpack_kv(pp)[1], pk.numpy())
    assert torch.equal(ph.unpack_kv(jp, device="cpu")[1],
                       torch.from_numpy(jk))


def test_handoff_rejects_malformed_payloads():
    k, v, first = pm.lm_prefill(TP, [3, 17])
    with pytest.raises(ValueError, match="malformed"):
        ph.pack_kv([3], k, v, first)
    bad = ph.pack_kv([3, 17], k, v, first)
    bad["k"] = bad["k"][:1]
    with pytest.raises(ValueError, match="malformed"):
        ph.unpack_kv(bad, device="cpu")
    with pytest.raises(ValueError, match="malformed sharded"):
        ph.pack_kv_sharded([3, 17], [k[:, :8]], [v[:, :8], v[:, 8:]], first)


# -- the scheduler against the JAX package's -------------------------------------


def _prompts(seed: int, lens, shared: int = 0) -> list:
    rs = np.random.RandomState(seed)
    base = [int(t) for t in rs.randint(0, 64, max(lens))]
    return [base[:min(n, shared)] + [int(t) for t in
                                      rs.randint(0, 64, max(n - shared, 0))]
            for n in lens]


def _schedule(sch, kv, params, draft, prompts, new, blocks, block=4,
              draft_k=0, prefix=False, window=64, kv_kw=None, handoff=None,
              shards=1, record=False, max_active=4):
    kept = {}

    class Recording(sch.IterationScheduler):
        def _retire(self, seq):
            if record:
                kept[seq.seq_id] = self.cache.gather(seq.seq_id, seq.kv_len)
            super()._retire(seq)

    cache = kv.PagedKVCache(blocks, block, params["dim"], watermark=0.05,
                            prefix_cache=prefix, model_shards=shards,
                            **(kv_kw or {}))
    s = Recording(cache, params, max_active=max_active, admission_window=window,
                  draft_params=draft if draft_k else None, draft_k=draft_k)
    for i, p in enumerate(prompts):
        first, pages = (handoff[i] if handoff else (None, None))
        s.submit(sch.Sequence(i, p, new, first_token=first, handoff=pages))
    for _ in range(20000):
        if len(s.finished) == len(prompts):
            break
        s.step()
    st = s.stats()
    st.pop("decode_busy_s")
    return {q.seq_id: (q.state, q.out) for q in s.finished}, st, kept


CASES = {
    # name: (prompt lengths, shared prefix, new tokens, blocks, draft_k,
    #        prefix cache, admission window)
    "churn": ((3, 9, 1, 14, 6, 11, 2, 20), 0, 10, 40, 0, False, 64),
    "preempt": ((30, 25, 28, 20, 31), 0, 14, 26, 0, False, 64),
    "fairness": ((30, 25, 28, 20, 31, 3), 0, 12, 26, 0, False, 2),
    "draft": ((3, 9, 1, 14, 6, 11, 2, 20), 0, 12, 40, 3, False, 64),
    "draft_preempt": ((30, 25, 28, 20, 31), 0, 14, 26, 4, False, 64),
    "prefix": ((13, 17, 9, 21, 30, 5), 8, 10, 40, 0, True, 64),
    "prefix_draft": ((13, 17, 9, 21, 30, 5), 8, 10, 40, 3, True, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_equals_jax(case):
    lens, shared, new, blocks, draft_k, prefix, window = CASES[case]
    prompts = _prompts(len(lens), lens, shared)
    j = _schedule(jsch, jkv, JP, jm.draft_lm_params(JP), prompts, new, blocks,
                  draft_k=draft_k, prefix=prefix, window=window)
    p = _schedule(psch, pkv, TP, pm.draft_lm_params(TP), prompts, new, blocks,
                  draft_k=draft_k, prefix=prefix, window=window,
                  kv_kw={"device": "cpu"}, record=True)
    assert p[0] == j[0]
    assert p[1] == j[1]
    # and bitwise the port's own oracle, tokens and K/V
    for i, prompt in enumerate(prompts):
        state, out = p[0][i]
        assert state == "finished" and out == pm.lm_generate(TP, prompt, new)
        k, v, _ = pm.lm_prefill(TP, prompt + out[:-1])
        assert torch.equal(p[2][i][0], k) and torch.equal(p[2][i][1], v)
    if case.startswith("preempt") or case == "fairness":
        assert p[1]["preemptions_total"] >= 1
    if "prefix" in case:
        assert p[1]["prefix_hit_tokens_total"] > 0
    if "draft" in case:
        assert p[1]["spec_proposed_total"] > 0


def test_scheduler_rejects_oversized_like_jax():
    for sch, kv, params, kw in ((jsch, jkv, JP, {}),
                                (psch, pkv, TP, {"device": "cpu"})):
        cache = kv.PagedKVCache(4, 4, 16, watermark=0.0, **kw)
        s = sch.IterationScheduler(cache, params)
        s.submit(sch.Sequence(0, [1] * 10, 10))
        assert s.finished[0].state == "failed" and "exceeds" in s.finished[0].error


@pytest.mark.parametrize("shards", [1, 2])
def test_handoff_admission_equals_jax_and_oracle(shards):
    prompts = _prompts(9, (5, 12, 3, 17))
    jhand, phand = [], []
    for p in prompts:
        jk, jv, jn = jm.lm_prefill(JP, p)
        pk, pv, pn = pm.lm_prefill(TP, p)
        jhand.append((jn, (jk, jv)))
        pay = ph.pack_kv(p, pk, pv, pn)
        _, k, v, first = ph.unpack_kv(pay, device="cpu")
        phand.append((first, (k, v)))
    j = _schedule(jsch, jkv, JP, None, prompts, 9, 30, handoff=jhand,
                  shards=shards)
    p = _schedule(psch, pkv, TP, None, prompts, 9, 30, handoff=phand,
                  shards=shards, kv_kw={"device": "cpu"})
    assert p[0] == j[0] and p[1] == j[1]
    for i, prompt in enumerate(prompts):
        assert p[0][i][1] == pm.lm_generate(TP, prompt, 9)


# -- inside the port: paged, sharded, resumed decode are bitwise -----------------


@pytest.mark.parametrize("draft_k", [0, 3])
def test_sharded_scheduler_bitwise_unsharded(draft_k):
    prompts = _prompts(4, (30, 25, 28, 20, 31))
    sharded = pm.shard_lm_params(TP, 2)
    a = _schedule(psch, pkv, TP, pm.draft_lm_params(TP), prompts, 14, 26,
                  draft_k=draft_k, kv_kw={"device": "cpu"}, record=True)
    b = _schedule(psch, pkv, sharded, pm.draft_lm_params(sharded), prompts, 14,
                  26, draft_k=draft_k, kv_kw={"device": "cpu"}, shards=2,
                  record=True)
    assert a[0] == b[0] and a[1] == b[1] and a[1]["preemptions_total"] >= 1
    for i in a[2]:
        assert torch.equal(a[2][i][0], b[2][i][0])
        assert torch.equal(a[2][i][1], b[2][i][1])


def test_paged_decode_bitwise_contiguous_cache():
    """One sequence through the paged pool (blocks of 3, scattered by an
    earlier tenant's free) against lm_generate's contiguous cache."""
    cache = pkv.PagedKVCache(20, 3, 16, watermark=0.0, device="cpu")
    cache.alloc.alloc("tenant", 14)
    s = psch.IterationScheduler(cache, TP, max_active=2)
    s.submit(psch.Sequence(0, [5, 9, 12, 1, 60, 33], 16))
    s.step()
    cache.alloc.free("tenant")
    while not s.finished:
        s.step()
    assert s.finished[0].out == pm.lm_generate(TP, [5, 9, 12, 1, 60, 33], 16)


def test_prefix_eviction_under_admission_pressure_keeps_the_matched_prefix():
    """A fault of the reference, found porting it: with the prefix cache on
    and an admission that must reclaim, the trie may evict the very blocks
    the admission matched, and ``BlockAllocator.admit`` then raises "shared
    block ... is not allocated". The port references the matched blocks
    before reclaiming and serves the same prompts bitwise its oracle."""
    rs = np.random.RandomState(0)
    base = [int(t) for t in rs.randint(0, 64, 512)]
    prompts = [base[:min(n, 32)] + [int(t) for t in rs.randint(0, 64, max(n - 32, 0))]
               for n in (1, 7, 33, 64, 129, 256, 400, 512)]
    jp = jm.tiny_lm_params(dim=16, max_context=4096)
    tp = pm.lm_params_to_torch(jp, "cpu")
    with pytest.raises(ValueError, match="not allocated"):
        _schedule(jsch, jkv, jp, None, prompts, 32, 36, block=16, prefix=True,
                  max_active=8)
    out, st, _ = _schedule(psch, pkv, tp, None, prompts, 32, 36, block=16,
                           prefix=True, kv_kw={"device": "cpu"}, max_active=8)
    assert st["preemptions_total"] >= 1 and st["recovered_blocks_total"] > 0
    for i, p in enumerate(prompts):
        assert out[i] == ("finished", pm.lm_generate(tp, p, 32))
