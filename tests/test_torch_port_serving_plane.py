"""The port's serving routers (``horovod_tpu_torch.serving``,
``control/serving.py``, ``tracing/serve.py``) against the JAX package's,
and the LLM plane end to end with CPU replicas.

Host logic, held exactly against the JAX package on the same inputs:
``ServeConfig``/``LLMConfig`` and their env round trip, admission
(request-rate and KV-block) decisions on the same observation series,
padding buckets, the batcher, ``GenRequest``/``GenQueue``, the autoscale
decision, ``ServingController`` decisions on the same anomaly and goodput
series, and ``ServeTracer`` records. The manager's device placement:
replica i on card ``i % device_count``, a replacement on the dead one's
card (the CUDA calls faked: no card here).

End to end (replicas asked for the CPU, ports from the kernel): the
disaggregated plane with a decode replica killed mid-load, the sharded
plane, and the colocated plane; every token stream equal to the port's
sequential oracle, which the model tests hold against the JAX package's.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu.control import serving as jcs
from horovod_tpu.metrics.registry import MetricsRegistry as JRegistry
from horovod_tpu.serving import admission as jadm
from horovod_tpu.serving import batcher as jb
from horovod_tpu.serving import config as jcfg
from horovod_tpu.serving import manager as jman
from horovod_tpu.serving.llm import generator as jgen
from horovod_tpu.tracing import serve as jts
from horovod_tpu_torch.control import serving as pcs
from horovod_tpu_torch.metrics.registry import MetricsRegistry as PRegistry
from horovod_tpu_torch.serving import admission as padm
from horovod_tpu_torch.serving import batcher as pb
from horovod_tpu_torch.serving import config as pcfg
from horovod_tpu_torch.serving import manager as pman
from horovod_tpu_torch.serving import model as pm
from horovod_tpu_torch.serving.llm import generator as pgen
from horovod_tpu_torch.tracing import serve as pts

TP = pm.lm_params_to_torch(pm.tiny_lm_params(), "cpu")


# -- config ---------------------------------------------------------------------


def test_serve_config_env_and_overrides_equal_jax(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_MAX_BATCH", "16")
    monkeypatch.setenv("HOROVOD_SERVE_SLO_MS", "250")
    monkeypatch.setenv("HOROVOD_SERVE_HOST", "0.0.0.0")
    a, b = pcfg.ServeConfig.from_env(max_wait_ms=2.0), \
        jcfg.ServeConfig.from_env(max_wait_ms=2.0)
    assert vars(a) == vars(b) and a.max_batch == 16
    assert pcfg.ServeConfig._ENV == jcfg.ServeConfig._ENV


def test_llm_config_env_roundtrip_equals_jax(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_LLM_BLOCK_SIZE", "8")
    monkeypatch.setenv("HOROVOD_SERVE_LLM_DRAFT_K", "3")
    a = pcfg.LLMConfig.from_env(max_active=3, model_shards=2)
    b = jcfg.LLMConfig.from_env(max_active=3, model_shards=2)
    assert vars(a) == vars(b) and a.to_env() == b.to_env()
    assert a.usable_blocks() == b.usable_blocks()
    for k, v in a.to_env().items():
        monkeypatch.setenv(k, v)
    assert pcfg.LLMConfig.from_env() == a


@pytest.mark.parametrize("bad", [dict(watermark=1.5), dict(max_active=0),
                                 dict(colocated=0, prefill_replicas=0),
                                 dict(ttft_slo_ms=0), dict(model_shards=3),
                                 dict(chip_budget=-1), dict(draft_k=-1),
                                 dict(nope=1)])
def test_llm_config_validation_equals_jax(bad):
    errs = []
    for mod in (jcfg, pcfg):
        with pytest.raises((ValueError, TypeError)) as ei:
            mod.LLMConfig.from_env(**bad)
        errs.append((type(ei.value), str(ei.value)))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("bad", [dict(max_batch=0), dict(decode_steps=0),
                                 dict(min_replicas=3, max_replicas=2),
                                 dict(slo_ms=0)])
def test_serve_config_validation_equals_jax(bad):
    errs = []
    for mod in (jcfg, pcfg):
        with pytest.raises(ValueError) as ei:
            mod.ServeConfig.from_env(**bad)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


# -- admission ------------------------------------------------------------------


def _admission_series(mod, reg):
    cfg = mod_cfg(mod).ServeConfig.from_env(port=0, slo_ms=500.0)
    adm = mod.AdmissionController(cfg, reg)
    rs = np.random.RandomState(0)
    out = [adm.admit(10_000, 1)]
    for _ in range(60):
        adm.observe_batch(int(rs.randint(0, 20)), float(rs.uniform(0.01, 2)))
        out.append((adm.admit(int(rs.randint(0, 40)), int(rs.randint(1, 4)),
                              budget_s=[None, 0.1, 5.0][rs.randint(3)]),
                    adm.drain_rate()))
    adm.set_slo_ms(120.0)
    out.append((adm.admit(5, 1), adm.report()))
    return out


def _kv_series(mod, reg):
    llm = mod_cfg(mod).LLMConfig.from_env(num_blocks=100, watermark=0.1,
                                          ttft_slo_ms=1000.0)
    adm = mod.KVAdmission(llm, reg)
    rs = np.random.RandomState(1)
    out = [adm.admit(1000, 0, 1000)]
    for _ in range(60):
        adm.observe_release(int(rs.randint(0, 12)), float(rs.uniform(0.1, 1)))
        free, queued = int(rs.randint(0, 100)), int(rs.randint(0, 50))
        out.append((adm.admit(int(rs.randint(1, 40)), free, queued),
                    adm.refresh_projection(free, queued), adm.release_rate()))
    out.append(adm.report())
    return out


def mod_cfg(mod):
    return jcfg if mod is jadm else pcfg


def test_admission_decisions_equal_jax():
    assert _admission_series(padm, PRegistry()) == \
        _admission_series(jadm, JRegistry())


def test_kv_admission_decisions_equal_jax():
    assert _kv_series(padm, PRegistry()) == _kv_series(jadm, JRegistry())


# -- batcher ----------------------------------------------------------------------


@pytest.mark.parametrize("max_batch", [1, 6, 8, 13])
def test_bucket_sizes_and_selection_equal_jax(max_batch):
    sizes = pb.bucket_sizes(max_batch)
    assert sizes == jb.bucket_sizes(max_batch)
    assert [pb.bucket_for(n, sizes) for n in range(1, max_batch + 1)] == \
        [jb.bucket_for(n, sizes) for n in range(1, max_batch + 1)]


def test_pad_batch_equals_jax():
    xs = [np.full(3, i, np.float32) for i in range(3)]
    assert np.array_equal(pb.pad_batch(xs, 4), jb.pad_batch(xs, 4))
    with pytest.raises(ValueError):
        pb.pad_batch(xs, 2)


def test_batcher_coalesces_expires_requeues_and_closes():
    cfg = pcfg.ServeConfig.from_env(port=0, max_batch=8, max_wait_ms=30.0)
    b = pb.ContinuousBatcher(cfg, PRegistry())
    dead = pb.Request(np.zeros(2, np.float32), deadline_t=time.monotonic() - 1)
    live = [pb.Request(np.zeros(2, np.float32)) for _ in range(4)]
    for r in [dead] + live:
        assert b.submit(r)
    batch = b.take_batch(timeout=1.0)
    assert [r.rid for r in batch] == [r.rid for r in live]
    assert dead.code == 504
    b.requeue_front(live[:2])
    assert [r.rid for r in b.take_batch(1.0)] == [r.rid for r in live[:2]]
    pending = pb.Request(np.zeros(2, np.float32))
    b.submit(pending)
    b.close()
    assert pending.code == 503 and not b.submit(pb.Request(np.zeros(2)))
    assert pending.tid.startswith("req:infer:")


def test_autoscale_decision_equals_jax():
    pc = pcfg.ServeConfig.from_env(port=0, min_replicas=1, max_replicas=4,
                                   target_queue=4.0, cooldown_s=10.0)
    jc = jcfg.ServeConfig.from_env(port=0, min_replicas=1, max_replicas=4,
                                   target_queue=4.0, cooldown_s=10.0)
    grid = [(d, n, s, busy) for d in (0, 3, 9, 100) for n in (1, 2, 4)
            for s in (0.0, 995.0) for busy in (1000.0, 998.0, 980.0)]
    assert [pman.autoscale_decision(d, n, pc, 1000.0, s, b)
            for d, n, s, b in grid] == \
        [jman.autoscale_decision(d, n, jc, 1000.0, s, b) for d, n, s, b in grid]


def test_manager_requeue_failed_retries_then_503_like_jax():
    out = []
    for cfgm, bm, adm, man in ((jcfg, jb, jadm, jman), (pcfg, pb, padm, pman)):
        cfg = cfgm.ServeConfig.from_env(port=0, max_retries=1, max_batch=4)
        batcher = bm.ContinuousBatcher(cfg)
        kw = {"device": "cpu"} if man is pman else {}
        mgr = man.ReplicaManager(cfg, batcher, adm.AdmissionController(cfg),
                                 **kw)
        fresh, spent = bm.Request(np.zeros(1)), bm.Request(np.zeros(1))
        spent.retries = 1
        mgr._requeue_failed([fresh, spent])
        out.append((spent.code, spent.error, fresh.retries, batcher.depth()))
    assert out[0] == out[1]


# -- devices: replica i on card i % count, a respawn on the dead one's card ------


def test_manager_places_replicas_on_cards_and_respawns_keep_theirs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cfg = pcfg.ServeConfig.from_env(port=0)
    mgr = pman.ReplicaManager(cfg, None, None)
    assert mgr.device.type == "cuda"
    cards = [mgr._device_for() for _ in range(4)]
    assert cards == ["cuda:0", "cuda:1", "cuda:2", "cuda:0"]
    dead = pman._Replica(1, None, "", "", None, "cuda:1")
    mgr._free_device(dead)
    assert mgr._device_for() == "cuda:1"        # the replacement's card
    assert mgr._device_for() == "cuda:1"        # then on in turn
    pinned = pman.ReplicaManager(cfg, None, None, device="cuda:2")
    assert {pinned._device_for() for _ in range(3)} == {"cuda:2"}
    cpu = pman.ReplicaManager(cfg, None, None, device="cpu")
    assert cpu._device_for() == "cpu"
    assert not torch.cuda.is_initialized()


def test_checkpoint_streaming_is_refused_until_ported(monkeypatch, tmp_path):
    """The streaming cold start, now ported: with no sources a no-op, as in
    JAX; a fetch that fails logs and falls through; with a leader
    exporting the checkpoint the missing path is fetched before any
    replica spawns, byte-identical to the leader's copy."""
    from horovod_tpu_torch import checkpoint as pckpt
    from horovod_tpu_torch.ctrl.agent import ControlAgent

    cfg = pcfg.ServeConfig.from_env(port=0)
    dest = tmp_path / "missing"
    mgr = pman.ReplicaManager(cfg, None, None, device="cpu", checkpoint=str(dest))
    monkeypatch.delenv("HOROVOD_CKPT_STREAM_FROM", raising=False)
    mgr._prefetch_checkpoint()          # no sources: a no-op, as in JAX
    key = b"serve-stream-secret"
    monkeypatch.setenv("HOROVOD_SECRET", key.hex())
    monkeypatch.setenv("HOROVOD_CKPT_STREAM_FROM", "127.0.0.1:1")
    mgr._prefetch_checkpoint()          # unreachable: logged, falls through
    assert not dest.exists()
    src = str(tmp_path / "exported")
    pckpt.export_for_inference(src, {"params": {"w": torch.arange(6.0)}})
    leader = ControlAgent(key, ckpt_dir=src)
    try:
        monkeypatch.setenv("HOROVOD_CKPT_STREAM_FROM", f"127.0.0.1:{leader.port}")
        mgr._prefetch_checkpoint()
    finally:
        leader.stop()
    with open(os.path.join(src, pckpt.STATE_FILE), "rb") as a, \
            open(dest / pckpt.STATE_FILE, "rb") as b:
        assert a.read() == b.read()
    assert torch.equal(pckpt.load_for_inference(str(dest))["params"]["w"],
                       torch.arange(6.0))


# -- generation requests and queues ---------------------------------------------


def _request_story(gen):
    out = []
    req = gen.GenRequest([1, 2], 8)
    out.append((req.blocks_needed(4), req.push_tokens([5]),
                req.push_tokens([5, 6]), req.push_tokens([7, 6]),
                req.wait_tokens(1, 0.01), req.finish([5, 6, 7]),
                req.fail(504, "late"), req.code, req.tokens,
                req.push_tokens([5, 6, 7, 8])))
    req2 = gen.GenRequest([1], 4)
    out.append((req2.fail(504, "deadline"), req2.finish([9]), req2.code,
                req2.tpot_s(), req2.expired(), req2.tid.split(":")[:2]))
    q = gen.GenQueue(cap=2)
    out.append((q.put("a"), q.put("b"), q.put("c")))
    q.put_front(["x", "y"])
    out.append(([q.take(0.01) for _ in range(4)], q.take(0.01)))
    q2 = gen.GenQueue()
    q2.put("z")
    out.append((q2.items(), q2.close(), q2.put("w")))
    return out


def test_gen_request_and_queue_equal_jax():
    assert _request_story(pgen) == _request_story(jgen)


# -- the serving controller ------------------------------------------------------


def _controller_story(cs, cfgm, regm, kinds) -> tuple:
    cfg = cfgm.ServeConfig.from_env(port=0)
    reg = regm()
    sc = cs.ServingController(cfg, reg=reg, canary_steps=2, cooldown_s=0.0,
                              tick_s=1.0)
    req = reg.counter("horovod_serve_requests_total", help="x", code="200")
    tok = reg.counter("horovod_serve_llm_tokens_total", help="x", phase="decode")
    rs = np.random.RandomState(5)
    verdicts = []
    for i in range(40):
        req.inc(int(rs.randint(0, 20)))
        tok.inc(int(rs.randint(0, 200)))
        if i in kinds:
            sc.on_anomaly(kinds[i], {})
        verdicts.append(sc.tick(now=float(i * 10)))
    hist = [{k: v for k, v in h.items() if k != "time_unix_s"}
            for h in sc.loop.history]
    return verdicts, hist, dict(sc.loop.values), vars(cfg)


@pytest.mark.parametrize("kinds", [
    {10: "ttft_slo", 20: "drain_collapse", 30: "shed_spike"},
    {5: "preempt_storm", 6: "ttft_slo", 25: "ttft_slo", 33: "not_a_kind"},
], ids=["three_kinds", "storm"])
def test_serving_controller_decisions_equal_jax(kinds):
    assert pcs.RULES == jcs.RULES
    assert _controller_story(pcs, pcfg, PRegistry, kinds) == \
        _controller_story(jcs, jcfg, JRegistry, kinds)


def test_maybe_start_serving_controller_gated_on_env(monkeypatch):
    cfg = pcfg.ServeConfig.from_env(port=0)
    monkeypatch.delenv("HOROVOD_CONTROLLER", raising=False)
    assert pcs.maybe_start_serving_controller(cfg, anomaly=object()) is None
    monkeypatch.setenv("HOROVOD_CONTROLLER", "1")
    assert pcs.maybe_start_serving_controller(cfg, anomaly=None) is None


# -- the serve tracer -------------------------------------------------------------


def _tracer_lines(mod, flight_mod, tmp, monkeypatch) -> list:
    monkeypatch.setenv("HOROVOD_TRACE_DIR", str(tmp))
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", "")
    flight_mod._flight = None
    t = mod.ServeTracer("serve-router")
    assert t.enabled
    t.span(mod.serve_trace_id("gen", 12), "admit", 100, 200, rid=12,
           decision="ok")
    t.point(mod.serve_trace_id("infer", 3), "retire", tokens=3)
    t.span("it:serve-router:1", "decode", 5, 9, seqs=[1, 2], n=2)
    t.set_clock_offset(-42)
    t.flush()
    lines = [json.loads(ln) for ln in
             open(os.path.join(str(tmp), "spans-serve-router.jsonl"))]
    ring = [r.get("phase") for r in t.flight.records()]
    t.close()
    for ln in lines:   # the point's own clock reading differs run to run
        if ln.get("phase") == "retire":
            ln["t0"] = ln["t1"] = 0
        ln.pop("pid", None)
        ln.pop("wall_unix_s", None)
        ln.pop("time_unix_s", None)
    return [lines, ring]


def test_serve_tracer_records_equal_jax(tmp_path, monkeypatch):
    from horovod_tpu.tracing import flight as jflight
    from horovod_tpu_torch.tracing import flight as pflight

    assert pts.serve_trace_id("gen", 12) == jts.serve_trace_id("gen", 12) \
        == "req:gen:12"
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = _tracer_lines(pts, pflight, tmp_path / "p", monkeypatch)
    want = _tracer_lines(jts, jflight, tmp_path / "j", monkeypatch)
    assert got == want
    assert pts.init_serve_tracer("llm-decode-0") is pts.get_serve_tracer()


# -- end to end: the LLM plane, CPU replicas --------------------------------------


def _post(port, payload, timeout=120.0, path="/v1/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _server(**llm):
    from horovod_tpu_torch.serving.llm import LLMServer

    cfg = pcfg.ServeConfig.from_env(port=0, slo_ms=120000.0, max_retries=3,
                                    replica_start_timeout_s=180.0)
    return LLMServer(config=cfg, llm_config=pcfg.LLMConfig.from_env(**llm),
                     device="cpu")


def test_disaggregated_e2e_oracle_kill_and_stats():
    """1 prefill + 1 decode replica on the CPU: HTTP generations equal the
    oracle, /debug/sequences answers, malformed requests answer 400, and a
    SIGKILL'd decode replica recovers by re-prefill with zero failed
    requests; the respawn takes the dead replica's device."""
    server = _server(colocated=0, prefill_replicas=1, decode_replicas=1)
    server.start()
    try:
        assert server.wait_ready(180), \
            {r: p.describe() for r, p in server.pools.items()}
        st, body = _post(server.port, {"prompt": [3, 17, 5], "max_tokens": 16})
        assert st == 200 and body["n_tokens"] == 16
        assert body["tokens"] == pm.lm_generate(TP, [3, 17, 5], 16)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/debug/sequences",
                timeout=30) as r:
            assert "replicas" in json.loads(r.read())
        for bad in ({"prompt": []}, {"prompt": [999]},
                    {"prompt": [1], "max_tokens": 10 ** 6}, {}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(server.port, bad)
            assert ei.value.code == 400
        failures, oks = [], []
        stop_t = time.monotonic() + 3.0

        def load(i):
            j = 0
            while time.monotonic() < stop_t:
                j += 1
                pr = [(i * 7 + j) % 64, (i * 3 + 1) % 64]
                try:
                    code, b = _post(server.port, {"prompt": pr, "max_tokens": 8})
                    if code != 200 or b["tokens"] != pm.lm_generate(TP, pr, 8):
                        failures.append((code, pr, b))
                    else:
                        oks.append(time.monotonic())
                except Exception as e:  # noqa: BLE001
                    failures.append(repr(e))

        threads = [threading.Thread(target=load, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        dec = server.pools["decode"]
        victim = next(r for r in dec.describe()["replicas"].values()
                      if r["state"] == "serving")
        kill_t = time.monotonic()
        os.kill(victim["pid"], 9)
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
        assert not failures, failures[:5]
        assert any(t0 > kill_t for t0 in oks), "nothing completed after the kill"
        deadline = time.monotonic() + 120
        while dec.serving_count() < 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert dec.serving_count() >= 1 and dec.blacklist.blacklisted()
        assert [r["device"] for r in dec.describe()["replicas"].values()] == \
            [victim["device"]] == ["cpu"]
        stats = dec.replica_stats()
        assert [s["device"] for s in stats.values()] == ["cpu"]
        from horovod_tpu_torch.metrics import validate_snapshot

        snap = server.stats()
        assert validate_snapshot(snap["metrics"]) == []
        cs = snap["metrics"]["counters"]
        assert cs.get("horovod_serve_replica_deaths_total", 0) >= 1
        assert cs.get('horovod_serve_llm_handoffs_total{path="wire"}', 0) >= 10
        assert snap["serving"]["llm"]["ttft_p99_ms"] > 0
        assert not torch.cuda.is_initialized()
    finally:
        server.stop()


def test_sharded_replica_e2e_oracle():
    """model_shards=2 under a chip budget the unsharded model exceeds:
    sharded pages cross the handoff channel, generations oracle-exact."""
    from horovod_tpu.serving.llm.replica import \
        per_chip_persistent_nbytes as jneed
    from horovod_tpu.serving.model import shard_lm_params as jshard
    from horovod_tpu.serving.model import tiny_lm_params as jparams
    from horovod_tpu_torch.serving.llm.replica import \
        per_chip_persistent_nbytes as pneed

    full = pneed(pcfg.LLMConfig.from_env(colocated=0), TP)
    sharded = pneed(pcfg.LLMConfig.from_env(colocated=0, model_shards=2),
                    pm.shard_lm_params(TP, 2))
    assert full == jneed(jcfg.LLMConfig.from_env(colocated=0), jparams())
    assert sharded == jneed(jcfg.LLMConfig.from_env(colocated=0, model_shards=2),
                            jshard(jparams(), 2))
    budget = (full + sharded) // 2
    server = _server(colocated=0, model_shards=2, chip_budget=budget)
    server.start()
    before = dict(server.reg.snapshot()["counters"])
    try:
        assert server.wait_ready(180)
        for pr, n in ([3, 17, 5], 16), ([60], 8), ([9, 30, 2, 8], 12):
            st, body = _post(server.port, {"prompt": pr, "max_tokens": n})
            assert st == 200 and body["tokens"] == pm.lm_generate(TP, pr, n), pr
        after = server.reg.snapshot()["counters"]
        key = 'horovod_serve_llm_handoffs_total{path="wire"}'
        assert after.get(key, 0) - before.get(key, 0) >= 3
    finally:
        server.stop()


def test_colocated_e2e_local_fast_path():
    server = _server(colocated=1, decode_replicas=1)
    server.start()
    before = dict(server.reg.snapshot()["counters"])
    try:
        assert server.wait_ready(180)
        st, body = _post(server.port, {"prompt": [9, 2], "max_tokens": 12})
        assert st == 200 and body["tokens"] == pm.lm_generate(TP, [9, 2], 12)
        cs = server.stats()["metrics"]["counters"]

        def delta(series):
            return cs.get(series, 0) - before.get(series, 0)

        assert delta('horovod_serve_llm_handoffs_total{path="local"}') >= 1
        assert delta('horovod_serve_llm_handoffs_total{path="wire"}') == 0
        assert delta("horovod_serve_llm_handoff_bytes_total") == 0
        stats = server.pools["both"].replica_stats()
        assert [s["device"] for s in stats.values()] == ["cpu"]
    finally:
        server.stop()
