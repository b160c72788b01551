"""The port's copies of the framework-free metrics modules
(``metrics/registry.py``, ``schema.py``, ``aggregate.py``,
``exposition.py``, ``watchdog.py``, ``anomaly.py``) against
``horovod_tpu.metrics``: the same operations on a registry of each give
identical snapshots (all but the wall-clock stamp) and identical
Prometheus text; ``merge_snapshots``, the partial monoid, the deltas and
``validate_snapshot`` give identical results on the same inputs; the HTTP
exposition serves the same text and JSON; the stall watchdog publishes
the same report; the anomaly detector fires the same kinds at the same
ticks on the same counter sequence. The plan gauges and the compiled-plan
line of the port's ``DistributedOptimizer`` (flat, bf16 wire,
hierarchical, ZeRO) equal those the JAX package's ``fused_allreduce`` and
sharded planner record while they trace the same model's parameters.
Every comparison is exact."""

import importlib
import json
import os
import random

import numpy as np
import pytest

import horovod_tpu_torch.metrics as port_metrics
from horovod_tpu.metrics import aggregate as ref_agg
from horovod_tpu.metrics import schema as ref_schema
from horovod_tpu_torch.metrics import aggregate, schema

# The packages export a function ``registry`` under the module's name.
ref_reg = importlib.import_module("horovod_tpu.metrics.registry")
reg_mod = importlib.import_module("horovod_tpu_torch.metrics.registry")


def _drive(reg, seed):
    """A seeded mix of every registry operation."""
    rng = random.Random(seed)
    reg.counter("horovod_steps_total", help="steps").inc(3)
    reg.counter("horovod_bytes_total", help="bytes", op="allreduce").inc(1024.5)
    reg.counter("horovod_bytes_total", op="allgather").inc(7)
    g = reg.gauge("horovod_steps_per_sec", help="rate")
    g.set(rng.uniform(1, 100))
    g.inc(0.25)
    reg.gauge("horovod_queue", host="a").set(-2)
    h = reg.histogram("horovod_ckpt_commit_seconds", help="commit")
    for _ in range(50):
        h.observe(rng.expovariate(3.0))
    hb = reg.histogram("horovod_bucket_bytes", buckets=reg_buckets(reg), kind="x")
    for _ in range(20):
        hb.observe(rng.choice([100, 5000, 1 << 20, 1 << 30]))
    reg.histogram("horovod_empty")
    reg.set_info("stall_report", {"ranks": [1, 2], "tensor": "w"})
    reg.counter("horovod_gone").inc()
    assert reg.remove("horovod_gone")
    assert not reg.remove("horovod_never")
    reg.register_collector(lambda r: r.gauge("horovod_collected").set(seed))
    reg.register_collector(lambda r: 1 / 0)     # a broken collector is skipped
    return reg


def reg_buckets(reg):
    module = ref_reg if isinstance(reg, ref_reg.MetricsRegistry) else reg_mod
    return module.DEFAULT_BYTE_BUCKETS


def _pair(seed):
    return _drive(ref_reg.MetricsRegistry(), seed), _drive(reg_mod.MetricsRegistry(), seed)


def _no_clock(snap):
    return {k: v for k, v in snap.items() if k != "time_unix_s"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_prometheus_text_match(seed):
    ref, port = _pair(seed)
    assert _no_clock(port.snapshot()) == _no_clock(ref.snapshot())
    assert port.render_prometheus() == ref.render_prometheus()
    h_ref = ref.histogram("horovod_ckpt_commit_seconds")
    h_port = port.histogram("horovod_ckpt_commit_seconds")
    for p in (0, 12.5, 50, 90, 99, 100):
        assert h_port.percentile(p) == h_ref.percentile(p)
    with pytest.raises(ValueError):
        h_port.percentile(101)
    with pytest.raises(ValueError):
        port.counter("horovod_steps_total").inc(-1)


def test_reset_and_the_process_registry():
    _, port = _pair(3)
    port.reset()
    assert _no_clock(port.snapshot()) == _no_clock(ref_reg.MetricsRegistry().snapshot())
    assert port_metrics.registry() is reg_mod.registry()
    snap = port_metrics.snapshot()
    assert snap["schema"] == "horovod_tpu.metrics.v1"
    assert port_metrics.render_prometheus().endswith("\n")


def _snapshots(n, seed):
    out = []
    for r in range(n):
        if r == 1:
            out.append(None)            # a rank that reported nothing
            continue
        snap = _drive(reg_mod.MetricsRegistry(), seed * 10 + r).snapshot()
        snap["time_unix_s"] = 1000.0 + r
        out.append(snap)
    return out


@pytest.mark.parametrize("n", [1, 3, 4])
def test_merge_snapshots_matches(n):
    snaps = _snapshots(n, n)
    assert aggregate.merge_snapshots(snaps) == ref_agg.merge_snapshots(snaps)
    assert port_metrics.merge_snapshots is aggregate.merge_snapshots


def test_partials_deltas_and_schema_match():
    snaps = _snapshots(4, 7)
    parts = [aggregate.lift_snapshot(r, s) for r, s in enumerate(snaps)]
    assert parts == [ref_agg.lift_snapshot(r, s) for r, s in enumerate(snaps)]
    tree = aggregate.combine_partials(aggregate.merge_partials(parts[:2]),
                                      aggregate.merge_partials(parts[2:]))
    assert aggregate.finalize_partial(tree) == ref_agg.merge_snapshots(snaps)
    prev, cur = snaps[0], snaps[2]
    delta = aggregate.snapshot_delta(prev, cur)
    assert delta == ref_agg.snapshot_delta(prev, cur)
    assert aggregate.apply_snapshot_delta(prev, delta) == cur
    pod = aggregate.merge_snapshots(snaps)
    for snap in (cur, pod, {"schema": "horovod_tpu.metrics.v1"}):
        assert schema.validate_snapshot(snap) == ref_schema.validate_snapshot(snap)
    assert schema.validate_snapshot(cur) == []
    assert schema.SCHEMA_PATH == ref_schema.SCHEMA_PATH


# -- exposition, watchdog, anomaly: the port's copies against the JAX modules -------
#
# Same inputs to each package's module; every comparison exact, but for the
# wall-clock stamps a snapshot or an event carries.

def _get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


@pytest.mark.parametrize("seed", [0, 3])
def test_exposition_text_and_snapshot_match(seed):
    from horovod_tpu.metrics import exposition as ref_expo
    from horovod_tpu_torch.metrics import exposition

    ref, port = _pair(seed)
    servers = [ref_expo.MetricsServer(0, reg=ref), exposition.MetricsServer(0, reg=port)]
    try:
        want, got = (_get(s.port, "/metrics") for s in servers)
        assert got == want and "horovod_steps_total 3.0" in got
        snaps = [json.loads(_get(s.port, "/metrics.json")) for s in servers]
        assert _no_clock(snaps[1]) == _no_clock(snaps[0])
        assert _no_clock(json.loads(_get(servers[1].port, "/snapshot"))) == \
            _no_clock(snaps[0])
        assert _get(servers[1].port, "/healthz") == "ok\n"
    finally:
        for s in servers:
            s.stop()


def test_watchdog_report_matches():
    from horovod_tpu.metrics import watchdog as ref_wd
    from horovod_tpu_torch.metrics import watchdog

    def run(module, reg):
        stalled = [module.StallInfo("grad.3#2", "allreduce", 7.25),
                   module.StallInfo("param.0#1", "allgather", 2.5, [1, 3]),
                   module.StallInfo("young#1", "broadcast", 0.5)]
        wd = module.StallWatchdog(check_time_s=2.0, shutdown_time_s=0.0,
                                  reg=reg, poll_interval_s=3600)
        wd.add_source(lambda: stalled)
        wd.add_source(lambda: 1 / 0)          # a broken source is skipped
        wd._scan()
        wd.stop()
        report = dict(reg.get_info("stall_report"))
        report.pop("time_unix_s")
        return (report, module.format_report(stalled[:2], 2.0),
                reg.snapshot()["counters"], reg.snapshot()["gauges"])

    want = run(ref_wd, ref_reg.MetricsRegistry())
    got = run(watchdog, reg_mod.MetricsRegistry())
    assert got == want
    assert "grad.3#2 (allreduce, waiting 7.2s" in got[0]["text"]


class _Flight:
    def event(self, *a, **k):
        pass

    def dump(self, *a, **k):
        return ""


def _anomaly_run(module, reg_module):
    """Ticks of a detector over a seeded counter sequence that trips every
    kind: the kinds fired at each tick, the history and the counters."""
    rng = random.Random(7)
    reg = reg_module.MetricsRegistry()
    det = module.AnomalyDetector(reg=reg, slo_s=0.5, factor=4.0, cooldown_s=5.0,
                                 flight=_Flight())
    fired = []
    for t in range(40):
        reg.counter("horovod_wire_bytes_total", plane="eager").inc(
            1000 + rng.randint(0, 50) + (20000 if t == 20 else 0))
        reg.counter("horovod_serve_llm_tokens_total").inc(
            100 if t < 25 else 1)
        reg.gauge("horovod_serve_llm_waiting_sequences").set(3)
        reg.counter("horovod_serve_shed_total").inc(40 if t == 12 else 0)
        reg.counter("horovod_serve_llm_preemptions_total").inc(12 if t == 15 else 0)
        reg.counter("horovod_plane_demotions_total").inc(2 if t in (5, 6) else 0)
        reg.gauge("horovod_serve_projected_wait_seconds").set(0.9 if t == 30 else 0)
        reg.gauge("horovod_telemetry_snapshot_age_ticks", host="h1").set(
            5 if t == 33 else 0)
        fired.append(det.tick(now=float(t)))
    history = [{k: v for k, v in e.items() if k != "time_unix_s"}
               for e in det.history]
    return fired, history, reg.snapshot()["counters"]


def test_anomaly_detector_fires_the_same_kinds():
    from horovod_tpu.metrics import anomaly as ref_anomaly
    from horovod_tpu_torch.metrics import anomaly

    want = _anomaly_run(ref_anomaly, ref_reg)
    got = _anomaly_run(anomaly, reg_mod)
    assert got == want
    kinds = {k for tick in got[0] for k in tick}
    assert kinds == set(anomaly.AnomalyDetector.KINDS), kinds


# -- the plan gauges of the port's DistributedOptimizer --------------------------
#
# The port's optimizer over the 2-layer TransformerLM's parameters (in the
# converter's order) against the JAX package's fused_allreduce and sharded
# planner traced on the same model's parameter tree: the gauges, the last
# plans and the compiled-plan line, bit-equal (integers and the same float
# ratios of them), all but the line's wall-clock stamp.

_LM = dict(vocab=64, dim=32, heads=2, layers=2)
_THRESHOLD = 40000
_PLAN_GAUGES = ("horovod_fusion_", "horovod_overlap_efficiency_planned",
                "horovod_compiled_")


def _plan_view(reg, last, trace_dir):
    snap = reg.snapshot()
    gauges = {k: v for k, v in snap["gauges"].items()
              if k.startswith(_PLAN_GAUGES)}
    hist = snap["histograms"].get("horovod_fusion_bucket_bytes")
    with open(os.path.join(trace_dir, "compiled-plan-rank0.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    for line in lines:
        line.pop("time_unix_s")
    info = {k: snap["info"].get(k) for k in ("wire_compression",
                                             "compiled_tier_plan",
                                             "compiled_shard_plan")}
    return gauges, hist, last, lines, info


def _jax_plan(case, monkeypatch, trace_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu import metrics as jm
    from horovod_tpu.compat import shard_map
    from horovod_tpu.models import TransformerLM as JaxLM
    from horovod_tpu.parallel import fusion as jf
    from horovod_tpu.parallel import sharded as jsh

    params = jax.jit(JaxLM(**_LM).init)(jax.random.PRNGKey(0),
                                        jnp.ones((1, 8), jnp.int32))["params"]
    monkeypatch.setenv("HOROVOD_TRACE_DIR", trace_dir)
    monkeypatch.setenv("HOROVOD_RANK", "0")
    jm.registry().reset()
    devs = np.asarray(jax.devices())
    if case["kind"] == "zero":
        mesh = Mesh(devs[:4].reshape(2, 2), ("batch", "shard"))
        plan = jsh.build_shard_plan(params, 2, threshold=_THRESHOLD,
                                    num_buckets=case["k"])
        body = lambda g: sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(  # noqa: E731
            jsh.reduce_scatter_gradients(g, plan, compression=case["wire"])))
    elif case["kind"] == "hier":
        mesh = Mesh(devs[:4].reshape(2, 2), ("dcn", "ici"))
        body = lambda g: jf.fused_allreduce(  # noqa: E731
            g, threshold=_THRESHOLD, hierarchical=True, num_buckets=case["k"],
            compression=case["wire"], dcn_compression=case.get("dcn"))
    else:
        mesh = Mesh(devs[:1], ("hvd",))
        body = lambda g: jf.fused_allreduce(  # noqa: E731
            g, threshold=_THRESHOLD, num_buckets=case["k"],
            compression=case["wire"])
    jax.jit(shard_map(body, mesh=mesh, in_specs=P(), out_specs=P(),
                      check_vma=False))(params)
    last = (jm.last_plan(), jm.last_wire_plan(),
            jm.last_shard_plan() if case["kind"] == "zero" else jm.last_tier_plan())
    return _plan_view(jm.registry(), last, trace_dir)


def _port_plan(case, monkeypatch, trace_dir):
    from types import SimpleNamespace

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel import sharded as sh

    monkeypatch.setenv("HOROVOD_TRACE_DIR", trace_dir)
    port_metrics.registry().reset()
    hvd.init(device="cpu")
    try:
        named = convert.jax_ordered(TransformerLM(**_LM).named_parameters())
        params = [p for _, p in named]
        kw = dict(fusion_threshold=_THRESHOLD, num_buckets=case["k"],
                  compression=case["wire"])
        if case["kind"] == "zero":
            layout = SimpleNamespace(batch_size=2, shard_size=2, shard_rank=0,
                                     batch_group=None, shard_group=None)
            plan = sh.build_shard_plan(params, 2, _THRESHOLD, case["k"])
            rows = sh.shard_params(params, plan, 0)
            hvd.DistributedOptimizer(torch.optim.Adam(list(rows)), named,
                                     sharded=True, shard_plan=plan,
                                     layout=layout, **kw)
        elif case["kind"] == "hier":
            groups = SimpleNamespace(ici_size=2, dcn_size=2)
            hvd.DistributedOptimizer(torch.optim.Adam(params), named,
                                     hierarchical=True, groups=groups,
                                     dcn_compression=case.get("dcn"), **kw)
        else:
            hvd.DistributedOptimizer(torch.optim.Adam(params), named, **kw)
        m = port_metrics
        last = (m.last_plan(), m.last_wire_plan(),
                m.last_shard_plan() if case["kind"] == "zero" else m.last_tier_plan())
        return _plan_view(m.registry(), last, trace_dir)
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("case", [
    {"kind": "flat", "k": 1, "wire": None},
    {"kind": "flat", "k": 3, "wire": None},
    {"kind": "flat", "k": 3, "wire": "bf16"},
    {"kind": "hier", "k": 2, "wire": None, "dcn": "bf16"},
    {"kind": "hier", "k": 1, "wire": "bf16"},
    {"kind": "zero", "k": 2, "wire": None},
    {"kind": "zero", "k": 3, "wire": "bf16"},
], ids=["flat-k1", "flat-k3", "flat-bf16", "hier-dcn-bf16", "hier-bf16",
        "zero", "zero-bf16"])
def test_plan_gauges_match_reference(case, monkeypatch, tmp_path):
    for k in ("HOROVOD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "HOROVOD_COORD_ADDR", "HOROVOD_COMPRESSION", "HOROVOD_DCN_COMPRESSION",
              "HOROVOD_COMPRESSION_MIN_BYTES", "HOROVOD_MESH", "HOROVOD_SHARD_PARAMS",
              "HOROVOD_HIERARCHICAL_ALLREDUCE"):
        monkeypatch.delenv(k, raising=False)
    want = _jax_plan(case, monkeypatch, str(tmp_path / "jax"))
    got = _port_plan(case, monkeypatch, str(tmp_path / "port"))
    assert got == want
    gauges, _, _, (line,), _ = got
    assert gauges["horovod_fusion_buckets"] == line["num_buckets"] > 0
    assert any(line["wire_compressed"]) == (case["wire"] is not None)
