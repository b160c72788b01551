"""The port's copies of the framework-free metrics modules
(``metrics/registry.py``, ``schema.py``, ``aggregate.py``) against
``horovod_tpu.metrics``: the same operations on a registry of each give
identical snapshots (all but the wall-clock stamp) and identical
Prometheus text; ``merge_snapshots``, the partial monoid, the deltas and
``validate_snapshot`` give identical results on the same inputs."""

import importlib
import random

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
