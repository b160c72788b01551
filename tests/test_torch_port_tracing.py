"""The port's tracing (``horovod_tpu_torch.tracing``) against the JAX
package's (``horovod_tpu.tracing``), and the spans, counters and stall
watchdog that the port's own collectives feed.

In one process, on the same inputs, every comparison exact (integers,
strings and the float arithmetic of the same formulas on the same
numbers):
- ``trace_id`` and the recorder's lines (all but the meta line's pid and
  wall-clock stamp);
- ``load_spans``, ``build_trace`` and ``analyze`` on the same span
  directories (a seeded synthetic pod with tier-tagged wire spans and a
  serving process, and the 4-rank world below); the collector's CLI;
- each package's ``read_ring`` decodes the other's ring file;
- ``make_bundle``'s summary and MANIFEST.md (all but the collection
  stamp) over the same flight and trace directories; the port's
  ``--leader`` sweep raises ``NotImplementedError``.

A world of one (gloo): the collectives' counters equal the bytes issued,
each collective writes ``enqueue``, ``wire`` and ``done`` spans under
``<name>#<seq>``, and a traced run is bit-equal to an untraced one.
Workers started by the port's launcher announce their clock offset to
the driver in their span files.

A 4-rank gloo world (tests/torch_port_tracing_worker.py): the 2-layer
TransformerLM, flat DP at 3 buckets, 5 steps, rank 2 sleeping 0.2 s before
step 3's backward. Every bucket's trace ID on all four ranks;
``multi_rank_collectives`` equal to buckets x steps (and the hooked
exchange's one broadcast of its launch order); at least 80% of the
sleep in ``skew_seconds_by_rank[2]`` (the reference's own acceptance
rule, ``horovod_tpu/tracing/critical_path.py:20-22``); every ``wire`` span
inside its step's host window; the traced run bit-equal to the untraced
one. A 2-rank stall world: rank 1 skips a collective, rank 0's watchdog
warns and its wait raises ``HorovodInternalError`` within the shutdown
time + 10 s.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu.tracing as ref_tracing
import horovod_tpu_torch as hvd
import horovod_tpu_torch.tracing as port_tracing
from horovod_tpu.tracing import bundle as ref_bundle
from horovod_tpu.tracing import collector as ref_collector
from horovod_tpu.tracing import critical_path as ref_cp
from horovod_tpu.tracing import flight as ref_flight
from horovod_tpu.tracing import recorder as ref_recorder
from horovod_tpu_torch.tracing import bundle, collector, critical_path, flight, recorder
from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_tracing_worker.py")
LM = dict(vocab=64, dim=32, heads=2, layers=2, seq=16)
STEPS, BUCKETS, SLEEP_RANK, SLEEP_S = 5, 3, 2, 0.2


@pytest.mark.parametrize("name,seq", [("grad.0", 1), ("grad.13", 3),
                                      ("allreduce", 7), ("param.2", 12)])
def test_trace_id_matches(name, seq):
    assert port_tracing.trace_id(name, seq) == ref_tracing.trace_id(name, seq)


def _drive_recorder(module, path):
    rec = module.TraceRecorder(path, 1, clock_offset_ns=1234, max_spans=5)
    rec.span("grad.0#1", "grad.0", "allreduce", "enqueue", 100)
    rec.span("grad.0#1", "grad.0", "allreduce", "wire", 100, 250, bytes=64,
             tier="local")
    rec.point("grad.0#1", "grad.0", "allreduce", "done")
    rec.emit_raw({"tid": "x#1", "name": "x", "op": "broadcast",
                  "phase": "wire", "t0": 5, "t1": 9})
    rec.set_clock_offset(77)
    for i in range(4):      # past the cap of 5: counted as dropped
        rec.span(f"y#{i}", "y", "allgather", "wire", i, i + 1)
    rec.close()
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    for line in lines:
        line.pop("pid", None)
        line.pop("time_unix_s", None)
        if line.get("phase") == "done":
            line["t0"] = line["t1"] = 0         # the point's own clock
    return lines


def test_recorder_lines_match(tmp_path):
    assert _drive_recorder(recorder, str(tmp_path / "port.jsonl")) == \
        _drive_recorder(ref_recorder, str(tmp_path / "ref.jsonl"))
    assert recorder.span_path("/d", 3) == ref_recorder.span_path("/d", 3)
    assert recorder.proc_span_path("/d", "router") == \
        ref_recorder.proc_span_path("/d", "router")


def _synthetic_pod(d, seed=0, ranks=4, collectives=6):
    """Span files of a seeded pod: per collective and rank an enqueue, a
    negotiate, wire spans with and without a tier, a reduce and a done;
    rank files with clock offsets, a torn last line on rank 1, and one
    serving process's file."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for r in range(ranks):
        lines = [{"meta": 1, "rank": r, "clock": "monotonic_ns",
                  "clock_offset_ns": int(rng.integers(-5000, 5000)),
                  "pid": 1, "time_unix_s": 0.0}]
        for c in range(collectives):
            tid = f"grad.{c % 3}#{c // 3 + 1}"
            t = int(1_000_000 * c + rng.integers(0, 400_000))
            lines.append({"tid": tid, "rank": r, "name": tid.split("#")[0],
                          "op": "allreduce", "phase": "enqueue", "t0": t, "t1": t})
            n = t + int(rng.integers(1000, 50_000))
            lines.append({"tid": tid, "rank": r, "name": "x", "op": "allreduce",
                          "phase": "negotiate", "t0": t, "t1": n,
                          "cached": bool(c % 2)})
            w = n + int(rng.integers(1000, 90_000))
            lines.append({"tid": tid, "rank": r, "name": "x", "op": "allreduce",
                          "phase": "wire", "t0": n, "t1": w,
                          **({"tier": "cross"} if c % 3 == 0 else {})})
            lines.append({"tid": tid, "rank": r, "name": "x", "op": "allreduce",
                          "phase": "reduce", "t0": w, "t1": w + 700})
            lines.append({"tid": tid, "rank": r, "name": "x", "op": "allreduce",
                          "phase": "done", "t0": w + 900, "t1": w + 900})
        with open(os.path.join(d, f"spans-rank{r}.jsonl"), "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
            if r == 1:
                f.write('{"tid": "torn", "rank": 1, "ph')
    with open(os.path.join(d, "spans-router.jsonl"), "w") as f:
        f.write(json.dumps({"meta": 1, "rank": 0, "proc": "router",
                            "clock_offset_ns": 10}) + "\n")
        f.write(json.dumps({"tid": "req:gen:1", "rank": 0, "name": "req",
                            "op": "serve", "phase": "admit", "t0": 5, "t1": 5})
                + "\n")


@pytest.mark.parametrize("seed", [0, 1])
def test_collector_and_critical_path_match(tmp_path, seed):
    d = str(tmp_path / "trace")
    _synthetic_pod(d, seed)
    spans, metas = collector.load_spans(d)
    ref_spans, ref_metas = ref_collector.load_spans(d)
    assert spans == ref_spans and metas == ref_metas
    assert collector.build_trace(spans, metas) == \
        ref_collector.build_trace(ref_spans, ref_metas)
    train = [s for s in spans if "proc" not in s]
    report = critical_path.analyze(train)
    assert report == ref_cp.analyze(train)
    assert critical_path.format_summary(report) == ref_cp.format_summary(report)
    assert report["multi_rank_collectives"] == 6
    port_trace = collector.merge_trace(d, str(tmp_path / "port.json"))
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == port_trace       # strict JSON


def test_collector_cli(tmp_path):
    d = str(tmp_path / "trace")
    _synthetic_pod(d)
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tracing.collector", d,
         "--critical-path"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    spans, _ = ref_collector.load_spans(d)
    want = ref_cp.format_summary(ref_cp.analyze(spans))
    assert want in out.stdout
    with open(os.path.join(d, "trace.json")) as f:
        assert f.read(1) == "{"


def _fill(module, d, proc):
    rec = module.FlightRecorder(proc, flight_dir=d, capacity=16)
    for i in range(20):             # wraps the ring of 16
        rec.retain({"tid": f"grad.{i}#1", "phase": "wire", "t0": i})
    rec.event("stall", rank=0, stalled=[{"name": "grad.0#2", "op": "allreduce"}])
    rec.retain({"big": "x" * 2000})     # past a slot: truncated
    return rec


def test_rings_read_across_packages(tmp_path):
    d = str(tmp_path / "flight")
    port_rec = _fill(flight, d, "rank0")
    ref_rec = _fill(ref_flight, d, "rank1")
    for rec in (port_rec, ref_rec):
        path = rec.ring_path(d, rec.proc)
        got, want = flight.read_ring(path), ref_flight.read_ring(path)
        assert got == want
        assert got["records"] == rec.records() and len(got["records"]) == 16
        assert got["records"][-1] == {"flight_truncated": 1, "tid": None,
                                      "phase": None, "flight_event": None}
    assert flight.ring_files(d) == ref_flight.ring_files(d)
    fp, ref_fp = flight.config_fingerprint(), ref_flight.config_fingerprint()
    assert fp == ref_fp
    os.environ["HOROVOD_SECRET_TEST"] = "hidden"
    try:
        assert "HOROVOD_SECRET_TEST" not in flight.config_fingerprint()["env"]
    finally:
        del os.environ["HOROVOD_SECRET_TEST"]
    port_rec.close()
    ref_rec.close()


def test_bundle_matches(tmp_path):
    fdir, tdir = str(tmp_path / "flight"), str(tmp_path / "trace")
    rec = _fill(flight, fdir, "rank0")
    rec.event("anomaly", kind="wire_drift", ratio=5.0)
    assert rec.dump("stall-abort-grad.0#2")
    rec.close()
    _fill(ref_flight, fdir, "rank1").close()
    _synthetic_pod(tdir)

    def manifest(out):
        with open(os.path.join(out, "MANIFEST.md")) as f:
            lines = f.read().splitlines()
        return [line for line in lines[1:] if not line.startswith("Collected")]

    got = bundle.make_bundle(str(tmp_path / "port"), trace_dir=tdir,
                             flight_dir=fdir)
    want = ref_bundle.make_bundle(str(tmp_path / "ref"), trace_dir=tdir,
                                  flight_dir=fdir)
    got.pop("bundle"), want.pop("bundle")
    assert got == want and got["events"] >= 2 and got["trace"]
    assert manifest(str(tmp_path / "port")) == manifest(str(tmp_path / "ref"))
    for name in ("critical_path.json", "trace.json"):
        with open(tmp_path / "port" / name) as a, open(tmp_path / "ref" / name) as b:
            assert json.load(a) == json.load(b)
    # the --leader sweep: an unreachable leader is named a coverage gap
    lead = {name: mod.make_bundle(str(tmp_path / f"lead-{name}"),
                                  leaders=["127.0.0.1:1"], leader_key=b"k")
            for name, mod in (("port", bundle), ("jax", ref_bundle))}
    for summary in lead.values():
        summary.pop("bundle")
    assert lead["port"] == lead["jax"]
    assert lead["port"]["coverage_gaps"] == ["127.0.0.1:1"]


# -- the collectives' telemetry, a world of one (gloo) ------------------------------

@pytest.fixture
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR",
              "HOROVOD_TRACE_DIR", "HOROVOD_NUM_BUCKETS",
              "HOROVOD_STALL_CHECK_DISABLE", "HOROVOD_METRICS_PORT"):
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    hvd.shutdown()


def _counters():
    return hvd.metrics.registry().snapshot()["counters"]


def _lm_steps(trace_dir, monkeypatch, steps=3):
    """Three steps of the 2-layer TransformerLM at 3 buckets in a world of
    one: the losses, the parameters, the optimizer's plan."""
    from horovod_tpu_torch import train as train_mod
    from horovod_tpu_torch.convert import jax_ordered

    if trace_dir:
        monkeypatch.setenv("HOROVOD_TRACE_DIR", trace_dir)
    else:
        monkeypatch.delenv("HOROVOD_TRACE_DIR", raising=False)
    monkeypatch.setenv("HOROVOD_NUM_BUCKETS", str(BUCKETS))
    hvd.init(device="cpu")
    cfg = train_mod.TrainConfig(**LM)
    model = train_mod.build_model(cfg, hvd.device())
    opt = hvd.DistributedOptimizer(train_mod.adam(model.parameters(), cfg),
                                   jax_ordered(model.named_parameters()))
    step = train_mod.make_train_step(model, opt)
    before = _counters()
    losses = [float(step(train_mod.make_batch(cfg, 0, hvd.device())))
              for _ in range(steps)]
    after = _counters()
    params = [p.detach().clone() for p in model.parameters()]
    hvd.shutdown()
    return losses, params, opt, before, after


def test_traced_steps_bit_equal_and_spanned(tmp_path, world_of_one):
    plain, plain_params, _, _, _ = _lm_steps("", world_of_one)
    d = str(tmp_path / "trace")
    losses, params, opt, before, after = _lm_steps(d, world_of_one)
    assert losses == plain
    assert all(torch.equal(a, b) for a, b in zip(params, plain_params))
    key = 'horovod_collective_bytes_total{op="allreduce"}'
    plan_bytes = sum(n for _, n in hvd.metrics.last_plan())
    assert after[key] - before.get(key, 0) == 3 * plan_bytes
    n = 'horovod_collectives_total{op="allreduce"}'
    assert after[n] - before.get(n, 0) == 3 * opt.plan.num_buckets
    spans, metas = collector.load_spans(d)
    assert metas[0]["clock_offset_ns"] == 0
    tids = {s["tid"] for s in spans}
    want = {f"grad.{b}#{k}" for b in range(BUCKETS) for k in (1, 2, 3)}
    assert tids == want
    for tid in want:
        phases = sorted(s["phase"] for s in spans if s["tid"] == tid)
        assert phases == ["done", "enqueue", "wire"], (tid, phases)
    wire = [s for s in spans if s["phase"] == "wire"]
    assert all(s["t1"] >= s["t0"] and s["op"] == "allreduce" for s in wire)
    with open(os.path.join(d, "compiled-plan-rank0.jsonl")) as f:
        (line,) = [json.loads(x) for x in f]
    assert line["num_buckets"] == BUCKETS and line["compression"] == "none"
    assert sum(line["bucket_bytes"]) == plan_bytes


def test_collective_counters_and_names(world_of_one):
    hvd.init(device="cpu")
    before = _counters()
    x = torch.arange(6, dtype=torch.float32)
    hvd.allreduce(x, name="loss")
    hvd.broadcast(x.clone(), 0)
    hvd.allgather(x)
    hvd.broadcast_object({"a": 1}, name="meta")
    after = _counters()
    for op, nbytes in (("allreduce", 24), ("broadcast", 24), ("allgather", 24)):
        key = f'horovod_collective_bytes_total{{op="{op}"}}'
        assert after[key] - before.get(key, 0) == nbytes, op
    hist = hvd.metrics.registry().snapshot()["histograms"]
    assert any(k.startswith("horovod_collective_seconds") for k in hist)


# -- multi-process worlds (gloo) -----------------------------------------------------

def _spawn(mode, n, tmp, env_extra=None, timeout=240):
    port, port2 = free_port(), free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}",
                   TRACING_COORD_ADDR2=f"127.0.0.1:{port2}", TRACING_MODE=mode,
                   TRACING_OUT=str(tmp / "out"), OMP_NUM_THREADS="1",
                   **(env_extra or {}))
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "HOROVOD_TRACE_DIR", "HOROVOD_FUSION_THRESHOLD",
                    "HOROVOD_COMPRESSION", "HOROVOD_LATENCY_HIDING",
                    "HOROVOD_STALL_CHECK_DISABLE"):
            if var not in (env_extra or {}):
                env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errors = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"rank {rank}: {err[-3000:]}")
    assert not errors, errors
    out = []
    for rank in range(n):
        with open(tmp / f"out.{rank}.json") as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module", params=["serial", "hooked"])
def tracing_world(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"torch_port_tracing_{request.param}")
    env = {"TRACING_CFG": json.dumps(LM), "TRACING_STEPS": str(STEPS),
           "TRACING_SLEEP_RANK": str(SLEEP_RANK), "TRACING_SLEEP_S": str(SLEEP_S),
           "TRACING_TRACE_DIR": str(tmp / "trace"),
           "HOROVOD_NUM_BUCKETS": str(BUCKETS),
           "HOROVOD_LATENCY_HIDING": "1" if request.param == "hooked" else "0"}
    return _spawn("world", 4, tmp, env), str(tmp / "trace"), request.param


def test_world_traced_equals_untraced(tracing_world):
    out, _, _ = tracing_world
    for r in out:
        assert r["bit_equal"], r["rank"]
        assert r["traced_losses"] == r["plain_losses"], r["rank"]


def test_world_trace_ids_and_attribution(tracing_world):
    out, d, mode = tracing_world
    spans, metas = collector.load_spans(d)
    assert sorted(metas) == [0, 1, 2, 3]
    assert (spans, metas) == ref_collector.load_spans(d)
    buckets = out[0]["buckets"]
    assert buckets == BUCKETS
    for b in range(buckets):
        for k in range(1, STEPS + 1):
            ranks = {s["rank"] for s in spans if s["tid"] == f"grad.{b}#{k}"}
            assert ranks == {0, 1, 2, 3}, (b, k)
    report = critical_path.analyze(spans)
    assert report == ref_cp.analyze(spans)
    # The hooked exchange agrees its launch order once, by a broadcast.
    assert report["multi_rank_collectives"] == buckets * STEPS + (mode == "hooked")
    assert [s["tid"] for s in spans if not s["tid"].startswith("grad.")
            and s["phase"] == "enqueue" and s["rank"] == 0] == \
        (["broadcast#1"] if mode == "hooked" else [])
    assert report["phase_seconds"]["negotiation"] == 0
    assert report["phase_seconds"]["cache"] == 0
    assert report["skew_seconds_by_rank"].get(SLEEP_RANK, 0) >= 0.8 * SLEEP_S
    for s in spans:
        if s["phase"] != "wire":
            continue
        w = out[s["rank"]]["windows"][int(s["tid"].split("#")[1]) - 1]
        assert w["t0"] <= s["t0"] <= s["t1"] <= w["t1"], s


def test_stall_watchdog_aborts_the_wait(tmp_path):
    check_s, shutdown_s = 1.0, 3.0
    out = _spawn("stall", 2, tmp_path, {
        "HOROVOD_STALL_CHECK_TIME": str(check_s),
        "HOROVOD_STALL_SHUTDOWN_TIME": str(shutdown_s)}, timeout=120)
    r = out[0]
    assert r["error"] and "allreduce#2" in r["error"], r
    assert "HOROVOD_STALL_SHUTDOWN_TIME" in r["error"]
    assert shutdown_s <= r["seconds"] <= shutdown_s + 10
    assert r["warnings"] >= 1 and r["aborts"] == 1 and r["errors"] == 1
    (stalled,) = r["report"]["stalled"]
    assert stalled["name"] == "allreduce#2" and stalled["op"] == "allreduce"
    assert stalled["missing_ranks"] is None
    assert "allreduce#2 (allreduce, waiting" in r["report"]["text"]


def test_launched_workers_record_the_driver_clock_offset(tmp_path):
    """Workers started by the port's launcher (``run``) with
    ``HOROVOD_TRACE_DIR`` estimate their clock offset to the driver over
    the task channel (``tracing/clock.py``) and announce it in a second
    meta line, which the collector applies (its last meta line wins);
    their allreduce is traced under the same ID on both ranks."""
    from horovod_tpu_torch.runner import run

    d = str(tmp_path / "trace")

    def traced_fn():
        import torch as _torch

        import horovod_tpu_torch as _hvd

        _hvd.init(device="cpu")
        _hvd.allreduce(_torch.ones(3), name="probe")
        _hvd.shutdown()
        return True

    assert run(traced_fn, num_proc=2, timeout=120,
               env={"HOROVOD_TRACE_DIR": d}) == [True, True]
    for r in range(2):
        with open(os.path.join(d, f"spans-rank{r}.jsonl")) as f:
            metas = [m for m in map(json.loads, f) if m.get("meta")]
        # The second meta line is the estimate's announcement (the first
        # is written with the first record, which the announcement is).
        assert len(metas) == 2, metas
        assert abs(metas[1]["clock_offset_ns"]) < 10**9     # one host
    spans, metas = collector.load_spans(d)
    assert {(s["rank"], s["phase"]) for s in spans if s["tid"] == "probe#1"} == \
        {(r, p) for r in range(2) for p in ("enqueue", "wire", "done")}
    assert metas[1]["clock_offset_ns"] == \
        ref_collector.load_spans(d)[1][1]["clock_offset_ns"]
