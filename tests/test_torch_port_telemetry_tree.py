"""The port's telemetry tree (``horovod_tpu_torch.telemetry``) against the
JAX package's (``horovod_tpu.telemetry``), on the same inputs: the plan and
the interval knob over a table of host maps and env values; the merge
monoid (host-then-root bitwise the flat merge over fuzzed worlds and
groupings, both packages alike); ``RootAggregator`` over the same fuzzed
delta streams (every partial, coverage and pod view bitwise); the agent's
delta/need_full protocol, its events and its host view, each package's
client against each package's agent; the driver's ``host_metrics`` root and
``pod_metrics`` merge; the elastic pruning of hosts; the ``telemetry_lag``
anomaly; the leader's ``/metrics.json?host=1``; the bundle's ``--leader``
sweep with its Pod coverage; the watchdog's ``event_sink``; and the
services' wire accounting (``stats``), byte for byte. Tolerance: none —
every comparison is exact (JSON with sorted keys where floats are
involved)."""

from __future__ import annotations

import json
import os
import random
import secrets
import time
import urllib.error
import urllib.request

import pytest

from horovod_tpu.metrics import aggregate as ref_agg
from horovod_tpu.metrics.registry import MetricsRegistry as RefRegistry
from horovod_tpu.runner import network as jnet
from horovod_tpu.runner import service as jservice
from horovod_tpu import telemetry as ref_tele
from horovod_tpu.telemetry import root as ref_root
from horovod_tpu.tracing import bundle as ref_bundle
from horovod_tpu.tracing import clock as ref_clock
from horovod_tpu_torch.metrics import aggregate as agg
from horovod_tpu_torch.metrics.anomaly import TELEMETRY_LAG_TICKS, AnomalyDetector
from horovod_tpu_torch.metrics.registry import MetricsRegistry
from horovod_tpu_torch.runner import network as pnet
from horovod_tpu_torch.runner import service as pservice
from horovod_tpu_torch import telemetry as tele
from horovod_tpu_torch.telemetry import root as proot
from horovod_tpu_torch.tracing import bundle
from horovod_tpu_torch.tracing import clock

KEY = secrets.token_bytes(32)
LOOP = "127.0.0.1"
PKGS = {"port": (tele, pnet, pservice, MetricsRegistry),
        "jax": (ref_tele, jnet, jservice, RefRegistry)}


def _dump(x) -> str:
    return json.dumps(x, sort_keys=True)


def _snap(rank: int, tick: int = 1, rng: random.Random = None) -> dict:
    """A synthetic rank snapshot; with ``rng``, values are adversarial
    floats (non-dyadic decimals, tiny/huge magnitudes) whose sums are
    grouping-sensitive in plain fp arithmetic."""
    rv = rng.random if rng else (lambda: 0.1)
    counters = {"horovod_allreduce_ops_total": 3.0 * tick + rank,
                "horovod_x_total": 0.1 + rank * 0.3 + rv() * 1e-9,
                'horovod_labeled_total{op="ar"}': rv() * 1e12}
    gauges = {"horovod_q_depth": rank * 0.7 + rv(),
              "horovod_step_time_s": 0.1 * (1 + (rank + tick) % 3)}
    hist = {"count": 10 * tick + rank, "sum": 0.3 * tick + rv(),
            "p50": 0.1, "p90": 0.2, "p99": 0.3,
            "buckets": [[0.1, 4 * tick], [1.0, 8 * tick],
                        ["+Inf", 10 * tick + rank]]}
    return {"schema": "horovod_tpu.metrics.v1",
            "time_unix_s": 1.7e9 + tick + rank * 0.01,
            "counters": counters, "gauges": gauges,
            "histograms": {"horovod_lat_seconds": hist},
            "info": {"device": f"cuda:{rank}"}}


# -- the plan and the knob ----------------------------------------------------

HOST_MAPS = [
    ["hB", "hB", "hA", "hA", "hA"],
    ["h0"],
    ["x", "y", "x", "y"],
    {0: "a", 1: "a", 2: "b"},
    {3: "b", 1: "a", 7: "c", 2: "a"},
    [f"h{r // 8}" for r in range(64)],
]


@pytest.mark.parametrize("hosts", HOST_MAPS, ids=range(len(HOST_MAPS)))
def test_plan_tree_matches(hosts):
    got, want = tele.plan_tree(hosts), ref_tele.plan_tree(hosts)
    assert (got.hosts, got.ranks_of, got.leader_of, got.num_hosts) == \
        (want.hosts, want.ranks_of, want.leader_of, want.num_hosts)
    ranks = hosts if isinstance(hosts, dict) else range(len(hosts))
    for r in ranks:
        assert got.host_of(r) == want.host_of(r)
        assert got.leader_for(r) == want.leader_for(r)
        assert got.is_leader(r) == want.is_leader(r)
    with pytest.raises(KeyError):
        got.host_of(999)


@pytest.mark.parametrize("raw", [None, "", "2.5", "0.0001", "bogus", "1e-9", "7"])
def test_interval_knob_matches(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("HOROVOD_TELEMETRY_INTERVAL_S", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TELEMETRY_INTERVAL_S", raw)
    assert tele.interval_s_from_env() == ref_tele.interval_s_from_env()
    assert tele.interval_s_from_env() >= 0.05


def test_tree_plan_and_interval_knob(monkeypatch):
    plan = tele.plan_tree(["hB", "hB", "hA", "hA", "hA"])
    assert plan.hosts == ("hA", "hB")     # sorted, like rank assignment
    assert plan.leader_of == {"hA": 2, "hB": 0}
    assert plan.leader_for(4) == 2 and plan.leader_for(1) == 0
    assert plan.is_leader(2) and not plan.is_leader(3)
    monkeypatch.setenv("HOROVOD_TELEMETRY_INTERVAL_S", "0.0001")
    assert tele.interval_s_from_env() == 0.05   # floored, cannot busy-spin
    monkeypatch.setenv("HOROVOD_TELEMETRY_INTERVAL_S", "bogus")
    assert tele.interval_s_from_env() == 1.0


# -- the merge monoid ----------------------------------------------------------


@pytest.mark.parametrize("seed", [1234, 7])
def test_host_then_root_merge_bitwise_equals_flat_fuzz(seed):
    """For random worlds and random contiguous host groupings, lifting per
    host, combining host partials, then finalizing is bitwise the flat
    merge, in the port as in the JAX package."""
    rng = random.Random(seed)
    for trial in range(15):
        world = rng.randrange(2, 33)
        snaps = [_snap(r, tick=rng.randrange(1, 5), rng=rng)
                 for r in range(world)]
        cuts = sorted(rng.sample(range(1, world), min(rng.randrange(0, 5),
                                                      world - 1)))
        groups, lo = [], 0
        for c in cuts + [world]:
            groups.append(list(range(lo, c)))
            lo = c
        for mod in (agg, ref_agg):
            host_parts = [mod.merge_partials([mod.lift_snapshot(r, snaps[r])
                                              for r in g]) for g in groups]
            tree = mod.finalize_partial(mod.merge_partials(host_parts))
            assert _dump(tree) == _dump(ref_agg.merge_snapshots(snaps)), trial


def test_merge_fixtures_nonassociative_floats():
    """0.1 + 0.2 + 0.3 groups differently in fp; the exact-rational partial
    makes both groupings identical; None and non-finite values are
    absorbed without poisoning the sums."""
    snaps = []
    for r, v in enumerate([0.1, 0.2, 0.3, float("nan"), float("inf")]):
        s = _snap(r)
        s["counters"] = {"horovod_t_total": v}
        s["gauges"] = {}
        s["histograms"] = {}
        snaps.append(s)
    snaps.append(None)
    flat = agg.merge_snapshots(snaps)
    left = agg.combine_partials(
        agg.combine_partials(agg.lift_snapshot(0, snaps[0]),
                             agg.lift_snapshot(1, snaps[1])),
        agg.merge_partials([agg.lift_snapshot(r, snaps[r]) for r in range(2, 6)]))
    assert _dump(agg.finalize_partial(left)) == _dump(flat) == \
        _dump(ref_agg.merge_snapshots(snaps))
    assert flat["counters"]["horovod_t_total"] == pytest.approx(0.6)
    assert flat["ranks_reporting"] == 5


def test_partial_survives_json_wire():
    part = agg.merge_partials([agg.lift_snapshot(r, _snap(r)) for r in range(4)])
    wired = json.loads(json.dumps(part))
    more = agg.lift_snapshot(7, _snap(7))
    assert _dump(agg.finalize_partial(agg.combine_partials(wired, more))) == \
        _dump(agg.finalize_partial(agg.combine_partials(part, more))) == \
        _dump(ref_agg.finalize_partial(ref_agg.combine_partials(wired, more)))


def test_snapshot_delta_roundtrip_and_size():
    prev, cur = _snap(3, tick=1), _snap(3, tick=2)
    cur["counters"]["horovod_new_total"] = 1.0
    del cur["gauges"]["horovod_q_depth"]
    d = agg.snapshot_delta(prev, cur)
    assert d == ref_agg.snapshot_delta(prev, cur)
    assert agg.apply_snapshot_delta(prev, d) == cur
    tiny = dict(prev, time_unix_s=prev["time_unix_s"] + 1)
    assert len(json.dumps(agg.snapshot_delta(prev, tiny))) < len(json.dumps(prev)) / 4
    pa = agg.merge_partials([agg.lift_snapshot(r, _snap(r, 1)) for r in range(3)])
    pb = agg.merge_partials([agg.lift_snapshot(r, _snap(r, 2)) for r in range(3)])
    assert agg.apply_snapshot_delta(pa, agg.snapshot_delta(pa, pb)) == pb


def test_compose_offsets_accuracy_under_jitter():
    """Two simulated hops with asymmetric jitter: the composed (offset,
    error) brackets the true end-to-end offset within the summed bounds;
    the composition is the JAX package's on the same hops."""
    rng = random.Random(7)
    true_ab, true_bc = 5_000_000, -2_000_000

    def probe(true_off):
        def one():
            there = rng.randrange(10_000, 300_000)
            back = rng.randrange(10_000, 300_000)
            t = time.monotonic_ns() + true_off + there
            time.sleep((there + back) / 1e9)
            return t
        return one

    hop_ab = clock.estimate_offset_ns(probe(true_ab), rounds=8)
    hop_bc = clock.estimate_offset_ns(probe(true_bc), rounds=8)
    off, err = clock.compose_offsets(hop_ab, hop_bc)
    assert (off, err) == ref_clock.compose_offsets(hop_ab, hop_bc)
    assert err >= hop_ab[1] and err >= hop_bc[1]
    assert abs(off - (true_ab + true_bc)) <= err + 2_000_000
    assert clock.compose_offsets((3, 1), (-5, 2)) == (-2, 3)


# -- the root ------------------------------------------------------------------


def _fuzz_stream(seed: int) -> list:
    """Leader pushes of three hosts over several ticks: full first, deltas
    after, a sequence gap now and then (answered need_full), a resend."""
    rng = random.Random(seed)
    hosts = {"hA": (0, 1), "hB": (2,), "hC": (3, 4, 5)}
    acked, seq, out = {}, {}, []
    for tick in range(1, 7):
        for host, ranks in hosts.items():
            part = agg.merge_partials([agg.lift_snapshot(
                r, _snap(r, tick, rng)) for r in ranks])
            if host not in acked:
                req = {"host": host, "seq": 0, "full": True, "body": part}
                seq[host] = 0
            elif rng.random() < 0.2:
                req = {"host": host, "seq": seq[host] + 5, "full": False,
                       "body": agg.snapshot_delta(acked[host], part)}
                out.append((req, tick))
                req = {"host": host, "seq": seq[host] + 1, "full": True,
                       "body": part}
                seq[host] += 1
            else:
                req = {"host": host, "seq": seq[host] + 1, "full": False,
                       "body": agg.snapshot_delta(acked[host], part)}
                seq[host] += 1
            req.update(interval_s=0.5, expected=list(ranks),
                       events=[{"kind": "stall", "tick": tick}])
            acked[host] = part
            out.append((req, tick))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_root_aggregator_matches_on_fuzzed_deltas(seed):
    roots = []
    for mod, reg in ((proot, MetricsRegistry()), (ref_root, RefRegistry())):
        clk = [100.0]
        root = mod.RootAggregator(interval_s=1.0, reg=reg, now=lambda c=clk: c[0])
        answers = []
        for req, tick in _fuzz_stream(seed):
            clk[0] = 100.0 + tick
            answers.append(root.ingest(dict(req)))
        clk[0] += 1.25
        roots.append((root, answers, clk))
    (p, p_ans, _), (j, j_ans, _) = roots
    assert p_ans == j_ans and any(a["need_full"] for a in p_ans)
    assert _dump(p.partials()) == _dump(j.partials())
    assert p.covered_ranks() == j.covered_ranks() == set(range(6))
    assert p.ages_ticks() == j.ages_ticks() and p.staleness() == j.staleness()
    assert p.drain_events() == j.drain_events()
    assert _dump(agg.finalize_partial(agg.merge_partials(p.partials()))) == \
        _dump(ref_agg.finalize_partial(ref_agg.merge_partials(j.partials())))
    p.keep_only(["hA", "hC"])
    j.keep_only(["hA", "hC"])
    assert p.hosts() == j.hosts() == ["hA", "hC"]


def test_root_aggregator_delta_resync_and_coverage():
    reg = MetricsRegistry()
    clk = [100.0]
    root = proot.RootAggregator(interval_s=1.0, reg=reg, now=lambda: clk[0])
    pa1 = agg.merge_partials([agg.lift_snapshot(r, _snap(r, 1)) for r in (0, 1)])
    pa2 = agg.merge_partials([agg.lift_snapshot(r, _snap(r, 2)) for r in (0, 1)])
    assert root.ingest({"host": "hA", "seq": 0, "full": True, "body": pa1,
                        "interval_s": 1.0}) == {"ok": True, "need_full": False}
    assert root.ingest({"host": "hA", "seq": 1, "full": False,
                        "body": agg.snapshot_delta(pa1, pa2),
                        "interval_s": 1.0}) == {"ok": True, "need_full": False}
    assert root.partials() == [pa2]
    assert root.ingest({"host": "hA", "seq": 5, "full": False,
                        "body": {}})["need_full"] is True
    assert root.covered_ranks() == {0, 1}
    clk[0] += 2.5
    assert root.ages_ticks()["hA"] == pytest.approx(2.5)
    assert reg.counter("horovod_telemetry_pushes_total", hop="host").value == 2
    root.forget_host("hA")
    assert root.hosts() == [] and root.covered_ranks() == set()


# -- the agent -----------------------------------------------------------------


@pytest.mark.parametrize("client", ["port", "jax"])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_agent_push_delta_and_need_full_resync(client, server):
    """Each package's client against each package's agent: the requests
    sent, the agent's answers, its host view and its coverage are the same
    whichever package is on either end."""
    agent_mod, reg_cls = PKGS[server][0], PKGS[server][3]
    reg = reg_cls()
    ag = agent_mod.TelemetryAgent(KEY, host_name="hA", flight_dir="", trace_dir="",
                                  interval_s=0.5, reg=reg)
    try:
        rc = PKGS[client][0].RankTelemetryClient([(LOOP, ag.port)], KEY, rank=4)
        assert rc.interval_s == 0.5
        req1 = rc.push(_snap(4, 1))
        req2 = rc.push(_snap(4, 2))
        assert req1["full"] is True and req2["full"] is False
        assert req1["body"] == _snap(4, 1)
        assert req2["body"] == ref_agg.snapshot_delta(_snap(4, 1), _snap(4, 2))
        assert _dump(ag.host_view()) == _dump(
            ref_agg.merge_snapshots([None] * 4 + [_snap(4, 2)])).replace(
                '"ranks": 5', '"ranks": 1')
        with ag._state_lock:
            ag._ranks.clear()
        req3 = rc.push(_snap(4, 3))
        assert req3["full"] is True       # the resend after need_full
        assert ag.coverage()["ranks"]["4"]["seq"] == 2
        assert ag.expected_ranks() == [4]
        assert reg.counter("horovod_telemetry_pushes_total",
                           hop="rank").value == 3
        rc.close()
    finally:
        ag.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_agent_events_batched_and_counted(pkg):
    mod, _, _, reg_cls = PKGS[pkg]
    reg = reg_cls()
    ag = mod.TelemetryAgent(KEY, host_name="hB", flight_dir="", trace_dir="",
                            interval_s=1.0, reg=reg)
    try:
        rc = tele.RankTelemetryClient([(LOOP, ag.port)], KEY, rank=0)
        rc.push_events([{"kind": "stall", "rank": 0},
                        {"kind": "anomaly", "anomaly": "ttft_slo"},
                        {"kind": "custom"}])
        rc.event_sink({"kind": "stall", "rank": 0})   # never raises
        evs = ag.drain_events()
        assert len(evs) == 4 and all(e["_rank"] == 0 for e in evs)
        assert ag.drain_events() == []
        counts = {src: reg.counter("horovod_telemetry_events_total",
                                   source=src).value
                  for src in ("watchdog", "anomaly", "other")}
        assert counts == {"watchdog": 2, "anomaly": 1, "other": 1}
        rc.close()
    finally:
        ag.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_driver_tree_pod_metrics_bitwise_and_mixed(pkg):
    """Ranks -> two agents -> the driver's ``host_metrics``, plus a
    tree-less rank pushing direct and a covered rank also pushing direct:
    ``pod_metrics`` is bitwise the flat merge of all snapshots, for the
    port's driver and agents as for the JAX package's, and the two pod
    views are equal."""
    mod, net, service, reg_cls = PKGS[pkg]
    world = 5
    snaps = {r: _snap(r, tick=2) for r in range(world)}
    driver = service.DriverService(world, KEY)
    agents, rcs = [], []
    try:
        for h, ranks in enumerate([(0, 1), (2, 3)]):
            ag = mod.TelemetryAgent(KEY, host_name=f"h{h}", flight_dir="",
                                    trace_dir="", interval_s=1.0,
                                    expected_ranks=ranks, reg=reg_cls())
            ag.attach_root([(LOOP, driver.port)], probe_rounds=2,
                           start_loop=False)
            agents.append(ag)
            for r in ranks:
                rc = mod.RankTelemetryClient([(LOOP, ag.port)], KEY, r)
                rc.push(snaps[r])
                rcs.append(rc)
            ag.push_to_root_once()
        c = net.BasicClient([(LOOP, driver.port)], KEY, timeout=10.0)
        c.request({"kind": "metrics", "rank": 4, "snapshot": snaps[4]})
        c.request({"kind": "metrics", "rank": 0, "snapshot": snaps[0]})
        c.close()
        pod = driver.pod_metrics()
        flat = ref_agg.merge_snapshots([snaps[r] for r in range(world)])
        assert _dump(pod) == _dump(flat)
        assert pod["ranks"] == world and pod["ranks_reporting"] == world
        snaps2 = {r: _snap(r, tick=3) for r in range(world)}
        for rc in rcs:
            rc.push(snaps2[rc.rank])
        for ag in agents:
            resp = ag.push_to_root_once()
            assert resp == {"ok": True, "need_full": False}
            assert ag._root_seq == 2
        st = driver.telemetry_root().staleness()
        assert sorted(st) == ["h0", "h1"] and st["h0"]["expected"] == [0, 1]
        assert st["h0"]["pushes"] == 2
    finally:
        for rc in rcs:
            rc.close()
        for ag in agents:
            ag.stop()
        driver.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_elastic_membership_prunes_telemetry_hosts(pkg):
    service = PKGS[pkg][2]
    drv = service.ElasticDriverService(KEY)
    try:
        root = drv.telemetry_root()
        for host in ("hGone", "hStays"):
            root.ingest({"host": host, "seq": 0, "full": True,
                         "body": agg.lift_snapshot(0, _snap(0)),
                         "interval_s": 1.0})
        root.publish()
        drv.begin_reset({0, 1})
        for i in (0, 1):
            drv.handle({"kind": "register", "index": i, "host_hash": "hStays",
                        "addresses": [(LOOP, 1)], "coord_port": 1,
                        "jax_coord_port": 2}, None)
        assert drv.generation == 1
        assert root.hosts() == ["hStays"]
        gauges = root.reg.snapshot()["gauges"]
        assert 'horovod_telemetry_snapshot_age_ticks{host="hGone"}' not in gauges
        assert 'horovod_telemetry_snapshot_age_ticks{host="hStays"}' in gauges
    finally:
        drv.stop()


def test_telemetry_lag_fires_names_host_and_clears():
    reg = MetricsRegistry()
    clk = [50.0]
    root = proot.RootAggregator(interval_s=0.5, reg=reg, now=lambda: clk[0])

    class _NullFlight:
        def event(self, *a, **k):
            pass

        def dump(self, *a, **k):
            return ""

    det = AnomalyDetector(reg=reg, cooldown_s=1e9, flight=_NullFlight())
    root.ingest({"host": "hFresh", "seq": 0, "full": True,
                 "body": agg.lift_snapshot(0, _snap(0)), "interval_s": 0.5})
    root.ingest({"host": "hDead", "seq": 0, "full": True,
                 "body": agg.lift_snapshot(1, _snap(1)), "interval_s": 0.5})
    root.publish()
    assert det.tick() == []
    clk[0] += (TELEMETRY_LAG_TICKS + 1) * 0.5
    root.ingest({"host": "hFresh", "seq": 1, "full": False,
                 "body": agg.snapshot_delta(agg.lift_snapshot(0, _snap(0)),
                                            agg.lift_snapshot(0, _snap(0, 2))),
                 "interval_s": 0.5})
    assert "telemetry_lag" in det.tick()
    ev = det.history[-1]
    assert ev["hosts"] == ["hDead"] and ev["threshold_ticks"] == TELEMETRY_LAG_TICKS
    assert reg.counter("horovod_anomaly_total", kind="telemetry_lag").value == 1
    root.forget_host("hDead")
    det2 = AnomalyDetector(reg=reg, cooldown_s=1e9, flight=_NullFlight())
    root.publish()
    assert "telemetry_lag" not in det2.tick()
    assert 'horovod_telemetry_snapshot_age_ticks{host="hDead"}' \
        not in reg.snapshot()["gauges"]


# -- the leader's host view over HTTP ---------------------------------------------


def test_metrics_http_host_view():
    from horovod_tpu_torch.metrics.exposition import MetricsServer

    reg = MetricsRegistry()
    reg.counter("horovod_local_total").inc(2)
    view = {"box": None}
    srv = MetricsServer(0, reg=reg, host_view=lambda: view["box"])
    plain = MetricsServer(0, reg=reg)
    try:
        url = f"http://{LOOP}:{srv.port}/metrics.json"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "?host=1")
        assert ei.value.code == 503
        view["box"] = agg.finalize_partial(
            agg.merge_partials([agg.lift_snapshot(r, _snap(r)) for r in range(3)]))
        doc = json.loads(urllib.request.urlopen(url + "?host=1").read())
        assert doc == json.loads(json.dumps(view["box"]))
        assert doc["ranks_reporting"] == 3
        doc2 = json.loads(urllib.request.urlopen(url).read())
        assert doc2["schema"] == "horovod_tpu.metrics.v1"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{LOOP}:{plain.port}/metrics.json?host=1")
        assert ei.value.code == 404
    finally:
        srv.stop()
        plain.stop()


# -- the bundle's sweep -----------------------------------------------------------


def _swept_pod(tmp_path, flight_mod):
    fdir = tmp_path / "flight"
    tdir = tmp_path / "trace"
    fdir.mkdir()
    tdir.mkdir()
    fr = flight_mod.FlightRecorder("rank0", flight_dir=str(fdir))
    fr.event("replica_death", replica=9, pid=1, state_was="up", reason="test")
    fr.close()
    (fdir / "flight-rank1.ring").write_bytes(b"HVDFLT1\ngarbage")
    (tdir / "spans-rank0.jsonl").write_text(
        json.dumps({"meta": 1, "rank": 0, "clock_offset_ns": 0}) + "\n" +
        json.dumps({"tid": "t#1", "rank": 0, "name": "g", "op": "ar",
                    "phase": "enqueue", "t0": 10, "t1": 20}) + "\n")
    return str(fdir), str(tdir)


def test_bundle_leader_sweep_names_gaps(tmp_path):
    """The port's ``--leader`` sweep through the port's agent against the
    JAX package's through its own, on the same flight ring, torn ring and
    span file: the same summary, the same MANIFEST (its first line and the
    collection time aside), the same merged trace."""
    from horovod_tpu_torch.tracing import flight

    fdir, tdir = _swept_pod(tmp_path, flight)
    out = {}
    for pkg, make in (("port", bundle.make_bundle), ("jax", ref_bundle.make_bundle)):
        mod, _, _, reg_cls = PKGS[pkg]
        ag = mod.TelemetryAgent(KEY, host_name="hSwept", flight_dir=fdir,
                                trace_dir=tdir, interval_s=100.0,
                                expected_ranks=(0, 1), reg=reg_cls())
        rc = mod.RankTelemetryClient([(LOOP, ag.port)], KEY, 0)
        rc.push(_snap(0))
        try:
            dst = tmp_path / f"bundle-{pkg}"
            summary = make(str(dst), leaders=[f"{LOOP}:{ag.port}", f"{LOOP}:1"],
                           leader_key=KEY)
        finally:
            rc.close()
            ag.stop()
        summary.pop("bundle")
        with open(dst / "MANIFEST.md") as f:
            manifest = [ln for ln in f.read().splitlines()[1:]
                        if not ln.startswith("Collected")]
        with open(dst / "trace.json") as f:
            out[pkg] = (summary, manifest, json.load(f))
    summary, manifest, trace = out["port"]
    text = "\n".join(manifest)
    assert "## Pod coverage" in text
    assert "| hSwept | partial |" in text and "ranks [1] never pushed" in text
    assert f"| {LOOP}:1 | unreachable |" in text
    assert summary["coverage_gaps"] == ["hSwept", f"{LOOP}:1"]
    assert summary["flight_decode_failures"] == 1
    assert "flight-rank1.ring" in text and "replica 9 died" in text
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])
    assert out["port"] == out["jax"]


def test_bundle_leader_key_from_env(monkeypatch):
    monkeypatch.delenv("HOROVOD_SECRET", raising=False)
    monkeypatch.delenv("HOROVOD_AGENT_SECRET", raising=False)
    with pytest.raises(SystemExit, match="telemetry secret"):
        bundle._leader_key(None)
    monkeypatch.setenv("HOROVOD_SECRET", KEY.hex())
    assert bundle._leader_key(None) == KEY == ref_bundle._leader_key(None)
    assert bundle._leader_key("ab") == b"\xab"


# -- event plumbing and wire accounting ---------------------------------------------


def test_watchdog_event_sink_receives_stall():
    from horovod_tpu_torch.metrics.watchdog import StallInfo, StallWatchdog

    got = []
    wd = StallWatchdog(check_time_s=0.05, rank=3, reg=MetricsRegistry(),
                       event_sink=got.append)
    try:
        wd.add_source(lambda: [StallInfo(name="grad0", op="allreduce", age_s=1.0)])
        deadline = time.monotonic() + 5.0
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert got, "stall never reached the event sink"
        ev = got[0]
        assert ev["kind"] == "stall" and ev["rank"] == 3
        assert ev["stalled"] == [{"name": "grad0", "op": "allreduce", "age_s": 1.0}]
    finally:
        wd.stop()


def test_watchdog_events_reach_the_leader():
    """The watchdog's ``event_sink`` wired to a rank's client: the stall
    lands at the host leader as a ``watchdog`` event."""
    from horovod_tpu_torch.metrics.watchdog import StallInfo, StallWatchdog

    reg = MetricsRegistry()
    ag = tele.TelemetryAgent(KEY, host_name="hW", flight_dir="", trace_dir="",
                             interval_s=1.0, reg=reg)
    rc = tele.RankTelemetryClient([(LOOP, ag.port)], KEY, rank=2)
    wd = StallWatchdog(check_time_s=0.05, rank=2, reg=MetricsRegistry(),
                       event_sink=rc.event_sink)
    try:
        wd.add_source(lambda: [StallInfo(name="grad1", op="allreduce", age_s=1.0)])
        deadline = time.monotonic() + 5.0
        evs = []
        while not evs and time.monotonic() < deadline:
            time.sleep(0.02)
            evs = ag.drain_events()
        assert evs and evs[0]["kind"] == "stall" and evs[0]["_rank"] == 2
        assert reg.counter("horovod_telemetry_events_total",
                           source="watchdog").value >= 1
    finally:
        wd.stop()
        rc.close()
        ag.stop()


def _settled(svc, n):
    deadline = time.monotonic() + 5.0
    while svc.stats()["requests_total"] < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return svc.stats()


def test_service_stats_count_wire_bytes():
    """The same requests cost the same wire bytes on the port's service as
    on the JAX package's, and ``request_counted`` reads each exchange's
    bytes off the client's channel."""
    stats, counted = {}, {}
    for pkg in ("port", "jax"):
        net = PKGS[pkg][1]

        class Echo(net.BasicService):
            def handle(self, req, client_addr):
                return {"ok": True, "echo": req.get("x")}

        svc = Echo(KEY)
        try:
            c = net.BasicClient([(LOOP, svc.port)], KEY, timeout=10.0)
            for i in range(3):
                assert c.request({"kind": "e", "x": i})["echo"] == i
            counted[pkg] = c.request_counted({"kind": "e", "x": "z" * 100})
            c.close()
            stats[pkg] = _settled(svc, 4)
        finally:
            svc.stop()
    st = stats["port"]
    assert st["connections_total"] == 1 and st["requests_total"] == 4
    assert st["bytes_in"] > 4 * 40 and st["bytes_out"] > 4 * 40
    assert stats["port"] == stats["jax"]
    assert counted["port"] == counted["jax"]
    resp, out_b, in_b = counted["port"]
    assert resp["echo"] == "z" * 100 and out_b > 140 and in_b > 40
