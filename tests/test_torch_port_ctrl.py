"""The port's control tree (``horovod_tpu_torch.ctrl``) against the JAX
package's (``horovod_tpu.ctrl``), on the same inputs: the ``use_tree``
gate and its warnings word for word, and the poll and batch knobs, over a
table of host counts, worlds and env values; the upstream requests a
``ControlAgent`` sends for the same local traffic (kinds, the decoded
``entries_z`` batch, the grouped waits, the cached polls), each package's
agent in front of its own package's driver; the straggler, removal,
pass-through and no-root cases; the ``HostAgent``'s ``ctrl`` and
``telemetry`` hosting (idempotent, the first instance kept when starts
race, stopped with the job, ``HOROVOD_CTRL_ADDRS`` injected into workers
only when the leader has a root, the engine relay started on request);
and, end to end over
gloo, ``run(fn, hosts=...)`` across fake hosts ``a:2,b:2`` with the tree
on equal to the flat run, and ``run_elastic`` across the same fake hosts
with a killed worker whose respawn rendezvouses through its host's leader.
(Two slots on each host: ``init`` refuses a world whose size is not a
multiple of its host's slots, in both packages, ``common/topology.py``
``validate``.)
Tolerance: none — every comparison is exact."""

from __future__ import annotations

import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import zlib

import pytest

from horovod_tpu.ctrl import agent as ref_agent
from horovod_tpu.ctrl import tree as ref_tree
from horovod_tpu.runner import network as jnet
from horovod_tpu.runner import service as jservice
from horovod_tpu_torch.ctrl import agent as pagent
from horovod_tpu_torch.ctrl import tree as ptree
from horovod_tpu_torch.runner import network as pnet
from horovod_tpu_torch.runner import service as pservice
from launch_util import REPO

KEY = b"ctrl-test-secret"
LOOP = "127.0.0.1"
PKGS = {"port": (pagent, pnet, pservice), "jax": (ref_agent, jnet, jservice)}


# -- the gate and the knobs ------------------------------------------------------

GATES = [(h, w) for h in (0, 1, 2, 3) for w in (1, 2, 3, 8)]


@pytest.mark.parametrize("env", [None, "", "1", "0", "false", "yes"])
def test_use_tree_gate_matches(env, monkeypatch):
    """``use_tree`` over every (hosts, world) of the table: the port's
    verdict and its warnings are the JAX package's, word for word."""
    if env is None:
        monkeypatch.delenv("HOROVOD_CTRL_TREE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_CTRL_TREE", env)
    said = {"port": [], "jax": []}
    monkeypatch.setattr(ptree, "log", lambda *a: said["port"].append(a))
    monkeypatch.setattr(ref_tree, "log", lambda *a: said["jax"].append(a))
    got = [ptree.use_tree(h, w) for h, w in GATES]
    want = [ref_tree.use_tree(h, w) for h, w in GATES]
    assert got == want
    assert said["port"] == said["jax"]
    assert ptree.tree_enabled() == ref_tree.tree_enabled() == (env not in ("0", "false"))
    on = {(h, w) for (h, w), g in zip(GATES, got) if g}
    assert on == ({(h, w) for h, w in GATES if h > 1 and w > 2}
                  if ptree.tree_enabled() else set())


def test_use_tree_gates(monkeypatch):
    monkeypatch.delenv("HOROVOD_CTRL_TREE", raising=False)
    assert ptree.use_tree(2, 8) is True     # on by default, as in JAX
    assert ptree.use_tree(1, 8) is False    # single host: nothing to fan through
    assert ptree.use_tree(2, 2) is False    # degenerate grouping
    monkeypatch.setenv("HOROVOD_CTRL_TREE", "0")
    assert ptree.use_tree(2, 8) is False    # knobbed off


@pytest.mark.parametrize("raw", [None, "", "0.2", "0", "-3", "bogus", "0.0005"])
def test_poll_and_batch_knobs_match(raw, monkeypatch):
    for k in ("HOROVOD_CTRL_POLL_S", "HOROVOD_CTRL_BATCH_S"):
        if raw is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, raw)
    assert ptree.ctrl_poll_s() == ref_tree.ctrl_poll_s()
    assert ptree.ctrl_batch_s() == ref_tree.ctrl_batch_s()


def test_tree_reexports_the_telemetry_plan():
    from horovod_tpu_torch import ctrl
    from horovod_tpu_torch.telemetry import tree as ttree

    assert ctrl.plan_tree is ttree.plan_tree and ctrl.TreePlan is ttree.TreePlan


# -- what a leader sends upstream --------------------------------------------------


_DEPTH = threading.local()


def _recording(cls):
    """``cls`` (a driver service) recording every top-level request it
    handles as (kind, request); the per-rank requests a ``host_*`` request
    loops through are not recorded again."""

    class Recording(cls):
        def __init__(self, *a, **k):
            self.seen = []
            super().__init__(*a, **k)

        def handle(self, req, client_addr):
            depth = getattr(_DEPTH, "n", 0)
            if depth == 0:
                self.seen.append((req.get("kind"), dict(req), client_addr))
            _DEPTH.n = depth + 1
            try:
                return super().handle(req, client_addr)
            finally:
                _DEPTH.n = depth

    return Recording


def _decoded(seen) -> list:
    """The upstream requests with ``entries_z`` batches inflated and
    entries in index order; assignment polls with their indices."""
    out = []
    for kind, req, _ in seen:
        req = dict(req)
        if req.get("entries_z") is not None:
            req["entries"] = pickle.loads(zlib.decompress(req.pop("entries_z")))
        if "entries" in req:
            req["entries"] = sorted(req["entries"], key=lambda e: e["index"])
        req.pop("timeout", None)
        out.append(req)
    return out


def _register_and_wait(port, index, results, errors, min_gen=None, delay=0.0):
    try:
        time.sleep(delay)
        c = pnet.BasicClient([(LOOP, port)], KEY, timeout=60.0)
        try:
            c.request({"kind": "register", "index": index, "host_hash": "hostA",
                       "addresses": [(LOOP, 40000 + index)],
                       "coord_port": 40000 + index})
            req = {"kind": "wait_assignment", "index": index, "timeout": 30.0}
            if min_gen is not None:
                req["min_generation"] = min_gen
            results[index] = c.request(req)
        finally:
            c.close()
    except Exception as e:  # noqa: BLE001 - surfaced by the caller's assert
        errors.append(e)


def _one_host_of_four(pkg):
    agent_mod, _, service = PKGS[pkg]
    driver = _recording(service.DriverService)(4, KEY, fn=None)
    ca = agent_mod.ControlAgent(KEY, batch_s=1.0, reg=_registry(pkg))
    ca.attach_root(driver.addresses())
    results, errors = {}, []
    try:
        threads = [threading.Thread(target=_register_and_wait,
                                    args=(ca.port, i, results, errors))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        return results, _decoded(driver.seen), ca.upstream_requests(), \
            ca.reg.snapshot()["counters"]
    finally:
        ca.stop()
        driver.stop()


def _registry(pkg):
    if pkg == "port":
        from horovod_tpu_torch.metrics.registry import MetricsRegistry
    else:
        from horovod_tpu.metrics.registry import MetricsRegistry
    return MetricsRegistry()


def test_control_agent_batches_registrations():
    """Four ranks of one host register and wait through the leader: the
    flat path's ranks, in two upstream requests (one ``host_register``
    with the four registrations, one grouped ``host_wait_assignment``),
    and the same requests as the JAX package's leader sends."""
    out = {pkg: _one_host_of_four(pkg) for pkg in PKGS}
    results, upstream, n_up, counters = out["port"]
    assert sorted(r["rank"] for r in results.values()) == [0, 1, 2, 3]
    assert all(r["topology"]["size"] == 4 for r in results.values())
    assert [u["kind"] for u in upstream] == ["host_register", "host_wait_assignment"]
    assert [e["index"] for e in upstream[0]["entries"]] == [0, 1, 2, 3]
    assert upstream[1]["indices"] == [0, 1, 2, 3] and n_up == 2
    assert upstream == out["jax"][1] and n_up == out["jax"][2]
    assert results == {i: {k: v for k, v in a.items() if k != "jax_coord_addr"}
                       for i, a in out["jax"][0].items()}
    for key in ('horovod_ctrl_bytes_total{dir="absorbed"}',
                'horovod_ctrl_bytes_total{dir="up_out"}',
                'horovod_ctrl_bytes_total{dir="up_in"}'):
        assert counters[key] > 0
    assert counters['horovod_ctrl_bytes_total{dir="up_out"}'] == \
        out["jax"][3]['horovod_ctrl_bytes_total{dir="up_out"}']


def test_pack_register_matches():
    """The batch of a host's registrations: ``entries_z`` when deflating
    wins, the same bytes as the JAX package's; plain ``entries`` when not."""
    entries = [{"kind": "register", "index": i, "host_hash": "h" * 20,
                "addresses": [("10.0.0.1", 4000 + i)], "coord_port": 5000 + i}
               for i in range(8)]
    got = pagent.ControlAgent._pack_register(_Bytes(), entries)
    want = ref_agent.ControlAgent._pack_register(_Bytes(), entries)
    assert got == want and "entries_z" in got
    assert pickle.loads(zlib.decompress(got["entries_z"])) == entries
    one = [{"i": 1}]
    assert pagent.ControlAgent._pack_register(_Bytes(), one) == \
        {"kind": "host_register", "entries": one}


class _Bytes:
    """Stands in for an agent in ``_pack_register``: counts nothing."""

    def _bytes_c(self, direction):
        class _C:
            def inc(self, n=1):
                pass
        return _C()


def test_flat_bytes_matches():
    for req, resp in (({"kind": "register", "index": 3}, {"ok": True}),
                      ({"kind": "elastic_poll", "index": 0, "generation": 2}, None)):
        assert pagent._flat_bytes(req, resp) == ref_agent._flat_bytes(req, resp)


def test_control_agent_straggler_register_not_starved():
    """The grouped assignment wait rides its own upstream connection: a
    straggler's registration is never queued behind a wait that needs it."""
    driver = pservice.ElasticDriverService(KEY, fn=None)
    driver.begin_reset({0, 1})
    ca = pagent.ControlAgent(KEY, batch_s=0.01)
    ca.attach_root(driver.addresses())
    results, errors = {}, []
    try:
        t0 = time.monotonic()
        threads = [threading.Thread(target=_register_and_wait,
                                    args=(ca.port, 0, results, errors, 1, 0.0)),
                   threading.Thread(target=_register_and_wait,
                                    args=(ca.port, 1, results, errors, 1, 0.5))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        took = time.monotonic() - t0
        assert not errors, errors
        assert sorted(results) == [0, 1] and all(r["ok"] for r in results.values())
        assert took < ca.WAIT_POLL_S + 10.0, took
    finally:
        ca.stop()
        driver.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_control_agent_elastic_poll_cached(pkg):
    """Polls within HOROVOD_CTRL_POLL_S are answered from the leader's
    cache: six rank polls, one upstream ``host_elastic_poll``; the port's
    leader sends what the JAX package's sends."""
    agent_mod, _, service = PKGS[pkg]
    driver = _recording(service.ElasticDriverService)(KEY, fn=None)
    ca = agent_mod.ControlAgent(KEY, poll_s=5.0, batch_s=0.01, reg=_registry(pkg))
    ca.attach_root(driver.addresses())
    client = pnet.BasicClient([(LOOP, ca.port)], KEY, timeout=30.0)
    try:
        for index in range(6):
            resp = client.request({"kind": "elastic_poll", "index": index,
                                   "generation": 0})
            assert resp == {"ok": True, "reset_required": False}
        assert ca.upstream_requests() == 1
        assert _decoded(driver.seen) == [{"kind": "host_elastic_poll",
                                          "indices": [0], "generation": 0}]
        absorbed = ca.reg.counter("horovod_ctrl_bytes_total", dir="absorbed").value
        assert absorbed == 5 * ref_agent._flat_bytes(
            {"kind": "elastic_poll", "index": 5, "generation": 0},
            {"ok": True, "reset_required": False})
    finally:
        client.close()
        ca.stop()
        driver.stop()


def test_control_agent_poll_reports_removed_rank():
    driver = pservice.ElasticDriverService(KEY, fn=None)
    ca = pagent.ControlAgent(KEY, poll_s=5.0, batch_s=0.01)
    ca.attach_root(driver.addresses())
    client = pnet.BasicClient([(LOOP, ca.port)], KEY, timeout=30.0)
    try:
        for index in (0, 1):
            hello = client.request({"kind": "ctrl_hello", "index": index})
            assert hello["ok"] and hello["poll_s"] == 5.0
        with driver._cv:
            driver._removed.add(1)
        assert client.request({"kind": "elastic_poll", "index": 0,
                               "generation": 0})["reset_required"] is False
        assert client.request({"kind": "elastic_poll", "index": 1,
                               "generation": 0})["reset_required"] is True
        stats = client.request({"kind": "ctrl_stats"})
        assert stats["ok"] and stats["upstream_requests"] == 1
    finally:
        client.close()
        ca.stop()
        driver.stop()


@pytest.mark.parametrize("root_pkg", ["port", "jax"])
def test_control_agent_passthrough_verbatim(root_pkg):
    """Kinds the leader does not aggregate reach the root untouched, and
    the port's leader talks to a root of either package."""
    net = PKGS[root_pkg][1]

    class Echo(net.BasicService):
        def handle(self, req, client_addr):
            return {"ok": True, "echo": req}

    root = Echo(KEY)
    ca = pagent.ControlAgent(KEY)
    ca.attach_root([(LOOP, root.port)])
    client = pnet.BasicClient([(LOOP, ca.port)], KEY, timeout=30.0)
    try:
        resp = client.request({"kind": "result", "rank": 3, "value": 42})
        assert resp["echo"] == {"kind": "result", "rank": 3, "value": 42}
        assert ca.has_root()
    finally:
        client.close()
        ca.stop()
        root.stop()


def test_control_agent_without_root_errors_loudly():
    ca = pagent.ControlAgent(KEY)
    client = pnet.BasicClient([(LOOP, ca.port)], KEY, timeout=30.0)
    try:
        resp = client.request({"kind": "result", "rank": 0, "value": 1})
        assert resp["ok"] is False and "no root" in resp["error"]
        assert ca.has_root() is False
    finally:
        client.close()
        ca.stop()


def test_relay_port_names_the_engine_item():
    """``relay_port`` starts the engine coordinator relay once (the same
    port again), keyed as a worker's engine keys its frames (the text of
    HOROVOD_SECRET, the leader key's hex); a rank's hello and clock probe
    pass through it to an engine coordinator; ``stop`` ends it."""
    from horovod_tpu_torch.common.engine import (_Coordinator, _recv_msg,
                                                 _send_msg)

    key = KEY.hex().encode()
    coord = _Coordinator(1, LOOP, 0, key=key)
    coord.start()
    ca = pagent.ControlAgent(KEY)
    try:
        assert not ca.relay_running()
        port = ca.relay_port()
        assert port > 0 and ca.relay_port() == port and ca.relay_running()
        sock = socket.create_connection((LOOP, port), timeout=10)
        _send_msg(sock, {"kind": "relay_hello", "rank": 0, "local": 1,
                         "coord": [LOOP, coord.server.getsockname()[1]]},
                  key)
        assert _recv_msg(sock, key) == {"ok": 1}
        _send_msg(sock, {"kind": "clock_probe", "rank": 0}, key)
        assert _recv_msg(sock, key)["t"] > 0
        _send_msg(sock, {"kind": "bye"}, key)
        sock.close()
    finally:
        ca.stop()
        coord.stop()
    assert not ca.relay_running()


def test_worker_addresses_prefers_ctrl(monkeypatch):
    for mod in (pservice, jservice):
        monkeypatch.setenv("HOROVOD_DRIVER_ADDRS", json.dumps([["10.0.0.1", 9000]]))
        monkeypatch.delenv("HOROVOD_CTRL_ADDRS", raising=False)
        assert mod.worker_addresses() == [("10.0.0.1", 9000)]
        monkeypatch.setenv("HOROVOD_CTRL_ADDRS", json.dumps([["127.0.0.1", 7777]]))
        assert mod.worker_addresses() == [("127.0.0.1", 7777)]
        monkeypatch.delenv("HOROVOD_DRIVER_ADDRS")
        monkeypatch.delenv("HOROVOD_CTRL_ADDRS")
        assert mod.worker_addresses() == []


# -- the host agent hosts the leaders ----------------------------------------------


def test_host_agent_ctrl_cmd_idempotent():
    """``ctrl`` start is idempotent (same leader and port), keyed with the
    derived job secret; a ``relay`` request starts the leader's engine
    relay and answers its port; job kill stops the leader."""
    from horovod_tpu_torch.runner.agent import HostAgent

    agent_secret = b"agent-secret-ctrl"
    agent = HostAgent(agent_secret, host=LOOP, port=0)
    client = pnet.BasicClient([(LOOP, agent.port)], agent_secret, timeout=30.0)
    try:
        a = client.request({"kind": "ctrl", "cmd": "start", "job_id": "j1"})
        assert a["ok"] and a["port"] > 0
        b = client.request({"kind": "ctrl", "cmd": "start", "job_id": "j1"})
        assert b["port"] == a["port"]
        r = client.request({"kind": "ctrl", "cmd": "start", "job_id": "j1",
                            "relay": True})
        assert r["ok"] and r["port"] == a["port"] and r["relay_port"] > 0
        assert agent._ctrl["j1"].relay_port() == r["relay_port"]
        bad = client.request({"kind": "ctrl", "cmd": "bogus", "job_id": "j1"})
        assert not bad["ok"]
        job_secret = pnet.derive_key(agent_secret, b"hvd-job:j1")
        cc = pnet.BasicClient([(LOOP, a["port"])], job_secret, timeout=30.0)
        assert cc.request({"kind": "ctrl_hello", "index": 0})["ok"]
        cc.close()
        client.request({"kind": "kill", "job_id": "j1"})
        assert agent._ctrl == {}
    finally:
        client.close()
        agent.stop()


def test_host_agent_telemetry_cmd_idempotent(tmp_path):
    from horovod_tpu_torch.runner.agent import HostAgent
    from horovod_tpu_torch.telemetry import RankTelemetryClient

    agent_secret = b"agent-secret-tele"
    agent = HostAgent(agent_secret, host=LOOP, port=0)
    client = pnet.BasicClient([(LOOP, agent.port)], agent_secret, timeout=30.0)
    try:
        a = client.request({"kind": "telemetry", "cmd": "start", "job_id": "j2",
                            "flight_dir": str(tmp_path), "interval_s": 0.5,
                            "expected_ranks": [0, 1]})
        assert a["ok"] and a["port"] > 0
        assert client.request({"kind": "telemetry", "cmd": "start",
                               "job_id": "j2"})["port"] == a["port"]
        job_secret = pnet.derive_key(agent_secret, b"hvd-job:j2")
        rc = RankTelemetryClient([(LOOP, a["port"])], job_secret, rank=1)
        assert rc.interval_s == 0.5
        rc.close()
        assert agent._telemetry["j2"].expected_ranks() == [0, 1]
        client.request({"kind": "telemetry", "cmd": "stop", "job_id": "j2"})
        assert agent._telemetry == {}
    finally:
        client.close()
        agent.stop()


@pytest.mark.parametrize("kind", ["ctrl", "telemetry"])
def test_host_agent_racing_starts_keep_the_first(kind):
    """Eight starts of one job's leader at once: every answer names one
    leader, and only that one stays hosted."""
    from horovod_tpu_torch.runner.agent import HostAgent

    agent_secret = b"agent-secret-race"
    agent = HostAgent(agent_secret, host=LOOP, port=0)
    ports, errors = [], []

    def start():
        try:
            c = pnet.BasicClient([(LOOP, agent.port)], agent_secret, timeout=30.0)
            try:
                ports.append(c.request({"kind": kind, "cmd": "start",
                                        "job_id": "race"})["port"])
            finally:
                c.close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=start) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors and len(ports) == 8 and len(set(ports)) == 1
        hosted = agent._ctrl if kind == "ctrl" else agent._telemetry
        assert list(hosted) == ["race"] and hosted["race"].port == ports[0]
    finally:
        sys.setswitchinterval(old)
        agent.stop()


@pytest.mark.parametrize("root", [True, False])
def test_spawn_injects_ctrl_addrs_only_with_a_root(root, tmp_path):
    from horovod_tpu_torch.runner.agent import HostAgent

    agent_secret = b"agent-secret-spawn"
    agent = HostAgent(agent_secret, host=LOOP, port=0)
    driver = pservice.DriverService(1, KEY)
    client = pnet.BasicClient([(LOOP, agent.port)], agent_secret, timeout=30.0)
    out = tmp_path / "env.txt"
    try:
        req = {"kind": "ctrl", "cmd": "start", "job_id": "j3"}
        if root:
            req["root"] = [list(a) for a in driver.addresses()]
        leader = client.request(req)
        assert leader["ok"]
        code = ("import os, sys; open(sys.argv[1], 'w')"
                ".write(os.environ.get('HOROVOD_CTRL_ADDRS', '-'))")
        client.request({"kind": "spawn", "job_id": "j3", "workers": [
            {"index": 0, "argv": [sys.executable, "-c", code, str(out)],
             "env": {}}]})
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            w = client.request({"kind": "poll", "job_id": "j3"})["workers"]
            if w[0]["returncode"] is not None:
                break
            time.sleep(0.05)
        assert w[0]["returncode"] == 0
        want = json.dumps([["127.0.0.1", leader["port"]]]) if root else "-"
        assert out.read_text() == want
    finally:
        client.close()
        agent.stop()
        driver.stop()


# -- end to end over gloo, across fake hosts --------------------------------------


def _start_agent(fake_host: str, secret: bytes):
    env = dict(os.environ, HOROVOD_HOSTNAME=fake_host,
               HOROVOD_AGENT_SECRET=secret.hex())
    env.pop("HOROVOD_CTRL_TREE", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.agent", "--port", "0"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, text=True)
    info = json.loads(proc.stdout.readline())
    assert info["agent"] == "ready"
    return proc, info["port"]


@pytest.fixture
def fake_hosts():
    """Two hvd-agents standing in for hosts ``a`` and ``b``: a function of
    the slots of each that gives the hosts spec, and the agent secret."""
    secret = pnet.make_secret()
    agents = [_start_agent("fake-host-a", secret), _start_agent("fake-host-b", secret)]

    def spec(a: int, b: int) -> str:
        return f"127.0.0.1@{agents[0][1]}:{a},127.0.0.1@{agents[1][1]}:{b}"

    yield spec, secret
    for p, _ in agents:
        p.send_signal(signal.SIGTERM)
    for p, _ in agents:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()


def _recorded_driver(monkeypatch, module, name, base):
    made = []

    class Rec(_recording(base)):
        def stop(self):
            self.final_stats = self.stats()
            made.append(self)
            super().stop()

    monkeypatch.setattr(module, name, Rec)
    return made


def _make_gloo_fn():
    """The launched function: a closure, which cloudpickle ships by value."""

    def fn():
        import os as _os

        import torch as _torch

        import horovod_tpu_torch as _hvd

        _hvd.init(device="cpu")
        out = _hvd.allreduce(_torch.tensor([float(_hvd.rank() + 1)]),
                             _hvd.ReduceOp.SUM)
        got = (_hvd.rank(), _hvd.size(), _hvd.local_rank(), _hvd.local_size(),
               _hvd.cross_rank(), _hvd.cross_size(), out.item())
        _hvd.shutdown()
        return got, "HOROVOD_CTRL_ADDRS" in _os.environ

    return fn


def test_run_across_fake_hosts_tree_equals_flat(fake_hosts, monkeypatch):
    """``run(fn, hosts="a:2,b:2")`` with the tree on by default and with
    ``HOROVOD_CTRL_TREE=0``: the same ranks, topology and allreduce; with
    the tree every worker dialed its host's leader, the driver saw two
    ``host_register`` requests (one per host) and no worker directly."""
    import horovod_tpu_torch.runner as prunner

    spec, secret = fake_hosts
    runs = {}
    for tree in (True, False):
        if tree:
            monkeypatch.delenv("HOROVOD_CTRL_TREE", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_CTRL_TREE", "0")
        made = _recorded_driver(monkeypatch, prunner, "DriverService",
                                pservice.DriverService)
        results = prunner.run(_make_gloo_fn(), hosts=spec(2, 2), agent_secret=secret,
                              timeout=240)
        (driver,) = made
        runs[tree] = (results, driver.seen, driver.final_stats)
    (tree_res, tree_seen, tree_stats), (flat_res, flat_seen, flat_stats) = \
        runs[True], runs[False]
    tree_kinds = [k for k, _, _ in tree_seen]
    flat_kinds = [k for k, _, _ in flat_seen]
    assert [r for r, _ in tree_res] == [r for r, _ in flat_res]
    assert [r[:2] for r, _ in tree_res] == [(r, 4) for r in range(4)]
    assert all(r[6] == 10.0 for r, _ in tree_res)
    assert [via for _, via in tree_res] == [True] * 4
    assert [via for _, via in flat_res] == [False] * 4
    # Every registration rode a host leader's batch (how many batches
    # depends on how far apart a host's workers start), over one request
    # connection per host; the waits ride each leader's second connection.
    assert "register" not in tree_kinds and "wait_assignment" not in tree_kinds
    batches = [req for req in _decoded(tree_seen) if req["kind"] == "host_register"]
    assert sorted(e["index"] for req in batches for e in req["entries"]) == \
        [0, 1, 2, 3]
    assert len({a for k, _, a in tree_seen if k != "host_wait_assignment"}) == 2
    assert len({a for k, _, a in tree_seen if k == "host_wait_assignment"}) == 2
    assert tree_stats["connections_total"] == 4
    assert flat_kinds.count("register") == 4 and "host_register" not in flat_kinds
    assert len({a for _, _, a in flat_seen}) == flat_stats["connections_total"] == 4


def _elastic_entry(total_steps):
    """An elastic job that commits every step; returns what each rank saw,
    with the control leader it dialed."""

    def entry():
        import os as _os

        import torch as _torch

        import horovod_tpu_torch as _hvd

        _hvd.init(device="cpu")
        state = _hvd.elastic.ElasticState(step=0, acc=0.0)

        def train(state):
            while state.step < total_steps:
                out = _hvd.allreduce(_torch.ones(2, dtype=_torch.float64))
                state.acc = state.acc + float(out[0])
                state.step += 1
                state.commit()
            return (_hvd.rank(), _hvd.size(), int(state.step), float(state.acc),
                    int(_os.environ["HOROVOD_TASK_INDEX"]),
                    _os.environ.get("HOROVOD_CTRL_ADDRS"),
                    int(_os.environ.get("HOROVOD_ELASTIC_GENERATION", "0")))

        return _hvd.elastic.run(train)(state)

    return entry


def test_run_elastic_respawn_rendezvous_through_its_leader(fake_hosts, monkeypatch):
    """``run_elastic`` across fake hosts ``a:2,b:2`` with the tree on:
    worker index 1 (host ``a``) is killed at step 3, its slot respawned on
    its host (as index 4), which rendezvouses through host ``a``'s leader:
    it dials the same leader address as its host-mate, and every
    registration of both generations reached the driver inside a
    ``host_register``."""
    from horovod_tpu_torch.runner import run_elastic

    spec, secret = fake_hosts
    monkeypatch.delenv("HOROVOD_CTRL_TREE", raising=False)
    made = _recorded_driver(monkeypatch, pservice, "ElasticDriverService",
                            pservice.ElasticDriverService)
    results = run_elastic(
        _elastic_entry(8), hosts=spec(2, 2), agent_secret=secret, timeout=240,
        env={"HOROVOD_STALL_CHECK_TIME": "1", "HOROVOD_STALL_SHUTDOWN_TIME": "5",
             "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2",
             "HOROVOD_FAULT_INJECT_STEP": "3", "HOROVOD_FAULT_INJECT_INDEX": "1"})
    (driver,) = made
    assert [r[:4] for r in results] == [(r, 4, 8, 8.0) for r in range(4)]
    by_index = {r[4]: r for r in results}
    assert sorted(by_index) == [0, 2, 3, 4]   # index 1's slot respawned as 4
    assert by_index[4][6] >= 2                  # the respawn's generation
    assert by_index[4][5] == by_index[0][5] != by_index[2][5] == by_index[3][5]
    assert all(r[5] for r in results)
    kinds = [k for k, _, _ in driver.seen]
    assert "register" not in kinds and "rendezvous" not in kinds
    assert kinds.count("host_register") >= 3     # gen 1: a, b; then a again
    assert "host_elastic_poll" in kinds
