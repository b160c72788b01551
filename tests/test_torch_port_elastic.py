"""Elastic training on the port (``horovod_tpu_torch.elastic``) against the
JAX package's (``horovod_tpu.elastic``): ``ElasticState`` over tensors read
the same values as the JAX state over the same numpy values through
construction, commits, changes, restores, ``checkpoint_every`` and
``load_checkpoint``, and restores modules and optimizers in place; the
blacklist, discovery, backoff and fault-injection parsing; the elastic
driver's generations and membership; the translation of a failed backend
into ``HorovodInternalError`` and the layouts refused under
``HOROVOD_ELASTIC``; and ``run_elastic`` end to end on gloo, with the JAX
tests' expected results (tests/test_elastic.py), a 2-layer
TransformerLM through ``DistributedOptimizer`` that loses a worker, a job
of one worker resumed from its checkpoint, a job whose every worker dies,
and checkpoint writes that outlast the stall time."""

from __future__ import annotations

import os
import random
import stat
import subprocess
import sys
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu.common import resilience as jres
from horovod_tpu.elastic import discovery as jdisc
from horovod_tpu.elastic import fault as jfault
from horovod_tpu.elastic.state import ElasticState as JaxState
from horovod_tpu.runner import service as jservice
from horovod_tpu_torch.common import basics, resilience as pres
from horovod_tpu_torch.elastic import discovery as pdisc
from horovod_tpu_torch.elastic import fault as pfault
from horovod_tpu_torch.elastic.state import ElasticState as PortState
from horovod_tpu_torch.runner import network as pnet
from horovod_tpu_torch.runner import service as pservice
from launch_util import REPO

WORKER_PATH = os.pathsep.join([os.path.join(REPO, "tests"), REPO])


def _to_port(x):
    """The port's form of a JAX-side value: numpy arrays become tensors."""
    if isinstance(x, dict):
        return {k: _to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_port(v) for v in x]
    return torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_numpy(v) for v in x]
    return x.numpy() if torch.is_tensor(x) else x


def _assert_same(port, jax):
    port = _to_numpy(port)
    if not isinstance(jax, (dict, list, bool, int, float, str, type(None))) \
            and hasattr(jax, "__array__"):
        jax = np.asarray(jax)
    assert type(port) is type(jax) or isinstance(jax, np.ndarray), (port, jax)
    if isinstance(jax, dict):
        assert port.keys() == jax.keys()
        for k in jax:
            _assert_same(port[k], jax[k])
    elif isinstance(jax, list):
        assert len(port) == len(jax)
        for a, b in zip(port, jax):
            _assert_same(a, b)
    elif isinstance(jax, np.ndarray):
        assert port.dtype == jax.dtype and port.tobytes() == jax.tobytes()
    else:
        assert port == jax


# -- ElasticState against the JAX package's -------------------------------------

# Each op: ("mul"/"add", path, x) changes a leaf in place, ("set", name, v)
# rebinds a value, and "commit"/"restore"/"check" act on the state.
SCRIPTS = {
    "bitwise rollback": (
        dict(params={"w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0},
             opt_state={"mom": np.arange(12, dtype=np.float64).reshape(3, 4) * 1e-3,
                        "count": 3}, epoch=1, step=10),
        [("mul", ("params", "w"), 1.5), ("add", ("opt_state", "mom"), 0.25),
         ("set", "step", 11), "commit", "check",
         ("add", ("params", "w"), 99.0), ("mul", ("opt_state", "mom"), 0.0),
         ("setin", ("opt_state", "count"), 77), ("set", "step", 12), "restore",
         "check"]),
    "construction is the first commit": (
        dict(x=np.ones(3), step=0),
        [("set", "x", np.ones(3) + 5), ("set", "step", 4), "restore", "check"]),
    "no aliasing of the live values": (
        dict(w=np.zeros(4, dtype=np.float32)),
        ["commit", ("add", ("w",), 42.0), "restore", "check"]),
    "several commits": (
        dict(a=np.linspace(0, 1, 5, dtype=np.float32), b=[np.ones(2), 2.5], n=0),
        [("add", ("a",), 1.0), "commit", ("mul", ("a",), 3.0),
         ("set", "n", 1), "commit", ("add", ("b", 0), 4.0), ("set", "n", 2),
         "check", "restore", "check", "restore", "check"]),
}


def _leaf_op(values, path, fn):
    *head, last = path
    node = values
    for k in head:
        node = node[k]
    node[last] = fn(node[last])


def _run_script(cls, init, ops, convert):
    state = cls(**convert(init))
    seen = []
    for op in ops:
        if op == "commit":
            state.commit(check_host_updates=False)
        elif op == "restore":
            state.restore()
        elif op == "check":
            seen.append({k: v for k, v in state.to_dict().items()})
            seen[-1] = _copy(seen[-1])
        else:
            kind, where, x = op
            if kind == "set":
                setattr(state, where, convert(x))
            elif kind == "setin":
                _leaf_op(state.to_dict(), where, lambda _: x)
            else:
                def change(v, kind=kind, x=x):
                    if kind == "mul":
                        v *= x
                    else:
                        v += x
                    return v
                _leaf_op(state.to_dict(), where, change)
    return state, seen


def _copy(x):
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_copy(v) for v in x]
    if torch.is_tensor(x):
        return x.clone()
    return x.copy() if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_state_reads_as_the_jax_state(name):
    init, ops = SCRIPTS[name]
    _, want = _run_script(JaxState, init, ops, lambda v: _copy(v))
    _, got = _run_script(PortState, init, ops, _to_port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_state_unknown_attribute_raises():
    with pytest.raises(AttributeError, match="no value"):
        _ = PortState(a=1).missing


@pytest.mark.parametrize("every,commits", [(1, 1), (2, 1), (2, 3), (100, 1)])
def test_state_checkpoint_backed_commit(tmp_path, every, commits):
    """``checkpoint_dir`` commits write a checkpoint every ``every``-th
    commit; a fresh state cold-starts from it (or finds none) as the JAX
    state does from its own."""
    out = {}
    for name, cls, conv in (("jax", JaxState, lambda v: v), ("port", PortState, _to_port)):
        ckpt = str(tmp_path / name)
        state = cls(checkpoint_dir=ckpt, checkpoint_every=every,
                    params=conv({"w": np.arange(6, dtype=np.float32)}), step=0)
        for i in range(commits):
            state.params["w"] = state.params["w"] * 2.0
            state.step = 5 + i
            state.commit(check_host_updates=False)
        state.checkpoint_wait()
        cold = cls(checkpoint_dir=ckpt,
                   params=conv({"w": np.zeros(6, dtype=np.float32)}), step=0)
        loaded = cold.load_checkpoint()
        values = _copy(cold.to_dict())
        cold.step = 99
        cold.restore()
        out[name] = (loaded, values, int(cold.step))
    assert out["port"][0] == out["jax"][0]
    _assert_same(out["port"][1], {k: (v if k != "step" else int(v))
                                  for k, v in out["jax"][1].items()})
    assert out["port"][2] == out["jax"][2]


def test_state_sync_single_process():
    state = PortState(x=torch.ones(2), step=3)
    state.x = state.x + 1
    state.sync()
    assert torch.equal(state.x, torch.ones(2))


def _lm(seed=0):
    from horovod_tpu_torch.train import TrainConfig, build_model

    return build_model(TrainConfig(vocab=32, dim=16, heads=2, layers=1, seq=8,
                                   seed=seed, attention="dense"), "cpu")


def _adam_step(model, opt, seed):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, 32, (2, 8), generator=g)
    opt.zero_grad()
    model(tokens).float().logsumexp(-1).mean().backward()
    opt.step()


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR", "HOROVOD_ELASTIC"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("wrapped", [False, True], ids=["adam", "distributed"])
def test_restore_keeps_the_live_tensors(world_of_one, wrapped):
    """restore() writes the commit back into the module's parameters and
    the optimizer's state: the same tensor objects, at the same addresses,
    holding the committed values; a DistributedOptimizer's exchange is
    reset (no gradient, plan order)."""
    model = _lm()
    adam = torch.optim.Adam(model.parameters(), lr=1e-2, foreach=True)
    opt = hvd.DistributedOptimizer(adam, model.named_parameters()) if wrapped else adam
    _adam_step(model, opt, 0)
    state = PortState(model=model, opt=opt, step=1)
    want_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_state = {id(p): {k: v.clone() for k, v in adam.state[p].items()}
                  for p in model.parameters()}
    before = {n: (p, p.data_ptr()) for n, p in model.named_parameters()}
    before_state = {id(p): {k: (v, v.data_ptr()) for k, v in adam.state[p].items()}
                    for p in model.parameters()}
    for seed in (1, 2):
        _adam_step(model, opt, seed)
    adam.param_groups[0]["lr"] = 0.5
    state.step = 3
    state.restore()
    assert state.step == 1 and adam.param_groups[0]["lr"] == 1e-2
    for n, p in model.named_parameters():
        assert p is before[n][0] and p.data_ptr() == before[n][1]
        assert torch.equal(p, want_params[n]), n
    for p in model.parameters():
        for k, v in adam.state[p].items():
            assert v is before_state[id(p)][k][0]
            assert v.data_ptr() == before_state[id(p)][k][1]
            assert torch.equal(v, want_state[id(p)][k]), k
    if wrapped:
        assert all(p.grad is None for p in model.parameters())
        assert opt.launch_order == list(range(opt.plan.num_buckets))


def test_load_checkpoint_into_a_fresh_optimizer(world_of_one, tmp_path):
    """A respawned worker's cold start: a fresh model and Adam with no state
    take the checkpoint (Adam's state created by load_state_dict), and the
    next steps are bit-equal to the run that never stopped."""
    model, straight = _lm(), _lm()
    opts = [torch.optim.Adam(m.parameters(), lr=1e-2, foreach=True)
            for m in (model, straight)]
    for seed in range(2):
        for m, o in zip((model, straight), opts):
            _adam_step(m, o, seed)
    state = PortState(checkpoint_dir=str(tmp_path), model=model, opt=opts[0],
                      step=2)
    state.commit(check_host_updates=False)
    state.checkpoint_wait()
    fresh = _lm(seed=7)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2, foreach=True)
    cold = PortState(checkpoint_dir=str(tmp_path), model=fresh, opt=fresh_opt,
                     step=0)
    assert cold.load_checkpoint() and cold.step == 2
    for seed in (2, 3):
        _adam_step(fresh, fresh_opt, seed)
        _adam_step(straight, opts[1], seed)
    for (n, a), b in zip(fresh.named_parameters(), straight.parameters()):
        assert torch.equal(a, b), n


# -- the pure parts against the JAX package's -------------------------------------


@pytest.mark.parametrize("ops", [
    [("record", "a"), ("record", "a"), ("record", "a"), ("ban", "b"), ("ban", "b")],
    [("ban", "x"), ("record", "x"), ("record", "y")],
    [("record", "h:0"), ("record", "h"), ("record", "h:0"), ("record", "h")],
])
@pytest.mark.parametrize("threshold", [None, 1, 2, 3])
def test_blacklist_equal(ops, threshold, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_BLACKLIST_THRESHOLD", "3")
    out = []
    for mod in (pdisc, jdisc):
        b = mod.Blacklist(threshold=threshold)
        trace = [b.threshold]
        for op, key in ops:
            trace.append(b.record_failure(key) if op == "record" else b.ban(key))
            trace.append((b.is_blacklisted(key), b.failures(key), b.blacklisted()))
        trace.append(b.filter([("a", 2), ("b", 1), ("h", 1), ("x", 3)]))
        out.append(trace)
    assert out[0] == out[1]


@pytest.mark.parametrize("text", [
    "a:2\n\n# comment\nb\nbad:x\n", "", "host1:4\nhost2:4", "  spaced : 3 \n",
    "#only\n# comments", "h:0\nh:-1\nx:", "a:1:2\nb:",
])
def test_parse_discovery_output_equal(text):
    assert pdisc.parse_discovery_output(text) == jdisc.parse_discovery_output(text)
    hosts = pdisc.parse_discovery_output(text)
    assert pdisc.StaticDiscovery(hosts).probe() == jdisc.StaticDiscovery(hosts).probe()


def test_discovery_script(tmp_path):
    """The port's ScriptDiscovery: failures return the last good answer."""
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\ncat " + str(tmp_path / "hosts.txt") + "\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "hosts.txt").write_text("node1:2\nnode2:2\n")
    d = pdisc.ScriptDiscovery(str(script))
    assert d.probe() == [("node1", 2), ("node2", 2)]
    os.remove(tmp_path / "hosts.txt")
    assert d.probe() == [("node1", 2), ("node2", 2)]


@pytest.mark.parametrize("base,cap", [(0.05, 0.4), (0.001, 2.0), (0.2, 0.2)])
def test_backoff_equal(base, cap):
    """The same random draws give the same delays from both packages, each
    within [base, cap]."""
    seqs = []
    for mod in (pres, jres):
        rng = random.Random(1234)
        b = mod.Backoff(base_s=base, cap_s=cap, rng=rng)
        delays = [b.next() for _ in range(12)]
        b.reset()
        delays.append(b.next())
        seqs.append(delays)
    assert seqs[0] == seqs[1]
    assert all(max(base, 0.001) <= d <= cap for d in seqs[0])


@pytest.mark.parametrize("env", [
    {}, {"HOROVOD_FAULT_INJECT_STEP": "5"},
    {"HOROVOD_FAULT_INJECT_STEP": "5", "HOROVOD_FAULT_INJECT_INDEX": "3",
     "HOROVOD_TASK_INDEX": "3"},
    {"HOROVOD_FAULT_INJECT_STEP": "5", "HOROVOD_FAULT_INJECT_INDEX": "3",
     "HOROVOD_TASK_INDEX": "0"},
    {"HOROVOD_FAULT_INJECT_STEP": "", "HOROVOD_FAULT_INJECT_INDEX": "0",
     "HOROVOD_TASK_INDEX": "0"},
    {"HOROVOD_FAULT_NET": "delay", "HOROVOD_FAULT_NET_RANK": "1", "HOROVOD_RANK": "1"},
    {"HOROVOD_FAULT_NET": "bogus"},
])
def test_fault_env_parsing_equal(env, monkeypatch):
    for k in ("HOROVOD_FAULT_INJECT_STEP", "HOROVOD_FAULT_INJECT_INDEX",
              "HOROVOD_TASK_INDEX", "HOROVOD_FAULT_NET", "HOROVOD_FAULT_NET_RANK",
              "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pfault.armed() == jfault.armed()
    assert pfault.net_fault_armed() == jfault.net_fault_armed()
    assert pfault.net_fault_delay_s(1 << 20) == jfault.net_fault_delay_s(1 << 20)


def test_fault_injection_fires_at_step():
    script = ("from horovod_tpu_torch.elastic import fault\n"
              "fault.maybe_die(4)\nfault.maybe_die(5)\nprint('survived')\n")
    env = dict(os.environ, HOROVOD_FAULT_INJECT_STEP="5",
               HOROVOD_FAULT_INJECT_INDEX="3", HOROVOD_TASK_INDEX="3",
               HOROVOD_FAULT_INJECT_SIGNAL="exit:7")
    p = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 7 and "survived" not in p.stdout
    env["HOROVOD_TASK_INDEX"] = "0"
    p = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and "survived" in p.stdout


# -- the elastic driver's membership --------------------------------------------


def _membership_script(d, script):
    """Drive an ElasticDriverService through ``script`` by calling its
    handler directly; returns what every step answered."""
    seen = []
    for op in script:
        kind = op[0]
        if kind == "reset":
            d.begin_reset(set(op[1]))
            seen.append(("gen", d.generation))
        elif kind in ("register", "rendezvous"):
            index = op[1]
            seen.append(d.handle({"kind": kind, "index": index,
                                  "host_hash": op[2],
                                  "addresses": [("127.0.0.1", 0)],
                                  "coord_port": 7000 + index}, None))
        elif kind == "wait":
            seen.append(d.handle({"kind": "wait_assignment", "index": op[1],
                                  "min_generation": op[2], "timeout": 0.2}, None))
        elif kind == "poll":
            seen.append(d.handle({"kind": "elastic_poll", "index": op[1],
                                  "generation": op[2]}, None))
        elif kind == "result":
            d.handle({"kind": "result", "rank": op[1], "index": op[2],
                      "generation": op[3], "value": {"ok": True, "value": op[4]}},
                     None)
        m = d.membership()
        seen.append((m["generation"], m["forming"], m["members"], m["ranks"],
                     sorted(m["removed"]), m["results"]))
    return seen


MEMBERSHIP = {
    "die, respawn, stale result": [
        ("reset", [0, 1]), ("register", 0, "h0"), ("register", 1, "h1"),
        ("wait", 0, 1), ("wait", 1, 1), ("poll", 1, 1),
        ("reset", [1, 2]), ("poll", 1, 1), ("rendezvous", 1, "h1"),
        ("register", 2, "h2"), ("wait", 1, 2), ("wait", 2, 2), ("wait", 0, 2),
        ("poll", 1, 1), ("poll", 1, 2), ("poll", 0, 2),
        ("result", 0, 1, 1, "stale"), ("result", 0, 1, 2, "fresh")],
    "scale up and down": [
        ("reset", [0, 1, 2]), ("register", 2, "a"), ("register", 0, "b"),
        ("register", 1, "a"), ("wait", 0, 1), ("wait", 1, 1), ("wait", 2, 1),
        ("reset", [0, 1, 2, 3]), ("register", 3, "c"), ("rendezvous", 0, "b"),
        ("rendezvous", 1, "a"), ("rendezvous", 2, "a"), ("wait", 3, 2),
        ("wait", 0, 2), ("reset", [0, 3]), ("rendezvous", 3, "c"),
        ("rendezvous", 0, "b"), ("wait", 3, 3), ("wait", 0, 3), ("wait", 1, 3),
        ("poll", 2, 2)],
    "register before the reset opens": [
        ("register", 0, "h"), ("register", 1, "h"), ("reset", [0, 1]),
        ("wait", 0, 1), ("wait", 1, 1), ("wait", 1, 2)],
}


@pytest.mark.parametrize("name", sorted(MEMBERSHIP))
def test_elastic_driver_membership_equal(name):
    """The same registrations, deaths and resets give the same generations,
    ranks (oldest member first), topologies, coordinator addresses, removals
    and accepted results from both packages' ElasticDriverService."""
    out = []
    for mod in (pservice, jservice):
        d = mod.ElasticDriverService(pnet.make_secret())
        try:
            seen = _membership_script(d, MEMBERSHIP[name])
        finally:
            d.stop()
        for s in seen:   # the JAX side also hands out its jax coordinator
            if isinstance(s, dict):
                s.pop("jax_coord_addr", None)
        out.append(seen)
    assert out[0] == out[1]


def test_elastic_driver_over_the_wire():
    """A port worker's rendezvous against the port driver through the
    network: formation, the survivor keeps rank 0, the removed slot is told."""
    from horovod_tpu_torch.runner.service import TaskAgent, WorkerRemovedError

    key = pnet.make_secret()
    d = pservice.ElasticDriverService(key)
    addr = [("127.0.0.1", d.port)]
    saved = dict(os.environ)
    try:
        d.begin_reset({0, 1})
        out = {}
        ts = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, TaskAgent(i, addr, key).rendezvous(1, timeout=30))) for i in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert {out[0]["rank"], out[1]["rank"]} == {0, 1}
        d.begin_reset({1, 2})
        ts = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, TaskAgent(i, addr, key).rendezvous(2, timeout=30))) for i in (1, 2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert out[1]["rank"] == 0 and out[2]["rank"] == 1
        assert out[1]["generation"] == 2 and out[1]["topology"]["size"] == 2
        c = pnet.BasicClient(addr, key)
        resp = c.request({"kind": "wait_assignment", "index": 0,
                          "min_generation": 2})
        c.close()
        assert resp.get("removed"), resp
        with pytest.raises(WorkerRemovedError):
            # what TaskAgent.rendezvous raises on that answer
            agent = TaskAgent(0, addr, key)
            agent.client.request = lambda req: resp
            agent.rendezvous(3, timeout=5)
    finally:
        os.environ.clear()
        os.environ.update(saved)
        d.stop()


# -- failures of the backend, and what elastic refuses ----------------------------


@pytest.mark.parametrize("exc,translated", [
    (dist.DistBackendError("NCCL watchdog: collective timed out"), True),
    (dist.DistNetworkError("connection refused"), True),
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:553] "
                  "Connection closed by peer [127.0.0.1]:4242"), True),
    (RuntimeError("Connection reset by peer"), True),
    (RuntimeError("shapes (3,) and (4,) do not match"), False),
    (ValueError("dim 0 not divisible"), False),
    (basics.HorovodInternalError("already ours"), True),
])
def test_backend_failures_raise_internal_error(exc, translated):
    from horovod_tpu_torch.parallel.collectives import backend_errors

    with pytest.raises(basics.HorovodInternalError if translated else type(exc)):
        with backend_errors("test"):
            raise exc


def test_a_dead_peer_fails_the_survivors_allreduce():
    """Two gloo ranks; rank 1 exits mid-job: rank 0's next allreduce raises
    HorovodInternalError (not a bare RuntimeError), and shutdown after it
    returns."""
    from launch_util import launch_world

    script = ("import os, sys, time, torch\n"
              "sys.path.insert(0, os.environ['HVD_REPO'])\n"
              "import horovod_tpu_torch as hvd\n"
              "hvd.init(device='cpu')\n"
              "hvd.allreduce(torch.ones(4))\n"
              "if hvd.rank() == 1:\n"
              "    os._exit(0)\n"
              "time.sleep(1)\n"
              "try:\n"
              "    hvd.allreduce(torch.ones(4))\n"
              "    print('{\"raised\": null}')\n"
              "except hvd.HorovodInternalError as e:\n"
              "    hvd.shutdown(abort=True)\n"
              "    print('{\"raised\": \"HorovodInternalError\", \"init\": %s}'"
              " % str(hvd.is_initialized()).lower())\n")
    res = launch_world(2, script, extra_env={"HOROVOD_ELASTIC": "1",
                                             "HOROVOD_STALL_SHUTDOWN_TIME": "20"},
                       timeout=120, check=False)
    assert res[0]["rc"] == 0, res[0]["stderr"][-2000:]
    assert res[0]["out"] == {"raised": "HorovodInternalError", "init": False}


def _builders():
    from horovod_tpu_torch import loop
    from horovod_tpu_torch import train as train_mod
    from horovod_tpu_torch.parallel import mesh

    config = train_mod.TrainConfig(vocab=16, dim=8, heads=2, layers=1, seq=8)

    def opt(**kw):
        p = torch.nn.Parameter(torch.zeros(2))
        return lambda: hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                                [("p", p)], **kw)

    return {
        "hierarchical_groups": lambda: mesh.hierarchical_groups(1),
        "dp_sp_groups": lambda: mesh.dp_sp_groups(1),
        "sharded_groups": lambda: mesh.sharded_groups(1, 1),
        "training_groups": lambda: mesh.training_groups(1, 1),
        "optimizer hierarchical": opt(hierarchical=True),
        "optimizer group": opt(group=dist.group.WORLD),
        "graphed loop": lambda: loop.make_scan_train_loop(
            lambda x, y: x.sum(), train_mod.make_cache(config, None, "cpu"), 2,
            optimizer=None),
    }


@pytest.mark.parametrize("name", sorted(_builders()))
def test_elastic_refuses_layouts_it_cannot_reset(world_of_one, monkeypatch, name):
    build = _builders()[name]
    build()                                        # builds outside elastic
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    with pytest.raises(ValueError, match="does not survive an elastic reset"):
        build()


def test_elastic_refuses_sharded_optimizer(world_of_one, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    p = torch.nn.Parameter(torch.zeros(4))
    with pytest.raises(ValueError, match="sharded=True"):
        hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0), [("p", p)],
                                 sharded=True)


@pytest.mark.parametrize("env,want", [
    ({}, timedelta(minutes=10)),
    ({"HOROVOD_STALL_SHUTDOWN_TIME": "7"}, timedelta(minutes=10)),
    ({"HOROVOD_ELASTIC": "1"}, timedelta(minutes=10)),
    ({"HOROVOD_ELASTIC": "1", "HOROVOD_STALL_SHUTDOWN_TIME": "7.5"},
     timedelta(seconds=7.5)),
])
def test_elastic_collective_timeout(monkeypatch, env, want):
    """Under HOROVOD_ELASTIC the process group's timeout is
    HOROVOD_STALL_SHUTDOWN_TIME (set by the elastic launcher)."""
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "HOROVOD_COORD_ADDR", "HOROVOD_ELASTIC",
              "HOROVOD_STALL_SHUTDOWN_TIME"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    real = dist.init_process_group

    def spy(*args, **kwargs):
        seen["timeout"] = kwargs["timeout"]
        return real(*args, **kwargs)

    monkeypatch.setattr(dist, "init_process_group", spy)
    hvd.init(device="cpu")
    try:
        assert seen["timeout"] == want
        assert basics.config().elastic == (env.get("HOROVOD_ELASTIC") == "1")
    finally:
        hvd.shutdown()


def test_shutdown_drops_every_group(world_of_one):
    from horovod_tpu_torch.parallel import mesh

    layout = mesh.sharded_groups(1, 1)
    assert layout.batch_group is not None
    hvd.shutdown()
    assert not dist.is_initialized()
    assert not dist.distributed_c10d._world.pg_map
    hvd.init(device="cpu")          # and a new world forms in the process
    assert torch.equal(hvd.allreduce(torch.ones(2)), torch.ones(2))


# -- run_elastic end to end (gloo) -------------------------------------------------

FAST = {"HOROVOD_STALL_CHECK_TIME": "1", "HOROVOD_STALL_SHUTDOWN_TIME": "5"}


def _make_entry(total_steps):
    """The JAX tests' entry on the port: +1 per step through an averaged
    allreduce of ones, committed every step, so the final value proves
    exact resume. A closure, which cloudpickle ships by value."""

    def entry():
        import sys as _sys

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
            loaded = sorted(m for m in _sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
            assert not loaded, loaded
            return (_hvd.rank(), _hvd.size(), int(state.step), float(state.acc))

        return _hvd.elastic.run(train)(state)

    return entry


def test_run_elastic_no_faults_matches_run():
    from horovod_tpu_torch.runner import run_elastic

    results = run_elastic(_make_entry(4), num_proc=2, timeout=120)
    assert [(r, s) for r, s, _, _ in results] == [(0, 2), (1, 2)]
    assert all(step == 4 and acc == 4.0 for _, _, step, acc in results)


def test_run_elastic_kill_coordinator_completes():
    from horovod_tpu_torch.runner import run_elastic

    results = run_elastic(
        _make_entry(8), num_proc=2, timeout=120,
        env={**FAST, "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "1",
             "HOROVOD_FAULT_INJECT_STEP": "3", "HOROVOD_FAULT_INJECT_INDEX": "0"})
    assert results == [(0, 1, 8, 8.0)]


def test_run_elastic_respawn_rejoins():
    from horovod_tpu_torch.runner import run_elastic

    results = run_elastic(
        _make_entry(8), num_proc=2, timeout=120,
        env={**FAST, "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2",
             "HOROVOD_FAULT_INJECT_STEP": "3", "HOROVOD_FAULT_INJECT_INDEX": "0"})
    assert results == [(0, 2, 8, 8.0), (1, 2, 8, 8.0)]


def test_run_elastic_below_min_np_aborts():
    from horovod_tpu_torch.runner import run_elastic

    with pytest.raises((RuntimeError, TimeoutError), match="min_np|failed"):
        run_elastic(
            _make_entry(50), num_proc=2, min_np=2, timeout=60,
            env={**FAST, "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "1",
                 "HOROVOD_FAULT_INJECT_STEP": "2", "HOROVOD_FAULT_INJECT_INDEX": "0"})


def test_run_elastic_user_exception_aborts():
    """A bug in the training function aborts the job with its traceback:
    no reset (elastic heals the backend's failures only)."""
    from horovod_tpu_torch.runner import run_elastic

    def entry():
        import horovod_tpu_torch as _hvd

        _hvd.init(device="cpu")
        state = _hvd.elastic.ElasticState(step=0)

        def train(state):
            raise RuntimeError("intentional elastic user bug")

        return _hvd.elastic.run(train)(state)

    with pytest.raises(RuntimeError, match="intentional elastic user bug"):
        run_elastic(entry, num_proc=2, timeout=90)


LM = dict(vocab=64, dim=32, heads=2, layers=2, seq=16)


def _lm_job(tmp, name, env, num_proc=2, steps=6, checkpoint_every=None,
            **train_kwargs):
    """One ``run_elastic`` job of ``lm_train`` on gloo; with
    ``checkpoint_every`` its ``ElasticState`` checkpoints to
    ``<tmp>/<name>/ckpt``. Returns the results and each rank's parameters."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.runner import run_elastic

    out = os.path.join(tmp, name)
    os.makedirs(out)
    ckpt = {} if checkpoint_every is None else {
        "checkpoint_dir": os.path.join(out, "ckpt"),
        "checkpoint_every": checkpoint_every}
    results = run_elastic(worker.lm_train, args=("cpu", LM, steps, out),
                          kwargs={**ckpt, **train_kwargs}, num_proc=num_proc, timeout=180,
                          env={"PYTHONPATH": WORKER_PATH, **FAST, **env})
    params = [torch.load(os.path.join(out, f"params.{r}.pt"), weights_only=True)
              for r in range(num_proc)]
    return results, params


def _events(path):
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("hooks", [False, True], ids=["serial", "hooked"])
def test_run_elastic_transformer_survives_a_dead_worker(tmp_path, hooks):
    """The 2-layer TransformerLM through DistributedOptimizer under
    ``hvd.elastic.run``, with the serial exchange or from the gradient
    hooks (HOROVOD_LATENCY_HIDING, 4 buckets, the launch order agreed again
    in the new world), index 1 killed at step 2's commit and respawned:
    both ranks end at step 6 with bit-equal parameters, equal to a run
    that never stopped (two ranks keep their numbers, and a sum of two
    numbers is the same in either order)."""
    env = {"HOROVOD_LATENCY_HIDING": "1", "HOROVOD_NUM_BUCKETS": "4"} if hooks else {}
    straight, want = _lm_job(str(tmp_path), "straight", env)
    results, params = _lm_job(str(tmp_path), "killed", {
        **env, "HOROVOD_FAULT_INJECT_STEP": "2", "HOROVOD_FAULT_INJECT_INDEX": "1",
        "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2"})
    assert [(r["rank"], r["size"], r["step"], r["generation"]) for r in results] \
        == [(0, 2, 6, 2), (1, 2, 6, 2)]
    assert [len(r["resets"]) for r in results] == [1, 0]
    assert results[0]["losses"] == straight[0]["losses"]
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k
        assert torch.equal(params[0][k], want[0][k]), k


@pytest.fixture(scope="module")
def straight_lm(tmp_path_factory):
    """The 2-rank job with no fault: its results and parameters."""
    return _lm_job(str(tmp_path_factory.mktemp("straight")), "straight", {})


def test_run_elastic_reset_without_membership_change(tmp_path, straight_lm):
    """Rank 1 raises HorovodInternalError once, before step 3, and the
    reset aborts its communicators, so rank 0's collective fails too: no
    process dies and the membership stays the same. Both ranks register
    for the next generation, and the driver opens it over the same two
    members (it opened one only when a slot died, was removed or was
    added, so both ranks waited forever). Each rank resets once, both end
    at step 6 in generation 2, bit-equal to the run with no fault."""
    straight, want = straight_lm
    events = str(tmp_path / "events.jsonl")
    results, params = _lm_job(str(tmp_path), "raised", {
        "HOROVOD_ELASTIC_EVENT_LOG": events}, raise_at=(1, 3))
    assert [(r["rank"], r["size"], r["step"], r["generation"]) for r in results] \
        == [(0, 2, 6, 2), (1, 2, 6, 2)]
    assert [len(r["resets"]) for r in results] == [1, 1]
    log = _events(events)
    assert [e["generation"] for e in log
            if e["event"] == "rendezvous_complete"] == [1, 2]
    assert not [e for e in log if e["event"] == "worker_failed"]
    assert results[0]["losses"] == straight[0]["losses"]
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k
        assert torch.equal(params[0][k], want[0][k]), k


def test_run_elastic_slow_joiner_is_not_a_stall(tmp_path, straight_lm):
    """Index 1 is killed at step 2's commit, and its respawned worker sleeps
    twice the stall time (2 x 5 s) between ``init`` and its ``sync``. The
    survivor waits for it on the rendezvous store, not in the broadcast,
    whose wait the stall time bounds: one reset on the survivor and none
    on the joiner, generation 2, bit-equal to the run with no fault."""
    straight, want = straight_lm
    results, params = _lm_job(str(tmp_path), "slow-joiner", {
        "HOROVOD_FAULT_INJECT_STEP": "2", "HOROVOD_FAULT_INJECT_INDEX": "1",
        "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2"},
        joiner_sleep_s=2 * float(FAST["HOROVOD_STALL_SHUTDOWN_TIME"]))
    assert [(r["rank"], r["size"], r["step"], r["generation"]) for r in results] \
        == [(0, 2, 6, 2), (1, 2, 6, 2)]
    assert [len(r["resets"]) for r in results] == [1, 0]
    assert results[0]["losses"] == straight[0]["losses"]
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k
        assert torch.equal(params[0][k], want[0][k]), k


def test_run_elastic_single_worker_resumes_from_its_checkpoint(tmp_path):
    """A job of one worker that dies has no survivor to re-form with: the
    port's driver respawns the slot (the JAX driver ends such a job), and
    the new worker cold-starts from the checkpoint of step 2's commit
    (construction is commit 1, step i's is commit i + 1, every 3rd
    checkpoints). It ends at step 6 in generation 2, its losses and
    parameters bit-equal to a worker that never stopped."""
    straight, want = _lm_job(str(tmp_path), "straight", {}, num_proc=1)
    events = str(tmp_path / "events.jsonl")
    (got,), (params,) = _lm_job(str(tmp_path), "killed", {
        "HOROVOD_FAULT_INJECT_STEP": "2", "HOROVOD_FAULT_INJECT_INDEX": "0",
        "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2", "HOROVOD_CKPT_ASYNC": "0",
        "HOROVOD_ELASTIC_EVENT_LOG": events}, num_proc=1, checkpoint_every=3)
    log = _events(events)
    assert [e["generation"] for e in log
            if e["event"] == "rendezvous_complete"] == [1, 2]
    assert [e["index"] for e in log if e["event"] == "worker_failed"] == [0]
    assert (got["step"], got["generation"], got["resumed_from"]) == (6, 2, 2)
    assert got["losses"] == straight[0]["losses"]
    for k in want[0]:
        assert torch.equal(params[k], want[0][k]), k


def test_run_elastic_every_worker_dies(tmp_path):
    """Every worker of a 2-rank job dies at step 2, and so does each
    respawned one (no checkpoint, so each starts again from step 0): the
    blacklist (threshold 2) bans each slot after its second failure, so the
    driver spawns 4 workers in all, and the job fails with an error that
    names the slots' failures (SIGKILL: exit code -9)."""
    from horovod_tpu_torch.runner import run_elastic

    events = str(tmp_path / "events.jsonl")
    with pytest.raises(RuntimeError, match=r"min_np=1 .*last failures: "
                       r"local:0 exited with -9, local:1 exited with -9"):
        run_elastic(_make_entry(8), num_proc=2, timeout=120,
                    env={**FAST, "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2",
                         "HOROVOD_FAULT_INJECT_STEP": "2",
                         "HOROVOD_ELASTIC_EVENT_LOG": events})
    log = _events(events)
    spawned = [e["slot"] for e in log if e["event"] == "worker_spawned"]
    failed = [e["slot"] for e in log if e["event"] == "worker_failed"]
    assert sorted(spawned) == ["local:0", "local:0", "local:1", "local:1"]
    assert sorted(failed) == sorted(spawned)
    assert sorted(e["host"] for e in log if e["event"] == "host_blacklisted") \
        == ["local:0", "local:1"]


@pytest.mark.parametrize("killed", [False, True], ids=["whole", "index1-killed"])
def test_elastic_checkpoint_outlasts_the_stall_time(tmp_path, killed):
    """Under HOROVOD_ELASTIC a collective waits at most the stall time (5 s
    here), but a commit that writes the checkpoint may take longer: rank 0
    holds each of its writes (steps 2 and 5) for 7 s, and rank 1 waits on
    the rendezvous store's key, not in a barrier of the world, so no reset
    happens. With index 1 killed after step 2's checkpoint, rank 0 resets
    once and the respawned worker cold-starts from that checkpoint; it
    takes rank 0's count of commits in the sync, so both ranks checkpoint
    step 5 together. Both ranks end at step 6 with bit-equal parameters,
    equal to the run without a checkpoint."""
    _, want = _lm_job(str(tmp_path), "straight", {})
    fault = {"HOROVOD_FAULT_INJECT_STEP": "2", "HOROVOD_FAULT_INJECT_INDEX": "1",
             "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2"} if killed else {}
    results, params = _lm_job(str(tmp_path), "slow", {
        "HOROVOD_CKPT_ASYNC": "0", "HOROVOD_CKPT_TEST_STALL": "stage",
        "HOROVOD_CKPT_TEST_STALL_S": "7", **fault}, checkpoint_every=3)
    gen = 2 if killed else 1
    assert [(r["rank"], r["step"], r["generation"], len(r["resets"]))
            for r in results] == [(0, 6, gen, int(killed)), (1, 6, gen, 0)]
    assert [r["resumed_from"] for r in results] == [0, 2 if killed else 0]
    assert os.path.exists(str(tmp_path / "slow" / "ckpt"))
    for k in want[0]:
        assert torch.equal(params[0][k], params[1][k]), k
        assert torch.equal(params[0][k], want[0][k]), k
