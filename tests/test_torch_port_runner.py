"""The port's launcher (``horovod_tpu_torch.runner``) against the JAX
package's (``horovod_tpu.runner``): the frames bit for bit (a client of
either package talks to a service of the other, and both refuse a wrong
secret, a replayed frame and an over-cap payload), the pure functions, the
CLI's parsing into ``run_command``, the driver's rank and topology
assignment, and the launch paths end to end on gloo: ``run`` in rank order
with a worker's exception surfaced, ``run_command`` of the CLI with the
MNIST example, the remote leg through two ``hvd-agent`` daemons, and
``--check-build``. Every spawned worker loads neither JAX nor
``horovod_tpu``, and no source of the port names a module of the JAX
package in a string (the spawn strings)."""

from __future__ import annotations

import ast
import hashlib
import hmac
import json
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import time

import pytest

from horovod_tpu.runner import network as jnet
from horovod_tpu.runner import remote as jremote
from horovod_tpu.runner import service as jservice
from horovod_tpu_torch.runner import network as pnet
from horovod_tpu_torch.runner import remote as premote
from horovod_tpu_torch.runner import service as pservice
from launch_util import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
PKG = os.path.join(REPO, "horovod_tpu_torch")
NETS = {"port": pnet, "jax": jnet}


def _echo_service(net, key):
    class Echo(net.BasicService):
        def handle(self, request, client_addr):
            return {"echo": request}

    return Echo(key)


# -- frames ---------------------------------------------------------------------


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_frames_cross_package(client, server):
    """One secret: a client of either package gets the other's answers, over
    several requests of the same session (sequence numbers advance alike)."""
    key = pnet.make_secret()
    svc = _echo_service(NETS[server], key)
    try:
        c = NETS[client].BasicClient([("127.0.0.1", svc.port)], key)
        for i in range(3):
            req = {"x": i, "blob": bytes(range(i * 7 % 256)), "t": (1.5, None)}
            assert c.request(req) == {"echo": req}
        # the built-in clock responder answers both packages' probes
        assert c.request({"kind": "clock_probe"})["ok"]
        c.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_frames_wrong_secret_rejected(client, server):
    svc = _echo_service(NETS[server], pnet.make_secret())
    try:
        c = NETS[client].BasicClient([("127.0.0.1", svc.port)],
                                     pnet.make_secret())
        with pytest.raises((ConnectionError, OSError, PermissionError)):
            c.request({"evil": True})
        c.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_frames_replay_rejected(server):
    """A captured request does not authenticate again, neither within its
    connection (sequence numbers) nor on a fresh one (session nonce)."""
    calls = []
    net = NETS[server]

    class Spy(net.BasicService):
        def handle(self, request, client_addr):
            calls.append(request)
            return {"ok": True}

    key = pnet.make_secret()
    svc = Spy(key)
    try:
        conn = socket.create_connection(("127.0.0.1", svc.port), timeout=10)
        head = conn.recv(20)
        assert head[:4] == b"HVD2"
        session = hmac.new(key, b"hvd-session:" + head[4:], hashlib.sha256).digest()
        payload = pickle.dumps({"kind": "spawn", "argv": ["evil"]})
        mac = hmac.new(session, b"C" + struct.pack("!Q", 0) + payload,
                       hashlib.sha256).digest()
        frame = mac + struct.pack("!Q", len(payload)) + payload
        conn.sendall(frame)
        assert conn.recv(1)
        conn.recv(1 << 16)
        assert len(calls) == 1
        for sock in (conn, socket.create_connection(("127.0.0.1", svc.port),
                                                    timeout=10)):
            if sock is not conn:
                sock.recv(20)
            sock.settimeout(5)
            sock.sendall(frame)
            got = b""
            try:
                got = sock.recv(1)
            except (ConnectionError, OSError, TimeoutError):
                pass
            assert got == b"", "server answered a replayed frame"
        assert len(calls) == 1
    finally:
        svc.stop()


@pytest.mark.parametrize("sender,receiver", [("port", "jax"), ("jax", "port")])
def test_frames_payload_cap(sender, receiver):
    """A frame claiming more than MAX_PAYLOAD is refused before the body is
    read; both packages share the cap."""
    assert pnet.MAX_PAYLOAD == jnet.MAX_PAYLOAD
    key = pnet.make_secret()
    a, b = socket.socketpair()
    try:
        a.settimeout(10)
        b.settimeout(10)
        got = {}
        import threading

        t = threading.Thread(target=lambda: got.setdefault(
            "ch", NETS[sender].Channel(a, key, server=False)))
        t.start()
        srv = NETS[receiver].Channel(b, key, server=True)
        t.join(10)
        a.sendall(b"\0" * 32 + struct.pack("!Q", pnet.MAX_PAYLOAD + 1))
        with pytest.raises(PermissionError, match="exceeds cap"):
            srv.recv()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("purpose", [b"hvd-job:aaaa", b"hvd-job:", b"x" * 100,
                                     bytes(range(256))])
def test_derive_key_equal(purpose):
    key = bytes(range(32))
    assert pnet.derive_key(key, purpose) == jnet.derive_key(key, purpose)
    assert len(pnet.make_secret()) == len(jnet.make_secret()) == 32


# -- pure functions -------------------------------------------------------------


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [
    "host1:4,host2:4", "a", "a:2, b ,c:3", "127.0.0.1@9001:2,127.0.0.1@9002:1",
    "[::1]:4", "[fe80::1]@9009:2", "[::1]", "::1:4", "[fe80::1]8000:2",
    "[::1", "a:0", "a:x", ":3", "", "h@:2", "a,,b",
    [("h1", 2), ("h2", 3, 9100)],
])
def test_parse_hosts_equal(spec):
    def norm(out):
        kind, val = out
        if kind == "ok":
            return kind, [(s.host, s.slots, s.agent_port) for s in val]
        return out

    assert norm(_outcome(premote.parse_hosts, spec, None)) == \
        norm(_outcome(jremote.parse_hosts, spec, None))
    assert norm(_outcome(premote.parse_hosts, spec, 9200)) == \
        norm(_outcome(jremote.parse_hosts, spec, 9200))


@pytest.mark.parametrize("argv", [
    ["-np", "2", "--", "python", "train.py"],
    ["-np", "4", "python", "train.py", "--lr", "0.1"],
    ["-H", "a:2,b:2", "--env", "K=V", "--env", "X=1=2", "--", "cmd", "-x"],
    ["-H", "h@9001:1", "--agent-port", "9100", "--", "echo"],
    ["--num-proc", "3", "--env", "E=", "--", "sh", "-c", "exit 0"],
])
def test_cli_parses_into_run_command_as_jax(argv, monkeypatch):
    """The CLI hands ``run_command`` the same command, sizes and env (the
    JAX launcher's ``jax_distributed`` has no counterpart in the port)."""
    import horovod_tpu.runner as jrun
    import horovod_tpu.runner.__main__ as jmain
    import horovod_tpu_torch.runner as prun
    import horovod_tpu_torch.runner.__main__ as pmain

    calls = {}

    def fake(name):
        def run_command(command, **kw):
            calls[name] = (list(command), kw)
            return 0
        return run_command

    monkeypatch.setattr(jrun, "run_command", fake("jax"))
    monkeypatch.setattr(prun, "run_command", fake("port"))
    assert jmain.main(argv) == pmain.main(argv) == 0
    jcmd, jkw = calls["jax"]
    assert jkw.pop("jax_distributed") is False
    assert calls["port"] == (jcmd, jkw)


def test_cli_agent_secret_file(tmp_path, monkeypatch):
    import horovod_tpu_torch.runner as prun
    import horovod_tpu_torch.runner.__main__ as pmain
    from horovod_tpu.runner.agent import _load_secret as jload
    from horovod_tpu_torch.runner.agent import _load_secret as pload

    path = tmp_path / "secret"
    path.write_text(bytes(range(32)).hex() + "\n")
    assert pload(str(path)) == jload(str(path)) == bytes(range(32))
    got = {}
    monkeypatch.setattr(prun, "run_command",
                        lambda command, **kw: got.update(kw) or 0)
    pmain.main(["-H", "a:1", "--agent-secret-file", str(path), "--", "x"])
    assert got["agent_secret"] == bytes(range(32))


@pytest.mark.parametrize("argv,message", [
    (["-np", "2"], "no command given"),
    (["--", "python", "x.py"], "one of -np or -H is required"),
])
def test_cli_usage_errors(argv, message):
    proc = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.runner",
                           *argv], capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert proc.returncode != 0 and message in proc.stderr


def test_run_command_rejects_bad_num_proc():
    from horovod_tpu_torch.runner import run_command

    for n in (0, None):
        with pytest.raises(ValueError, match="num_proc"):
            run_command(["echo", "hi"], num_proc=n)


# -- driver state ---------------------------------------------------------------


def _registrations():
    # (index, host_hash, coord_port), in registration order
    return [
        [(0, "hostB", 7000), (1, "hostA", 7001), (2, "hostB", 7002),
         (3, "hostA", 7003)],
        [(2, "h", 7100), (0, "h", 7101), (1, "h", 7102)],
        [(0, "only", 7200)],
        [(1, "z", 7301), (0, "y", 7300), (3, "y", 7303), (2, "z", 7302),
         (4, "x", 7304), (5, "x", 7305)],
    ]


@pytest.mark.parametrize("regs", _registrations(), ids=lambda r: f"{len(r)}ranks")
def test_driver_assignment_equal(regs):
    """The same registrations give every index the same rank, topology and
    coordinator address from both packages' DriverService."""
    out = {}
    for name, mod in (("port", pservice), ("jax", jservice)):
        d = mod.DriverService(len(regs), pnet.make_secret())
        try:
            for index, host, port in regs:
                d.handle({"kind": "register", "index": index, "host_hash": host,
                          "addresses": [("10.0.0.1", 0), ("127.0.0.1", 0)],
                          "coord_port": port}, None)
            out[name] = {}
            for index, _, _ in regs:
                a = d.handle({"kind": "wait_assignment", "index": index,
                              "timeout": 5}, None)
                out[name][index] = (a["ok"], a["rank"], a["topology"],
                                    a["coord_addr"])
        finally:
            d.stop()
    assert out["port"] == out["jax"]


def test_driver_results_and_pending():
    d = pservice.DriverService(2, pnet.make_secret())
    try:
        assert d.result_pending_index(0)
        for i in range(2):
            d.handle({"kind": "register", "index": i, "host_hash": "h",
                      "addresses": [("127.0.0.1", 0)], "coord_port": 7000 + i},
                     None)
        d.handle({"kind": "result", "rank": 1, "value": {"ok": True, "value": "b"}},
                 None)
        assert d.result_pending_index(0) and not d.result_pending_index(1)
        d.handle({"kind": "result", "rank": 0, "value": {"ok": True, "value": "a"}},
                 None)
        assert d.wait_results(timeout=5) == {0: "a", 1: "b"}
        # a telemetry-tree leader's push lands at the driver's root, as in
        # the JAX package's driver
        from horovod_tpu_torch.metrics.aggregate import lift_snapshot

        push = {"kind": "host_metrics", "host": "h", "seq": 0, "full": True,
                "body": lift_snapshot(1, {"counters": {"c_total": 2.0}}),
                "interval_s": 1.0}
        ref = jservice.DriverService(2, pnet.make_secret())
        try:
            assert d.handle(dict(push), None) == ref.handle(dict(push), None) \
                == {"ok": True, "need_full": False}
            assert d.pod_metrics()["counters"] == ref.pod_metrics()["counters"] \
                == {"c_total": 2.0}
        finally:
            ref.stop()
    finally:
        d.stop()


def test_ship_fn_without_cloudpickle(monkeypatch):
    """Without cloudpickle a closure cannot ship: the launch fails at once
    with a message that says so; an importable function still ships."""
    def closure():
        return 1

    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    with pytest.raises(TypeError, match="cloudpickle is not installed"):
        pservice.DriverService(1, pnet.make_secret(), fn=closure)
    payload = pservice.ship_fn(os.path.join, ("a", "b"), {})
    fn, args, kwargs = pickle.loads(payload)
    assert fn(*args, **kwargs) == os.path.join("a", "b")


def test_use_tree_gate(monkeypatch):
    """The launcher's gate for the control tree: the JAX package's
    ``use_tree``, on by default for a multi-host world of 3 or more."""
    from horovod_tpu.ctrl import tree as jtree
    from horovod_tpu_torch.ctrl import tree as ptree

    for env in (None, "1", "0"):
        if env is None:
            monkeypatch.delenv("HOROVOD_CTRL_TREE", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_CTRL_TREE", env)
        for hosts, world in ((2, 8), (1, 8), (2, 2), (2, 3)):
            assert ptree.use_tree(hosts, world) == jtree.use_tree(hosts, world)
    monkeypatch.delenv("HOROVOD_CTRL_TREE")
    assert ptree.use_tree(2, 3) and not ptree.use_tree(1, 8)
    assert not hasattr(premote, "require_flat_control")


def test_clock_offset_against_driver():
    d = pservice.DriverService(1, pnet.make_secret())
    try:
        c = pnet.BasicClient([("127.0.0.1", d.port)], d.key)
        agent = pservice.TaskAgent.__new__(pservice.TaskAgent)
        agent.client = c
        offset, bound = agent.estimate_clock_offset_ns(rounds=4)
        # one host, one monotonic clock: the offset is within its bound
        assert abs(offset) <= bound + 1_000_000
        c.close()
    finally:
        d.stop()


def test_proc_tree_reaps_escaped_descendants():
    """terminate_trees takes down the worker, its group and a grandchild
    that left the group (its own session), read from /proc."""
    from horovod_tpu_torch.runner.proc_tree import terminate_trees

    script = ("import os, subprocess, sys, time\n"
              "a = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(300)'])\n"
              "b = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(300)'],\n"
              "                     start_new_session=True)\n"
              "print(a.pid, b.pid, flush=True)\n"
              "time.sleep(300)\n")
    p = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                         text=True, start_new_session=True)
    pids = [int(x) for x in p.stdout.readline().split()]
    t0 = time.monotonic()
    terminate_trees([p], grace=5.0)
    assert p.poll() is not None and time.monotonic() - t0 < 12
    for pid in pids:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                        break
            except OSError:
                break
            time.sleep(0.05)
        else:
            os.kill(pid, signal.SIGKILL)
            pytest.fail(f"descendant {pid} survived terminate_trees")


# -- launch end to end (gloo) ---------------------------------------------------


def test_run_results_in_rank_order_and_no_jax():
    """4-process ``run``: ranks assigned, the port's allreduce correct,
    results ordered by rank; no worker loaded JAX or horovod_tpu."""
    from horovod_tpu_torch.runner import run

    def train_fn(scale):
        import sys as _sys

        import torch

        import horovod_tpu_torch as hvd

        hvd.init(device="cpu")
        out = hvd.allreduce(torch.full((2,), float(hvd.rank()) * scale,
                                       dtype=torch.float64))
        loaded = sorted(m for m in _sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
        result = (hvd.rank(), hvd.size(), out.tolist(), loaded)
        hvd.shutdown()
        return result

    results = run(train_fn, args=(2.0,), num_proc=4, timeout=120)
    mean = sum(r * 2.0 for r in range(4)) / 4
    assert [(r, s, red, loaded) for r, s, red, loaded in results] == [
        (rank, 4, [mean, mean], []) for rank in range(4)]


def test_run_surfaces_worker_exception():
    from horovod_tpu_torch.runner import run

    def failing_fn():
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu")
        if hvd.rank() == 1:
            raise ValueError("intentional rank-1 explosion")
        hvd.shutdown()
        return "ok"

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="intentional rank-1 explosion"):
        run(failing_fn, num_proc=2, timeout=120)
    assert time.monotonic() - t0 < 90


def test_cli_launches_mnist_example():
    """``python -m horovod_tpu_torch.runner -np 2 -- python
    examples/torch_mnist.py --device cpu``: two gloo ranks train and exit 0."""
    env = dict(os.environ, MNIST_EPOCHS="1", MNIST_STEPS="3")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2", "--",
         sys.executable, os.path.join(REPO, "examples", "torch_mnist.py"),
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "epoch 0: loss" in proc.stdout


def test_run_command_exports_identity():
    """The CLI's path: each worker gets its identity in its env, the
    largest exit code wins, and no worker loads JAX or horovod_tpu."""
    from horovod_tpu_torch.runner import run_command

    script = ("import json, os, sys\n"
              "import horovod_tpu_torch\n"
              "keys = ['HOROVOD_RANK', 'HOROVOD_SIZE', 'HOROVOD_LOCAL_RANK',\n"
              "        'HOROVOD_LOCAL_SIZE', 'HOROVOD_COORD_ADDR']\n"
              "got = {k: os.environ.get(k) for k in keys}\n"
              "got['loaded'] = sorted(m for m in sys.modules\n"
              "                       if m.split('.')[0] in ('jax', 'horovod_tpu'))\n"
              "with open(os.path.join(os.environ['OUT'], os.environ['HOROVOD_RANK']), 'w') as f:\n"
              "    json.dump(got, f)\n"
              "sys.exit(int(os.environ['HOROVOD_RANK']) * 3)\n")
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        rc = run_command([sys.executable, "-c", script], num_proc=2,
                         env={"OUT": out}, timeout=120)
        got = [json.load(open(os.path.join(out, str(r)))) for r in range(2)]
    assert rc == 3
    assert [(g["HOROVOD_RANK"], g["HOROVOD_SIZE"], g["HOROVOD_LOCAL_SIZE"])
            for g in got] == [("0", "2", "2"), ("1", "2", "2")]
    assert got[0]["HOROVOD_COORD_ADDR"] == got[1]["HOROVOD_COORD_ADDR"]
    assert got[0]["loaded"] == got[1]["loaded"] == []


def test_check_build_reports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    code = ("import runpy, sys\n"
            "sys.argv = ['x', '--check-build']\n"
            "try:\n"
            "    runpy.run_module('horovod_tpu_torch.runner', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'horovod_tpu')), rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    out = proc.stdout
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED [] 0" in out
    for line in ("torch: ", "CUDA: ", "NCCL (GPU collectives): ",
                 "gloo (CPU collectives): yes", "CUDA kernels, flash_attention.cu:",
                 "CUDA kernels, ring_flash.cu:", "GPUs: "):
        assert line in out, (line, out)


# -- the remote leg -------------------------------------------------------------


def _start_agent(fake_host: str, secret: bytes):
    env = dict(os.environ, HOROVOD_HOSTNAME=fake_host,
               HOROVOD_AGENT_SECRET=secret.hex())
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.agent", "--port", "0"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, text=True)
    info = json.loads(proc.stdout.readline())
    assert info["agent"] == "ready"
    return proc, info["port"]


def test_remote_run_two_agents():
    """``run(fn, hosts=...)`` through two port agents standing in for two
    machines: 2 hosts x 2 slots, the topology and the collective right; the
    agents host the telemetry and control-tree leaders, the latter with
    its engine-coordinator relay on request."""
    from horovod_tpu_torch.runner import run

    secret = pnet.make_secret()
    agents = [_start_agent("fake-host-a", secret), _start_agent("fake-host-b", secret)]
    try:
        c = pnet.BasicClient([("127.0.0.1", agents[0][1])], secret)
        for kind in ("telemetry", "ctrl"):
            resp = c.request({"kind": kind, "cmd": "start", "job_id": "j"})
            assert resp["ok"] and resp["port"] > 0, resp
            assert c.request({"kind": kind, "cmd": "stop", "job_id": "j"})["ok"]
        resp = c.request({"kind": "ctrl", "cmd": "start", "job_id": "j",
                          "relay": True})
        assert resp["ok"] and resp["relay_port"] > 0, resp
        assert c.request({"kind": "ctrl", "cmd": "stop", "job_id": "j"})["ok"]
        c.close()

        def train_fn():
            import torch

            import horovod_tpu_torch as hvd

            hvd.init(device="cpu")
            out = hvd.allreduce(torch.tensor([float(hvd.rank())]), hvd.ReduceOp.SUM)
            result = (hvd.rank(), hvd.size(), hvd.cross_rank(), hvd.cross_size(),
                      hvd.local_size(), out.item())
            hvd.shutdown()
            return result

        hosts = ",".join(f"127.0.0.1@{port}:2" for _, port in agents)
        results = run(train_fn, hosts=hosts, agent_secret=secret, timeout=180)
        assert [r[:2] for r in results] == [(r, 4) for r in range(4)]
        assert {r[2] for r in results} == {0, 1}
        assert all(r[3] == 2 and r[4] == 2 and r[5] == 6.0 for r in results)
    finally:
        for p, _ in agents:
            p.send_signal(signal.SIGTERM)
        for p, _ in agents:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


# -- the import guard -----------------------------------------------------------


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _names_jax_module(text: str) -> bool:
    """``text`` holds a dotted name that is a module of the JAX package."""
    import re

    for name in re.findall(r"(?<![\w.])horovod_tpu(?:\.\w+)+", text):
        path = os.path.join(REPO, *name.split("."))
        if os.path.exists(path + ".py") or os.path.isdir(path):
            return True
    return False


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_string_names_the_jax_package(path):
    """No string of the port's code (docstrings aside) names a module of
    the JAX package (``"horovod_tpu.runner.task_main"``): a copied spawn
    string would launch the JAX package's worker, which the import check
    cannot see. A format tag such as ``"horovod_tpu.metrics.partial.v1"``
    names no module."""
    assert _names_jax_module("-m horovod_tpu.runner.task_main")
    assert not _names_jax_module("horovod_tpu.metrics.partial.v1 horovod_tpu_torch.runner")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    prose = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in prose:
            assert not _names_jax_module(node.value), (path, node.value)
