"""The port's per-host relay of the engine coordinator
(``horovod_tpu_torch.ctrl.relay.CoordRelay``) against the JAX package's:

- a launched gloo world of 4 (``init(device="cpu")``, the engine's
  coordinator found through the world's store;
  ``tests/torch_port_engine_world_worker.py``) on two fake hosts of two
  ranks, each host's ranks dialing their host's relay
  (``HOROVOD_CTRL_RELAY``): on the flat ring its results equal the same
  world without relays (one host per rank), bitwise, under the bf16 and
  topk wires, cold and cached; on the two-level plane (the same world,
  ``hierarchical_allreduce`` on) they equal the grid order's canonical
  oracle; the coordinator accepts 2 control connections with the relays
  against 4 without;
- the same world launched by ``run_command`` across two hvd-agents
  standing in for hosts a:2 and b:2, the control tree on: each host's
  leader hosts the relay and its workers get ``HOROVOD_CTRL_RELAY``;
  the results equal the flat oracle's and the coordinator accepts 2
  connections (the relay is keyed as the workers' engines key their
  frames, the text of ``HOROVOD_SECRET``; the JAX package's agent keys
  it with the raw job secret, which their frames do not authenticate
  under);
- 4 rank threads through one relay: coalesced exchanges give the JAX
  relay's results, the ring barrier resolves the shared verdict, the
  clock probe passes through, one upstream connection;
- an unclean drop of one rank behind the relay fails exactly that rank
  at the coordinator (``peer_lost``), a clean ``bye`` none, and a relay's
  own unclean drop fails every rank it declared, as in the JAX package.
Tolerance: none."""

from __future__ import annotations

import json
import os
import secrets
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

import horovod_tpu.common.engine as JE
import horovod_tpu.ctrl.relay as JR
import horovod_tpu_torch.common.engine as PE
import horovod_tpu_torch.ctrl.relay as PR
import torch_port_engine_world_worker as W
from launch_util import REPO

KEY = b"relay-secret"
COMPS = ["bf16", "topk"]
ELEMS, SMALL, STEPS = 30011, 6, 2


def test_relayed_world_equals_the_flat_world(tmp_path):
    secret = secrets.token_hex(16)
    env = {"HOROVOD_SECRET": secret, "T_COMPS": ",".join(COMPS),
           "T_ELEMS": str(ELEMS), "T_SMALL": str(SMALL),
           "T_STEPS": str(STEPS)}
    reports = {"flat": W.spawn(str(tmp_path / "flat"), env)}
    hosts = {r: {"HOROVOD_LOCAL_RANK": str(r % 2), "HOROVOD_LOCAL_SIZE": "2",
                 "HOROVOD_CROSS_RANK": str(r // 2), "HOROVOD_CROSS_SIZE": "2"}
             for r in range(4)}
    relays = [PR.CoordRelay(secret.encode(), window_s=0.005) for _ in range(2)]
    try:
        per = {r: dict(hosts[r], HOROVOD_CTRL_RELAY=
                       f"127.0.0.1:{relays[r // 2].port}")
               for r in range(4)}
        reports["relayed"] = W.spawn(str(tmp_path / "relayed"),
                                     dict(env, T_PLANES="ring,hier"), per)
    finally:
        for relay in relays:
            relay.stop()
    shape = W.sizes(ELEMS, SMALL)
    oracle = W.oracle_digests(COMPS, STEPS, 4, shape, grids=(None, (2, 2)))
    W.hold(reports["flat"], "ring", oracle[None])
    W.hold(reports["relayed"], "ring", oracle[None])
    W.hold(reports["relayed"], "hier", oracle[(2, 2)])
    assert set(reports["flat"][0]["accepted"]["ring"].values()) == {4}
    for plane in ("ring", "hier"):
        assert set(reports["relayed"][0]["accepted"][plane].values()) == {2}


def _agent(name: str, secret: bytes):
    env = dict(os.environ, HOROVOD_HOSTNAME=name,
               HOROVOD_AGENT_SECRET=secret.hex(), PYTHONPATH=REPO)
    env.pop("HOROVOD_CTRL_TREE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.agent", "--port", "0"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, text=True)
    info = json.loads(proc.stdout.readline())
    assert info["agent"] == "ready"
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    return proc, info["port"]


def test_agent_hosted_relays_serve_a_launched_world(tmp_path, monkeypatch):
    monkeypatch.delenv("HOROVOD_CTRL_TREE", raising=False)
    secret = secrets.token_bytes(32)
    agents = [_agent("fake-host-a", secret), _agent("fake-host-b", secret)]
    try:
        spec = ",".join(f"127.0.0.1@{port}:2" for _, port in agents)
        reports = W.launch(
            str(tmp_path), {"T_COMPS": "bf16", "T_ELEMS": str(ELEMS),
                            "T_SMALL": str(SMALL), "T_STEPS": str(STEPS),
                            "HOROVOD_STALL_CHECK_DISABLE": "1"},
            hosts=spec, secret=secret, timeout=180)
    finally:
        for proc, _ in agents:
            proc.send_signal(signal.SIGTERM)
        for proc, _ in agents:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
    W.hold(reports, "ring",
           W.oracle_digests(["bf16"], STEPS, 4, W.sizes(ELEMS, SMALL))[None])
    assert reports[0]["accepted"]["ring"] == {"bf16": 2}


def _relay_world(emod, rmod):
    coord = emod._Coordinator(4, "127.0.0.1", 0, key=KEY)
    port = coord.server.getsockname()[1]
    coord.start()
    relay = rmod.CoordRelay(KEY, window_s=0.02)
    results: dict = {}
    errors: list = []

    def worker(rank):
        try:
            client = emod._Client("127.0.0.1", port, rank, key=KEY, local=4)
            try:
                req = [{"name": "g", "op": "allreduce", "shape": (3,),
                        "dtype": "float64", "root": 0, "average": True}]
                arr = np.arange(3.0) * (rank + 1)
                out: dict = {}
                for _ in range(40):
                    out.update(client.exchange(
                        req, {"g": arr} if not out else {}))
                    if "g" in out:
                        break
                hello = client.ring_hello({"enabled": False})
                probe = client.clock_probe()
                results[rank] = (out["g"][0], out["g"][1].tobytes(), hello,
                                 isinstance(probe, int))
            finally:
                client.close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    old = os.environ.get("HOROVOD_CTRL_RELAY")
    os.environ["HOROVOD_CTRL_RELAY"] = f"127.0.0.1:{relay.port}"
    try:
        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        if old is None:
            os.environ.pop("HOROVOD_CTRL_RELAY", None)
        else:
            os.environ["HOROVOD_CTRL_RELAY"] = old
        relay.stop()
        accepted = getattr(coord, "accepted", None)
        coord.stop()
    assert not errors, errors
    return results, accepted


def test_relay_exchange_barrier_probe_equal_the_jax_relay():
    got, accepted = _relay_world(PE, PR)
    want, _ = _relay_world(JE, JR)
    assert got == want
    assert got[0][0] is None and got[0][2] == {"peers": None}
    assert accepted == 1                  # one upstream for the host


def _drops(emod, rmod) -> list:
    coord = emod._Coordinator(3, "127.0.0.1", 0, key=KEY)
    port = coord.server.getsockname()[1]
    coord.start()
    relay = rmod.CoordRelay(KEY)
    try:
        def dial(rank):
            s = socket.create_connection(("127.0.0.1", relay.port),
                                         timeout=10)
            emod._send_msg(s, {"kind": "relay_hello", "rank": rank,
                               "local": 2, "coord": ["127.0.0.1", port]}, KEY)
            emod._recv_msg(s, KEY)
            return s

        def dead_after(cond) -> list:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with coord._cv:
                    if cond(coord._dead):
                        break
                time.sleep(0.05)
            time.sleep(0.3)      # nothing more may die
            with coord._cv:
                return sorted(coord._dead)

        s0, s1 = dial(0), dial(1)
        emod._send_msg(s0, {"kind": "bye"}, KEY)   # clean
        s0.close()
        s1.close()                                 # unclean: no bye
        first = dead_after(bool)
        # the relay's own unclean death fails every rank it declared
        raw = socket.create_connection(("127.0.0.1", port), timeout=10)
        emod._send_msg(raw, {"kind": "relay_hello", "ranks": [2]}, KEY)
        emod._recv_msg(raw, KEY)
        raw.close()
        return [first, dead_after(lambda d: 2 in d)]
    finally:
        relay.stop()
        coord.stop()


def test_unclean_local_drop_fails_exactly_that_rank():
    got = _drops(PE, PR)
    assert got == _drops(JE, JR)
    assert got == [[1], [1, 2]]
