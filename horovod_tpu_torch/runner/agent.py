"""Per-host agent daemon — the remote-spawn leg of the launcher.

The reference's launcher materializes workers on remote machines through a
resident execution service: `horovod.spark.run()` spawns a Spark job whose
executors register back and accept `RunCommandRequest`s from the driver
(reference spark/__init__.py:61-77, spark/task/task_service.py:53-152); the
mpirun path reaches remote hosts through the rsh agent
(spark/driver/mpirun_rsh.py:24-43). Here the resident service is explicit:
each host runs ONE `hvd-agent` daemon (``python -m horovod_tpu_torch.runner.agent``)
and the driver contacts every agent over the HMAC-authenticated TCP protocol
(network.py) to spawn, poll, and kill that host's worker processes.

Orphan policy (three independent layers, each sufficient on its own):

1. Job lifetime is tied to the driver's TCP connection: the driver keeps one
   persistent connection per agent for the whole job; when it closes for any
   reason (clean exit, crash, network partition) the agent terminates the
   job's worker trees (`on_disconnect`).
2. Workers run a parent-death watchdog (task_main/task_exec): if the agent
   itself dies, every worker notices its ppid change and exits within ~1 s.
3. Explicit `kill` requests from the driver's `finally` block.

Security: anyone holding the agent secret can execute arbitrary commands on
the host (same trust model as sshd with an authorized key). The secret is
never sent on the wire — both sides prove possession via HMAC over each
message. Start the agent with `--secret-file` (or HOROVOD_AGENT_SECRET hex).

The port's own copy of ``horovod_tpu.runner.agent``, with the same protocol.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
from typing import Any, Optional

from .network import BasicService, derive_key
from .proc_tree import terminate_trees
from .service import host_hash

DEFAULT_AGENT_PORT = 9009


class HostAgent(BasicService):
    """Spawn/poll/kill service for one host's workers.

    Protocol (request ``kind`` → response):

    - ``ping`` → ``{ok, host_hash, jobs}`` — health + identity probe.
    - ``metrics`` → ``{ok, host_hash, jobs, workers_running,
      workers_spawned_total, workers_exited_nonzero_total}`` — host-level
      telemetry for the driver's pod view (docs/metrics.md).
    - ``spawn`` ``{job_id, workers: [{index, argv, env}], cwd?, extend?}`` →
      ``{ok, pids}`` — start one process per entry, each in its own session
      (so `proc_tree.terminate_trees` can reap whole trees). With
      ``extend`` the workers are ADDED to an existing job (same owner and
      derived secret) — how an elastic job grows a host's slot set
      mid-run without re-keying the world.
    - ``poll`` ``{job_id}`` → ``{ok, workers: [{index, pid, returncode}]}``.
    - ``kill`` ``{job_id}`` → ``{ok}`` — terminate the job's worker trees.
    - ``telemetry`` ``{cmd: start|stop, job_id, flight_dir?, trace_dir?,
      interval_s?, expected_ranks?}`` → ``{ok, port, host}`` — host a
      telemetry-tree agent (telemetry/agent.py) for the job, keyed with the
      same derived job secret the workers hold, so the job's ranks can push
      metric deltas and probe the host clock without extra key exchange.
      The telemetry agent's lifetime is the job's: ``kill`` and driver
      disconnect stop it with the workers.
    - ``ctrl`` ``{cmd: start|stop, job_id, root?, relay?, ckpt_dir?}`` →
      ``{ok, port, host[, relay_port]}`` — host a control-tree leader
      (ctrl/agent.py ControlAgent) for the job, keyed with the same
      derived job secret. ``root`` is the driver service's address list;
      the leader batches its ranks' rendezvous/poll traffic into one
      upstream connection and serves checkpoint streaming from
      ``ckpt_dir``; ``relay`` also starts its eager-engine coordinator
      relay (ctrl/relay.py), whose loopback address the job's workers
      get as ``HOROVOD_CTRL_RELAY``. Same lifetime discipline as the
      telemetry agent.
    """

    def __init__(self, key: bytes, host: str = "0.0.0.0", port: int = 0) -> None:
        super().__init__(key, host=host, port=port)
        self._jobs_lock = threading.Lock()
        # job_id -> {"procs": {index: Popen}, "owner": client_addr}
        self._jobs: dict[str, dict] = {}
        self._spawned_total = 0
        self._exited_nonzero_total = 0
        self._exit_counted: set[int] = set()  # pids already tallied
        # job_id -> TelemetryAgent (hosted for that job's ranks)
        self._telemetry: dict[str, Any] = {}
        # job_id -> ControlAgent (control-tree host leader)
        self._ctrl: dict[str, Any] = {}

    def handle(self, req: Any, client_addr) -> Any:
        kind = req.get("kind")
        if kind == "ping":
            with self._jobs_lock:
                njobs = len(self._jobs)
            return {"ok": True, "host_hash": host_hash(), "jobs": njobs}
        if kind == "spawn":
            return self._spawn(req, client_addr)
        if kind == "metrics":
            with self._jobs_lock:
                running = sum(
                    1 for job in self._jobs.values()
                    for p in job["procs"].values() if p.poll() is None)
                return {"ok": True, "host_hash": host_hash(),
                        "jobs": len(self._jobs),
                        "workers_running": running,
                        "workers_spawned_total": self._spawned_total,
                        "workers_exited_nonzero_total":
                            self._exited_nonzero_total}
        if kind == "poll":
            with self._jobs_lock:
                job = self._jobs.get(req["job_id"])
                if job is None:
                    return {"ok": False, "error": f"unknown job {req['job_id']!r}"}
                workers = [{"index": i, "pid": p.pid, "returncode": p.poll()}
                           for i, p in sorted(job["procs"].items())]
                for w in workers:
                    if w["returncode"] not in (None, 0) \
                            and w["pid"] not in self._exit_counted:
                        self._exit_counted.add(w["pid"])
                        self._exited_nonzero_total += 1
            return {"ok": True, "workers": workers}
        if kind == "kill":
            self._kill_job(req["job_id"])
            return {"ok": True}
        if kind == "telemetry":
            return self._telemetry_cmd(req, client_addr)
        if kind == "ctrl":
            return self._ctrl_cmd(req, client_addr)
        return {"ok": False, "error": f"unknown request {kind}"}

    def _telemetry_cmd(self, req: Any, client_addr) -> Any:
        job_id = str(req.get("job_id", ""))
        cmd = req.get("cmd", "start")
        if cmd == "stop":
            self._stop_telemetry(job_id)
            return {"ok": True}
        if cmd != "start":
            return {"ok": False, "error": f"unknown telemetry cmd {cmd!r}"}
        with self._jobs_lock:
            ta = self._telemetry.get(job_id)
            if ta is not None:   # idempotent: re-start returns the live one
                return {"ok": True, "port": ta.port, "host": ta.host_name}
        from ..telemetry.agent import TelemetryAgent

        job_secret = derive_key(self.key, b"hvd-job:" + job_id.encode())
        try:
            ta = TelemetryAgent(
                job_secret,
                flight_dir=req.get("flight_dir") or None,
                trace_dir=req.get("trace_dir") or None,
                interval_s=req.get("interval_s"),
                expected_ranks=req.get("expected_ranks"))
        except Exception as e:
            return {"ok": False,
                    "error": f"telemetry agent failed on {host_hash()}: {e}"}
        with self._jobs_lock:
            live = self._telemetry.get(job_id)
            if live is not None:   # lost the race; keep the first
                ta.stop()
                return {"ok": True, "port": live.port, "host": live.host_name}
            self._telemetry[job_id] = ta
        return {"ok": True, "port": ta.port, "host": ta.host_name}

    def _stop_telemetry(self, job_id: str) -> None:
        with self._jobs_lock:
            ta = self._telemetry.pop(job_id, None)
        if ta is not None:
            try:
                ta.stop()
            except Exception:
                pass

    def _ctrl_cmd(self, req: Any, client_addr) -> Any:
        # Same idempotent/race-safe hosting discipline as _telemetry_cmd:
        # re-start returns the live leader, a construction race keeps the
        # first instance, and job kill / driver disconnect stop it.
        job_id = str(req.get("job_id", ""))
        cmd = req.get("cmd", "start")
        if cmd == "stop":
            self._stop_ctrl(job_id)
            return {"ok": True}
        if cmd != "start":
            return {"ok": False, "error": f"unknown ctrl cmd {cmd!r}"}
        from ..ctrl.agent import ControlAgent

        def answer(agent) -> dict:
            out = {"ok": True, "port": agent.port, "host": agent.host_name}
            if req.get("relay"):
                out["relay_port"] = agent.relay_port()
            return out

        with self._jobs_lock:
            ca = self._ctrl.get(job_id)
            if ca is not None:
                return answer(ca)
        job_secret = derive_key(self.key, b"hvd-job:" + job_id.encode())
        ca = None
        try:
            ca = ControlAgent(job_secret,
                              ckpt_dir=req.get("ckpt_dir") or None)
            if req.get("root"):
                ca.attach_root([(h, int(p)) for h, p in req["root"]])
            if req.get("relay"):
                ca.relay_port()
        except Exception as e:
            if ca is not None:
                ca.stop()
            return {"ok": False,
                    "error": f"control agent failed on {host_hash()}: {e}"}
        with self._jobs_lock:
            live = self._ctrl.get(job_id)
            if live is not None:   # lost the race; keep the first
                ca.stop()
                return answer(live)
            self._ctrl[job_id] = ca
        return answer(ca)

    def _stop_ctrl(self, job_id: str) -> None:
        with self._jobs_lock:
            ca = self._ctrl.pop(job_id, None)
        if ca is not None:
            try:
                ca.stop()
            except Exception:
                pass

    def _spawn(self, req: Any, client_addr) -> Any:
        job_id = req["job_id"]
        cwd = req.get("cwd") or None
        procs: dict[int, subprocess.Popen] = {}
        # Per-job worker secret, derived locally from the agent secret and
        # job id (network.derive_key) — the driver derives the same value
        # (RemoteSpawner.job_secret), so it never crosses the unencrypted
        # channel in worker env.
        job_secret = derive_key(self.key, b"hvd-job:" + str(job_id).encode())
        # Control tree: if this job has a local control agent, point the
        # workers' runner-plane traffic at it (loopback, only when it
        # actually has a root to forward to) and, when its engine relay is
        # running, their coordinator hop too, unless the driver pinned
        # something else.
        with self._jobs_lock:
            ca = self._ctrl.get(job_id)
        relay_addr = ctrl_addr = ""
        if ca is not None:
            if ca.has_root():
                ctrl_addr = json.dumps([["127.0.0.1", ca.port]])
            if ca.relay_running():
                relay_addr = f"127.0.0.1:{ca.relay_port()}"
        try:
            for w in req["workers"]:
                env = dict(os.environ)
                env.update(w.get("env") or {})
                env["HOROVOD_SECRET"] = job_secret.hex()
                if ctrl_addr:
                    env.setdefault("HOROVOD_CTRL_ADDRS", ctrl_addr)
                if relay_addr:
                    env.setdefault("HOROVOD_CTRL_RELAY", relay_addr)
                # Lets the worker's watchdog detect a parent that died
                # before its first ppid snapshot (task_main.watch_parent).
                env["HVD_PARENT_PID"] = str(os.getpid())
                # Own session per worker: abort signals the whole group, so
                # grandchildren (data loaders, shells) die too.
                procs[w["index"]] = subprocess.Popen(
                    list(w["argv"]), env=env, cwd=cwd, start_new_session=True)
        except OSError as e:
            terminate_trees(list(procs.values()))
            return {"ok": False, "error": f"spawn failed on {host_hash()}: {e}"}
        with self._jobs_lock:
            job = self._jobs.get(job_id)
            if job is not None and not req.get("extend"):
                terminate_trees(list(procs.values()))
                return {"ok": False, "error": f"job {job_id!r} already exists"}
            if job is not None:
                if job["owner"] != client_addr:
                    # extend is same-driver only: a different connection
                    # must not append workers to a job it doesn't own.
                    terminate_trees(list(procs.values()))
                    return {"ok": False,
                            "error": f"job {job_id!r} owned by another driver"}
                dup = set(job["procs"]) & set(procs)
                if dup:
                    terminate_trees(list(procs.values()))
                    return {"ok": False,
                            "error": f"job {job_id!r} already has worker "
                                     f"indices {sorted(dup)}"}
                job["procs"].update(procs)
            else:
                self._jobs[job_id] = {"procs": procs, "owner": client_addr}
            self._spawned_total += len(procs)
        return {"ok": True, "pids": [p.pid for p in procs.values()]}

    def _kill_job(self, job_id: str) -> None:
        with self._jobs_lock:
            job = self._jobs.pop(job_id, None)
        self._stop_telemetry(job_id)
        self._stop_ctrl(job_id)
        if job is not None:
            terminate_trees(list(job["procs"].values()))

    def on_disconnect(self, client_addr) -> None:
        """Driver connection gone — reap every job it owned (layer 1 of the
        orphan policy)."""
        with self._jobs_lock:
            owned = [jid for jid, job in self._jobs.items()
                     if job["owner"] == client_addr]
        for jid in owned:
            self._kill_job(jid)

    def stop(self) -> None:
        with self._jobs_lock:
            jobs = list(self._jobs)
            tele = list(self._telemetry)
            ctrl = list(self._ctrl)
        for jid in jobs:
            self._kill_job(jid)
        for jid in tele:
            self._stop_telemetry(jid)
        for jid in ctrl:
            self._stop_ctrl(jid)
        super().stop()


def _load_secret(secret_file: Optional[str]) -> bytes:
    if secret_file:
        with open(secret_file, "rb") as f:
            data = f.read().strip()
        # Accept raw bytes or hex text.
        try:
            return bytes.fromhex(data.decode())
        except (UnicodeDecodeError, ValueError):
            return data
    hex_secret = os.environ.get("HOROVOD_AGENT_SECRET")
    if hex_secret:
        return bytes.fromhex(hex_secret)
    raise SystemExit(
        "hvd-agent: no secret. Pass --secret-file or set HOROVOD_AGENT_SECRET "
        "(hex). Generate one with: python -c \"import secrets; "
        "print(secrets.token_bytes(32).hex())\"")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner.agent",
        description="Resident per-host worker-spawn agent for hvdrun -H.")
    parser.add_argument("--port", type=int, default=DEFAULT_AGENT_PORT,
                        help=f"listen port (0 = random; default {DEFAULT_AGENT_PORT})")
    parser.add_argument("--host", default="0.0.0.0", help="bind address")
    parser.add_argument("--secret-file", default=None,
                        help="file holding the shared agent secret (hex or raw)")
    args = parser.parse_args(argv)

    agent = HostAgent(_load_secret(args.secret_file), host=args.host, port=args.port)
    # Fault injection (tests / elastic smoke): HOROVOD_FAULT_AGENT_EXIT_AFTER_S
    # hard-exits this agent after a delay, modeling sudden host loss.
    from ..elastic.fault import start_agent_fault_timer

    start_agent_fault_timer()
    # Machine-readable readiness line: launch scripts / tests wait for it.
    print(json.dumps({"agent": "ready", "port": agent.port,
                      "host_hash": host_hash()}), flush=True)
    try:
        threading.Event().wait()  # serve until killed
    except KeyboardInterrupt:
        pass
    finally:
        agent.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
