"""Elastic launcher orchestration, the driver side: the port's own copy of
``horovod_tpu.elastic.driver``.

``launch_elastic`` (exposed as ``horovod_tpu_torch.runner.run_elastic``)
owns the job across membership changes:

- a **slot pool** materializes workers: :class:`LocalSlotPool` spawns local
  processes (the ``run()`` local leg), :class:`AgentSlotPool` spawns through
  resident per-host ``hvd-agent`` daemons (the ``-H`` leg, extended with an
  incremental-spawn request so one job can grow).
- a supervision loop polls worker liveness, the
  :class:`~.discovery.HostDiscovery` hook, and the
  :class:`~..runner.service.ElasticDriverService` membership; a
  dead worker (non-zero exit, clean exit without a result, lost agent) or a
  discovery change starts a new generation: failed slots are respawned
  under FRESH task indices (so rank 0 — assigned oldest-member-first — is
  always a survivor carrying committed state) or their host blacklisted
  after repeated failures (:class:`~.discovery.Blacklist`). A reset that
  changes no membership (a live member's collective failed or timed out,
  and it registered for the next generation) opens a generation over the
  same live members, which the JAX driver never does.
- every membership event lands in the **elastic event log** (structured,
  JSONL at ``HOROVOD_ELASTIC_EVENT_LOG``; docs/elastic.md explains how to
  read it) and in the driver-process metrics registry.

Each worker's env carries ``HOROVOD_DEVICE_ORDINAL``, its slot's ordinal on
its host: ``init`` puts the process on that GPU, so a survivor keeps its
card across resets (the ranks of a new generation renumber the local
ranks) and a respawned worker takes the card of the slot it replaces.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Optional

from ..metrics import registry as _registry
from ..utils.logging import log
from .discovery import Blacklist, HostDiscovery, StaticDiscovery

_POLL_S = 0.1


class ElasticEventLog:
    """Append-only membership event record. Always logged; mirrored as
    JSONL to ``HOROVOD_ELASTIC_EVENT_LOG`` when set (the artifact
    troubleshooting tells a reset-surprised user to read)."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path if path is not None \
            else os.environ.get("HOROVOD_ELASTIC_EVENT_LOG", "")
        self.events: list[dict] = []

    def emit(self, event: str, **detail: Any) -> None:
        rec = {"time_unix_s": time.time(), "event": event, **detail}
        self.events.append(rec)
        log("info", f"elastic: {event} "
            + " ".join(f"{k}={v}" for k, v in detail.items()))
        if self.path:
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:   # telemetry must never kill the job
                pass


class _Slot:
    __slots__ = ("key", "host", "index")

    def __init__(self, key: str, host: str, index: int) -> None:
        self.key = key      # stable slot identity ("host:ordinal")
        self.host = host    # host component (blacklist granularity, agents)
        self.index = index  # task index of the CURRENT incarnation

    def env(self, env: Optional[dict]) -> dict:
        """The job's worker env plus this slot's device ordinal."""
        return {**(env or {}),
                "HOROVOD_DEVICE_ORDINAL": self.key.rsplit(":", 1)[1]}


class LocalSlotPool:
    """Workers as local child processes (one pseudo-host per slot: a local
    slot stands in for a host, so blacklisting works per slot — the same
    convention the agent tests use for faked hosts)."""

    def __init__(self, driver, secret: bytes, env: Optional[dict],
                 python: Optional[str]) -> None:
        self._driver = driver
        self._secret = secret
        self._env = env
        self._python = python or sys.executable
        self._procs: dict[int, Any] = {}

    def blame_keys(self, slot: _Slot) -> list:
        return [slot.key]

    def spawn(self, slot: _Slot) -> None:
        from ..runner import _spawn_worker

        self._procs[slot.index] = _spawn_worker(
            slot.index, self._driver.addresses(), self._secret,
            [self._python, "-m", "horovod_tpu_torch.runner.task_main"],
            slot.env(self._env))

    def poll(self) -> dict:
        return {i: p.poll() for i, p in self._procs.items()}

    def kill(self, indices) -> None:
        from ..runner.proc_tree import terminate_trees

        terminate_trees([self._procs[i] for i in indices if i in self._procs])

    def close(self) -> None:
        self.kill(list(self._procs))


class AgentSlotPool:
    """Workers through resident hvd-agents (the remote leg). One persistent
    authenticated connection per host; slots spawn incrementally into a
    single job id (agent ``spawn`` with ``extend``), so membership can grow
    without re-deriving the job secret. An unreachable agent reads as every
    one of its slots dying at once (its workers self-terminate via the
    parent-death watchdog) and bans the host outright."""

    def __init__(self, driver, agent_secret: bytes, agent_port: Optional[int],
                 env: Optional[dict], python: Optional[str]) -> None:
        import secrets as _secrets

        self._driver = driver
        self._agent_secret = agent_secret
        self._agent_port = agent_port
        self._env = env
        self._python = python or sys.executable
        self.job_id = _secrets.token_hex(8)
        self._clients: dict[str, Any] = {}      # host -> BasicClient | None
        self._host_indices: dict[str, set] = {}  # host -> task indices
        self._last_codes: dict[int, Optional[int]] = {}
        # Control tree: set via enable_control() before spawns; each host's
        # leader starts lazily with its first slot, so hosts joining
        # mid-run (discovery) get one too.
        self._ctrl_root: Optional[list] = None
        self._ctrl_ckpt_dir = ""
        self._ctrl_started: set[str] = set()

    def enable_control(self, root_addrs, ckpt_dir: str = "") -> None:
        """Route every host's rank traffic through a ControlAgent leader
        (started on first spawn per host) instead of rank-to-root."""
        self._ctrl_root = [list(a) for a in root_addrs]
        self._ctrl_ckpt_dir = ckpt_dir

    def _start_control(self, host: str, client) -> None:
        if self._ctrl_root is None or host in self._ctrl_started:
            return
        try:
            resp = client.request({
                "kind": "ctrl", "cmd": "start", "job_id": self.job_id,
                "root": self._ctrl_root, "relay": True,
                "ckpt_dir": self._ctrl_ckpt_dir})
        except (ConnectionError, OSError) as e:
            resp = {"ok": False, "error": str(e)}
        if resp.get("ok"):
            self._ctrl_started.add(host)
        else:
            log("warning",
                f"[ctrl] control leader failed to start on {host}: "
                f"{resp.get('error')} — that host's workers use the flat "
                "control plane")

    def job_secret(self) -> bytes:
        from ..runner.network import derive_key

        return derive_key(self._agent_secret,
                          b"hvd-job:" + self.job_id.encode())

    def _client(self, host: str):
        from ..runner.agent import DEFAULT_AGENT_PORT
        from ..runner.network import BasicClient

        if host not in self._clients:
            name, _, port = host.partition("@")
            client = BasicClient(
                [(name, int(port) if port else
                  (self._agent_port or DEFAULT_AGENT_PORT))],
                self._agent_secret, timeout=30.0)
            pong = client.request({"kind": "ping"})
            if not pong.get("ok"):
                raise RuntimeError(f"agent on {host} rejected ping: {pong}")
            self._clients[host] = client
        if self._clients[host] is None:
            raise ConnectionError(f"agent on {host} is gone")
        return self._clients[host]

    def blame_keys(self, slot: _Slot) -> list:
        return [slot.key, slot.host]

    def spawn(self, slot: _Slot) -> None:
        from ..runner import _worker_env

        env = _worker_env(slot.index, self._driver.addresses(), None,
                          slot.env(self._env))
        client = self._client(slot.host)
        self._start_control(slot.host, client)
        resp = client.request({
            "kind": "spawn", "job_id": self.job_id, "extend": True,
            "workers": [{"index": slot.index,
                         "argv": [self._python, "-m",
                                  "horovod_tpu_torch.runner.task_main"],
                         "env": env}]})
        if not resp.get("ok"):
            raise RuntimeError(
                f"agent on {slot.host} failed to spawn: {resp.get('error')}")
        self._host_indices.setdefault(slot.host, set()).add(slot.index)
        self._last_codes[slot.index] = None

    def poll(self) -> dict:
        codes = dict(self._last_codes)
        for host, indices in self._host_indices.items():
            if self._clients.get(host) is None:
                continue
            try:
                resp = self._clients[host].request(
                    {"kind": "poll", "job_id": self.job_id})
            except (ConnectionError, OSError):
                # Lost agent = lost host: every slot on it reads as dead
                # with a sentinel code; the orchestrator bans the host.
                self._clients[host] = None
                for i in indices:
                    codes[i] = codes[i] if codes[i] is not None else -9
                continue
            if resp.get("ok"):
                for w in resp["workers"]:
                    if w["index"] in indices:
                        codes[w["index"]] = w["returncode"]
        self._last_codes = codes
        return codes

    def lost_hosts(self) -> list:
        return sorted(h for h, c in self._clients.items() if c is None)

    def kill(self, indices) -> None:
        # Agents key kills by job, not worker; individual removals happen
        # via the rendezvous protocol (the worker exits on removal). A
        # whole-job kill is only issued from close().
        pass

    def close(self) -> None:
        for host, client in self._clients.items():
            if client is None:
                continue
            try:
                client.request({"kind": "kill", "job_id": self.job_id})
            except (ConnectionError, OSError):
                pass
            try:
                client.close()
            except OSError:
                pass
        self._clients.clear()


def _desired_slot_keys(hosts: list, blacklist: Blacklist,
                       max_np: Optional[int]) -> list:
    """Expand ``[(host, slots)]`` into stable slot keys, dropping
    blacklisted hosts/slots and capping at ``max_np``."""
    keys = []
    for host, slots in hosts:
        if blacklist.is_blacklisted(host):
            continue
        for i in range(int(slots)):
            key = f"{host}:{i}"
            if not blacklist.is_blacklisted(key):
                keys.append(key)
    return keys[:max_np] if max_np else keys


def launch_elastic(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
                   num_proc: Optional[int] = None, min_np: int = 1,
                   max_np: Optional[int] = None, env: Optional[dict] = None,
                   timeout: float = 600.0,
                   discovery: Optional[HostDiscovery] = None,
                   python: Optional[str] = None,
                   hosts=None, agent_port: Optional[int] = None,
                   agent_secret: Optional[bytes] = None) -> list:
    """Supervise an elastic job to completion; returns per-rank results of
    the final generation (see runner.run_elastic docstring)."""
    from ..runner.network import make_secret
    from ..runner.service import ElasticDriverService

    env = dict(env or {})
    env.setdefault("HOROVOD_ELASTIC", "1")
    # A dead peer must surface as a Python-visible failure on survivors: a
    # collective waits at most HOROVOD_STALL_SHUTDOWN_TIME for a peer (the
    # process group's timeout under HOROVOD_ELASTIC, common/basics.py).
    for var, default in (("HOROVOD_STALL_CHECK_TIME", "10"),
                         ("HOROVOD_STALL_SHUTDOWN_TIME", "30")):
        if var not in env and var not in os.environ:
            env[var] = default

    def knob(name: str, default: str) -> str:
        # Driver-side knobs honor the job's env= dict too: callers naturally
        # put every HOROVOD_ELASTIC_* setting there, and the blacklist /
        # discovery cadence / event log live in THIS process.
        return env.get(name) or os.environ.get(name) or default

    events = ElasticEventLog(path=knob("HOROVOD_ELASTIC_EVENT_LOG", ""))
    blacklist = Blacklist(
        threshold=int(knob("HOROVOD_ELASTIC_BLACKLIST_THRESHOLD", "2")))
    reg = _registry()
    added_c = reg.counter("horovod_elastic_workers_added_total",
                          help="workers added to the elastic job")
    removed_c = reg.counter("horovod_elastic_workers_removed_total",
                            help="workers removed from the elastic job")
    gen_gauge = reg.gauge("horovod_elastic_generation",
                          help="current elastic rendezvous generation")
    black_gauge = reg.gauge("horovod_elastic_blacklisted_hosts",
                            help="hosts/slots currently blacklisted")

    if hosts is not None:
        from ..runner.remote import parse_hosts

        if agent_secret is None:
            hex_secret = os.environ.get("HOROVOD_AGENT_SECRET")
            if not hex_secret:
                raise ValueError(
                    "elastic multi-host launch needs the agent secret: pass "
                    "agent_secret= or set HOROVOD_AGENT_SECRET (hex)")
            agent_secret = bytes.fromhex(hex_secret)
        specs = parse_hosts(hosts, agent_port)
        initial_hosts = [(f"{s.host}@{s.agent_port}", s.slots) for s in specs]
        driver = ElasticDriverService(b"\0" * 32, fn=fn, args=args,
                                      kwargs=kwargs)
        pool = AgentSlotPool(driver, agent_secret, agent_port, env, python)
        # Workers authenticate with the per-job derived secret (the agents
        # derive the same value and inject it into worker env; it never
        # crosses the wire) — re-key the driver service before any worker
        # can connect (spawns happen strictly later).
        driver.key = pool.job_secret()
        # Control tree: per-host leaders fold rendezvous and elastic-poll
        # traffic into one upstream connection per host, and serve
        # checkpoint streaming to cold-starting joiners.
        from ..ctrl.tree import use_tree

        world = sum(int(s.slots) for s in specs)
        if use_tree(len(specs), world):
            pool.enable_control(
                driver.addresses(),
                ckpt_dir=knob("HOROVOD_CKPT_STREAM_DIR", ""))
    else:
        num_proc = num_proc or os.cpu_count() or 1
        if num_proc < 1:
            raise ValueError(f"num_proc must be >= 1, got {num_proc}")
        initial_hosts = [("local", num_proc)]
        secret = make_secret()
        driver = ElasticDriverService(secret, fn=fn, args=args, kwargs=kwargs)
        pool = LocalSlotPool(driver, secret, env, python)

    if discovery is None:
        discovery = StaticDiscovery(initial_hosts)
    discovery_interval = float(
        knob("HOROVOD_ELASTIC_DISCOVERY_INTERVAL", "1.0"))

    slots: dict[str, _Slot] = {}
    done: dict[int, tuple] = {}   # index -> (rank, value) of ok results seen
    failed: dict[str, Optional[int]] = {}   # slot key -> its last exit code
    next_index = 0

    def spawn_key(key: str) -> None:
        nonlocal next_index
        slot = _Slot(key, key.rsplit(":", 1)[0], next_index)
        next_index += 1
        pool.spawn(slot)
        slots[key] = slot
        added_c.inc()
        events.emit("worker_spawned", slot=key, index=slot.index)

    def reform(reason: str) -> None:
        expected = {s.index for s in slots.values() if s.index not in done}
        if not expected and done:
            return  # every remaining slot already delivered a result
        if len(expected) < min_np:
            exits = ", ".join(f"{k} exited with {rc}"
                              for k, rc in sorted(failed.items()))
            raise RuntimeError(
                f"elastic job fell below min_np={min_np} "
                f"({len(expected)} live slots; blacklisted: "
                f"{blacklist.blacklisted()}; last failures: "
                f"{exits or 'none'})")
        driver.begin_reset(expected)
        events.emit("rendezvous_opened", reason=reason,
                    expected=sorted(expected))

    def harvest(m: dict) -> None:
        """Fold the membership snapshot's results into ``done`` (ok) or
        raise (a non-resettable failure in user code aborts the job)."""
        index_by_rank = {r: i for i, r in m["ranks"].items()}
        failures = {}
        for rank, payload in m["results"].items():
            if isinstance(payload, dict) and not payload.get("ok", True):
                failures[rank] = payload.get("error", "unknown")
            else:
                idx = index_by_rank.get(rank)
                if idx is not None:
                    done.setdefault(idx, (rank, payload))
        if failures:
            rank, tb = sorted(failures.items())[0]
            raise RuntimeError(
                f"task on rank {rank} failed"
                f" (and {len(failures) - 1} more):\n{tb}")

    try:
        for key in _desired_slot_keys(discovery.probe() or initial_hosts,
                                      blacklist, max_np):
            spawn_key(key)
        if not slots:
            raise RuntimeError("no slots to launch (empty discovery?)")
        reform("initial formation")
        deadline = time.monotonic() + timeout
        next_probe = time.monotonic() + discovery_interval
        last_gen = 0
        while True:
            # Order matters: a worker reports its result strictly before it
            # exits, so polling process exits FIRST and reading driver
            # results SECOND guarantees a finished worker's result is
            # visible before its exit is judged — a clean exit without a
            # result is then always a real failure (never a race).
            codes = pool.poll()
            m = driver.membership()
            if m["generation"] != last_gen:
                last_gen = m["generation"]
                gen_gauge.set(last_gen)
                events.emit("rendezvous_complete", generation=last_gen,
                            size=len(m["ranks"]))
            harvest(m)
            live_pending = {s.index for s in slots.values()
                            if s.index not in done}
            if not live_pending and slots:
                break  # every current member delivered a result
            # -- liveness ----------------------------------------------------
            dead: list[_Slot] = []
            for slot in list(slots.values()):
                rc = codes.get(slot.index)
                if rc is None or slot.index in done:
                    continue  # running, or finished cleanly after reporting
                dead.append(slot)
            for host in (pool.lost_hosts()
                         if hasattr(pool, "lost_hosts") else ()):
                if blacklist.ban(host):
                    events.emit("host_blacklisted", host=host,
                                reason="agent unreachable")
            for slot in dead:
                del slots[slot.key]
                failed[slot.key] = codes.get(slot.index)
                removed_c.inc()
                events.emit("worker_failed", slot=slot.key, index=slot.index,
                            returncode=codes.get(slot.index))
                for key in pool.blame_keys(slot):
                    if blacklist.record_failure(key):
                        events.emit("host_blacklisted", host=key,
                                    reason=f"{blacklist.failures(key)} "
                                           "failures")
            black_gauge.set(len(blacklist.blacklisted()))
            # -- discovery ---------------------------------------------------
            if time.monotonic() >= next_probe:
                next_probe = time.monotonic() + discovery_interval
                probed = discovery.probe()
                if probed:
                    initial_hosts = probed
            desired = _desired_slot_keys(initial_hosts, blacklist, max_np)
            to_remove = [k for k in slots if k not in desired
                         and slots[k].index not in done]
            to_add = [k for k in desired if k not in slots]
            survivors_pending = [s for s in slots.values()
                                 if s.index not in done]
            if dead and not survivors_pending and not to_remove and done:
                # End-game: the failure hit while everyone else had already
                # finished; nobody is left to re-rendezvous with, and a
                # fresh replacement alone would restart from scratch. (Where
                # no worker has finished, every slot died: the slots are
                # respawned, a full-job restart that ElasticState's
                # checkpoint resumes, where the JAX driver ends the job.)
                events.emit("job_finished_degraded",
                            missing=[s.key for s in dead])
                break
            # A reset that changed no membership: a live member of the
            # current generation has registered for the next one (its
            # collective failed, or timed out past the stall time, with
            # every peer alive), and nothing else will open a generation.
            # The first such registration opens one over the live members;
            # the forming flag keeps the others' from opening more.
            reregistered = (m["pending"] & set(m["ranks"]) & {
                s.index for s in slots.values() if s.index not in done}) \
                - m["removed"]
            if dead or to_remove or to_add:
                for key in to_remove:
                    slot = slots.pop(key)
                    pool.kill([slot.index])
                    removed_c.inc()
                    events.emit("worker_removed", slot=key, index=slot.index,
                                reason="scale-down or blacklist")
                for key in to_add:
                    spawn_key(key)
                reform("membership changed: "
                       f"{len(dead)} dead, {len(to_remove)} removed, "
                       f"{len(to_add)} added")
            elif reregistered and not m["forming"]:
                reform("reset without a change of membership: "
                       f"{sorted(reregistered)} re-registered")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic job incomplete after {timeout}s "
                    f"(generation {m['generation']}, "
                    f"{len(done)}/{len(slots)} results)")
            time.sleep(_POLL_S)
        _emit_elastic_pod_metrics(driver, events, blacklist, last_gen)
        ordered = sorted(done.values(), key=lambda rv: rv[0])
        return [_unwrap(v) for _, v in ordered]
    finally:
        pool.close()
        driver.stop()


def _unwrap(payload: Any) -> Any:
    return payload["value"] if isinstance(payload, dict) and "value" in payload \
        else payload


def _emit_elastic_pod_metrics(driver, events: ElasticEventLog,
                              blacklist: Blacklist, generation: int) -> None:
    """Pod snapshot to HOROVOD_METRICS_SNAPSHOT (the run() contract) with
    the driver's elastic view attached under info.elastic. Never fatal."""
    path = os.environ.get("HOROVOD_METRICS_SNAPSHOT", "")
    try:
        pod = driver.pod_metrics()
        if pod is None:
            return
        pod["info"]["elastic"] = {
            "generation": generation,
            "blacklisted": blacklist.blacklisted(),
            "events": [e["event"] for e in events.events],
        }
        # Telemetry-tree coverage, when host leaders were pushing through
        # the tree: per-host snapshot age + expected ranks, so the final
        # snapshot records which hosts were still reporting at the end.
        if driver._telemetry is not None:
            pod["info"]["elastic"]["telemetry"] = driver._telemetry.staleness()
        if path:
            with open(path, "w") as f:
                json.dump(pod, f, indent=2)
        key = "horovod_elastic_resets_total"
        log("debug",
            f"elastic pod metrics: generation {generation}, "
            f"{pod['counters'].get(key, 0):.0f} worker resets"
            + (f" -> {path}" if path else ""))
    except Exception as e:  # pragma: no cover - telemetry must not kill jobs
        log("warning", f"elastic pod metrics emission failed: {e}")
