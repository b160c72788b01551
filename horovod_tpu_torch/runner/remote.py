"""Driver-side remote spawn: parse ``-H host1:4,host2:4``, contact each
host's resident agent (agent.py), ship worker commands, watch liveness.
The port's own copy of ``horovod_tpu.runner.remote``.

This is the reference's driver→task `RunCommandRequest` flow
(spark/task/task_service.py:53-152, spark/__init__.py:160-178) without
Spark: the driver holds one persistent authenticated connection per agent;
spawns that host's slots; polls agents every tick; an unreachable agent or a
crashed worker aborts the job with an actionable error, and cleanup kills
worker trees on every still-reachable agent (unreachable agents reap their
own via the connection-loss hook, agent.py on_disconnect).
"""

from __future__ import annotations

import secrets as _secrets
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

from .agent import DEFAULT_AGENT_PORT
from .network import BasicClient, derive_key


@dataclass(frozen=True)
class HostSpec:
    host: str
    slots: int
    agent_port: int = DEFAULT_AGENT_PORT


def parse_hosts(hosts: Union[str, Sequence],
                agent_port: Optional[int] = None) -> list[HostSpec]:
    """Parse a host spec into :class:`HostSpec` entries.

    String form matches the reference's ``-H host1:4,host2:4`` slot syntax
    (docs/running.md mpirun examples): ``host[:slots]`` entries separated by
    commas; an optional ``@port`` after the host overrides the agent port
    (``127.0.0.1@9001:2`` — used when several agents share one machine,
    e.g. tests). Bare IPv6 addresses contain colons, so they must be
    bracketed: ``[::1]:4`` or ``[fe80::1]@9009:2`` (an unbracketed ``::1:4``
    would be split at the first colon into nonsense). Also accepts a
    sequence of (host, slots) or (host, slots, agent_port) tuples /
    HostSpec instances.
    """
    default_port = agent_port or DEFAULT_AGENT_PORT
    specs: list[HostSpec] = []
    if isinstance(hosts, str):
        for entry in hosts.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("["):  # bracketed IPv6: [addr][@port][:slots]
                addr, bracket, rest = entry[1:].partition("]")
                if not bracket:
                    raise ValueError(
                        f"unterminated '[' in host spec entry {entry!r}; "
                        f"IPv6 form is [addr][@port][:slots]")
                rest, _, slots_s = rest.partition(":")
                junk, at, port_s = rest.partition("@")
                if junk or (at and not port_s):
                    # e.g. "[fe80::1]8000:2" (forgot the '@') — silently
                    # dropping `junk` would contact the default port instead
                    raise ValueError(
                        f"bad text {rest!r} after ']' in {entry!r}; "
                        f"expected [addr][@port][:slots]")
                host = addr
            else:
                if entry.count(":") > 1:
                    raise ValueError(
                        f"entry {entry!r} has multiple ':' — bracket IPv6 "
                        f"addresses like [::1]:4 so the slot count can be "
                        f"told apart from the address")
                host, _, slots_s = entry.partition(":")
                host, _, port_s = host.partition("@")
            if not host:
                raise ValueError(f"empty host in spec entry {entry!r}")
            try:
                slots = int(slots_s) if slots_s else 1
                port = int(port_s) if port_s else default_port
            except ValueError:
                raise ValueError(
                    f"bad host spec entry {entry!r}; expected host[@port][:slots]")
            if slots < 1:
                raise ValueError(f"slots must be >= 1 in {entry!r}")
            specs.append(HostSpec(host, slots, port))
    else:
        for entry in hosts:
            if isinstance(entry, HostSpec):
                specs.append(entry)
            else:
                host, slots, *rest = entry
                specs.append(HostSpec(host, int(slots),
                                      rest[0] if rest else default_port))
    if not specs:
        raise ValueError(f"no hosts in spec {hosts!r}")
    return specs


class RemoteSpawner:
    """One job's view of the agent fleet.

    Connects to every agent up front (fail fast with which host is missing),
    spawns each host's slice of the world, then serves as the launcher's
    liveness oracle: :meth:`liveness` returns an error string the moment an
    agent becomes unreachable or a worker exits non-zero.
    """

    def __init__(self, specs: Sequence[HostSpec], agent_secret: bytes,
                 connect_timeout: float = 30.0) -> None:
        self.specs = list(specs)
        self.agent_secret = agent_secret
        self.job_id = _secrets.token_hex(8)
        self._clients: list[Optional[BasicClient]] = []
        self._spawned = False
        for spec in self.specs:
            try:
                client = BasicClient([(spec.host, spec.agent_port)],
                                     agent_secret, timeout=connect_timeout)
                pong = client.request({"kind": "ping"})
            except (ConnectionError, OSError) as e:
                self.close()
                raise ConnectionError(
                    f"cannot reach hvd-agent on {spec.host}:{spec.agent_port} "
                    f"({e}); start one there with: python -m "
                    f"horovod_tpu_torch.runner.agent --secret-file <file>") from e
            if not pong.get("ok"):
                self.close()
                raise RuntimeError(f"agent on {spec.host} rejected ping: {pong}")
            self._clients.append(client)

    @property
    def num_proc(self) -> int:
        return sum(s.slots for s in self.specs)

    def job_secret(self) -> bytes:
        """The per-job worker secret, derived — never transmitted. The agent
        performs the same derivation and injects it into worker env
        (agent.py _spawn), so a passive observer of the unencrypted agent
        channel learns neither the agent secret nor the job secret."""
        return derive_key(self.agent_secret, b"hvd-job:" + self.job_id.encode())

    def spawn(self, make_argv: Callable[[int], list],
              make_env: Callable[[int], dict]) -> None:
        """Spawn the world: host i gets task indices
        [sum(slots[:i]), sum(slots[:i+1]))."""
        base = 0
        for spec, client in zip(self.specs, self._clients):
            workers = [{"index": base + j,
                        "argv": make_argv(base + j),
                        "env": make_env(base + j)}
                       for j in range(spec.slots)]
            resp = client.request({"kind": "spawn", "job_id": self.job_id,
                                   "workers": workers})
            if not resp.get("ok"):
                raise RuntimeError(
                    f"agent on {spec.host} failed to spawn: {resp.get('error')}")
            base += spec.slots
        self._spawned = True

    def liveness(self) -> Optional[str]:
        """Poll every agent once; None if healthy, else an actionable error."""
        for spec, client in zip(self.specs, self._clients):
            if client is None:
                continue
            try:
                resp = client.request({"kind": "poll", "job_id": self.job_id})
            except (ConnectionError, OSError) as e:
                return (f"hvd-agent on {spec.host}:{spec.agent_port} became "
                        f"unreachable ({e}); its workers self-terminate via "
                        f"the parent-death watchdog, aborting the job")
            if not resp.get("ok"):
                return f"agent on {spec.host}: {resp.get('error')}"
            for w in resp["workers"]:
                if w["returncode"] not in (None, 0):
                    return (f"worker index {w['index']} on {spec.host} exited "
                            f"with code {w['returncode']} before reporting a result")
        return None

    def start_control(self, root_addrs, ckpt_dir: str = "") -> None:
        """Start each host's control-tree leader (ctrl.ControlAgent), with
        the eager engine's coordinator relay, BEFORE :meth:`spawn`, so the
        agents can point worker env at both. ``root_addrs`` is the driver
        service's address list; ``ckpt_dir`` exports that directory for
        checkpoint streaming. A leader that fails to start only costs that
        host the tree (its workers keep the flat path) — logged loudly,
        never fatal."""
        from ..utils.logging import log

        for spec, client in zip(self.specs, self._clients):
            if client is None:
                continue
            try:
                resp = client.request({
                    "kind": "ctrl", "cmd": "start", "job_id": self.job_id,
                    "root": [list(a) for a in root_addrs],
                    "relay": True, "ckpt_dir": ckpt_dir})
            except (ConnectionError, OSError) as e:
                resp = {"ok": False, "error": str(e)}
            if not resp.get("ok"):
                log("warning",
                    f"[ctrl] control leader failed to start on {spec.host}: "
                    f"{resp.get('error')} — that host's workers use the "
                    "flat control plane")

    def poll_returncodes(self) -> Optional[list]:
        """Returncodes for all workers (None entries = still running), or
        None if any agent is unreachable."""
        codes: list = []
        for client in self._clients:
            try:
                resp = client.request({"kind": "poll", "job_id": self.job_id})
            except (ConnectionError, OSError):
                return None
            if not resp.get("ok"):
                return None
            codes.extend(w["returncode"] for w in resp["workers"])
        return codes

    def kill(self) -> None:
        if not self._spawned:
            return
        for client in self._clients:
            if client is None:
                continue
            try:
                client.request({"kind": "kill", "job_id": self.job_id})
            except (ConnectionError, OSError):
                pass  # dead agent reaped its workers on disconnect already

    def close(self) -> None:
        for client in self._clients:
            if client is not None:
                client.close()
        self._clients = [None] * len(self.specs)
