"""Host discovery + blacklist for elastic jobs: the port's own copy of
``horovod_tpu.elastic.discovery``.

Upstream Horovod's elastic mode learns the current host set from a
user-supplied ``--host-discovery-script`` (re-run periodically by the
driver) and blacklists hosts whose workers keep failing. Same contract
here, minus the CLI shell-out being the only option:

- :class:`HostDiscovery` — interface: ``probe()`` returns the *desired*
  ``[(host, slots), ...]`` right now. The elastic driver polls it every
  ``HOROVOD_ELASTIC_DISCOVERY_INTERVAL`` seconds and triggers a reset when
  the answer changes.
- :class:`StaticDiscovery` — a fixed list (the no-discovery default).
- :class:`ScriptDiscovery` — the ``--host-discovery-script`` analog: runs
  an executable that prints one ``host[:slots]`` per line.
- :class:`Blacklist` — failure bookkeeping per host key: after
  ``HOROVOD_ELASTIC_BLACKLIST_THRESHOLD`` (default 2) recorded failures a
  key is excluded from every future generation.
"""

from __future__ import annotations

import os
import subprocess
from typing import Iterable, Optional, Sequence


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class HostDiscovery:
    """Interface: the driver polls :meth:`probe` for the desired slot set."""

    def probe(self) -> list:   # pragma: no cover - interface
        """Return the currently-desired ``[(host, slots), ...]``."""
        raise NotImplementedError


class StaticDiscovery(HostDiscovery):
    """Fixed host set — elastic in the *fault tolerance* sense only (dead
    slots are respawned/blacklisted; nothing is ever added)."""

    def __init__(self, hosts: Sequence) -> None:
        self._hosts = [(str(h), int(s)) for h, s in hosts]

    def probe(self) -> list:
        return list(self._hosts)


class ScriptDiscovery(HostDiscovery):
    """Run ``script`` (any executable) and parse one ``host[:slots]`` per
    line — the ``horovodrun --host-discovery-script`` analog. A failing or
    hanging script yields the LAST good answer (never an empty world: a
    flaky discovery script must not scale the job to zero)."""

    def __init__(self, script: str, timeout: float = 10.0) -> None:
        self.script = script
        self.timeout = timeout
        self._last: list = []

    def probe(self) -> list:
        try:
            out = subprocess.run(
                [self.script], capture_output=True, text=True,
                timeout=self.timeout, check=True).stdout
        except (OSError, subprocess.SubprocessError):
            return list(self._last)
        hosts = parse_discovery_output(out)
        if hosts:
            self._last = hosts
        return list(self._last)


def parse_discovery_output(text: str) -> list:
    """``host[:slots]`` lines -> ``[(host, slots), ...]`` (slots default 1;
    blank lines and ``#`` comments ignored)."""
    hosts = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        host, _, slots = line.partition(":")
        try:
            hosts.append((host.strip(), int(slots) if slots.strip() else 1))
        except ValueError:
            continue
    return hosts


class Blacklist:
    """Failure counts per host key; a key past ``threshold`` failures is
    excluded from membership until the job ends (upstream Horovod's
    blacklisted-host set; the cooldown refinement arrived later)."""

    def __init__(self, threshold: Optional[int] = None) -> None:
        self.threshold = threshold if threshold is not None else _env_int(
            "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD", 2)
        self._failures: dict[str, int] = {}

    def record_failure(self, key: str) -> bool:
        """Count one failure; returns True when this pushed ``key`` over
        the threshold (i.e. it just became blacklisted)."""
        self._failures[key] = self._failures.get(key, 0) + 1
        return self._failures[key] == self.threshold

    def ban(self, key: str) -> bool:
        """Blacklist ``key`` immediately regardless of count (lost agent:
        the host is gone, not flaky). Returns True if newly blacklisted."""
        if self.is_blacklisted(key):
            return False
        self._failures[key] = max(self._failures.get(key, 0), self.threshold)
        return True

    def is_blacklisted(self, key: str) -> bool:
        return self._failures.get(key, 0) >= self.threshold

    def failures(self, key: str) -> int:
        return self._failures.get(key, 0)

    def blacklisted(self) -> list:
        return sorted(k for k, n in self._failures.items()
                      if n >= self.threshold)

    def filter(self, hosts: Iterable) -> list:
        """Drop blacklisted hosts from a ``[(host, slots), ...]`` list."""
        return [(h, s) for h, s in hosts if not self.is_blacklisted(h)]
