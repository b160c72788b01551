"""Transport-resilience policy: one deadline/retry/backoff implementation
for every socket the launcher and the elastic driver own; the port's own
copy of ``horovod_tpu.common.resilience`` (docs/troubleshooting.md, "my
ring keeps demoting to star").

- every socket op gets a per-attempt **deadline** (``HOROVOD_NETWORK_TIMEOUT``
  seconds, applied as the socket timeout by the callers) and a **retry
  budget** (``HOROVOD_NETWORK_RETRIES`` extra attempts). A receive that
  makes progress resets its budget — the deadline bounds *idle* time, not
  transfer time, so an MB-scale frame trickling over a congested link is
  not punished for being large.
- reconnect/poll loops share one **decorrelated-jitter** backoff
  (:class:`Backoff`, capped at ``HOROVOD_NETWORK_BACKOFF_MAX_MS``), so a
  whole pod retrying in lockstep cannot hammer a recovering peer at the
  same instants.
- every rung is observable: ``horovod_transport_retries_total`` (attempts
  absorbed in place), ``horovod_transport_timeouts_total`` (budgets
  exhausted) and ``horovod_frames_rejected_total`` (authentication
  failures: corrupt HMAC or replayed sequence numbers, treated as link
  faults, not crashes), in the port's ``metrics.registry()``.

Total patience per op is ``timeout_s * (1 + retries)`` — 120 s by default.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .config import _env_float, _env_int

# Defaults: 30 s idle deadline x (1 + 3) attempts = 120 s total patience,
# the pre-existing coordinator-client bound. The stall watchdog's 60 s
# warning fires inside that window, so a wedged link is *named* before it
# is given up on.
DEFAULT_TIMEOUT_S = 30.0
DEFAULT_RETRIES = 3
DEFAULT_BACKOFF_MAX_MS = 2000.0


@dataclass(frozen=True)
class Policy:
    """One transport policy: per-attempt deadline, retry budget, backoff cap."""

    timeout_s: float = DEFAULT_TIMEOUT_S
    retries: int = DEFAULT_RETRIES
    backoff_max_ms: float = DEFAULT_BACKOFF_MAX_MS

    @property
    def patience_s(self) -> float:
        """Worst-case wall time one op may stay idle before failing."""
        return self.timeout_s * (1 + self.retries)


def from_env() -> Policy:
    """Parse the HOROVOD_NETWORK_* knobs (README config table)."""
    return Policy(
        timeout_s=max(_env_float("HOROVOD_NETWORK_TIMEOUT",
                                 DEFAULT_TIMEOUT_S), 0.05),
        retries=max(_env_int("HOROVOD_NETWORK_RETRIES", DEFAULT_RETRIES), 0),
        backoff_max_ms=max(_env_float("HOROVOD_NETWORK_BACKOFF_MAX_MS",
                                      DEFAULT_BACKOFF_MAX_MS), 1.0),
    )


_lock = threading.Lock()
_default: Optional[Policy] = None


def default_policy(refresh: bool = False) -> Policy:
    """Process-wide policy, parsed from the env once (``refresh=True``
    re-reads — tests and elastic re-init use it)."""
    global _default
    with _lock:
        if _default is None or refresh:
            _default = from_env()
        return _default


# ------------------------------------------------------------------ metrics

_counters: dict = {}


def _counter(name: str, help_: str):
    c = _counters.get(name)
    if c is None:
        from ..metrics import registry

        c = _counters[name] = registry().counter(name, help=help_)
    return c


def retries_counter():
    return _counter(
        "horovod_transport_retries_total",
        "socket ops retried in place after an idle deadline "
        "(HOROVOD_NETWORK_TIMEOUT) — rung 1 of the escalation ladder")


def timeouts_counter():
    return _counter(
        "horovod_transport_timeouts_total",
        "socket ops that exhausted their retry budget "
        "(HOROVOD_NETWORK_RETRIES) and failed — what escalates to rung 2, "
        "plane demotion")


def frames_rejected_counter():
    return _counter(
        "horovod_frames_rejected_total",
        "authenticated frames rejected (HMAC mismatch: corruption, replay, "
        "or reordering) — treated as a link fault, never unpickled")


# ------------------------------------------------------------------ backoff

class Backoff:
    """Decorrelated-jitter backoff (the AWS architecture-blog variant):
    ``delay = min(cap, uniform(base, 3 * previous))``. One implementation
    for every reconnect/poll loop (BasicClient connect, run_command's
    remote poll, and anything new) so there is exactly one set of knobs."""

    def __init__(self, base_s: float = 0.05, cap_s: Optional[float] = None,
                 policy: Optional[Policy] = None, rng=random) -> None:
        p = policy or default_policy()
        self.base_s = max(base_s, 0.001)
        self.cap_s = cap_s if cap_s is not None else p.backoff_max_ms / 1000.0
        self._prev = self.base_s
        self._rng = rng

    def next(self) -> float:
        d = min(self.cap_s, self._rng.uniform(self.base_s, self._prev * 3))
        self._prev = max(d, self.base_s)
        return d

    def sleep(self) -> float:
        d = self.next()
        time.sleep(d)
        return d

    def reset(self) -> None:
        self._prev = self.base_s


# ------------------------------------------------------------- resilient IO

def recv_exact(sock: socket.socket, n: int,
               policy: Optional[Policy] = None) -> bytearray:
    """Receive exactly ``n`` bytes into a preallocated buffer (quadratic
    bytes-+= avoided), with the retry ladder applied *when the socket has a
    timeout set*: each idle period of the socket timeout costs one retry
    from the budget; any received byte resets the budget (the deadline
    bounds idle time, not frame size). A socket with no timeout keeps the
    historical block-forever behaviour — request servers waiting for the
    next command must idle indefinitely."""
    pol = policy or default_policy()
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    attempts = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except (socket.timeout, TimeoutError) as e:
            attempts += 1
            if attempts > pol.retries:
                timeouts_counter().inc()
                raise TimeoutError(
                    f"recv idle past deadline: {got}/{n} bytes after "
                    f"{attempts} attempts of "
                    f"{sock.gettimeout() or pol.timeout_s:g}s each "
                    "(HOROVOD_NETWORK_TIMEOUT / HOROVOD_NETWORK_RETRIES)"
                ) from e
            retries_counter().inc()
            continue
        if not r:
            raise ConnectionError("peer closed")
        got += r
        attempts = 0
    return buf


def send_all(sock: socket.socket, data) -> None:
    """``sendall`` with the timeout classified and counted. A send stalled
    past the socket deadline leaves the stream in an undefined partial
    state, so it is not retried — it fails as a link fault (the demotion
    rung handles it)."""
    try:
        sock.sendall(data)
    except (socket.timeout, TimeoutError) as e:
        timeouts_counter().inc()
        raise TimeoutError(
            "send stalled past the socket deadline "
            "(HOROVOD_NETWORK_TIMEOUT); stream state unknown — failing the "
            "link") from e


def bind_with_retry(bind_fn, port: int, window: int = 1,
                    deadline_s: float = 0.0, sleep_s: float = 0.2):
    """EADDRINUSE-tolerant server bind — ONE implementation for every
    listener the runtime opens.

    Tries ``bind_fn(port + offset)`` for each offset in ``window`` (a
    sliding sweep — an elastic respawn lands where the previous
    generation's exporter still holds ``port + local_rank``); when the
    whole window is busy, sleeps ``sleep_s`` and re-sweeps until
    ``deadline_s`` has elapsed (a re-rendezvous rebinds the SAME address
    moments after the old server closed — lingering accepted sockets can
    hold it for a beat despite SO_REUSEADDR). Any other OSError — and
    EADDRINUSE past the window and deadline — raises. Returns
    ``(bound_object, offset)`` so the caller can log a port slide."""
    import errno

    deadline = time.monotonic() + deadline_s
    window = max(window, 1)
    while True:
        last: Optional[OSError] = None
        for offset in range(window):
            try:
                return bind_fn(port + offset), offset
            except OSError as e:
                if e.errno != errno.EADDRINUSE:
                    raise
                last = e
        if time.monotonic() >= deadline:
            raise last
        time.sleep(sleep_s)


def _reset_for_tests() -> None:
    """Drop cached policy/counters (unit tests flip env vars)."""
    global _default
    with _lock:
        _default = None
        _counters.clear()
