"""Env-triggered fault injection — the test/chaos hooks the elastic smoke
and the reset tests drive: the port's own copy of
``horovod_tpu.elastic.fault``, with the same environment.

Everything here is opt-in via environment variables and free when unset;
none of it belongs in a production config:

- ``HOROVOD_FAULT_INJECT_STEP=N`` + ``HOROVOD_FAULT_INJECT_INDEX=i``:
  the worker at task index ``i`` kills itself when :func:`maybe_die` is
  called with ``step == N``. Training loops call ``maybe_die(step)`` once
  per step (``ElasticState.commit`` calls it with the state's ``step``/
  ``batch`` value when one exists, so elastic loops get the hook for
  free). A worker resumed from a commit PAST step N never re-triggers —
  which is exactly how the respawn-then-survive path is exercised — while
  a commit cadence that replays step N re-kills the worker and exercises
  the repeated-failure -> blacklist path.
- ``HOROVOD_FAULT_INJECT_SIGNAL`` (default ``KILL``): how to die — a
  signal name/number sent to self (``KILL`` models a hard crash: no
  result report, no clean TCP shutdown) or ``exit:<code>`` for
  ``os._exit``.
- ``HOROVOD_FAULT_AGENT_EXIT_AFTER_S=S``: a resident hvd-agent hard-exits
  ``S`` seconds after start (agent.py) — the host-loss scenario.

Network chaos (tools/chaos_smoke.py): frame-level fault injection
inside the authenticated Channel (runner/network.py), exercising the
transport-resilience ladder instead of killing processes:

- ``HOROVOD_FAULT_NET={delay,reset,corrupt,drop}``: what to inject on a
  matching outbound frame. ``delay`` sleeps ``HOROVOD_FAULT_NET_DELAY_MS``
  (default 1000) before sending — absorbed by the receive retry budget
  (rung 1); ``HOROVOD_FAULT_NET_DELAY_PER_MB`` (default 0) adds a
  bytes-proportional term (ms per MiB of payload) on top, modeling a
  bandwidth-collapsed link instead of a latency spike. ``reset`` abort-closes the socket (RST to the peer) — a hard
  link fault, absorbed by plane demotion (rung 2). ``corrupt`` flips a MAC
  byte so the receiver rejects the frame (``horovod_frames_rejected_total``)
  and fails the link — also rung 2. ``drop`` swallows the frame: the
  receiver sees the *next* frame early (size/HMAC mismatch — the
  broken-middlebox model) and fails the link.
- Target selectors: ``HOROVOD_FAULT_NET_SCOPE`` (comma list of channel
  scopes, default ``ring`` — the eager data-plane links; ``*`` = all),
  ``HOROVOD_FAULT_NET_RANK`` (only this HOROVOD_RANK injects; default
  any), ``HOROVOD_FAULT_NET_AFTER`` (skip the first N matching frames,
  default 0), ``HOROVOD_FAULT_NET_COUNT`` (stop after firing N times,
  default 1; -1 = unlimited), ``HOROVOD_FAULT_NET_RATE`` (per-frame firing
  probability once past AFTER, default 1 = deterministic).
"""

from __future__ import annotations

import os
import random
import signal
import threading


def _target_index() -> str:
    return os.environ.get("HOROVOD_FAULT_INJECT_INDEX", "")


def armed() -> bool:
    """True when this process is the fault target (cheap pre-check)."""
    step = os.environ.get("HOROVOD_FAULT_INJECT_STEP", "")
    if not step:
        return False
    target = _target_index()
    return target == "" or target == os.environ.get("HOROVOD_TASK_INDEX", "")


def maybe_die(step) -> None:
    """Kill this worker if the injected fault matches ``(step, index)``."""
    if not armed():
        return
    try:
        if int(step) != int(os.environ["HOROVOD_FAULT_INJECT_STEP"]):
            return
    except (TypeError, ValueError):
        return
    die()


def die() -> None:
    """Die the configured way, now. Logs first so the event is attributable
    in worker stderr."""
    spec = os.environ.get("HOROVOD_FAULT_INJECT_SIGNAL", "KILL")
    from ..utils.logging import log

    log("warning", f"fault injection firing ({spec}) at task index "
        f"{os.environ.get('HOROVOD_TASK_INDEX', '?')}")
    if spec.startswith("exit:"):
        os._exit(int(spec.split(":", 1)[1]))
    try:
        sig = int(spec)
    except ValueError:
        sig = getattr(signal, f"SIG{spec.upper()}", signal.SIGKILL)
    os.kill(os.getpid(), sig)


# -- network chaos -------------------------------------------------------------

NET_ACTIONS = ("delay", "reset", "corrupt", "drop")

_net_lock = threading.Lock()
_net_fired = 0
_net_frames: dict = {}


def net_fault_armed() -> bool:
    """True when this process injects network faults (checked once per
    Channel construction — the hot path stays branch-free when unset)."""
    spec = os.environ.get("HOROVOD_FAULT_NET", "")
    if spec not in NET_ACTIONS:
        return False
    target = os.environ.get("HOROVOD_FAULT_NET_RANK", "")
    return target == "" or target == os.environ.get("HOROVOD_RANK", "")


def net_fault(scope: str) -> str | None:
    """Per-frame decision: return the action to inject on this outbound
    frame, or None. Counts frames per scope so AFTER/COUNT selectors are
    deterministic (the chaos smoke needs the fault to land mid-run, not at
    a random establishment frame)."""
    global _net_fired
    spec = os.environ.get("HOROVOD_FAULT_NET", "")
    if spec not in NET_ACTIONS:
        return None
    scopes = os.environ.get("HOROVOD_FAULT_NET_SCOPE", "ring")
    if scopes != "*" and scope not in scopes.split(","):
        return None
    target = os.environ.get("HOROVOD_FAULT_NET_RANK", "")
    if target and target != os.environ.get("HOROVOD_RANK", ""):
        return None
    with _net_lock:
        count = int(os.environ.get("HOROVOD_FAULT_NET_COUNT", "") or 1)
        if 0 <= count <= _net_fired:
            return None
        n = _net_frames.get(scope, 0) + 1
        _net_frames[scope] = n
        if n <= int(os.environ.get("HOROVOD_FAULT_NET_AFTER", "") or 0):
            return None
        rate = float(os.environ.get("HOROVOD_FAULT_NET_RATE", "") or 1.0)
        if rate < 1.0 and random.random() >= rate:
            return None
        _net_fired += 1
    from ..utils.logging import log

    log("warning",
        f"net fault injection firing: {spec} on {scope} frame {n} "
        f"(rank {os.environ.get('HOROVOD_RANK', '?')})")
    return spec


def net_fault_delay_s(nbytes: int = 0) -> float:
    """Injected per-frame delay. ``HOROVOD_FAULT_NET_DELAY_MS`` is a flat
    per-frame latency (default 1000). ``HOROVOD_FAULT_NET_DELAY_PER_MB``
    adds a bytes-proportional component (ms per MiB of frame payload,
    default 0) — that models a bandwidth-collapsed link rather than a
    latency spike, which is the fault class where shrinking the wire
    format (bf16/top-k) genuinely restores throughput. The controller
    chaos leg (tools/controller_smoke.py) uses it so the canary's
    commit-vs-rollback verdict reflects a real causal win, not luck."""
    flat = float(os.environ.get("HOROVOD_FAULT_NET_DELAY_MS", "") or 1000.0)
    per_mb = float(
        os.environ.get("HOROVOD_FAULT_NET_DELAY_PER_MB", "") or 0.0)
    return (flat + per_mb * (nbytes / float(1 << 20))) / 1000.0


def reset_net_fault_state() -> None:
    """Forget fired/frame counters (unit tests re-arm between cases)."""
    global _net_fired
    with _net_lock:
        _net_fired = 0
        _net_frames.clear()


def start_agent_fault_timer() -> None:
    """Arm HOROVOD_FAULT_AGENT_EXIT_AFTER_S on a resident agent: hard-exit
    after the delay, modeling sudden host loss (the driver must notice via
    the broken connection, not a goodbye)."""
    delay = os.environ.get("HOROVOD_FAULT_AGENT_EXIT_AFTER_S", "")
    if not delay:
        return

    def _boom() -> None:
        os._exit(1)

    t = threading.Timer(float(delay), _boom)
    t.daemon = True
    t.start()
