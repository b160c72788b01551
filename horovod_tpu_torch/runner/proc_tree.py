"""Process-tree termination for the launcher: the counterpart of
``horovod_tpu.runner.proc_tree``, read from ``/proc`` (Linux) instead of
psutil, which the machines the port runs on need not have.

When a worker fails or times out, terminating only the direct child leaks
its descendants (a training script that spawned data-loader or shell
children keeps them running as orphans). Each worker is launched in its
own session (setsid), and teardown enumerates the session's group members
plus any descendants that escaped into their own group, then terminates
them with ONE shared grace window for the whole world.

Why enumerate instead of ``os.killpg``: by teardown time the worker may
already be reaped (``Popen.wait``/``poll``), and a reaped pid is eligible
for reuse — ``killpg`` on it could SIGKILL an unrelated new process group.
Group membership, by contrast, is forgery-proof for everyone but the leader
pid itself: a process group with id X can only be (re)created by the
process whose pid IS X (``setsid``/``setpgid`` semantics), so members with
``pid != X`` are genuinely ours; each target's start time, read when it is
collected and again before each signal, guards every kill against pid
reuse.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import Optional

GRACE_S = 5.0


def _stat(pid: int) -> Optional[tuple[str, int, int, int]]:
    """(state, ppid, pgid, start time in clock ticks) of ``pid`` from
    ``/proc/<pid>/stat``, or None when there is no such process."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            raw = f.read().decode(errors="replace")
    except OSError:
        return None
    # The command name sits in parentheses and may hold spaces: the fields
    # that follow start after its last ')'.
    fields = raw[raw.rindex(")") + 2:].split()
    return fields[0], int(fields[1]), int(fields[2]), int(fields[19])


def _pids() -> list[int]:
    return [int(d) for d in os.listdir("/proc") if d.isdigit()]


def _alive(pid: int, start: int) -> bool:
    """The process collected as (pid, start) still runs (a zombie does not)."""
    st = _stat(pid)
    return st is not None and st[3] == start and st[0] != "Z"


def _collect_targets(procs) -> dict[int, int]:
    """pid -> start time of every process to terminate."""
    stats = {pid: st for pid in _pids() if (st := _stat(pid)) is not None}
    leaders_alive = {p.pid for p in procs if p.poll() is None}
    pgids = {p.pid for p in procs}
    targets = {}
    for pid, (_, _, pgid, start) in stats.items():
        if pgid not in pgids:
            continue
        # A process whose pid equals the (reaped) leader's pid is a pid-reuse
        # imposter — the real leader is gone. Only the still-unreaped leader
        # is a legitimate same-pid member.
        if pid == pgid and pid not in leaders_alive:
            continue
        targets[pid] = start
    # Descendants that setsid'd themselves out of the group (only reachable
    # through a still-alive leader's process tree).
    children: dict[int, list[int]] = {}
    for pid, (_, ppid, _, _) in stats.items():
        children.setdefault(ppid, []).append(pid)
    stack = list(leaders_alive)
    while stack:
        for child in children.get(stack.pop(), []):
            if child not in targets:
                targets[child] = stats[child][3]
            stack.append(child)
    return targets


def _signal(targets: dict[int, int], sig: int) -> None:
    for pid, start in targets.items():
        if _alive(pid, start):
            try:
                os.kill(pid, sig)
            except (ProcessLookupError, PermissionError):
                pass


def terminate_trees(procs, grace: float = GRACE_S) -> None:
    """Tear down the workers' whole process trees: SIGTERM every group
    member and escaped descendant, wait one shared ``grace`` window, then
    SIGKILL the survivors — teardown stays ~grace seconds regardless of
    world size."""
    procs = [p for p in procs if isinstance(p, subprocess.Popen)]
    if not procs:
        return
    targets = _collect_targets(procs)
    _signal(targets, signal.SIGTERM)
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        for p in procs:
            p.poll()                # reap our own children as they exit
        if not any(_alive(pid, start) for pid, start in targets.items()):
            break
        time.sleep(0.05)
    _signal(targets, signal.SIGKILL)
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pass
