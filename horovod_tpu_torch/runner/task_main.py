"""Worker bootstrap for the programmatic launch path (reference
mpirun_exec_fn.py): register with the driver, run the shipped fn, report.
The port's own copy of ``horovod_tpu.runner.task_main``."""

from __future__ import annotations

import os
import sys
import threading


def watch_parent(on_death=None) -> int:
    """Exit if the parent (driver or host agent) dies (reference parent-death
    watchdog, mpirun_exec_fn.py:26-31). ``on_death`` runs first — the
    supervised CLI path uses it to take its child down too. Returns the
    watched ppid so callers can close the start-up race themselves.

    Three layers close the startup race (a parent dying between fork and
    the first ppid snapshot reparents the worker BEFORE the watchdog
    starts, so the snapshot is the reaper's pid and polling never fires):
    1. HVD_PARENT_PID, exported by the spawner: if the current ppid already
       differs, the parent is gone — die now.
    2. prctl(PR_SET_PDEATHSIG, SIGTERM) on Linux: kernel-delivered, no
       polling window at all (the SIGTERM handler runs on_death first).
       Anchor caveat: per prctl(2) the signal fires when the creating
       THREAD exits. On the agent path workers are spawned from the
       driver-connection serve thread, so this layer actually tracks the
       driver's connection — which coincides with the orphan policy's
       layer 1 (job lifetime IS the driver connection; on_disconnect reaps
       the same jobs at the same moment). If jobs ever outlive their spawn
       connection, spawn from a dedicated thread or drop this layer there.
    3. the 1 s ppid poll, as the portable fallback.
    """
    fire_lock = threading.Lock()

    def fire() -> None:  # runs at most once
        if not fire_lock.acquire(blocking=False):
            return
        if on_death is not None:
            try:
                on_death()
            except Exception:
                pass
        os._exit(1)

    import signal

    def _sigterm(signum, frame):
        fire()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:  # pragma: no cover - non-main thread
        pass
    try:  # layer 2: Linux parent-death signal
        import ctypes

        PR_SET_PDEATHSIG = 1
        ctypes.CDLL(None, use_errno=True).prctl(
            PR_SET_PDEATHSIG, signal.SIGTERM, 0, 0, 0)
    except Exception:  # pragma: no cover - non-Linux
        pass

    ppid = os.getppid()
    expected = os.environ.get("HVD_PARENT_PID")
    if expected is not None and ppid != int(expected):
        fire()  # layer 1: parent died before we started

    def loop():  # layer 3
        import time

        while True:
            if os.getppid() != ppid:
                fire()
            time.sleep(1.0)

    threading.Thread(target=loop, daemon=True).start()
    return ppid


def main() -> int:
    from .service import TaskAgent, worker_addresses

    watch_parent()
    index = int(os.environ["HOROVOD_TASK_INDEX"])
    addrs = worker_addresses()
    secret = bytes.fromhex(os.environ["HOROVOD_SECRET"])
    TaskAgent(index, addrs, secret).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
