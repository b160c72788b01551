"""Worker bootstrap for the CLI launch path: register, export HOROVOD_* env,
then exec the user command in-place (the orted->python hop of the reference,
without orted). The port's own copy of ``horovod_tpu.runner.task_exec``.

With ``HOROVOD_SUPERVISE=1`` (set by the remote-agent path) the command runs
as a supervised child instead: exec would discard the parent-death watchdog,
and remotely-spawned workers rely on it to self-terminate when their host
agent dies (agent.py orphan policy, layer 2)."""

from __future__ import annotations

import os
import subprocess
import sys


def main() -> int:
    from .service import TaskAgent, worker_addresses

    index = int(os.environ["HOROVOD_TASK_INDEX"])
    addrs = worker_addresses()
    secret = bytes.fromhex(os.environ["HOROVOD_SECRET"])
    agent = TaskAgent(index, addrs, secret)
    agent.register()  # exports HOROVOD_RANK/.../HOROVOD_COORD_ADDR
    agent.client.close()
    cmd = sys.argv[1:]
    if not cmd:
        print("task_exec: no command given", file=sys.stderr)
        return 2
    if os.environ.get("HOROVOD_SUPERVISE") == "1":
        from .task_main import watch_parent

        holder: dict = {}

        def kill_child():
            child = holder.get("p")
            if child is not None and child.poll() is None:
                child.terminate()
                try:
                    child.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    child.kill()

        ppid = watch_parent(on_death=kill_child)
        holder["p"] = subprocess.Popen(cmd)
        # Close the race where the agent died between watchdog start and
        # Popen: the watchdog thread saw no child to kill, so re-check here.
        if os.getppid() != ppid:
            kill_child()
            return 1
        rc = holder["p"].wait()
        # Signal deaths map to 128+signum (shell convention): a raw negative
        # return would be truncated by sys.exit and could read as success.
        return 128 - rc if rc < 0 else rc
    os.execvp(cmd[0], cmd)
    return 0  # unreachable


if __name__ == "__main__":
    sys.exit(main())
