"""Launcher — the horovodrun/`horovod.spark.run` capability for the port:
the counterpart of ``horovod_tpu.runner``, whose workers run
``horovod_tpu_torch`` (``init()`` reads the rank, size and coordinator
address the launcher exports).

Two entry points, each with a local and a multi-host leg:

- :func:`run(fn, args=..., num_proc=N)` — programmatic launch (the
  `horovod.spark.run()` analog, reference spark/__init__.py:80-196): starts a
  driver service, spawns ``num_proc`` local worker processes, ships the
  pickled ``fn`` to each, returns results ordered by rank. With
  ``hosts="host1:4,host2:4"`` the workers are spawned REMOTELY through each
  host's resident `hvd-agent` daemon (agent.py) — the reference's
  Spark-executor / mpirun-rsh remote materialization
  (spark/__init__.py:61-77, spark/driver/mpirun_rsh.py:24-43) without Spark
  or ssh.
- CLI ``hvdrun -np N -- python train.py`` / ``hvdrun -H host1:4,host2:4 --
  python train.py`` — script launch (the mpirun/horovodrun analog): each
  worker registers, learns its rank/topology via env, then executes the
  command.

No MPI, no ssh: the control plane is the HMAC-authenticated TCP service pair
from the reference's Spark layer (SURVEY.md §2.6), which was already the
in-repo blueprint for cluster launch without mpirun.

The JAX launcher's ``jax_distributed`` option has no counterpart: every
launched job forms one ``torch.distributed`` world.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, Optional, Sequence, Union

from .network import make_secret
from .proc_tree import terminate_trees
from .remote import HostSpec, RemoteSpawner, parse_hosts  # noqa: F401
from .service import (  # noqa: F401
    DriverService,
    ElasticDriverService,
    TaskAgent,
    WorkerRemovedError,
    host_hash,
)


def run_elastic(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
                num_proc: Optional[int] = None, min_np: int = 1,
                max_np: Optional[int] = None, env: Optional[dict] = None,
                timeout: float = 600.0, discovery=None,
                python: Optional[str] = None,
                hosts: Union[str, Sequence, None] = None,
                agent_port: Optional[int] = None,
                agent_secret: Optional[bytes] = None) -> list:
    """Elastic launch: like :func:`run`, but the job survives
    worker death — failed slots are respawned or blacklisted, survivors
    re-rendezvous into a new generation, and ``discovery`` (an
    ``elastic.HostDiscovery``) can add/remove slots mid-run. With ``hosts``
    the workers materialize through resident hvd-agents, as in :func:`run`.
    ``fn`` must build an ``ElasticState`` and call a training function
    wrapped with ``hvd.elastic.run``. See docs/elastic.md; on the port the
    reset re-forms the ``torch.distributed`` world (elastic/run.py)."""
    from ..elastic.driver import launch_elastic

    return launch_elastic(fn, args=args, kwargs=kwargs, num_proc=num_proc,
                          min_np=min_np, max_np=max_np, env=env,
                          timeout=timeout, discovery=discovery, python=python,
                          hosts=hosts, agent_port=agent_port,
                          agent_secret=agent_secret)


def _spawn_worker(index: int, driver_addrs, secret: bytes, argv: Sequence[str],
                  extra_env: Optional[dict] = None) -> subprocess.Popen:
    env = dict(os.environ)
    env["HOROVOD_DRIVER_ADDRS"] = json.dumps([list(a) for a in driver_addrs])
    env["HOROVOD_SECRET"] = secret.hex()
    env["HOROVOD_TASK_INDEX"] = str(index)
    env["HVD_PARENT_PID"] = str(os.getpid())  # startup-race watchdog anchor
    env.update(extra_env or {})
    # Own session per worker: on abort the launcher signals the whole
    # process group, so grandchildren die too (proc_tree.terminate_tree).
    return subprocess.Popen(list(argv), env=env, start_new_session=True)


def _worker_env(index: int, driver_addrs, secret: Optional[bytes],
                extra_env: Optional[dict]) -> dict:
    # secret=None on the remote-agent path: the per-job secret is DERIVED
    # independently by the agent (agent.py _spawn) and the driver
    # (RemoteSpawner.job_secret) from the agent secret + job id, so it never
    # rides the authenticated-but-unencrypted agent channel. (The reference
    # ships its secret through Spark executor env, spark/__init__.py:109 —
    # this build deliberately does not.)
    env = {
        "HOROVOD_DRIVER_ADDRS": json.dumps([list(a) for a in driver_addrs]),
        "HOROVOD_TASK_INDEX": str(index),
    }
    if secret is not None:
        env["HOROVOD_SECRET"] = secret.hex()
    env.update(extra_env or {})
    return env


def _exit_code(rc: Optional[int]) -> int:
    """Normalize a Popen returncode: signal deaths (negative) map to the
    shell convention 128+signum so they can't lose to 0 in max()."""
    if rc is None:
        return 0
    return 128 - rc if rc < 0 else rc


def _maybe_start_control(spawner: RemoteSpawner, driver: DriverService,
                         world: int, env: Optional[dict]) -> None:
    """Start per-host control leaders when the tree pays for itself
    (ctrl.tree.use_tree — multi-host, world >= 3, not knobbed off), so
    rendezvous/poll traffic reaches the driver via O(hosts) connections.
    The exported checkpoint directory (streaming cold-start source) is the
    job's HOROVOD_CKPT_STREAM_DIR, from the call's env or the launcher's.
    Each leader also hosts the eager engine's coordinator relay."""
    from ..ctrl.tree import use_tree

    if not use_tree(len(spawner.specs), world):
        return
    ckpt_dir = (env or {}).get("HOROVOD_CKPT_STREAM_DIR") \
        or os.environ.get("HOROVOD_CKPT_STREAM_DIR", "")
    spawner.start_control(driver.addresses(), ckpt_dir=ckpt_dir)


def _remote_spawner(hosts, agent_port, agent_secret) -> RemoteSpawner:
    if agent_secret is None:
        hex_secret = os.environ.get("HOROVOD_AGENT_SECRET")
        if not hex_secret:
            raise ValueError(
                "multi-host launch needs the agent secret: pass agent_secret= "
                "or set HOROVOD_AGENT_SECRET (hex)")
        agent_secret = bytes.fromhex(hex_secret)
    return RemoteSpawner(parse_hosts(hosts, agent_port), agent_secret)


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        num_proc: Optional[int] = None, env: Optional[dict] = None,
        timeout: float = 600.0, hosts: Union[str, Sequence, None] = None,
        agent_port: Optional[int] = None,
        agent_secret: Optional[bytes] = None,
        python: Optional[str] = None) -> list:
    """Run ``fn`` on ``num_proc`` processes; returns [result_rank0, ...]
    (reference horovod.spark.run returns per-rank results ordered by rank,
    spark/__init__.py:195-196).

    With ``hosts`` (``"host1:4,host2:4"``; ``@port`` overrides the agent
    port per host), workers are spawned through each host's resident
    hvd-agent daemon instead of locally; ``num_proc`` defaults to the total
    slot count and must match it if given.

    Without cloudpickle, ``fn`` must be importable by the workers (a
    module-level function of a module on their path): a closure fails the
    launch with a ``TypeError`` that says so (``service.ship_fn``)."""
    secret = make_secret()
    if hosts is not None:
        spawner = _remote_spawner(hosts, agent_port, agent_secret)
        if num_proc is not None and num_proc != spawner.num_proc:
            spawner.close()
            raise ValueError(
                f"num_proc={num_proc} contradicts hosts spec "
                f"({spawner.num_proc} total slots)")
        num_proc = spawner.num_proc
        # Per-job secret DERIVED on both ends (here and agent._spawn), not
        # shipped in worker env over the unencrypted agent channel.
        secret = spawner.job_secret()
        try:
            driver = DriverService(num_proc, secret, fn=fn, args=args,
                                   kwargs=kwargs)
        except BaseException:
            spawner.close()
            raise
        argv = [python or sys.executable, "-m",
                "horovod_tpu_torch.runner.task_main"]
        try:
            _maybe_start_control(spawner, driver, num_proc, env)
            spawner.spawn(
                make_argv=lambda i: argv,
                make_env=lambda i: _worker_env(i, driver.addresses(), None, env))
            results = driver.wait_results(timeout=timeout,
                                          liveness=spawner.liveness)
            _emit_pod_metrics(driver)
            return [results[r] for r in sorted(results)]
        finally:
            spawner.kill()
            spawner.close()
            driver.stop()

    num_proc = num_proc or os.cpu_count() or 1
    if num_proc < 1:
        raise ValueError(f"num_proc must be >= 1, got {num_proc}")
    driver = DriverService(num_proc, secret, fn=fn, args=args, kwargs=kwargs)
    procs = []
    try:
        for index in range(num_proc):
            procs.append(_spawn_worker(
                index, driver.addresses(), secret,
                [sys.executable, "-m", "horovod_tpu_torch.runner.task_main"],
                env))

        def liveness():
            for i, p in enumerate(procs):
                rc = p.poll()
                if rc not in (None, 0):
                    return f"worker {i} exited with code {rc} before reporting a result"
                # A worker that exits CLEANLY without ever delivering a
                # result is just as dead (sys.exit(0) in user code, a
                # silently-dropped report): flagging only non-zero codes
                # left the driver blocking for the full timeout.
                if rc == 0 and driver.result_pending_index(i):
                    return (f"worker {i} exited with code 0 before reporting "
                            "a result (user code exited early, or the result "
                            "report never reached the driver)")
            return None

        results = driver.wait_results(timeout=timeout, liveness=liveness)
        for p in procs:
            p.wait(timeout=30)
        _emit_pod_metrics(driver)
        return [results[r] for r in sorted(results)]
    finally:
        terminate_trees(procs)
        driver.stop()


def _emit_pod_metrics(driver: DriverService) -> None:
    """Pod-wide telemetry at job end: every worker attached its
    final metrics snapshot to its result payload; write the merged view to
    HOROVOD_METRICS_SNAPSHOT when set (JSON file — the launcher-side analog
    of bench.py --metrics) and log a one-line summary. Never fatal."""
    path = os.environ.get("HOROVOD_METRICS_SNAPSHOT", "")
    try:
        pod = driver.pod_metrics()
        if pod is None:
            return
        if path:
            import json

            with open(path, "w") as f:
                json.dump(pod, f, indent=2)
        from ..utils.logging import log

        key = 'horovod_collectives_total{op="allreduce"}'
        log("debug",
            f"pod metrics: {pod['ranks_reporting']}/{pod['ranks']} ranks "
            f"reporting, {pod['counters'].get(key, 0):.0f} allreduces"
            + (f" -> {path}" if path else ""))
    except Exception as e:  # pragma: no cover - telemetry must not kill jobs
        from ..utils.logging import log

        log("warning", f"pod metrics emission failed: {e}")


def run_command(command: Sequence[str], num_proc: Optional[int] = None,
                env: Optional[dict] = None, timeout: Optional[float] = None,
                hosts: Union[str, Sequence, None] = None,
                agent_port: Optional[int] = None,
                agent_secret: Optional[bytes] = None,
                python: Optional[str] = None) -> int:
    """Launch ``command`` on worker processes (CLI path); returns the max
    exit code. With ``hosts``, workers are spawned through each host's
    resident hvd-agent daemon (supervised, so they die with the agent)."""
    if hosts is not None:
        import time

        spawner = _remote_spawner(hosts, agent_port, agent_secret)
        if num_proc is not None and num_proc != spawner.num_proc:
            spawner.close()
            raise ValueError(
                f"num_proc={num_proc} contradicts hosts spec "
                f"({spawner.num_proc} total slots)")
        secret = spawner.job_secret()  # derived on both ends, never shipped
        driver = DriverService(spawner.num_proc, secret, fn=None)
        argv = ([python or sys.executable, "-m",
                 "horovod_tpu_torch.runner.task_exec"] + list(command))
        try:
            _maybe_start_control(spawner, driver, spawner.num_proc, env)
            spawner.spawn(
                make_argv=lambda i: argv,
                make_env=lambda i: {
                    **_worker_env(i, driver.addresses(), None, env),
                    "HOROVOD_SUPERVISE": "1",
                })
            deadline = time.monotonic() + timeout if timeout else None
            # Poll backoff on the shared transport policy (common/
            # resilience.py Backoff, capped by HOROVOD_NETWORK_BACKOFF_MAX_MS
            # — default 2 s): short jobs get sub-100ms exit latency, long
            # jobs don't hammer the agents with a fixed 2 Hz poll per host
            # for hours, and the jitter decorrelates multi-driver setups.
            from ..common.resilience import Backoff

            backoff = Backoff(base_s=0.05)
            while True:
                codes = spawner.poll_returncodes()
                if codes is None:
                    raise RuntimeError(
                        "an hvd-agent became unreachable mid-job; its workers "
                        "self-terminate via the parent-death watchdog")
                if all(c is not None for c in codes):
                    return max((_exit_code(c) for c in codes), default=0)
                if deadline and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{sum(c is None for c in codes)} workers still "
                        f"running after {timeout}s")
                backoff.sleep()
        finally:
            spawner.kill()
            spawner.close()
            driver.stop()

    if num_proc is None:
        raise ValueError("num_proc is required for local launch")
    if num_proc < 1:
        raise ValueError(f"num_proc must be >= 1, got {num_proc}")
    secret = make_secret()
    driver = DriverService(num_proc, secret, fn=None)
    procs = []
    try:
        for index in range(num_proc):
            procs.append(_spawn_worker(
                index, driver.addresses(), secret,
                [sys.executable, "-m", "horovod_tpu_torch.runner.task_exec"]
                + list(command), env))
        rc = 0
        for p in procs:
            p.wait(timeout=timeout)
            rc = max(rc, _exit_code(p.returncode))
        return rc
    finally:
        terminate_trees(procs)
        driver.stop()
