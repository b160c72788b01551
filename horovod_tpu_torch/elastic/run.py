"""``hvd.elastic.run`` — the worker-side reset loop: the counterpart of
``horovod_tpu.elastic.run``, which re-forms the ``torch.distributed``
world that every collective of the port runs over.

Wrap the training function; it gains survive-and-resume semantics:

    @hvd.elastic.run
    def train(state):
        while state.step < TOTAL:
            ... collectives ...
            state.step += 1
            state.commit()

    hvd.runner.run_elastic(train, args=(state,), num_proc=4)

On a collective failure — a peer died (gloo fails the survivors' next
collective at once; NCCL's waits fail after the process group's timeout,
``HOROVOD_STALL_SHUTDOWN_TIME`` under ``HOROVOD_ELASTIC``), which the
port's collectives raise as ``HorovodInternalError`` — or a membership
change the driver signalled (:class:`HostsUpdatedInterrupt` out of
``state.commit()``), the wrapper:

1. tears the world down: the eager engine (its response cache flushed
   first, so no response of the old membership is ever served; the next
   generation attaches a new engine), every process group, NCCL's
   communicators aborted first (``shutdown(abort=True)``), and the
   rendezvous store;
2. rolls the state back to the last commit (skipped for the clean
   host-update interrupt, which is raised post-commit), in place;
3. re-registers with the driver and blocks for the next generation's
   rendezvous (new rank/size/coordinator, exported into env);
4. re-initializes on the same device at the new coordinator address,
   adopts rank 0's committed state (``state.sync()``), and re-enters the
   training function.

A worker the driver dropped (its host blacklisted, or scaled away) gets
:class:`WorkerRemovedError` from the rendezvous and exits instead of
spinning. Everything else — a genuine bug in the training function —
propagates unchanged: elastic recovery is for infrastructure failures,
not for exceptions resets cannot fix.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, Optional

from ..common import basics
from ..common.basics import HorovodInternalError
from ..metrics import registry as _registry
from ..utils.logging import log
from .state import RENDEZVOUS_TIMEOUT_S, ElasticState, HostsUpdatedInterrupt

# Failures a reset can heal. HorovodInternalError is what the port's
# collectives raise when the backend fails (a peer gone, a wait past the
# process group's timeout): parallel/collectives.py backend_errors. Any
# other exception of the training function propagates.
RESETTABLE = (HorovodInternalError, HostsUpdatedInterrupt, ConnectionError)

_context: Optional["_WorkerContext"] = None


def _require_worker_removed():
    from ..runner.service import WorkerRemovedError

    return WorkerRemovedError


class _WorkerContext:
    """This worker's line to the elastic driver: rate-limited membership
    polls (state.commit) and the blocking re-rendezvous on reset."""

    def __init__(self, index: int, addresses, secret: bytes) -> None:
        self.index = index
        self.addresses = addresses
        self.secret = secret
        self._agent = None
        self._last_poll = 0.0
        self.poll_interval_s = float(
            os.environ.get("HOROVOD_ELASTIC_POLL_S", "") or 1.0)

    @classmethod
    def from_env(cls) -> Optional["_WorkerContext"]:
        if os.environ.get("HOROVOD_ELASTIC") != "1":
            return None
        from ..runner.service import worker_addresses

        addrs = worker_addresses()
        secret = os.environ.get("HOROVOD_SECRET")
        index = os.environ.get("HOROVOD_TASK_INDEX")
        if not addrs or not secret or index is None:
            return None
        return cls(int(index), addrs, bytes.fromhex(secret))

    @property
    def generation(self) -> int:
        return int(os.environ.get("HOROVOD_ELASTIC_GENERATION", "0"))

    def _task_agent(self):
        if self._agent is None:
            from ..runner.service import TaskAgent

            self._agent = TaskAgent(self.index, self.addresses, self.secret)
        return self._agent

    def _drop_agent(self) -> None:
        if self._agent is not None:
            try:
                self._agent.client.close()
            except OSError:
                pass
            self._agent = None

    def poll_reset_required(self) -> bool:
        """Cheap driver poll, at most once per ``poll_interval_s``. Errors
        (driver briefly busy) read as 'no change' — a real membership
        change also surfaces as a collective failure soon enough."""
        now = time.monotonic()
        if now - self._last_poll < self.poll_interval_s:
            return False
        self._last_poll = now
        try:
            resp = self._task_agent().client.request({
                "kind": "elastic_poll", "index": self.index,
                "generation": self.generation})
            return bool(resp.get("reset_required"))
        except (ConnectionError, OSError):
            self._drop_agent()
            return False

    def rendezvous(self, timeout: float = RENDEZVOUS_TIMEOUT_S) -> dict:
        """Blocking re-registration; exports the new assignment into env
        (rank/size/coordinator/generation). Raises WorkerRemovedError when
        the driver dropped this slot."""
        min_gen = self.generation + 1
        try:
            return self._task_agent().rendezvous(min_gen, timeout=timeout)
        except (ConnectionError, OSError):
            # stale connection from before the failure: reconnect once
            self._drop_agent()
            return self._task_agent().rendezvous(min_gen, timeout=timeout)


def poll_host_updates() -> bool:
    """Hook for ``ElasticState.commit``: True when the driver wants a reset
    (membership changed). False outside an elastic worker."""
    return _context.poll_reset_required() if _context is not None else False


def run(fn: Callable) -> Callable:
    """Decorator: make ``fn(state, *args, **kwargs)`` survive worker loss
    via reset/restore/re-rendezvous (module docstring). The first positional
    argument must be an :class:`ElasticState`."""

    @functools.wraps(fn)
    def wrapper(state: ElasticState, *args: Any, **kwargs: Any) -> Any:
        global _context
        ctx = _WorkerContext.from_env()
        _context = ctx
        reg = _registry()
        resets = reg.counter("horovod_elastic_resets_total",
                             help="elastic resets survived by this worker")
        gen_gauge = reg.gauge("horovod_elastic_generation",
                              help="current elastic rendezvous generation")
        reset_hist = reg.histogram(
            "horovod_elastic_reset_seconds",
            help="failure-to-resumed wall time per elastic reset",
            buckets=(0.1, 0.5, 1, 2, 5, 10, 30, 60, 120, 300))
        max_resets = int(os.environ.get("HOROVOD_ELASTIC_MAX_RESETS", "")
                         or 100)
        WorkerRemovedError = _require_worker_removed()
        # Every generation runs on the device of the first: the model and
        # the optimizer live there.
        device = basics.device() if basics.is_initialized() else None
        performed = 0
        try:
            while True:
                try:
                    if not basics.is_initialized():
                        basics.init(device)
                        device = basics.device()
                    gen_gauge.set(ctx.generation if ctx else 0)
                    # EVERY generation entry syncs — including this worker's
                    # first: a worker that just JOINED an in-flight job must
                    # participate in the survivors' committed-state broadcast,
                    # or the world deadlocks with survivors in sync() and the
                    # newcomer already in the training loop.
                    if ctx is not None and basics.size() > 1:
                        state.sync(root_rank=0)
                    return fn(state, *args, **kwargs)
                except RESETTABLE as exc:
                    if ctx is None:
                        # No elastic launcher behind us: nothing to
                        # rendezvous with — surface the failure.
                        raise
                    performed += 1
                    if performed > max_resets:
                        raise HorovodInternalError(
                            f"elastic worker exceeded "
                            f"HOROVOD_ELASTIC_MAX_RESETS={max_resets}"
                        ) from exc
                    t0 = time.monotonic()
                    rollback = not isinstance(exc, HostsUpdatedInterrupt)
                    log("warning",
                        f"elastic reset {performed}: "
                        f"{type(exc).__name__}: {exc}; "
                        f"{'rolling back to last commit' if rollback else 'state already committed'}"
                        " and re-rendezvousing")
                    # The engine's response cache is flushed FIRST, on every
                    # rank: a bit bound under the old membership must never
                    # serve a negotiation in the new one, even if the
                    # teardown below is interrupted. shutdown() then ends
                    # the engine; the next generation attaches a new one.
                    try:
                        if basics._state.engine is not None:
                            basics._state.engine.cache_flush()
                    except Exception:  # noqa: BLE001 - the world is gone
                        pass
                    # A collective of the dead world may still be in flight
                    # on the card: abort NCCL's communicators before the
                    # groups are destroyed, or the teardown waits on it.
                    try:
                        basics.shutdown(abort=True)
                    except Exception as e:  # noqa: BLE001 - the world is gone
                        log("warning", f"elastic reset: teardown of the dead "
                            f"world failed ({type(e).__name__}: {e})")
                    if rollback:
                        state.restore()
                    try:
                        ctx.rendezvous()
                    except WorkerRemovedError:
                        log("info",
                            f"task index {ctx.index} removed from the "
                            "elastic job; exiting")
                        raise
                    # init + sync happen at the top of the next loop pass,
                    # so a newly-joined peer and a reset survivor take the
                    # exact same entry path.
                    resets.inc()
                    gen_gauge.set(ctx.generation)
                    reset_hist.observe(time.monotonic() - t0)
                    log("info",
                        f"elastic reset complete: generation "
                        f"{ctx.generation}, rank "
                        f"{os.environ.get('HOROVOD_RANK', '?')}/"
                        f"{os.environ.get('HOROVOD_SIZE', '?')}, resuming "
                        "from last commit")
        finally:
            _context = None

    return wrapper
