"""Elastic training — fault-tolerant re-scaling: the counterpart of
``horovod_tpu.elastic`` on the port's ``torch.distributed`` world.

A job survives worker death and host loss without restarting from scratch,
and absorbs new hosts mid-run:

    import horovod_tpu_torch as hvd

    def main():
        hvd.init()
        s = train.setup(config)           # model, DistributedOptimizer, step
        state = hvd.elastic.ElasticState(model=s.model, opt=s.opt, step=0)

        @hvd.elastic.run
        def train_loop(state):
            while state.step < TOTAL_STEPS:
                s.step(tokens)
                state.step += 1
                state.commit()
            return state.step

        return train_loop(state)

    results = hvd.runner.run_elastic(main, num_proc=4)

Pieces (docs/elastic.md for the model, which the port keeps):

- :class:`ElasticState` (state.py) — commit/restore/sync over tensors,
  modules and optimizers, in place; optionally checkpoint-backed through
  the port's ``checkpoint``.
- :func:`run` (run.py) — the reset wrapper: catches the collectives'
  ``HorovodInternalError`` (a peer died, a wait ran past
  ``HOROVOD_STALL_SHUTDOWN_TIME``), tears the world down, re-rendezvouses,
  restores the last commit, re-initializes ``torch.distributed`` and
  re-enters.
- ``runner.run_elastic`` / :mod:`.driver` — the supervising launcher:
  rendezvous generations, respawn, blacklist, host discovery.
- :class:`HostDiscovery` / :class:`StaticDiscovery` /
  :class:`ScriptDiscovery`, :class:`Blacklist` (discovery.py).
- :mod:`.fault` — env-triggered fault injection for tests.

Elastic covers the flat data-parallel exchange, with or without
``HOROVOD_LATENCY_HIDING``, on the eager step. Under ``HOROVOD_ELASTIC=1``
the layouts a reset cannot carry — sharded, hierarchical, tp, pp, sp, and
the CUDA-graphed loop — raise when they are built
(``common/basics.py`` ``require_not_elastic``).
"""

from __future__ import annotations

from . import fault  # noqa: F401
from .discovery import (  # noqa: F401
    Blacklist,
    HostDiscovery,
    ScriptDiscovery,
    StaticDiscovery,
    parse_discovery_output,
)
from .run import RESETTABLE, poll_host_updates, run  # noqa: F401
from .state import ElasticState, HostsUpdatedInterrupt  # noqa: F401


def __getattr__(name: str):
    # Lazy, as in the JAX package: the launcher's modules load on first use.
    if name == "WorkerRemovedError":
        from ..runner.service import WorkerRemovedError

        return WorkerRemovedError
    if name == "run_elastic":
        from ..runner import run_elastic

        return run_elastic
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
