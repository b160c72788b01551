"""Functions that ``tests/test_torch_port_eager.py`` launches on the port's
eager engine (the workers import this module by name, so the launching
test puts this directory on their ``PYTHONPATH``):

``engine_train`` runs under ``run_elastic``: a gloo world, an
``ElasticState`` of a step and a running total, and per step one
allreduce of a numpy array through ``hvd.allreduce`` (the engine),
committed every step; ``raise_at=(rank, step)`` makes that rank raise
``HorovodInternalError`` once before that step (a reset with the same
members). It returns, per generation entered, the id of the engine the
world used (its id and class) and the mirror's hits at its first step, and
the final total.
"""

from __future__ import annotations


def engine_train(steps: int, raise_at=None) -> dict:
    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init("cpu")
    state = hvd.elastic.ElasticState(step=0, total=0.0)
    seen, engines = [], []
    injected = []

    @hvd.elastic.run
    def train(state):
        eng = basics.engine()
        engines.append(eng)          # alive, so that no id is reused
        entry = {"engine": id(eng), "hits_before": None,
                 "class": type(eng).__name__}
        seen.append(entry)
        while state.step < steps:
            if raise_at is not None and not injected \
                    and (hvd.rank(), int(state.step)) == tuple(raise_at):
                injected.append(True)
                raise hvd.HorovodInternalError("injected fault")
            if entry["hits_before"] is None:
                mirror = eng.cache_stats()["mirror"] or {}
                entry["hits_before"] = mirror.get("hits", 0)
            v = hvd.allreduce(np.full(3, float(state.step + hvd.rank())),
                              name="e")
            state.total = state.total + float(v[0])
            state.step += 1
            state.commit()
        return state.step

    train(state)
    out = {"rank": hvd.rank(), "step": int(state.step),
           "total": float(state.total), "seen": seen}
    hvd.shutdown()
    return out
