"""The port's protocol core (``horovod_tpu_torch.common.protocol``)
against the JAX package's (``horovod_tpu.common.protocol``):

- every table (id spaces, the native wire field orders, the cache-key
  facets, the request fields, ``COORD_WIRE_KINDS``) equal entry by entry;
- ``chunk_bounds``/``fold_start``/``fold_order`` on a grid of sizes and
  worlds, and ``reduce_plan`` on every payload dtype with and without an
  explicit wire (bfloat16 named ``"bfloat16"`` on both sides);
- the state machine: the JAX package's golden cache and demote/redo
  traces replay clean through the port's ``Machine``, and corrupted
  traces fail at the same event with the same rule;
- the real engines: the scripted cache lifecycle (bind, hits, shape-change
  rebind, flush and re-learn) driven through a 2-process world of each
  package gives the same transition stream, the golden one. The script is
  the JAX tests' with an allgather (which the cache never binds) after
  each observed step: without it a rank that finished a step may submit
  the next shape before the other rank's mirror was read, and the
  shape-change eviction then lands inside the observed step (the JAX
  tests' own streams show this under load).
Tolerance: none."""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest

from horovod_tpu.common import protocol as J
from horovod_tpu_torch.common import protocol as P
from horovod_tpu_torch.compression import dtype_name
from launch_util import launch_world

TABLES = ["OPS", "DTYPES", "STATUS_NAMES", "WIRE_FORMATS",
          "REQUEST_WIRE_ORDER", "TICK_WIRE_ORDER", "RESPONSE_LIST_WIRE_ORDER",
          "NATIVE_CACHE_KEY_FIELDS", "PY_REQUEST_KEY_FIELDS",
          "PY_REQUEST_FIELDS", "PY_REQUEST_OPTIONAL_FIELDS",
          "COORD_WIRE_KINDS"]


@pytest.mark.parametrize("table", TABLES)
def test_tables_equal_entry_by_entry(table):
    mine, theirs = getattr(P, table), getattr(J, table)
    assert type(mine) is type(theirs)
    if isinstance(mine, dict):
        assert list(mine.items()) == list(theirs.items())
    else:
        assert list(mine) == list(theirs)


def test_chunking_and_fold_order():
    for n in (0, 1, 5, 7, 8, 30011, 1 << 20):
        for w in (1, 2, 3, 4, 8, 16):
            assert P.chunk_bounds(n, w) == J.chunk_bounds(n, w)
    for w in (1, 2, 3, 4, 8):
        for c in range(w):
            assert P.fold_start(c, w) == J.fold_start(c, w)
            assert P.fold_order(c, w) == J.fold_order(c, w)


def _plan_view(plan):
    hop = plan["hop"]
    return (dtype_name(plan["acc"]),
            hop if hop is None or isinstance(hop, str) else dtype_name(hop),
            plan["storage_round"])


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32",
                                   "float64", "int32", "int64", "uint8"])
def test_reduce_plan_agrees(dtype):
    jdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    for pw, jw in ((None, None), ("topk", "topk"),
                   ("bfloat16", np.dtype(ml_dtypes.bfloat16)),
                   (np.float16, np.float16)):
        assert _plan_view(P.reduce_plan(dtype, pw)) == \
            _plan_view(J.reduce_plan(jdt, jw))


def _golden():
    import test_protocol as ref

    return ref._golden_cache_trace()


def test_golden_traces_replay_through_the_port_machine():
    trace = _golden()
    assert P.replay(trace, world=2) == J.replay(trace, world=2) == 20
    ka = ("a", "allreduce", "float32", (8,), 0, True, None)
    demote = [("tick_full", 0, ka), ("tick_full", 1, ka), ("assign", 0, ka),
              ("execute", ka), ("demote", 0), ("demote", 1), ("redo", ka),
              ("repromote", 0), ("repromote", 1)]
    assert P.replay(demote, world=2) == len(demote)


def test_corrupted_traces_fail_alike():
    import test_protocol as ref

    ka2 = ("a", "allreduce", "float32", (16,), 0, True, None)
    mutations = [
        lambda t: [("tick_cached", 0, ref.KEY_A)] + t,
        lambda t: t[:4] + [("assign", 0, ka2)] + t[4:],
        lambda t: t[:2] + [("execute", ref.KEY_A)] * 2 + t[3:],
        lambda t: t[:13] + [("tick_cached", 0, ka2)] + t[13:],
        lambda t: t + [("redo", ka2)],
        lambda t: t + [("bogus", 0)],
    ]
    for mutate in mutations:
        trace = mutate(_golden())
        with pytest.raises(J.ProtocolViolation) as je:
            J.replay(trace, world=2)
        with pytest.raises(P.ProtocolViolation) as pe:
            P.replay(trace, world=2)
        assert (pe.value.index, pe.value.why) == (je.value.index, je.value.why)


def test_engine_transition_streams_equal_the_golden():
    import test_protocol as ref

    step = """        stream.append([
            "hit" if after["hits"] > before["hits"] else "miss",
            int(before["size"]), int(after["size"])])
"""
    assert step in ref.CACHE_TRACE_WORKER
    barrier = step + ("        eng.run('allgather', np.zeros(1, np.int32), "
                      "f'barrier.{len(stream)}')\n")
    streams = {}
    for pkg in ("horovod_tpu_torch", "horovod_tpu"):
        script = ref.CACHE_TRACE_WORKER.replace(step, barrier).replace(
            "horovod_tpu.", pkg + ".")
        outs = [r["out"] for r in launch_world(
            2, script, extra_env={"HOROVOD_ENGINE": "python",
                                  "JAX_PLATFORMS": "cpu"})]
        streams[pkg] = next(o["stream"] for o in outs if o["rank"] == 0)
    assert streams["horovod_tpu_torch"] == streams["horovod_tpu"] == \
        ref.GOLDEN_STREAM
