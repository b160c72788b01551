"""The eager engine wired into the port's entry points:

- ``hvd.allreduce``/``allgather``/``broadcast``/``alltoall``/
  ``reducescatter`` of a numpy array or a Python scalar go to
  ``basics.engine().run`` with the JAX package's name, ``root_rank`` and
  averaging arguments, and return numpy; a ``torch.Tensor`` keeps the
  ``torch.distributed`` path and never reaches the engine;
- ``basics.engine()`` attaches once per world and ``shutdown`` ends it
  (the Python engine, ``HOROVOD_ENGINE=python``); under
  ``HOROVOD_ENGINE=native!`` it attaches the native engine, and
  ``reset_engine`` builds a new one; a sub-world of ``init(comm=[0, 2])`` gets an engine over its members only;
- ``TrainingController(engine=...)`` commits a wire change through the
  Python engine's ``set_knobs``, and every rank of a launched world adopts it (the knob
  epoch and table), the next allreduce bitwise the bf16 oracle of the JAX
  package;
- an elastic reset with the same members (``run_elastic``, one rank
  raising ``HorovodInternalError``) rebuilds the Python engine: the next
  generation runs on a new engine whose cache starts cold, and the job
  ends with the total of a run with no fault;
- ``utils.timeline.trace`` writes the engine's host pane
  (``host_timeline.json``) beside the device pane;
- ``examples/torch_mnist_eager.py`` under the launcher at ``-np 2`` on the
  CPU, on the Python engine: every rank's final parameters bitwise equal, step 1's averaged
  gradient leaves bitwise ``_ring_order_reduce`` of the two ranks' local
  leaves, a falling loss.
Tolerance: none."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from launch_util import REPO, launch_world

WORKER_PATH = os.pathsep.join([os.path.join(REPO, "tests"), REPO])


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_ENGINE", "python")
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


class _Recording:
    def __init__(self):
        self.calls = []

    def run(self, op, array, name=None, **kw):
        self.calls.append((op, np.asarray(array).tolist(), name, kw))
        return np.asarray(array)


def test_host_values_route_to_the_engine(world_of_one, monkeypatch):
    rec = _Recording()
    monkeypatch.setattr(basics, "engine", lambda: rec)
    a = np.arange(4.0)
    hvd.allreduce(a, name="a")
    hvd.allreduce(2.5, op=hvd.ReduceOp.SUM, name="s")
    hvd.allgather(a, name="g")
    hvd.broadcast(a, root_rank=0, name="b")
    hvd.alltoall(a, name="t")
    hvd.reducescatter(a, average=True, name="r")
    assert rec.calls == [
        ("allreduce", a.tolist(), "a", {"average": True}),
        ("allreduce", 2.5, "s", {"average": False}),
        ("allgather", a.tolist(), "g", {}),
        ("broadcast", a.tolist(), "b", {"root_rank": 0}),
        ("alltoall", a.tolist(), "t", {}),
        ("reducescatter", a.tolist(), "r", {"average": True}),
    ]
    with pytest.raises(ValueError, match="SUM or AVERAGE"):
        hvd.allreduce(a, op=hvd.ReduceOp.MAX)
    out = hvd.allreduce(torch.ones(3))           # a tensor: torch.distributed
    assert isinstance(out, torch.Tensor) and len(rec.calls) == 6


def test_engine_attaches_once_and_shutdown_ends_it(world_of_one):
    eng = basics.engine()
    assert basics.engine() is eng
    out = hvd.allreduce(np.arange(3.0), name="x")
    assert isinstance(out, np.ndarray) and out.tolist() == [0.0, 1.0, 2.0]
    assert hvd.allgather(np.ones((2, 2)), name="y").shape == (2, 2)
    basics.reset_engine()
    assert basics.engine() is not eng
    assert eng._shutdown.is_set() and not eng._thread.is_alive()


def test_native_engine_attaches_through_basics(world_of_one, monkeypatch):
    from horovod_tpu_torch.cc.native_engine import NativeEngine

    monkeypatch.setenv("HOROVOD_ENGINE", "native!")
    eng = basics.engine()
    assert isinstance(eng, NativeEngine) and basics.engine() is eng
    out = hvd.allreduce(np.arange(3.0), name="x")
    assert isinstance(out, np.ndarray) and out.tolist() == [0.0, 1.0, 2.0]
    basics.reset_engine()
    again = basics.engine()
    assert isinstance(again, NativeEngine) and again is not eng
    assert hvd.allgather(np.ones((2, 2)), name="y").shape == (2, 2)


SUBWORLD_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, os.environ["HVD_REPO"])
import numpy as np
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
launched = int(os.environ["HOROVOD_RANK"])
if launched == 1:
    print(json.dumps({"member": False}))
    sys.exit(0)
hvd.init(device="cpu", comm=[0, 2])
out = hvd.allreduce(np.array([launched + 1.0]), op=hvd.ReduceOp.SUM, name="m")
got = hvd.allgather(np.array([launched]), name="who")
print(json.dumps({"member": True, "rank": hvd.rank(), "size": hvd.size(),
                  "sum": out.tolist(), "who": got.tolist(),
                  "engine_size": basics.engine().topo.size}))
hvd.shutdown()
"""


def test_subworld_engine_spans_its_members():
    outs = [r["out"] for r in launch_world(3, SUBWORLD_SCRIPT, extra_env={
        "HOROVOD_STALL_CHECK_DISABLE": "1"})]
    assert outs[1] == {"member": False}
    assert [(o["rank"], o["size"], o["engine_size"]) for o in (outs[0], outs[2])] \
        == [(0, 2, 2), (1, 2, 2)]
    assert outs[0]["sum"] == outs[2]["sum"] == [4.0]
    assert outs[0]["who"] == outs[2]["who"] == [0, 2]


KNOB_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, os.environ["HVD_REPO"])
import numpy as np
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.control import TrainingController
hvd.init(device="cpu")
eng = basics.engine()
before = eng._knobs["compression"]
hvd.allreduce(np.zeros(1), name="barrier.0")
if hvd.rank() == 0:
    ctl = TrainingController(engine=eng)
    ctl._apply("compression", "bf16")
hvd.allreduce(np.zeros(1), name="barrier.1")
x = np.random.default_rng(hvd.rank()).standard_normal(4099).astype(np.float32)
out = hvd.allreduce(x, name="k")
print(json.dumps({"before": before, "after": eng._knobs["compression"],
                  "epoch": eng.knob_epoch(), "hex": out.tobytes().hex()}))
hvd.shutdown()
"""


def test_training_controller_sets_the_wire_world_wide():
    import ml_dtypes

    from horovod_tpu.common.engine import _ring_order_reduce

    outs = [r["out"] for r in launch_world(3, KNOB_SCRIPT, extra_env={
        "HOROVOD_ENGINE": "python", "HOROVOD_STALL_CHECK_DISABLE": "1"})]
    assert [(o["before"], o["after"], o["epoch"]) for o in outs] == \
        [("none", "bf16", 1)] * 3
    wd = np.dtype(ml_dtypes.bfloat16)
    pay = [np.random.default_rng(r).standard_normal(4099).astype(np.float32)
           for r in range(3)]
    want = _ring_order_reduce([p.astype(wd).astype(np.float32) for p in pay],
                              True, wire_dtype=wd)
    assert {o["hex"] for o in outs} == {want.tobytes().hex()}


def test_elastic_reset_rebuilds_the_engine(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_port_eager_worker as worker

    from horovod_tpu_torch.runner import run_elastic

    env = {"PYTHONPATH": WORKER_PATH, "HOROVOD_STALL_CHECK_TIME": "1",
           "HOROVOD_STALL_SHUTDOWN_TIME": "5", "HOROVOD_ENGINE": "python"}
    steps = 5
    results = run_elastic(worker.engine_train, args=(steps,),
                          kwargs={"raise_at": (1, 3)}, num_proc=2,
                          timeout=180, env=env)
    want = sum(float(s + 0.5) for s in range(steps))   # mean of s, s + 1
    for r in results:
        assert r["step"] == steps and r["total"] == want
        assert len(r["seen"]) == 2                       # one reset each
        first, second = r["seen"]
        assert first["engine"] != second["engine"]
        assert second["hits_before"] == 0                # a cold cache


def test_timeline_trace_writes_the_host_pane(world_of_one, tmp_path):
    from horovod_tpu_torch.utils import timeline

    basics.engine()
    with timeline.trace(str(tmp_path), mark_cycles=True):
        hvd.allreduce(np.ones(3), name="pane.a")
        hvd.allgather(np.ones((1, 2)), name="pane.b")
    with open(tmp_path / timeline.HOST_TIMELINE) as f:
        events = json.load(f)
    names = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    assert {"pane.a", "pane.b"} <= names
    assert os.path.exists(tmp_path / timeline.DEVICE_TRACE)
    assert basics.engine()._timeline is None         # the scope's own, closed


def test_eager_mnist_example_on_the_cpu(tmp_path):
    from horovod_tpu_torch.common.engine import _ring_order_reduce

    env = dict(os.environ, MNIST_EPOCHS="2", MNIST_STEPS="4",
               PYTHONPATH=REPO, HOROVOD_STALL_CHECK_DISABLE="1",
               HOROVOD_ENGINE="python")
    subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2", "--",
         sys.executable, os.path.join(REPO, "examples", "torch_mnist_eager.py"),
         "--device", "cpu", "--dump", str(tmp_path / "dump"),
         "--trace", str(tmp_path / "trace")],
        env=env, cwd=REPO, check=True, timeout=300)
    d = [np.load(tmp_path / "dump" / f"rank{r}.npz") for r in range(2)]
    params = [k for k in d[0].files if k.startswith("param.")]
    assert params
    for k in params:
        assert d[0][k].tobytes() == d[1][k].tobytes(), k
    grads = [k[4:] for k in d[0].files if k.startswith("avg.")]
    assert len(grads) == len(params)
    for n in grads:
        want = _ring_order_reduce([d[0]["local." + n], d[1]["local." + n]],
                                  True)
        assert d[0]["avg." + n].tobytes() == want.tobytes(), n
        assert d[1]["avg." + n].tobytes() == want.tobytes(), n
    losses = d[0]["losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    with open(tmp_path / "trace" / "host_timeline.json") as f:
        names = {e["args"]["name"] for e in json.load(f) if e.get("ph") == "M"}
    assert {f"grad.{n}" for n in grads} <= names
    launches = {k: int(d[r][k]) for r in range(2) for k in d[r].files
                if k.startswith("launches.")}
    assert len(launches) == 6 and not any(launches.values())
