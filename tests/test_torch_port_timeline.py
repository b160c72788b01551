"""The port's timeline (``horovod_tpu_torch/utils/timeline.py``) against
the JAX package's: both ``Timeline`` writers fed the same calls write the
same events, names, phases, pids, tids and order alike (timestamps
excepted); an unwritable path counts its drops in the port's metrics
registry; and ``trace(log_dir)`` writes the device pane, a
``torch.profiler`` Chrome trace of its scope (the host pane waits for a
host engine). Each writer is drained with ``close()``, never with a
sleep."""

import json

import torch

from horovod_tpu.utils.timeline import Timeline as JaxTimeline
from horovod_tpu_torch.metrics import registry
from horovod_tpu_torch.utils import timeline
from horovod_tpu_torch.utils.timeline import Timeline


def _feed(tl):
    for name in ("grad/w", "grad/b"):
        tl.negotiate_start(name, "ALLREDUCE")
        tl.negotiate_rank_ready(name, 0)
        tl.negotiate_rank_ready(name, 1)
        tl.start(name, "ALLREDUCE", tid="t-7" if name == "grad/b" else None)
        tl.activity_start(name, "MEMCPY_IN_FUSION_BUFFER")
        tl.activity_end(name)
        tl.activity_start(name, "NCCL_ALLREDUCE")
        tl.activity_end(name)
        tl.end(name)
        tl.mark_cycle()
    tl.negotiate_start("grad/w", "BROADCAST", tid="t-8")
    tl.end("grad/w")
    tl.close()


def _events(path):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in json.loads(open(path).read())]


def test_timeline_events_match_the_reference(tmp_path):
    for marks in (True, False):
        paths = [str(tmp_path / f"{who}{marks}.json") for who in ("jax", "port")]
        _feed(JaxTimeline(paths[0], mark_cycles=marks))
        _feed(Timeline(paths[1], mark_cycles=marks))
        want, got = _events(paths[0]), _events(paths[1])
        assert got == want
        names = [e["name"] for e in got]
        assert "NEGOTIATE_ALLREDUCE" in names and "NCCL_ALLREDUCE" in names
        assert ("CYCLE_START" in names) is marks
        assert {"trace_id": "t-7"} in [e.get("args") for e in got]
        stamps = [e["ts"] for e in json.loads(open(paths[1]).read()) if "ts" in e]
        assert stamps == sorted(stamps)


def test_timeline_unwritable_path_counts_drops(tmp_path):
    counter = registry().counter("horovod_timeline_dropped_total")
    before = counter.value
    tl = Timeline(str(tmp_path / "no" / "such" / "dir" / "t.json"))
    for i in range(5):
        tl.start(f"tensor.{i}", "ALLREDUCE")
        tl.end(f"tensor.{i}")
    tl.close()
    # 5 starts (each ending a negotiation first) + 5 ends + 5 pid records
    assert counter.value - before == 20 == tl.dropped


def test_trace_writes_the_device_pane(tmp_path):
    log_dir = tmp_path / "profile"
    with timeline.trace(str(log_dir)) as where:
        assert where == str(log_dir)
        torch.mm(torch.ones(64, 64), torch.ones(64, 64)).sum()
    trace = json.loads((log_dir / timeline.DEVICE_TRACE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert sorted(p.name for p in log_dir.iterdir()) == [timeline.DEVICE_TRACE]
