"""The port's scaling benchmark (``examples/torch_scaling_benchmark.py``)
on the CPU at a small size, against the JAX package's
(``examples/scaling_benchmark.py``) where both measure the same thing.

- The eager sweep's structure at worlds (2, 3), 4 MB, 1 iteration; a
  world above the host's CPUs is named as dropped.
- ``eager_hierarchical(world=4, local=2)``: each side's worst rank's
  cross-host bytes, flat and two-level, equal the JAX example's run on
  the same arguments exactly (the same core and the same ring plan).
- The compiled section on gloo at worlds (1, 2), one step, with the
  bucket A/B in the largest world: structure only.
- The projection's invariants: the ladder's ``t_comm`` strictly below
  flat's, a hostile setting below 0.5, every efficiency in (0, 1], and no
  TPU name or figure in its output.
"""

import importlib.util
import json
import os

import pytest

from launch_util import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_scaling_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def port(monkeypatch):
    ex = _example("torch_scaling_benchmark")
    monkeypatch.setattr(ex, "_free_port", free_port)
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORD_ADDR",
              "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    return ex


def test_eager_sweep_structure(port, monkeypatch):
    monkeypatch.setattr(port, "HOST_CPUS", 3)
    out = port.eager_scaling(worlds=(2, 3, 4), payload_mb=4, iters=1)
    assert out["baseline_world"] == 2 and out["host_cpus"] == 3
    assert out["dropped_worlds"] == [
        {"world": 4, "reason": "more ranks than the host's 3 CPUs"}]
    assert [r["world"] for r in out["worlds"]] == [2, 3]
    first = out["worlds"][0]
    assert first["per_rank_efficiency"] == 1.0
    assert first["software_efficiency"] == 1.0
    for r in out["worlds"]:
        assert set(r) == {"world", "import_s", "MB_per_s_rank",
                          "per_rank_efficiency", "aggregate_MB_per_s",
                          "software_efficiency"}
        assert r["MB_per_s_rank"] > 0 and r["import_s"] > 0


def test_hierarchical_cross_bytes_equal_the_jax_example(port, monkeypatch):
    jax_ex = _example("scaling_benchmark")
    monkeypatch.setattr(jax_ex, "_free_port", free_port)
    elems = int(4 * (1 << 20) / 4)
    want = {hier: max(r["cross_bytes"] for r in jax_ex._run_world(
        4, elems, 1, local=2, hier=hier)) for hier in (False, True)}
    got = port.eager_hierarchical(world=4, local=2, payload_mb=4, iters=1)
    assert got["flat_worst_rank_cross_bytes"] == want[False]
    assert got["hier_worst_rank_cross_bytes"] == want[True]
    assert 0 < want[True] < want[False]
    assert got["hosts"] == 2 and got["ranks_per_host"] == 2
    assert got["cross_byte_ratio"] == round(want[True] / want[False], 3)


def test_compiled_section_structure_on_gloo(port):
    out, ab = port.compiled_scaling(worlds=(1, 2), steps=1, reps=1,
                                    ab_grid=(2,))
    assert [r["num_buckets"] for r in ab["rows"]] == [1, 2]
    assert ab["world"] == 2 and ab["best_num_buckets"] == 2
    assert all(r["step_ms"] > 0 for r in ab["rows"])
    assert [r["world"] for r in out["worlds"]] == [1, 2]
    assert all(r["backend"] == "gloo" and r["step_ms"] > 0
               for r in out["worlds"])
    assert out["worlds"][0]["efficiency"] == 1.0
    assert out["global_batch"] == 64 and out["seq"] == 128
    nccl = out["nccl"]
    run = [r["world"] for r in nccl["worlds"]]
    skipped = [r["world"] for r in nccl["not_run"]]
    assert sorted(run + skipped) == [1, 2]
    assert all(r["reason"] for r in nccl["not_run"])


def test_projection_invariants(port):
    out = port.project_pod_efficiency(step_ms=40.0)
    rows = out["rows"]
    assert [r["gpus"] for r in rows] == [8, 64, 64, 256, 256, 512, 512]
    for gpus in (64, 256, 512):
        flat, ladder = [r for r in rows if r["gpus"] == gpus]
        assert "flat" in flat["fabric"] and "ladder" in ladder["fabric"]
        assert ladder["t_comm_ms"] < flat["t_comm_ms"]
    assert all(0 < r["efficiency"] <= 1 for r in rows)
    hostile = port.project_pod_efficiency(step_ms=1.0, overlap=0.0)
    assert min(r["efficiency"] for r in hostile["rows"]) < 0.5
    assert all(0 < r["efficiency"] <= 1 for r in hostile["rows"])
    text = json.dumps([out, hostile])
    for word in ("v5e", "tpu", "pod", "2489"):
        assert word not in text.lower(), word
    for word in ("ICI", "DCN"):
        assert word not in text, word
    with pytest.raises(ValueError):
        port.project_pod_efficiency(step_ms=0)
    with pytest.raises(SystemExit):
        port.parse_args(["--project"])
