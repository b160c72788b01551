"""The port's native eager engine on launched worlds of processes,
bitwise against the canonical oracle (``tests/engine_matrix.py``, the JAX
package's ``_ring_order_reduce``) and the JAX package's native engine:

- 4-process worlds (``tests/torch_port_engine_matrix_worker.py``) under
  ``HOROVOD_ENGINE=native!``: the flat ring and the two-level plane (2
  fake hosts of 2 ranks) under every wire, cold and cached; the Python
  engine's world and the native one on the same script, each the oracle;
  mixed worlds of the two packages' native cores (ranks 0 and 2 on
  ``horovod_tpu_torch``, 1 and 3 on ``horovod_tpu``, or the other way
  round), which hold the wire byte for byte; the same-host shm links on (2
  per rank) and off (0) with the same digests; the two-stage allgather on
  fake hosts, bitwise the flat allgather with fewer cross-host bytes;
- the checks of ``tests/test_ring_engine.py`` on the port's engine, each
  with the reference's assertion: a wrong secret refused, a peer's death
  mid-collective failing the survivors cleanly, the stall warning naming
  the missing rank, the autotuner's knobs identical on every rank, a
  bfloat16 NaN kept through the reduction, fusion running fewer ring
  passes;
- an elastic reset in a 2-rank gloo world on the native engine: the next
  generation's engine is a new one, and the job's total is the total of a
  run with no fault;
- ``examples/torch_engine_benchmark.py`` at ``-np 2`` prints its GB/s.

Tolerance: none.
"""

from __future__ import annotations

import json
import os
import secrets
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from engine_matrix import WORLD, matrix_world, oracle_digest
from launch_util import REPO, free_port, launch_world

NATIVE = "native!"


@pytest.fixture(scope="module", autouse=True)
def built():
    from horovod_tpu.cc import lib_path as j_lib
    from horovod_tpu_torch.cc import lib_path as p_lib

    j_lib()
    p_lib()


def _hold(outs, comp, grid=None):
    assert {o["hash"] for o in outs} == {oracle_digest(comp, grid=grid)}
    assert all(o["hits"] >= 1 for o in outs)       # step 3 rode the cache


@pytest.mark.parametrize("plane", ["ring", "hier"])
@pytest.mark.parametrize("comp", ["none", "bf16", "fp16", "topk"])
def test_native_world_equals_the_oracle(comp, plane):
    outs = matrix_world(comp, plane, engine=NATIVE)
    _hold(outs, comp, grid=(2, 2) if plane == "hier" else None)
    assert {o["plane"] for o in outs} == {plane}
    assert {o["engine"] for o in outs} == {"NativeEngine"}


def test_python_and_native_worlds_equal_the_oracle_and_each_other():
    outs = {e: matrix_world("bf16", "ring", engine=e)
            for e in ("python", NATIVE)}
    assert {o["engine"] for o in outs["python"]} == {"PyEngine"}
    for e in outs:
        _hold(outs[e], "bf16")


@pytest.mark.parametrize("plane,comp,coordinator", [
    ("ring", "none", "horovod_tpu_torch"), ("ring", "bf16", "horovod_tpu"),
    ("hier", "topk", "horovod_tpu_torch")])
def test_mixed_native_world_equals_the_oracle(plane, comp, coordinator):
    other = ("horovod_tpu_torch" if coordinator == "horovod_tpu"
             else "horovod_tpu")
    per = {r: coordinator if r % 2 == 0 else other for r in range(WORLD)}
    outs = matrix_world(comp, plane, per_rank_pkg=per, engine=NATIVE)
    _hold(outs, comp, grid=(2, 2) if plane == "hier" else None)
    assert {o["engine"] for o in outs} == {"NativeEngine"}


def test_shm_links_on_and_off_give_the_same_digests():
    got = {}
    for shm in ("1", "0"):
        got[shm] = matrix_world("none", "ring", engine=NATIVE, extra={
            "T_LOCAL": str(WORLD), "HOROVOD_SHM": shm})
        _hold(got[shm], "none")
    assert [o["shm_links"] for o in got["1"]] == [2] * WORLD
    assert [o["shm_links"] for o in got["0"]] == [0] * WORLD


def test_two_stage_allgather_equals_the_flat_one_with_fewer_cross_bytes():
    got = {}
    for hier in ("0", "1"):
        got[hier] = [o["gather"] for o in matrix_world(
            "none", "ring", engine=NATIVE, extra={
                "T_LOCAL": "2", "T_GATHER": "1", "T_HIER_AG": hier})]
    rows = sum(r + 1 for r in range(WORLD))
    for hier in got:
        assert {g["hash"] for g in got[hier]} == {got["0"][0]["hash"]}
        assert {tuple(g["shape"]) for g in got[hier]} == {(rows, 1031)}
    assert [g["hier"] for g in got["1"]] == [1] * WORLD
    assert [g["hier"] for g in got["0"]] == [0] * WORLD
    flat = sum(g["cross_bytes"] for g in got["0"])
    two = sum(g["cross_bytes"] for g in got["1"])
    assert 0 < two < flat, (two, flat)


# ------------------------------------------- tests/test_ring_engine.py's checks

PRELUDE = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    sys.path.insert(0, os.environ["HVD_REPO"])
    from horovod_tpu_torch.cc.native_engine import NativeEngine
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.common.topology import Topology

    rank = int(os.environ["HOROVOD_RANK"])
    world = int(os.environ["HOROVOD_SIZE"])
    topo = Topology(rank, world, rank, world, 0, 1)
""")


def test_fusion_executes_fewer_ring_passes():
    script = PRELUDE + textwrap.dedent("""
        eng = NativeEngine(topo, Config(cycle_time_ms=300.0))
        handles = [eng.enqueue("allreduce", np.full(64, float(rank + i)), f"g{i}")
                   for i in range(50)]
        outs = [eng.synchronize(h, timeout=60) for h in handles]
        st = eng.stats()
        ok = all(np.allclose(o, np.mean([r + i for r in range(world)]))
                 for i, o in enumerate(outs))
        eng.shutdown()
        print(json.dumps({"ok": ok, "passes": st["ring_passes"]}))
    """)
    for res in launch_world(2, script):
        assert res["out"]["ok"] is True
        assert res["out"]["passes"] <= 5, res["out"]


def test_stall_warning_names_missing_ranks():
    script = PRELUDE + textwrap.dedent("""
        import time
        eng = NativeEngine(topo, Config(cycle_time_ms=5.0, stall_warning_s=1.0))
        h = None
        if rank == 0:
            h = eng.enqueue("allreduce", np.ones(4), "lonely")
        time.sleep(3.0)
        if rank == 1:
            h = eng.enqueue("allreduce", np.ones(4), "lonely")
        out = eng.synchronize(h, timeout=30)
        eng.shutdown()
        print(json.dumps({"ok": bool(np.allclose(out, 1.0))}))
    """)
    for rank, res in enumerate(launch_world(2, script, timeout=120)):
        assert res["out"]["ok"] is True
        assert "missing ranks: 1" in res["stderr"], (
            f"rank {rank} stderr lacks missing-rank stall warning:\n"
            + res["stderr"][-2000:])
        assert "lonely" in res["stderr"]


def test_autotuner_knobs_identical_across_ranks():
    script = PRELUDE + textwrap.dedent("""
        eng = NativeEngine(topo, Config(cycle_time_ms=1.0, autotune=True))
        for i in range(300):
            eng.run("allreduce", np.ones(256, dtype=np.float32), f"t{i}")
        st = eng.stats()
        eng.shutdown()
        print(json.dumps({"version": st["knob_version"],
                          "threshold": st["fusion_threshold"],
                          "cycle": st["cycle_time_ms"]}))
    """)
    outs = [r["out"] for r in launch_world(4, script, timeout=300)]
    assert outs[0]["version"] > 0, f"autotuner never moved knobs: {outs[0]}"
    for o in outs[1:]:
        assert o == outs[0], f"ranks diverged: {outs}"


def test_bf16_nan_preserved_through_reduction():
    script = PRELUDE + textwrap.dedent("""
        from horovod_tpu_torch.compression import BFLOAT16, cast
        eng = NativeEngine(topo, Config(cycle_time_ms=2.0))
        val = cast(np.array([np.nan if rank == 0 else 1.0, 2.0], np.float32),
                   BFLOAT16)
        out = eng.run("allreduce", val, "nan_t", average=False)
        eng.shutdown()
        f32 = cast(out, np.float32)
        print(json.dumps({"nan": bool(np.isnan(f32[0])),
                          "rest": float(f32[1]), "bf16": out.dtype == BFLOAT16}))
    """)
    for res in launch_world(2, script):
        assert res["out"] == {"nan": True, "rest": 4.0, "bf16": True}


def test_wrong_secret_rejected():
    script = PRELUDE + textwrap.dedent("""
        try:
            eng = NativeEngine(topo, Config(cycle_time_ms=5.0))
            print(json.dumps({"joined": True}))
        except Exception as e:
            print(json.dumps({"joined": False, "error": str(e)[:200]}))
    """)
    port = free_port()
    common = {"HVD_REPO": REPO, "HOROVOD_SIZE": "2",
              "HOROVOD_COORD_ADDR": f"127.0.0.1:{port}"}
    good, bad = secrets.token_hex(16), secrets.token_hex(16)
    p1 = subprocess.Popen(
        [sys.executable, "-c", script],
        env=dict(os.environ, **common, HOROVOD_RANK="1", HOROVOD_SECRET=bad),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    p0 = subprocess.Popen(
        [sys.executable, "-c", script],
        env=dict(os.environ, **common, HOROVOD_RANK="0", HOROVOD_SECRET=good),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        stdout, _ = p1.communicate(timeout=90)
        out = json.loads(stdout.strip().splitlines()[-1])
        assert out["joined"] is False, "wrong-secret rank joined the job"
        assert "authentication" in out["error"] or "auth" in out["error"].lower() \
            or "recv" in out["error"].lower(), out
    finally:
        p0.kill()
        p1.kill()
        p0.communicate(timeout=10)


def test_peer_death_mid_collective_fails_cleanly():
    script = PRELUDE + textwrap.dedent("""
        import signal
        from horovod_tpu_torch.common.engine import HorovodInternalError
        eng = NativeEngine(topo, Config(cycle_time_ms=2.0))
        internal = []
        out = eng.run("allreduce", np.full(1024, float(rank)), "warm")
        ok_warm = bool(np.allclose(out, np.mean(range(world))))
        if rank == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        results = []
        for i in range(3):
            try:
                eng.run("allreduce", np.full(2_000_000, float(rank)),
                        f"big{i}", average=False)
                results.append("ok")
            except Exception as e:
                results.append(type(e).__name__ + ":" + str(e)[:80])
                internal.append(isinstance(e, HorovodInternalError))
        try:
            eng.shutdown()
        except Exception:
            pass
        print(json.dumps({"warm": ok_warm, "results": results,
                          "internal": internal}))
    """)
    res = launch_world(3, script, timeout=300, check=False)
    assert res[2]["rc"] != 0
    for r in (res[0], res[1]):
        assert r["rc"] == 0, f"survivor crashed instead of erroring:\n{r['stderr'][-2000:]}"
        out = r["out"]
        assert out is not None, f"survivor printed no result:\n{r['stderr'][-2000:]}"
        assert out["warm"] is True
        assert all(x != "ok" for x in out["results"]), out["results"]
        assert out["internal"] == [True] * 3, out["results"]


# ------------------------------------------------------------ elastic, example

def test_elastic_reset_rebuilds_the_native_engine():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_port_eager_worker as worker

    from horovod_tpu_torch.runner import run_elastic

    env = {"PYTHONPATH": os.pathsep.join([os.path.join(REPO, "tests"), REPO]),
           "HOROVOD_STALL_CHECK_TIME": "1", "HOROVOD_STALL_SHUTDOWN_TIME": "5",
           "HOROVOD_ENGINE": NATIVE}
    steps = 5
    results = run_elastic(worker.engine_train, args=(steps,),
                          kwargs={"raise_at": (1, 3)}, num_proc=2,
                          timeout=180, env=env)
    want = sum(float(s + 0.5) for s in range(steps))   # mean of s, s + 1
    for r in results:
        assert r["step"] == steps and r["total"] == want
        assert len(r["seen"]) == 2
        first, second = r["seen"]
        assert first["engine"] != second["engine"]
        assert second["hits_before"] == 0
        assert {e["class"] for e in r["seen"]} == {"NativeEngine"}


def test_engine_benchmark_example_prints_its_rate():
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2", "--",
         sys.executable, os.path.join(REPO, "examples",
                                      "torch_engine_benchmark.py"),
         "--mb", "4", "--tensors", "16", "--steps", "2", "--warmup", "1",
         "--dtype", "bf16"],
        env=dict(os.environ, PYTHONPATH=REPO, HOROVOD_ENGINE=NATIVE,
                 HOROVOD_STALL_CHECK_DISABLE="1"),
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads([ln for ln in proc.stdout.splitlines()
                       if ln.startswith("{")][-1])
    assert line["engine"] == "NativeEngine" and line["world"] == 2
    assert line["dtype"] == "bf16" and line["tensors"] == 16
    assert np.isfinite(line["gb_per_s"]) and line["gb_per_s"] > 0
    assert line["correct"] is True
