"""The port's native eager engine (``horovod_tpu_torch.cc``: the C++ core
built from the port's own ``cc/src``, ``NativeEngine`` over ctypes)
against the JAX package's (``horovod_tpu.cc``), on the same numpy inputs:

- a world of one: every op and dtype, bfloat16 as 16-bit patterns (NaN
  payloads included), bitwise the JAX engine's; a duplicate live name
  refused; auto-names unique; a timed-out wait keeps its handle; a scalar
  allgather refused; the timeline's names;
- a launched world of two per package: every op and dtype with a real
  reduction, and the shape mismatch raising ``TensorShapeMismatchError``
  on every rank, bitwise the JAX world's;
- the build: ``HVD_NATIVE_LIB`` to a missing file raises
  ``NativeBuildError``; two processes building a copy of the tree at once
  leave one library, compiled once (a stand-in compiler counts its runs);
  an edited source in that copy builds afresh;
- ``create``: ``native!`` raises when the library cannot load, and a world
  of one falls back to the Python engine with the JAX package's log line;
- the protocol spec: ``tools/analyze/protocol.py``'s ``extract`` pointed
  at the port's C++ and engines equals ``common/protocol_spec.json``, its
  native tables equal ``docs/protocol_spec.json``'s, and ``verify_spec()``
  is ``[]``;
- ``autotune.ParameterManager``: the knob trajectory of the same samples,
  pins, bucket count and hierarchy through both packages, step by step;
  ``autotune.gp_fit_predict`` (the GP that ``tune`` ranks with) bitwise
  the JAX package's; the convergence and pin checks of
  ``tests/test_autotune.py``;
- ``runner --check-build`` names the native engine's library;
- the coordinator's listener (``hvd_coord_listen``, the port's one code
  difference from the JAX core): repeated listen -> init -> shutdown
  cycles, an init that fails after adopting the listener among them,
  leave the process's count of open descriptors unchanged.

Tolerance: none.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from launch_util import REPO, launch_world

import horovod_tpu.autotune as J_autotune
from horovod_tpu.common.config import Config as JConfig
from horovod_tpu.common.topology import Topology as JTopology
from horovod_tpu_torch import autotune as P_autotune
from horovod_tpu_torch.common import engine as P_engine
from horovod_tpu_torch.common import protocol as P_protocol
from horovod_tpu_torch.common.config import Config as PConfig
from horovod_tpu_torch.common.topology import Topology as PTopology
from horovod_tpu_torch.compression import BFLOAT16

OPS = ["allreduce", "allgather", "broadcast", "alltoall", "reducescatter"]
DTYPES = ["uint8", "int8", "int32", "int64", "float16", "bfloat16",
          "float32", "float64"]


@pytest.fixture(scope="module")
def engines():
    from horovod_tpu.cc import lib_path as j_lib
    from horovod_tpu.cc.native_engine import NativeEngine as J
    from horovod_tpu_torch.cc import lib_path as p_lib
    from horovod_tpu_torch.cc.native_engine import NativeEngine as P

    j_lib()
    p_lib()
    return J, P


def _one(cls, pkg: str, cycle_ms: float = 1.0):
    topo = (JTopology if pkg == "jax" else PTopology)(0, 1, 0, 1, 0, 1)
    cfg = (JConfig if pkg == "jax" else PConfig)(cycle_time_ms=cycle_ms,
                                                 stall_check_disable=True)
    return cls(topo, cfg)


def _payload(dtype: str, op: str, seed: int) -> np.ndarray:
    """16-bit patterns for bfloat16 (NaNs with payloads among them)."""
    rng = np.random.default_rng(seed)
    shape = (4, 5) if op in ("alltoall", "reducescatter") else (3, 7)
    if dtype == "bfloat16":
        bits = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
        bits.flat[:3] = [0x7FC1, 0xFFA3, 0x7F80]
        return bits
    x = rng.standard_normal(shape) * 50
    return x.astype(dtype)


def _as_pkg(a: np.ndarray, dtype: str, pkg: str) -> np.ndarray:
    if dtype != "bfloat16":
        return a
    if pkg == "jax":
        import ml_dtypes

        return a.view(ml_dtypes.bfloat16)
    return a.view(BFLOAT16)


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def test_world_of_one_every_op_and_dtype_equals_the_jax_engine(engines):
    J, P = engines
    got = {}
    for pkg, cls in (("jax", J), ("port", P)):
        eng = _one(cls, pkg)
        try:
            for op in OPS:
                for dt in DTYPES:
                    a = _as_pkg(_payload(dt, op, OPS.index(op)), dt, pkg)
                    out = eng.run(op, a, f"{op}.{dt}")
                    got[pkg, op, dt] = (out.shape, out.dtype.itemsize,
                                        _bits(out))
            bf = eng.run("allreduce", _as_pkg(_payload("bfloat16", "x", 5),
                                              "bfloat16", pkg), "bf")
            if pkg == "port":
                assert bf.dtype == BFLOAT16
        finally:
            eng.shutdown()
    for op in OPS:
        for dt in DTYPES:
            assert got["port", op, dt] == got["jax", op, dt], (op, dt)


def test_duplicate_name_refused(engines, monkeypatch):
    _, P = engines
    monkeypatch.setenv("HOROVOD_WAKE_ON_ENQUEUE", "0")
    eng = _one(P, "port", cycle_ms=500.0)
    try:
        h1 = eng.enqueue("allreduce", np.ones(4), "dup")
        with pytest.raises(P_engine.HorovodInternalError,
                           match="Duplicate tensor name"):
            eng.enqueue("allreduce", np.ones(4), "dup")
        eng.synchronize(h1, timeout=10)
        eng.synchronize(eng.enqueue("allreduce", np.ones(4), "dup"), timeout=10)
    finally:
        eng.shutdown()


def test_auto_names_unique(engines):
    _, P = engines
    eng = _one(P, "port")
    try:
        h1 = eng.enqueue("allreduce", np.full(3, 1.0), None)
        h2 = eng.enqueue("allreduce", np.full(3, 2.0), None)
        assert eng.synchronize(h1, timeout=10).tolist() == [1.0] * 3
        assert eng.synchronize(h2, timeout=10).tolist() == [2.0] * 3
    finally:
        eng.shutdown()


def test_timeout_keeps_the_handle(engines, monkeypatch):
    _, P = engines
    monkeypatch.setenv("HOROVOD_WAKE_ON_ENQUEUE", "0")
    eng = _one(P, "port", cycle_ms=200.0)
    try:
        h = eng.enqueue("allreduce", np.arange(4.0), "slowpoke")
        with pytest.raises(TimeoutError):
            eng.synchronize(h, timeout=0.01)
        assert eng.synchronize(h, timeout=10).tolist() == [0.0, 1.0, 2.0, 3.0]
    finally:
        eng.shutdown()


def test_scalar_allgather_refused(engines):
    _, P = engines
    eng = _one(P, "port")
    try:
        with pytest.raises(P_engine.HorovodInternalError, match="rank >= 1"):
            eng.run("allgather", np.float64(3.0), "scalar_ag")
    finally:
        eng.shutdown()


def _timeline_names(path) -> set:
    with open(path) as f:
        text = f.read().rstrip().rstrip(",")
    events = json.loads(text if text.endswith("]") else text + "]")
    return {e.get("name") for e in events} | {
        (e.get("args") or {}).get("name") for e in events}


def test_timeline_names_equal_the_jax_engine(engines, tmp_path):
    J, P = engines
    names = {}
    for pkg, cls in (("jax", J), ("port", P)):
        tl = tmp_path / f"{pkg}.json"
        topo = (JTopology if pkg == "jax" else PTopology)(0, 1, 0, 1, 0, 1)
        cfg = (JConfig if pkg == "jax" else PConfig)(
            cycle_time_ms=1.0, timeline=str(tl), timeline_mark_cycles=True)
        eng = cls(topo, cfg)
        try:
            eng.run("allreduce", np.ones(4), "tl_tensor")
            eng.run("allgather", np.ones((2, 2)), "tl_gather")
        finally:
            eng.shutdown()
        names[pkg] = _timeline_names(tl)
    assert {"NEGOTIATE_ALLREDUCE", "tl_tensor", "tl_gather",
            "CYCLE_START"} <= names["port"]
    assert names["port"] == names["jax"]


WORLD_SCRIPT = r"""
import hashlib, importlib, json, os, sys
sys.path.insert(0, os.environ["HVD_REPO"])
import numpy as np
pkg = os.environ["T_PKG"]
ne = importlib.import_module(pkg + ".cc.native_engine")
Config = importlib.import_module(pkg + ".common.config").Config
Topology = importlib.import_module(pkg + ".common.topology").Topology
rank, world = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
eng = ne.NativeEngine(Topology(rank, world, rank, world, 0, 1),
                      Config(cycle_time_ms=1.0, stall_check_disable=True))
if pkg == "horovod_tpu":
    import ml_dtypes
    bf16 = np.dtype(ml_dtypes.bfloat16)
else:
    from horovod_tpu_torch.compression import BFLOAT16 as bf16
out = {}
for op in %(ops)r:
    for dt in %(dtypes)r:
        rng = np.random.default_rng([rank, len(op), len(dt)])
        rows = rank + 1 if op == "allgather" else world
        if dt == "bfloat16":
            a = rng.integers(0, 1 << 16, size=(rows, 6), dtype=np.uint16)
            a.flat[:2] = [0x7FC1, 0xFF80 if rank else 0x3F80]
            a = a.view(bf16)
        else:
            a = (rng.standard_normal((rows, 6)) * 9).astype(dt)
        kw = {"root_rank": 1} if op == "broadcast" else {}
        r = eng.run(op, a, op + "." + dt, **kw)
        out[op + "." + dt] = [list(r.shape),
                              hashlib.sha256(r.tobytes()).hexdigest()]
try:
    eng.run("allreduce", np.ones((3,) if rank == 0 else (4,)), "bad")
    out["mismatch"] = "no error"
except ne.TensorShapeMismatchError as e:
    out["mismatch"] = "Mismatched" in str(e)
eng.shutdown()
print(json.dumps(out))
""" % {"ops": OPS, "dtypes": DTYPES}


def test_two_rank_world_every_op_and_dtype_equals_the_jax_world(engines):
    outs = {}
    for pkg in ("horovod_tpu", "horovod_tpu_torch"):
        outs[pkg] = [r["out"] for r in launch_world(
            2, WORLD_SCRIPT, extra_env={"T_PKG": pkg,
                                        "HOROVOD_STALL_CHECK_DISABLE": "1"},
            timeout=120)]
    for o in outs["horovod_tpu_torch"]:
        assert o["mismatch"] is True
    assert outs["horovod_tpu_torch"] == outs["horovod_tpu"]


# ------------------------------------- the coordinator's listener and fds

RANK1_SCRIPT = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from horovod_tpu_torch.cc.native_engine import NativeEngine
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.topology import Topology
eng = NativeEngine(Topology(1, 2, 1, 2, 0, 1), Config(cycle_time_ms=1.0,
                                                      stall_check_disable=True))
out = eng.run("allreduce", np.ones(4, np.float32), "x", average=False)
eng.shutdown()
assert (out == 2).all(), out
"""


class _Store:
    """The slice of a store ``NativeEngine`` uses; ``set`` hands rank 0's
    published coordinator address to ``on_set``."""

    def __init__(self, on_set=None):
        self.value, self.on_set = None, on_set

    def set(self, key, value):
        self.value = value
        if self.on_set:
            self.on_set(value)

    def get(self, key):
        return self.value.encode()


def _fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_coordinator_listener_cycles_leave_no_descriptor(engines, monkeypatch):
    """``hvd_coord_listen`` -> ``hvd_init`` -> shutdown, repeated, leaves
    the process's descriptors as they were: a listener adopted by an init
    that then fails (rank 0 of two with no job secret), a listener the
    next listen replaces, one a world of one closes, and one adopted by a
    world of two that runs an allreduce (rank 1 in a child process)."""
    import ctypes

    from horovod_tpu_torch.cc import native_engine as NE
    from horovod_tpu_torch.common.engine import (HorovodInternalError,
                                                 StoreRendezvous)

    _, P = engines
    lib = NE._load()
    cfg = PConfig(cycle_time_ms=1.0, stall_check_disable=True)
    pair = PTopology(0, 2, 0, 2, 0, 1)
    secret = "ab" * 16
    children = []

    def failed_init():
        monkeypatch.delenv("HOROVOD_SECRET", raising=False)
        with pytest.raises(HorovodInternalError, match="HOROVOD_SECRET"):
            P(pair, cfg, rendezvous=StoreRendezvous(_Store(), "k", "127.0.0.1"))

    def replaced_then_closed():
        err = ctypes.create_string_buffer(256)
        for _ in range(2):
            assert lib.hvd_coord_listen(b"127.0.0.1", 4, err, 256) > 0
        P(PTopology(0, 1, 0, 1, 0, 1), cfg).shutdown()

    def world_of_two():
        monkeypatch.setenv("HOROVOD_SECRET", secret)

        def start_rank1(addr):
            children.append(subprocess.Popen(
                [sys.executable, "-c", RANK1_SCRIPT, REPO],
                env=dict(os.environ, HOROVOD_COORD_ADDR=addr)))

        eng = P(pair, cfg, rendezvous=StoreRendezvous(
            _Store(start_rank1), "k", "127.0.0.1"))
        out = eng.run("allreduce", np.ones(4, np.float32), "x", average=False)
        eng.shutdown()
        assert (out == 2).all()
        assert children.pop().wait(timeout=60) == 0

    cycles = (failed_init, replaced_then_closed, world_of_two)
    for cycle in cycles:       # first use: whatever a first call keeps open
        cycle()
    before = _fds()
    for _ in range(3):
        for cycle in cycles:
            cycle()
    assert _fds() == before


# ------------------------------------------------------------------ build

FAKE_CXX = r"""#!/usr/bin/env python3
import os, sys, time
with open(os.environ["FAKE_CXX_COUNT"], "a") as f:
    f.write("%d\n" % os.getpid())
time.sleep(1.0)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("library")
"""

BUILD_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
from horovod_tpu_torch import cc
print(cc.build_library(sys.argv[2], sys.argv[3], flags=("-O0",)))
"""


@pytest.fixture()
def fake_tree(tmp_path, monkeypatch):
    """A copy of ``cc/src`` and a stand-in compiler that counts its runs."""
    import shutil

    from horovod_tpu_torch import cc

    src = tmp_path / "src"
    shutil.copytree(cc.SRC_DIR, src)
    fake = tmp_path / "fake-cxx"
    fake.write_text(FAKE_CXX)
    fake.chmod(0o755)
    count = tmp_path / "count"
    count.write_text("")
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setenv("FAKE_CXX_COUNT", str(count))
    return src, tmp_path / "build", count


def test_concurrent_builds_compile_once(fake_tree):
    src, build, count = fake_tree
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, REPO,
                               str(src), str(build)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    paths = {p.communicate(timeout=60)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1
    assert [f for f in os.listdir(build) if f.endswith(".so")] == \
        [os.path.basename(paths.pop())]
    assert len(count.read_text().split()) == 1


def test_edited_source_builds_afresh(fake_tree):
    from horovod_tpu_torch import cc

    src, build, count = fake_tree
    first = cc.build_library(str(src), str(build), flags=("-O0",))
    assert cc.build_library(str(src), str(build), flags=("-O0",)) == first
    with open(src / "engine.cc", "a") as f:
        f.write("\n// edited\n")
    second = cc.build_library(str(src), str(build), flags=("-O0",))
    assert second != first and os.path.exists(second)
    assert len(count.read_text().split()) == 2


def test_missing_override_library_raises(monkeypatch, tmp_path):
    from horovod_tpu_torch import cc

    monkeypatch.setenv("HVD_NATIVE_LIB", str(tmp_path / "none.so"))
    with pytest.raises(cc.NativeBuildError, match="does not exist"):
        cc.lib_path()


def test_library_name_hashes_sources_flags_and_cpu(monkeypatch):
    from horovod_tpu_torch import cc

    base = cc.library_path()
    assert os.path.dirname(base).endswith(os.path.join("horovod_tpu_torch",
                                                       "_build"))
    assert cc.library_path(flags=("-O2",)) != base
    monkeypatch.setattr(cc, "cpu_model", lambda: "another host")
    assert cc.library_path() != base


# ----------------------------------------------------------------- create

def test_create_native_bang_raises_when_the_library_is_missing(
        monkeypatch, tmp_path):
    monkeypatch.setenv("HOROVOD_ENGINE", "native!")
    monkeypatch.setenv("HVD_NATIVE_LIB", str(tmp_path / "none.so"))
    with pytest.raises(P_engine.HorovodInternalError,
                       match="native engine unavailable"):
        P_engine.create(PTopology(0, 1, 0, 1, 0, 1), PConfig(cycle_time_ms=1.0))


def test_world_of_one_falls_back_with_the_log_line(monkeypatch, tmp_path):
    said = []
    monkeypatch.setattr(P_engine, "log",
                        lambda level, msg, **kw: said.append((level, msg)))
    monkeypatch.delenv("HOROVOD_ENGINE", raising=False)
    monkeypatch.delenv("HOROVOD_NATIVE_DATA_PLANE", raising=False)
    monkeypatch.setenv("HVD_NATIVE_LIB", str(tmp_path / "none.so"))
    eng = P_engine.create(PTopology(0, 1, 0, 1, 0, 1),
                          PConfig(cycle_time_ms=1.0))
    try:
        assert isinstance(eng, P_engine.PyEngine)
    finally:
        eng.shutdown()
    assert [lv for lv, m in said
            if m.startswith("native engine unavailable (")
            and m.endswith("); using Python engine")] == ["debug"]


# ---------------------------------------------------------- protocol spec

def _port_spec() -> dict:
    sys.path.insert(0, REPO)
    from tools.analyze import protocol as A

    saved = {}
    for attr, rel in (("WIRE_H", "cc/src/wire.h"),
                      ("COMMON_H", "cc/src/hvd_common.h"),
                      ("CACHE_H", "cc/src/cache.h"),
                      ("ENGINE_PY", "common/engine.py"),
                      ("RESPONSE_CACHE_PY", "common/response_cache.py"),
                      ("NATIVE_ENGINE_PY", "cc/native_engine.py")):
        saved[attr] = getattr(A, attr)
        setattr(A, attr, os.path.join("horovod_tpu_torch", *rel.split("/")))
    try:
        return A.extract(REPO)
    finally:
        for attr, v in saved.items():
            setattr(A, attr, v)


def test_extracted_spec_equals_the_checked_in_copy():
    spec = _port_spec()
    assert spec == P_protocol.load_spec()
    with open(os.path.join(REPO, "docs", "protocol_spec.json")) as f:
        assert spec["native"] == json.load(f)["native"]
    assert P_protocol.verify_spec() == []
    assert P_protocol.verify_spec(spec) == []


def test_verify_spec_names_a_drift():
    spec = P_protocol.load_spec()
    spec["native"]["messages"]["Request"]["wire_order"][1] = "dtype"
    assert P_protocol.verify_spec(spec) == [
        "Request.wire_order[1]: protocol.py has 'op', spec has 'dtype'"]


# -------------------------------------------------------- the native tuner

def _trajectory(mod, steps: int = 400) -> list:
    pm = mod.ParameterManager(fusion_threshold=2 << 20, cycle_time_ms=40.0,
                              cycle_pinned=False, num_buckets=2)
    pm.set_hierarchy(False, True, allreduce_pinned=False,
                     allgather_pinned=True)
    pm.enable_hierarchy(True, False)
    out = []
    try:
        for i in range(steps):
            if not pm.active:
                break
            t = pm.fusion_threshold / (1 << 20)
            score = (math.log2(t + 1) / 8.0 * math.exp(
                -((pm.cycle_time_ms - 8.0) ** 2) / 50.0)
                * (1.1 if pm.hier_allreduce else 1.0) / pm.num_buckets)
            changed = pm.update(int(score * 1e6) + i % 7, 1.0)
            out.append((changed, pm.fusion_threshold, pm.cycle_time_ms,
                        pm.num_buckets, pm.hier_allreduce, pm.hier_allgather,
                        pm.active))
            if i == 150:
                pm.set_num_buckets(3, pinned=True)
    finally:
        pm.close()
    return out


def test_parameter_manager_trajectory_equals_the_jax_package():
    port = _trajectory(P_autotune)
    assert len(port) > 10 and len({s[1] for s in port}) > 1
    assert port == _trajectory(J_autotune)


@pytest.mark.parametrize("pins", [(True, False), (False, True), (True, True)])
def test_parameter_manager_pins_equal_the_jax_package(pins):
    def run(mod):
        pm = mod.ParameterManager(fusion_threshold=8 << 20, cycle_time_ms=5.0,
                                  threshold_pinned=pins[0],
                                  cycle_pinned=pins[1])
        seen = [pm.active]
        for i in range(300):
            if not pm.active:
                break
            pm.update(1000000 + 997 * i, 0.01)
            seen.append((pm.fusion_threshold, pm.cycle_time_ms))
        pm.close()
        return seen

    port = run(P_autotune)
    assert port == run(J_autotune)
    if pins[0]:
        assert all(s[0] == 8 << 20 for s in port[1:])
    if pins == (True, True):
        assert port == [False]


def test_parameter_manager_converges_to_a_better_config():
    def score(threshold, cycle_ms):
        t_mb = threshold / (1 << 20)
        return (math.log2(t_mb + 1) / 8.0) * math.exp(
            -((cycle_ms - 8.0) ** 2) / 50.0)

    pm = P_autotune.ParameterManager(fusion_threshold=2 << 20,
                                     cycle_time_ms=40.0)
    for _ in range(3000):
        if not pm.active:
            break
        pm.update(int(score(pm.fusion_threshold, pm.cycle_time_ms) * 1e6), 1.0)
    assert not pm.active
    assert score(pm.fusion_threshold, pm.cycle_time_ms) > \
        1.5 * score(2 << 20, 40.0)
    pm.close()


@pytest.mark.parametrize("seed", range(4))
def test_native_gp_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(8 + seed, 2)).tolist()
    y = (rng.standard_normal(8 + seed) * 3).tolist()
    xs = rng.uniform(size=2).tolist()
    got = P_autotune.gp_fit_predict(X, y, xs)
    assert got == J_autotune.gp_fit_predict(X, y, xs)


# ------------------------------------------------------------- check-build

def test_check_build_names_the_native_library():
    from horovod_tpu_torch.cc import lib_path

    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ['x', '--check-build']
        try:
            runpy.run_module('horovod_tpu_torch.runner', run_name='__main__')
        except SystemExit:
            pass
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"  native eager engine (C++): yes ({lib_path()})" in \
        proc.stdout.splitlines()
    env = dict(os.environ, HVD_NATIVE_LIB="/nonexistent/libhvd_core.so")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    lines = proc.stdout.splitlines()
    i = lines.index("  native eager engine (C++): NO")
    assert lines[i + 1].startswith("    (NativeBuildError: HVD_NATIVE_LIB=")
