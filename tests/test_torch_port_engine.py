"""The port's eager engine (``horovod_tpu_torch.common.engine``) against
the JAX package's Python engine (``horovod_tpu.common.engine``), on the
same numpy inputs:

- ``HandleManager``; a world of one (the identity ops, async
  poll/synchronize, shutdown failing pending handles), each result bitwise
  the JAX engine's;
- the coordinator's semantics over in-process rank threads, as
  ``tests/test_engine.py`` drives them: allreduce, the ragged allgather
  and broadcast, alltoall and reducescatter, the shape and dtype mismatch
  errors on every rank, the refusal of an unauthenticated frame. Each runs
  in one package and in the two mixed worlds (the JAX ``_Coordinator``
  serving the port's ``_Client``s, and the other way round), and every
  world's results equal the all-JAX world's bitwise;
- ``create``: the native engine (``cc/native_engine.py``) by default and
  under ``HOROVOD_ENGINE=native``/``native!`` (any case); the Python
  engine under ``HOROVOD_ENGINE=python`` or ``HOROVOD_NATIVE_DATA_PLANE=0``;
- bfloat16 without ``ml_dtypes``: ``compression.cast`` rounds a grid of
  edge values (ties, subnormals, the overflow to inf, ±inf, NaN of both
  signs) bitwise as ``ml_dtypes`` does, from float32 and float64; and a
  launched world of two with ``sys.modules["ml_dtypes"] = None`` imports
  the port and runs a bf16-wire allreduce whose bytes equal the JAX
  package's canonical oracle (``_ring_order_reduce``) on the same inputs.

Tolerance: none — every comparison is bitwise.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import pickle
import socket
import struct
import threading

import ml_dtypes
import numpy as np
import pytest

import horovod_tpu.common.engine as J
import horovod_tpu_torch.common.engine as P
from horovod_tpu.common.config import Config as JConfig
from horovod_tpu.common.topology import Topology as JTopology
from horovod_tpu_torch.common.config import Config as PConfig
from horovod_tpu_torch.common.topology import Topology as PTopology
from horovod_tpu_torch.compression import BFLOAT16, cast
from launch_util import launch_world

KEY = b"test-secret"
WORLD = 4


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def test_handle_manager():
    for mod in (P, J):
        hm = mod.HandleManager()
        h1, h2 = hm.allocate(), hm.allocate()
        assert (h1, h2) == (0, 1)
        assert not hm.poll(h1)
        hm.mark_done(h1, None, 42)
        assert hm.poll(h1)
        assert hm.wait_and_clear(h1) == 42
        assert not hm.poll(h1)
        hm.mark_done(h2, RuntimeError("boom"), None)
        with pytest.raises(RuntimeError, match="boom"):
            hm.wait_and_clear(h2)
        with pytest.raises(TimeoutError):
            hm.wait_and_clear(hm.allocate(), timeout=0.05)


def _single(mod, topo_cls, cfg_cls):
    return mod.PyEngine(topo_cls(0, 1, 0, 1, 0, 1), cfg_cls(cycle_time_ms=1.0))


def test_single_process_ops_equal_the_jax_engine():
    rng = np.random.default_rng(5)
    inputs = {"allreduce": rng.standard_normal((2, 3)),
              "allgather": rng.standard_normal((3, 2)).astype(np.float32),
              "broadcast": rng.integers(0, 9, (4,)).astype(np.int32),
              "alltoall": rng.standard_normal((2, 2)),
              "reducescatter": rng.standard_normal((4,)).astype(np.float16)}
    outs = {}
    for key, mod, topo, cfg in (("port", P, PTopology, PConfig),
                                ("jax", J, JTopology, JConfig)):
        eng = _single(mod, topo, cfg)
        try:
            outs[key] = {op: eng.run(op, a, f"t.{op}")
                         for op, a in inputs.items()}
            h = eng.enqueue("allreduce", np.ones(4), "async1")
            outs[key]["async"] = eng.synchronize(h, timeout=10)
        finally:
            eng.shutdown()
    for op in (*inputs, "async"):
        assert _same(outs["port"][op], outs["jax"][op]), op
    assert _same(outs["port"]["allreduce"], inputs["allreduce"])


def test_async_poll_synchronize():
    from horovod_tpu_torch.common.basics import HorovodInternalError

    eng = _single(P, PTopology, PConfig)
    try:
        h = eng.enqueue("allreduce", np.arange(4.0), "async1")
        out = eng.synchronize(h, timeout=10)
        assert _same(out, np.arange(4.0))
        assert not eng.poll(h)          # cleared by synchronize
        eng._inflight.add("dup")        # a name still in flight
        with pytest.raises(HorovodInternalError, match="Duplicate tensor name"):
            eng.enqueue("allreduce", np.ones(2), "dup")
    finally:
        eng.shutdown()


def test_shutdown_fails_pending():
    from horovod_tpu_torch.common.basics import HorovodInternalError

    eng = _single(P, PTopology, PConfig)
    eng._shutdown.set()  # freeze the loop
    eng._thread.join(timeout=5)
    eng._queue.append({"op": "allreduce", "array": np.ones(2), "name": "x",
                       "root": 0, "average": True,
                       "handle": eng.handles.allocate(), "t": 0.0})
    h = eng._queue[-1]["handle"]
    eng.shutdown()
    with pytest.raises(HorovodInternalError, match="shut down"):
        eng.synchronize(h, timeout=1)
    with pytest.raises(HorovodInternalError):
        eng.enqueue("allreduce", np.ones(2), "late")


# ------------------------------------------------- multi-rank via coordinator

WORLDS = {"port": (P, P), "jax-coordinator,port-clients": (J, P),
          "port-coordinator,jax-clients": (P, J)}


def run_ranks(coord_mod, client_mod, fn):
    """fn(rank, client) on WORLD threads against one coordinator."""
    coord = coord_mod._Coordinator(WORLD, "127.0.0.1", 0, key=KEY)
    port = coord.server.getsockname()[1]
    coord.start()
    results: dict = {}
    errors: list = []

    def worker(rank):
        try:
            client = client_mod._Client("127.0.0.1", port, rank, key=KEY)
            try:
                results[rank] = fn(rank, client)
            finally:
                client.close()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    coord.stop()
    assert not errors, errors
    return results


def _req(name, op, arr, root=0, average=True):
    return {"name": name, "op": op, "shape": tuple(arr.shape),
            "dtype": str(arr.dtype), "root": root, "average": average}


def _scenario_collectives(rank, client):
    rng = np.random.default_rng(100 + rank)
    g = rng.standard_normal(7)
    ag = np.full((rank + 1, 2), float(rank))          # ragged dim 0
    bc = np.full((2,), float(rank))
    a2a = np.full((WORLD, 2), float(rank))
    rs = rng.standard_normal(WORLD * 2).astype(np.float32)
    reqs = [_req("g", "allreduce", g), _req("ag", "allgather", ag),
            _req("bc", "broadcast", bc, root=2),
            _req("a2a", "alltoall", a2a),
            _req("rs", "reducescatter", rs, average=False)]
    out: dict = {}
    arrays = {"g": g, "ag": ag, "bc": bc, "a2a": a2a, "rs": rs}
    for _ in range(50):
        out.update(client.exchange(reqs, arrays if not out else {}))
        if len(out) == len(reqs):
            break
    return out


def _scenario_mismatch(rank, client):
    shape = (3,) if rank != 1 else (4,)
    dtype = np.float64 if rank != 2 else np.int32
    reqs = [_req("bad", "allreduce", np.ones(shape)),
            _req("badt", "allreduce", np.ones((2,), dtype))]
    return client.exchange(reqs, {"bad": np.ones(shape),
                                  "badt": np.ones((2,), dtype)})


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_coordinator_collectives_equal_the_jax_world(world):
    want = run_ranks(J, J, _scenario_collectives)
    got = run_ranks(*WORLDS[world], _scenario_collectives)
    for r in range(WORLD):
        assert sorted(got[r]) == sorted(want[r])
        for name, (err, val) in got[r].items():
            assert err is None and want[r][name][0] is None, err
            assert _same(val, want[r][name][1]), (r, name)
    # the allgather is ragged: every rank holds all sum(r+1) rows
    assert got[0]["ag"][1].shape == (sum(range(1, WORLD + 1)), 2)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_coordinator_mismatch_errors_on_every_rank(world):
    want = run_ranks(J, J, _scenario_mismatch)
    got = run_ranks(*WORLDS[world], _scenario_mismatch)
    for r in range(WORLD):
        assert got[r]["bad"][0] == want[r]["bad"][0]
        assert "Mismatched tensor shapes" in got[r]["bad"][0]
        assert got[r]["badt"][0] == want[r]["badt"][0]
        assert "Mismatched data types" in got[r]["badt"][0]


def test_engine_raises_mismatch_as_tensor_shape_error():
    """The errors surface as the port's TensorShapeMismatchError, a
    HorovodInternalError (one class with basics', so elastic.run heals
    an engine failure)."""
    from horovod_tpu_torch.common.basics import HorovodInternalError

    assert issubclass(P.TensorShapeMismatchError, HorovodInternalError)
    assert P.HorovodInternalError is HorovodInternalError


def test_coordinator_rejects_unauthenticated_frames():
    coord = P._Coordinator(1, "127.0.0.1", 0, key=KEY)
    port = coord.server.getsockname()[1]
    coord.start()
    try:
        raw = socket.create_connection(("127.0.0.1", port), timeout=5)
        payload = pickle.dumps({"kind": "exchange", "rank": 0,
                                "requests": [], "arrays": {}})
        bad = hmac.new(b"wrong-key", payload, hashlib.sha256).digest()
        raw.sendall(bad + struct.pack("!Q", len(payload)) + payload)
        raw.settimeout(5)
        assert raw.recv(1) == b"", "coordinator answered an unauthenticated frame"
        raw.close()
        client = P._Client("127.0.0.1", port, 0, key=KEY)
        out = client.exchange([_req("t", "allreduce", np.ones(2),
                                    average=False)], {"t": np.ones(2)})
        assert out["t"][0] is None and _same(out["t"][1], np.ones(2))
        client.close()
    finally:
        coord.stop()


@pytest.mark.parametrize("env", [{"HOROVOD_ENGINE": "native"},
                                 {"HOROVOD_ENGINE": "native!"},
                                 {"HOROVOD_ENGINE": "NATIVE"}, {}])
def test_create_builds_the_native_engine(env, monkeypatch):
    from horovod_tpu_torch.cc.native_engine import NativeEngine

    monkeypatch.delenv("HOROVOD_ENGINE", raising=False)
    monkeypatch.delenv("HOROVOD_NATIVE_DATA_PLANE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = P.create(PTopology(0, 1, 0, 1, 0, 1), PConfig(cycle_time_ms=1.0))
    try:
        assert isinstance(eng, NativeEngine)
        assert eng.run("allreduce", np.arange(3.0), "x").tolist() == \
            [0.0, 1.0, 2.0]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("env", [{"HOROVOD_ENGINE": "python"},
                                 {"HOROVOD_NATIVE_DATA_PLANE": "0"}])
def test_create_builds_the_python_engine(env, monkeypatch):
    monkeypatch.delenv("HOROVOD_ENGINE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = P.create(PTopology(0, 1, 0, 1, 0, 1), PConfig(cycle_time_ms=1.0))
    try:
        assert isinstance(eng, P.PyEngine)
    finally:
        eng.shutdown()


# ------------------------------------------------------ bfloat16 without ml_dtypes

def _edge_floats() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = np.array([
        0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
        0x7F800001, 0xFF800001, 0x7FFFFFFF, 0xFFFFFFFF,      # inf, NaNs
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,      # overflow to inf
        0x00000001, 0x80000001, 0x00008000, 0x00018000,      # subnormal ties
        0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,      # ties to even
        0x00800000, 0x007FFFFF], dtype=np.uint32)
    rand = rng.integers(0, 2 ** 32, 50_000, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([edges, rand]).view(np.float32)


def test_bf16_rounding_equals_ml_dtypes():
    x = _edge_floats()
    with np.errstate(invalid="ignore", over="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        got = cast(x, BFLOAT16).view(np.uint16)
        assert np.array_equal(got, want)
        x64 = np.random.default_rng(1).standard_normal(20_000) * \
            np.exp(np.random.default_rng(2).uniform(-90, 90, 20_000))
        x64 = np.concatenate([x64, [1 + 2.0 ** -8 + 2.0 ** -30, np.inf,
                                    -np.inf, np.nan, -np.nan]])
        assert np.array_equal(cast(x64, BFLOAT16).view(np.uint16),
                              x64.astype(ml_dtypes.bfloat16).view(np.uint16))
        b = want.view(ml_dtypes.bfloat16)
        for dt in (np.float32, np.float64, np.float16):
            assert cast(b, dt).tobytes() == b.astype(dt).tobytes()


BF16_WORKER = r"""
import hashlib, json, os, sys
sys.modules["ml_dtypes"] = None          # blocked: importing it raises
sys.path.insert(0, os.environ["HVD_REPO"])
import numpy as np
import horovod_tpu_torch
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.engine import create
from horovod_tpu_torch.common.topology import Topology

rank = int(os.environ["HOROVOD_RANK"]); world = int(os.environ["HOROVOD_SIZE"])
eng = create(Topology(rank, world, 0, 1, rank, world),
             Config(cycle_time_ms=1.0, stall_check_disable=True,
                    compression="bf16"))
try:
    rng = np.random.default_rng(7)
    pay = [(rng.standard_normal(5003) * (r + 1)).astype(np.float32)
           for r in range(world)]
    out = eng.run("allreduce", pay[rank], "g")
    print(json.dumps({"rank": rank, "hex": out.tobytes().hex(),
                      "ml_dtypes": "ml_dtypes" in sys.modules
                      and sys.modules["ml_dtypes"] is not None}))
finally:
    eng.shutdown()
"""


def test_bf16_wire_without_ml_dtypes_equals_the_jax_oracle():
    outs = [r["out"] for r in launch_world(2, BF16_WORKER, extra_env={
        "HOROVOD_ENGINE": "python", "HOROVOD_RING_DATA_PLANE": "1"})]
    rng = np.random.default_rng(7)
    pay = [(rng.standard_normal(5003) * (r + 1)).astype(np.float32)
           for r in range(2)]
    wd = np.dtype(ml_dtypes.bfloat16)
    want = J._ring_order_reduce([p.astype(wd).astype(np.float32) for p in pay],
                                True, wire_dtype=wd)
    for o in outs:
        assert not o["ml_dtypes"]
        assert bytes.fromhex(o["hex"]) == want.tobytes()


# ------------------------------------------------------- the numpy wire helpers

def test_topk_select_equals_the_jax_selection():
    """The port's linear-time selection equals the JAX package's lexsort
    on ties, exact zeros (of both signs), NaN and inf."""
    from horovod_tpu.compression import topk_select as jsel
    from horovod_tpu_torch.compression import topk_select as psel

    rng = np.random.default_rng(3)
    for t in range(200):
        n = int(rng.integers(1, 2000))
        x = rng.integers(-4, 5, n).astype(np.float32) * np.float32(
            rng.choice([1.0, 0.25, 1e-40]))
        if t % 3 == 0:
            x[rng.integers(0, n, 3)] = np.nan
        if t % 4 == 0:
            x[rng.integers(0, n, 2)] = np.inf
            x[rng.integers(0, n, 2)] = -np.inf
        if t % 5 == 0:
            x[rng.integers(0, n, 4)] = -0.0
        k = int(rng.integers(1, n + 1))
        (pi, pv), (ji, jv) = psel(x, k), jsel(x, k)
        assert np.array_equal(pi, ji) and pv.tobytes() == jv.tobytes(), t


def test_topk_frames_and_states_equal_the_jax_helpers():
    import horovod_tpu.compression as jc
    import horovod_tpu_torch.compression as pc

    rng = np.random.default_rng(4)
    for t in range(60):
        n = int(rng.integers(8, 600))
        a = rng.standard_normal(n).astype(np.float32)
        a[rng.random(n) < 0.7] = 0
        b = rng.standard_normal(n).astype(np.float32)
        b[rng.random(n) < 0.6] = 0
        ia, va = pc.topk_sparsify(a)
        ib, vb = pc.topk_sparsify(b)
        for fn, args in (("topk_pack", (ia, va)), ("topk_pack_dense", (a,)),
                         ("topk_densify", (ia, va, n))):
            assert getattr(pc, fn)(*args).tobytes() == \
                getattr(jc, fn)(*args).tobytes(), fn
        for mod_args in ((ia, va, ib, vb, n), (ia, va, ib, vb, n, 3)):
            ps, js = pc.topk_merge(*mod_args), jc.topk_merge(*mod_args)
            assert ps[0] == js[0] and all(
                np.asarray(p).tobytes() == np.asarray(j).tobytes()
                for p, j in zip(ps[1:], js[1:]))
        st = ("sparse", ia, va)
        for p, j in ((pc.topk_state_add(st, ib, vb, n),
                      jc.topk_state_add(st, ib, vb, n)),
                     (pc.topk_state_slice(st, n // 3, n // 2),
                      jc.topk_state_slice(st, n // 3, n // 2)),
                     (pc.topk_state_scale(st, 3), jc.topk_state_scale(st, 3))):
            assert p[0] == j[0] and all(
                np.asarray(x).tobytes() == np.asarray(y).tobytes()
                for x, y in zip(p[1:], j[1:]))
        for prefer in (True, False):
            frame = pc.topk_encode(st, n, prefer)
            assert frame.tobytes() == jc.topk_encode(st, n, prefer).tobytes()
            pu, ju = pc.topk_unpack(frame, n), jc.topk_unpack(frame, n)
            assert pu[0] == ju[0] and all(
                x.tobytes() == y.tobytes() for x, y in zip(pu[1:], ju[1:]))
    with pytest.raises(ValueError, match="indices invalid"):
        pc.topk_unpack(pc.topk_pack(np.array([3, 1], np.int32),
                                    np.ones(2, np.float32)), 8)


@pytest.mark.parametrize("comp", ["none", "fp16", "bf16", "topk", "adaptive",
                                  "junk"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32",
                                   "float64", "int32"])
def test_numpy_wire_dtype_names_equal(comp, dtype):
    import horovod_tpu.compression as jc
    import horovod_tpu_torch.compression as pc

    jdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    p, j = pc.numpy_wire_dtype(comp, dtype), jc.numpy_wire_dtype(comp, jdt)
    assert (p is None) == (j is None)
    if p is not None:
        assert pc.dtype_name(p) == str(np.dtype(j))


def test_watchdog_sources_keep_their_own_abort_hooks():
    """The engine's queue joins ``init``'s watchdog as a source with its own
    abort hook: each stalled entry goes to its source's hook (else the
    watchdog's), and ``remove_source`` takes the source out."""
    import time

    from horovod_tpu_torch.metrics import StallInfo, StallWatchdog
    from horovod_tpu_torch.metrics.registry import MetricsRegistry

    hits = {"engine": [], "collectives": []}
    wd = StallWatchdog(check_time_s=0.01, shutdown_time_s=0.02,
                       on_abort=lambda s: hits["collectives"].append(s.name),
                       reg=MetricsRegistry(), poll_interval_s=0.01)
    try:
        def coll():
            return [StallInfo(name="nccl.0", op="allreduce", age_s=1.0)]

        def queue():
            return [StallInfo(name="grad.w", op="allreduce", age_s=1.0)]

        wd.add_source(coll)
        wd.add_source(queue, on_abort=lambda s: hits["engine"].append(s.name))
        deadline = time.monotonic() + 5
        while (not hits["engine"] or not hits["collectives"]) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert hits == {"engine": ["grad.w"], "collectives": ["nccl.0"]}
        wd.remove_source(queue)
        assert [fn for fn, _ in wd._sources] == [coll]
    finally:
        wd.stop()
