"""The port's response cache (``horovod_tpu_torch.common.response_cache``)
against the JAX package's, on one seeded sequence of operations: the
authority's bits, evictions (LRU, in-use protection, shape and wire-format
change invalidation), flushes and stats, the mirror's bits after the same
announcements, ``request_key`` of every request and
``cache_capacity_from_env``; and, through real coordinators over
in-process rank threads, the bits and the cached ticks a shape change
reassigns, in each package. Tolerance: none."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import horovod_tpu.common.engine as JE
import horovod_tpu.common.response_cache as J
import horovod_tpu_torch.common.engine as PE
import horovod_tpu_torch.common.response_cache as P

NAMES = [f"g{i}" for i in range(12)]
SHAPES = [(4,), (8,), (2, 3)]
WIRES = [None, "bfloat16", "float16", "topk"]


def _ops(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(["assign", "assign", "assign", "lookup", "evict",
                           "flush"], p=[0.3, 0.2, 0.2, 0.2, 0.08, 0.02])
        req = {"name": str(rng.choice(NAMES)), "op": "allreduce",
               "shape": SHAPES[int(rng.integers(len(SHAPES)))],
               "dtype": str(rng.choice(["float32", "bfloat16"])),
               "root": 0, "average": bool(rng.integers(2))}
        wire = WIRES[int(rng.integers(len(WIRES)))]
        if wire is not None:
            req["wire"] = wire
        in_use = set(rng.choice(NAMES, size=int(rng.integers(4)),
                                replace=False))
        out.append((str(kind), req, in_use))
    return out


def _drive(mod, ops, capacity):
    cache, mirror = mod.ResponseCache(capacity=capacity), mod.CacheMirror()
    log = []
    for kind, req, in_use in ops:
        key = mod.request_key(req)
        if kind == "assign":
            bit, evicted = cache.assign(key, dict(req), in_use=in_use)
            mirror.apply([(bit, key)] if bit is not None else [],
                         [e[0] for e in evicted])
            log.append(("assign", key, bit, [e[:2] for e in evicted]))
        elif kind == "lookup":
            bit = cache.bit_for(key)
            log.append(("lookup", key, bit,
                        None if bit is None else cache.lookup_bit(bit)[0],
                        mirror.lookup(key)))
        elif kind == "evict":
            ev = cache.evict_name(req["name"])
            mirror.apply([], [e[0] for e in ev])
            log.append(("evict", [e[:2] for e in ev]))
        else:
            ev = cache.flush()
            mirror.flush()
            log.append(("flush", sorted(e[0] for e in ev)))
    log.append(("stats", cache.stats(), mirror.stats(), len(cache),
                len(mirror)))
    return log


@pytest.mark.parametrize("seed,capacity", [(0, 4), (1, 8), (2, 1), (3, 0),
                                           (4, 1024)])
def test_seeded_operation_sequence_equals_the_jax_cache(seed, capacity):
    ops = _ops(seed)
    assert _drive(P, ops, capacity) == _drive(J, ops, capacity)


def test_capacity_from_env(monkeypatch):
    for v in (None, "", "0", "7", "-3", "junk"):
        if v is None:
            monkeypatch.delenv("HOROVOD_CACHE_CAPACITY", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", v)
        assert P.cache_capacity_from_env() == J.cache_capacity_from_env()


KEY = b"cache-secret"
TICK_TIMEOUT_S = 60.0


def _world(mod, shapes):
    """Two ranks tick the same name with ``shapes`` in turn; per tick the
    mirror's bit and whether the tick was cached.

    The ticks are ordered: both ranks have applied tick i's cache message
    before either looks up its bit for tick i + 1 (a barrier), so a rank
    that runs ahead cannot read its mirror while the other still waits for
    the same announcement. A worker that raises or does not finish fails
    the world."""
    coord = mod._Coordinator(2, "127.0.0.1", 0, key=KEY, cache_capacity=8)
    port = coord.server.getsockname()[1]
    coord.start()
    seen: dict = {}
    errors: dict = {}
    tick = threading.Barrier(2, timeout=TICK_TIMEOUT_S)

    def worker(rank):
        try:
            client = mod._Client("127.0.0.1", port, rank, key=KEY)
            mirror = P.CacheMirror() if mod is PE else J.CacheMirror()
            out = []
            try:
                for shape in shapes:
                    tick.wait()
                    req = {"name": "g", "op": "allreduce", "shape": shape,
                           "dtype": "float32", "root": 0, "average": True}
                    key = mod.request_key(req)
                    bit = mirror.lookup(key)
                    arr = np.ones(shape, np.float32) * (rank + 1)
                    res: dict = {}
                    deadline = time.monotonic() + TICK_TIMEOUT_S
                    while "g" not in res:
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"rank {rank}: tick {len(out)} not "
                                f"completed in {TICK_TIMEOUT_S} s")
                        if bit is not None:
                            res.update(client.exchange(
                                [], {"g": arr} if not res else {},
                                bits=1 << bit))
                        else:
                            res.update(client.exchange(
                                [req], {"g": arr} if not res else {}))
                        mirror.apply(*client.last_cache)
                    out.append((bit, res["g"][0], res["g"][1].tobytes()))
            finally:
                client.close()
            seen[rank] = out
        except BaseException as e:  # reported by the caller, never lost
            errors[rank] = repr(e)
            tick.abort()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=len(shapes) * TICK_TIMEOUT_S + 30)
    coord.stop()
    alive = [r for r, t in enumerate(threads) if t.is_alive()]
    assert not alive and not errors, \
        f"{mod.__name__}: ranks {alive} did not finish; errors {errors}"
    return seen


def test_shape_change_reassigns_alike():
    shapes = [(4,), (4,), (8,), (8,), (4,)]
    port, ref = _world(PE, shapes), _world(JE, shapes)
    assert port == ref, {"port": port, "jax": ref}
