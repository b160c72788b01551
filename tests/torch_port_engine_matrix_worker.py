"""One rank of a 4-process eager-engine world, for the port's engine tests
(``tests/test_torch_port_engine_*.py``) and phase 27 of ``chip_smoke.py``:
seeded float32 payloads allreduced under names ``g.0``/``g.1`` (the third
step reuses ``g.0``, so it negotiates through the response cache), the
digest of every result printed as one JSON line.

``T_PKG`` picks the package (``horovod_tpu_torch`` or ``horovod_tpu``),
and ``HOROVOD_ENGINE`` the engine of either, so that one script drives the
port, the JAX package and mixed worlds; ``T_COMP``, ``T_HIER``, ``T_LOCAL``
(ranks per fake host), ``T_ELEMS`` and ``T_STEPS`` set the wire, the plane
and the sizes. ``T_GATHER=1`` adds a ragged allgather (rank r gives r + 1
rows) under ``HOROVOD_HIERARCHICAL_ALLGATHER``'s setting (``T_HIER_AG``),
whose digest and cross-host bytes are reported. A native engine also
reports its shm links and cross-host ring bytes.
"""

import hashlib
import importlib
import json
import os
import sys

sys.path.insert(0, os.environ["HVD_REPO"])

import numpy as np  # noqa: E402

pkg = os.environ.get("T_PKG", "horovod_tpu_torch")
Config = importlib.import_module(pkg + ".common.config").Config
create = importlib.import_module(pkg + ".common.engine").create
Topology = importlib.import_module(pkg + ".common.topology").Topology

rank = int(os.environ["HOROVOD_RANK"])
world = int(os.environ["HOROVOD_SIZE"])
lsz = int(os.environ.get("T_LOCAL", "1"))
topo = (Topology(rank, world, rank % lsz, lsz, rank // lsz, world // lsz)
        if lsz > 1 else Topology(rank, world, 0, 1, rank, world))
eng = create(topo, Config(
    cycle_time_ms=1.0, stall_check_disable=True,
    compression=os.environ.get("T_COMP", "none"),
    hierarchical_allreduce=os.environ.get("T_HIER", "0") == "1",
    hierarchical_allgather=os.environ.get("T_HIER_AG", "0") == "1"))
try:
    elems = int(os.environ["T_ELEMS"])
    steps = int(os.environ["T_STEPS"])
    rng = np.random.default_rng(23)
    digest = hashlib.sha256()
    for step in range(steps):
        pay = [(rng.standard_normal(elems) * (r + 1)).astype(np.float32)
               for r in range(world)]
        out = eng.run("allreduce", pay[rank], f"g.{step % 2}")
        digest.update(np.ascontiguousarray(out).tobytes())
    stats = eng.cache_stats()
    coord = getattr(eng, "_coord", None)
    native = eng.stats() if type(eng).__name__ == "NativeEngine" else {}
    report = {"rank": rank, "hash": digest.hexdigest(),
              "plane": stats.get("plane", "?"),
              "hits": (stats.get("mirror") or {}).get("hits", 0),
              "accepted": getattr(coord, "accepted", None),
              "engine": type(eng).__name__,
              "shm_links": native.get("shm_links"),
              "cross_bytes": native.get("ring_cross_bytes_sent")}
    if os.environ.get("T_GATHER") == "1":
        rows = np.random.default_rng([29, rank]).standard_normal(
            (rank + 1, 1031)).astype(np.float32)
        out = eng.run("allgather", rows, "gather")
        after = eng.stats() if native else {}
        report["gather"] = {
            "hash": hashlib.sha256(np.ascontiguousarray(out).tobytes())
            .hexdigest(), "shape": list(out.shape),
            "hier": after.get("hier_allgather"),
            "cross_bytes": after.get("ring_cross_bytes_sent", 0)
            - native.get("ring_cross_bytes_sent", 0)}
    print(json.dumps(report))
finally:
    eng.shutdown()
