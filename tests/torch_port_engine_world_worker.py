"""One rank of a launched eager-engine world (``init`` and
``basics.engine()``), for phase 27 of ``chip_smoke.py``, the port's relay
test and the four-card ``engine_world`` of ``tests/test_torch_port_cuda.py``:

    python tests/torch_port_engine_world_worker.py OUT_DIR

:func:`launch` starts a world of it through the port's launcher and
:func:`spawn` one with an environment of each rank's own; both return the
ranks' reports.

For each plane of ``T_PLANES`` (comma-separated from ``ring``, ``star`` and
``hier``, default ``ring``; set in the world's config) and each wire of
``T_COMPS`` (default ``none``; a fresh engine each, ``HOROVOD_COMPRESSION``
set in the config) it runs ``T_STEPS`` steps (the first cold, the rest
through the response cache): a float32 tensor of ``T_ELEMS`` elements
(``big``) and ``T_SMALL`` small ones (``s<i>``, sizes from 257 to about
2 K elements, some below the compression floor), enqueued in an order of
this rank's own and waited for together. A plane named in ``T_LIGHT``
carries ``big`` under the ``none`` wire only. Each result's SHA-256 goes
to ``OUT_DIR/rank<r>.json``, by plane and wire, with the engine's plane,
the cache hits, the control bytes per exchange of each step, the
coordinator's accepted connections (rank 0) and, on the ring plane with
``T_TIMED`` > 0, the seconds of ``T_TIMED`` synchronous allreduces of the
big tensor on the engine (under the wires of ``T_TIMED_COMPS``, default
every wire); with ``T_DIST=1``, the seconds of
``torch.distributed``'s allreduce of the same tensors on the world's
backend (gloo on the CPU, NCCL on the card: ``T_DEVICE``, default
``cpu``, is ``init``'s device; the engine serves host arrays either way);
and the attention kernels' launches in the rank (``launches``; the engine
runs none). The engine is ``HOROVOD_ENGINE``'s, ``python`` unless the
caller's env names another; a native engine's reports add its class, its
shm links and its cross-host ring bytes by plane and wire, and with
``T_GATHER`` (comma-separated from ``flat`` and ``hier``) a ragged
allgather (rank r gives 3 + r rows) on a fresh engine with
``hierarchical_allgather`` off or on: its digest, whether the engine ran it
in two stages, and its cross-host bytes. Payloads are made by :func:`payload` from a seed, so that
:func:`oracle_digests` rebuilds every rank's and reduces them in the
canonical order (``common.engine._ring_order_reduce``), with the engine's
enqueue-time quantization, top-k selection and error feedback.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

MIN_BYTES = 4096          # HOROVOD_COMPRESSION_MIN_BYTES's default
TOPK_RATIO = 0.01         # HOROVOD_TOPK_RATIO's default
# The world's default sizes: a 64 MiB float32 tensor and 32 small ones on
# every wire, cold and then through the response cache.
ELEMS = 16 << 20
SMALL = 32
COMPS = ("none", "fp16", "bf16", "topk")
STEPS = 2


def sizes(elems: int, small: int) -> dict:
    out = {"big": elems}
    for i in range(small):
        out[f"s{i}"] = 257 + 61 * i
    return out


def payload(step: int, name: str, rank: int, n: int) -> np.ndarray:
    seed = [step, rank, int(hashlib.sha256(name.encode()).hexdigest()[:8], 16)]
    return np.random.default_rng(seed).standard_normal(n, dtype=np.float32)


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def oracle_digests(comps, steps: int, world: int, shape: dict,
                   grids=(None,)) -> dict:
    """``{grid: {comp: [{name: sha256} per step]}}`` of the canonical
    reduction, for each ``grid`` (None: the flat ring order; ``(L, C)``:
    the two-level order). Every payload is made once."""
    from horovod_tpu_torch.common.engine import _ring_order_reduce
    from horovod_tpu_torch.compression import (cast, numpy_wire_dtype,
                                               topk_densify, topk_eligible,
                                               topk_k, topk_select)

    out = {g: {c: [] for c in comps} for g in grids}
    residuals = {c: {} for c in comps}
    for step in range(steps):
        got = {g: {c: {} for c in comps} for g in grids}
        for name, n in shape.items():
            pay = [payload(step, name, r, n) for r in range(world)]
            for comp in comps:
                wire, prep = None, pay
                if comp == "topk" and topk_eligible(
                        np.float32, n * 4, TOPK_RATIO, MIN_BYTES):
                    prep = []
                    for r, x in enumerate(pay):
                        res = residuals[comp].pop((name, r), None)
                        x = x if res is None else x + res
                        i, v = topk_select(x, topk_k(n, TOPK_RATIO))
                        d = topk_densify(i, v, n)
                        residuals[comp][(name, r)] = x - d
                        prep.append(d)
                    wire = "topk"
                elif comp in ("bf16", "fp16"):
                    wire = numpy_wire_dtype(comp, np.float32)
                    prep = [cast(cast(x, wire), np.float32) for x in pay]
                for g in grids:
                    got[g][comp][name] = digest(_ring_order_reduce(
                        prep, True, wire_dtype=wire, grid=g))
        for g in grids:
            for comp in comps:
                out[g][comp].append(got[g][comp])
    return out


def hold(reports: list[dict], plane: str, want: dict,
         light: bool = False) -> None:
    """Raise unless every rank ran ``plane`` on the engine's plane of that
    name, its results there are ``want``'s (one grid of
    :func:`oracle_digests`; without ``big`` under a wire other than
    ``none`` where the plane was ``light``), and every tensor after the
    cold step was a cache hit."""
    for rep in reports:
        ran = rep["planes"][plane]
        if set(ran.values()) != {plane}:
            raise AssertionError(f"rank {rep['rank']} ran {plane} on {ran}")
        if set(ran) != set(want):
            raise AssertionError(f"rank {rep['rank']} ran the wires {set(ran)} "
                                 f"on {plane}, not {set(want)}")
        for comp, steps in want.items():
            got = rep["digests"][plane][comp]
            if light and comp != "none":
                steps = [{n: d for n, d in st.items() if n != "big"}
                         for st in steps]
            if got != steps:
                bad = sorted({n for s, st in enumerate(steps) for n in st
                              if s >= len(got) or got[s].get(n) != st[n]})
                raise AssertionError(f"rank {rep['rank']}, {plane}, wire {comp}: "
                                     f"{bad[:4]} differ from the oracle")
            hits = len(steps[0]) * (len(steps) - 1)
            if rep["hits"][plane][comp] != hits:
                raise AssertionError(f"rank {rep['rank']}, {plane}, wire {comp}: "
                                     f"{rep['hits'][plane][comp]} cache hits, "
                                     f"not {hits}")


def _counter(snap: dict, name: str) -> float:
    return float(snap.get("counters", {}).get(name, 0) or 0)


def _reports(out_dir: str, world: int) -> list[dict]:
    reports = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(env: dict) -> dict:
    return {"PYTHONPATH": REPO, "HOROVOD_ENGINE": "python",
            "T_COMPS": ",".join(COMPS),
            "T_ELEMS": str(ELEMS), "T_SMALL": str(SMALL), "T_STEPS": str(STEPS),
            **env}


def launch(out_dir: str, env: dict, world: int = 4, hosts=None, secret=None,
           timeout: float = 600) -> list[dict]:
    """Run one world of this worker through ``runner.run_command``:
    ``world`` local ranks, or the slots of ``hosts`` through their
    hvd-agents keyed with ``secret``. ``env`` adds to the default sizes.
    Returns every rank's report, the launch's seconds in the first's
    ``_secs``."""
    import horovod_tpu_torch.runner as prunner

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    rc = prunner.run_command([sys.executable, os.path.abspath(__file__), out_dir],
                             num_proc=None if hosts else world, hosts=hosts,
                             agent_secret=secret, env=_env(env), timeout=timeout)
    if rc != 0:
        raise AssertionError(f"the engine world in {out_dir} exited {rc}")
    reports = _reports(out_dir, world)
    reports[0]["_secs"] = time.perf_counter() - t0
    return reports


def spawn(out_dir: str, env: dict, per_rank_env=None, world: int = 4,
          timeout: float = 180) -> list[dict]:
    """Start this worker as a gloo world of ``world`` processes with the
    launched-world variables set by hand, ``env`` over the default sizes
    and ``per_rank_env[r]`` over that; return every rank's report. ``env``
    must carry HOROVOD_SECRET when a relay of the caller's serves it."""
    import subprocess

    from launch_util import free_port

    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(world),
                 HOROVOD_COORD_ADDR=f"127.0.0.1:{port}",
                 HOROVOD_STALL_CHECK_DISABLE="1")
        e.update(_env(env))
        e.update((per_rank_env or {}).get(r, {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out_dir], env=e,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    return _reports(out_dir, world)


def main(out_dir: str) -> int:
    import torch

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.metrics import registry
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import ring_flash as rf

    fa.reset_launches()
    rf.reset_launches()
    basics.init(device=os.environ.get("T_DEVICE", "cpu"))
    rank, world = basics.rank(), basics.size()
    planes = os.environ.get("T_PLANES", "ring").split(",")
    light = os.environ.get("T_LIGHT", "").split(",")
    comps = os.environ.get("T_COMPS", "none").split(",")
    steps = int(os.environ.get("T_STEPS", "2"))
    timed = int(os.environ.get("T_TIMED", "0"))
    timed_comps = os.environ.get("T_TIMED_COMPS", "").split(",")
    shape = sizes(int(os.environ["T_ELEMS"]), int(os.environ.get("T_SMALL", "32")))
    order = list(shape)
    np.random.default_rng(1000 + rank).shuffle(order)   # this rank's order
    reg = registry()
    report = {"rank": rank, "order": order, "digests": {}, "planes": {},
              "hits": {}, "ctrl_bytes_per_exchange": {}, "accepted": {},
              "engine_s": {}, "shm_links": {}, "cross_bytes": {}}
    made = [{n: payload(step, n, rank, shape[n]) for n in order}
            for step in range(steps)]
    for plane in planes:
        for key in ("digests", "planes", "hits", "ctrl_bytes_per_exchange",
                    "accepted", "engine_s", "shm_links", "cross_bytes"):
            report[key][plane] = {}
        cfg = basics.config()
        cfg.ring_data_plane = plane != "star"
        cfg.hierarchical_allreduce = plane == "hier"
        for comp in comps:
            names = [n for n in order if n != "big" or comp == "none"
                     or plane not in light]
            basics.reset_engine()
            cfg.compression = comp
            eng = basics.engine()
            per_step, ctrl = [], []
            for step in range(steps):
                arrays = made[step]
                snap0 = reg.snapshot()
                handles = {n: eng.enqueue("allreduce", arrays[n], n,
                                          average=True) for n in names}
                per_step.append({n: digest(eng.synchronize(h))
                                 for n, h in handles.items()})
                snap1 = reg.snapshot()
                ex = (_counter(snap1, "horovod_engine_exchanges_total")
                      - _counter(snap0, "horovod_engine_exchanges_total"))
                cb = (_counter(snap1, "horovod_engine_control_bytes_total")
                      - _counter(snap0, "horovod_engine_control_bytes_total"))
                ctrl.append([cb, ex])
            stats = eng.cache_stats()
            report["digests"][plane][comp] = per_step
            report["planes"][plane][comp] = stats["plane"]
            report["hits"][plane][comp] = \
                (stats.get("mirror") or {}).get("hits", 0)
            report["ctrl_bytes_per_exchange"][plane][comp] = ctrl
            coord = getattr(eng, "_coord", None)
            report["accepted"][plane][comp] = getattr(coord, "accepted", None)
            report["engine"] = type(eng).__name__
            if report["engine"] == "NativeEngine":
                st = eng.stats()
                report["shm_links"][plane][comp] = st["shm_links"]
                report["cross_bytes"][plane][comp] = \
                    st["ring_cross_bytes_sent"]
            if timed and plane == "ring" and (comp in timed_comps
                                              or timed_comps == [""]):
                big = made[0]["big"]
                secs = []
                for _ in range(timed):
                    t0 = time.perf_counter()
                    eng.run("allreduce", big, "big.timed")
                    secs.append(time.perf_counter() - t0)
                report["engine_s"][plane][comp] = secs
    gathers = [g for g in os.environ.get("T_GATHER", "").split(",") if g]
    if gathers:
        report["gather"] = {}
        cfg = basics.config()
        cfg.compression, cfg.hierarchical_allreduce = "none", False
        rows = np.random.default_rng([29, rank]).standard_normal(
            (3 + rank, 4099)).astype(np.float32)
        for mode in gathers:
            basics.reset_engine()
            cfg.hierarchical_allgather = mode == "hier"
            eng = basics.engine()
            st0 = eng.stats()
            out = eng.run("allgather", rows, f"gather.{mode}")
            st1 = eng.stats()
            report["gather"][mode] = {
                "digest": digest(out), "rows": int(out.shape[0]),
                "two_stage": st1["hier_allgather"],
                "cross_bytes": st1["ring_cross_bytes_sent"]
                - st0["ring_cross_bytes_sent"]}
    if os.environ.get("T_DIST") == "1":
        import torch.distributed as dist

        dev = basics.device()
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        tensors = {n: torch.from_numpy(made[0][n]).to(dev) for n in shape}
        dist.all_reduce(tensors["big"].clone())       # warm the backend up
        secs = []
        for _ in range(max(timed, 1)):
            x = tensors["big"].clone()
            sync()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            sync()
            secs.append(time.perf_counter() - t0)
        sync()
        t0 = time.perf_counter()
        for n in shape:          # the backend pairs calls by order: one for all
            if n != "big":
                dist.all_reduce(tensors[n].clone())
        sync()
        report["dist_s"] = {"backend": dist.get_backend(), "big": secs,
                            "small_all": time.perf_counter() - t0}
    basics.shutdown()
    report["launches"] = {**fa.launches, **rf.launches}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1]))
