"""Scaling benchmark on the PyTorch port: the counterpart of
``examples/scaling_benchmark.py``, with its sections, flags and JSON keys.
The reference's headline artifact is its efficiency-against-world-size
curve; this harness produces the curve on every plane one machine can
measure, and an analytic projection to the scale it cannot.

(a) EAGER plane (``--eager``, ``--hier``): the port's ``NativeEngine``
    (the C++ core) allreducing a fixed payload per rank over worlds of
    processes on this host, 2/4/8/16 capped at the host's CPUs (the JSON
    names the worlds dropped and why). Every rank checks that its reduced
    buffer of ones (``average=False``) is exactly ``world`` in every
    element. All ranks share one host's memory and loopback, so this
    measures the engine's software scaling: the aggregate rate staying
    flat is the signal. The hierarchical variant runs flat and two-level
    on a simulated 2-host grid and reports each rank's cross-host bytes.
    A worker imports ``horovod_tpu_torch.cc.native_engine``, which imports
    torch through the package: each rank reports that import's seconds.
(b) COMPILED plane (``--compiled``): the port's ``DistributedOptimizer``
    step on ``TransformerLM(vocab 256, dim 128, heads 4, layers 2,
    float32)``, dense attention, SGD(0.01), a fixed global batch of 64 x
    128 tokens (strong scaling), one step at a time with a host fence:
    over gloo on the CPU in worlds of 1/2/4 processes, each given an equal
    share of the host's CPUs (the same silicon time-shared, as the JAX
    package's virtual mesh), and over NCCL, one process per card, in every
    world the card count allows (the others reported not run, with the
    reason). Efficiency = step_time(1) / step_time(world). Every world is
    started by the port's launcher, ``runner.run_command``.
    ``--compiled-mp``: the same gloo step as 1 process and as 2: the cost
    of crossing a process boundary, which every rank of the port crosses
    (with ``--compiled``, its worlds 1 and 2). ``--buckets-ab``:
    ``num_buckets`` 1 against 2/4/8 on the largest gloo world (with
    ``--compiled``, in that world's processes after its own step).
(c) PROJECTION (``--project``, needs ``--step-ms``): an analytic model of
    ResNet-50 data parallelism on H100 nodes of 8 (NVLink 4 inside a node,
    InfiniBand across nodes) from a measured single-card step time, flat
    against the hierarchical ladder.

    python examples/torch_scaling_benchmark.py --step-ms 40     # all sections
    python examples/torch_scaling_benchmark.py --eager --hier
    python examples/torch_scaling_benchmark.py --compiled --compiled-mp --buckets-ab
    python examples/torch_scaling_benchmark.py --project --step-ms 40

One JSON document on stdout; tables on stderr. Every worker counts the
launches of the port's attention kernels in its own process, and each
section reports their sum (``launches``).
"""

from __future__ import annotations

import argparse
import json
import os
import secrets
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

HOST_CPUS = len(os.sched_getaffinity(0))

# ---------------------------------------------------------------- (a) eager


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# Worker body: the native engine and nothing else of the package's
# training path. An example runs from a checkout without the test tree,
# hence this minimal spawner rather than tests/launch_util.py.
_WORKER = r"""
import json, os, sys, time
t0 = time.perf_counter()
import numpy as np
sys.path.insert(0, os.environ["HVD_REPO"])
from horovod_tpu_torch.cc.native_engine import NativeEngine
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.topology import Topology
from horovod_tpu_torch.ops import flash_attention as fa, ring_flash as rf
import_s = time.perf_counter() - t0

rank = int(os.environ["HOROVOD_RANK"])
world = int(os.environ["HOROVOD_SIZE"])
elems = int(os.environ["HVD_SCALE_ELEMS"])
iters = int(os.environ["HVD_SCALE_ITERS"])
buf = np.ones(elems, dtype=np.float32)
out = []
# One engine after another, each at a coordinator port of its own:
# (ranks per simulated host, two-level ring on or off).
runs = [r.split(":") for r in os.environ["HVD_SCALE_RUNS"].split(",")]
ports = os.environ["HVD_SCALE_PORTS"].split(",")
for (local, hier), port in zip(runs, ports):
    local, hier = int(local), hier == "1"
    os.environ["HOROVOD_COORD_ADDR"] = f"127.0.0.1:{port}"
    topo = Topology(rank, world, rank % local, local, rank // local,
                    max(world // local, 1))
    cfg = Config(cycle_time_ms=1.0, hierarchical_allreduce=hier,
                 pinned={"HOROVOD_HIERARCHICAL_ALLREDUCE"})
    eng = NativeEngine(topo, cfg)
    outs = [eng.run("allreduce", buf, "warmup", average=False)]  # links + first pass
    t0 = time.perf_counter()
    for i in range(iters):
        outs.append(eng.run("allreduce", buf, f"it{i}", average=False))
    dt = time.perf_counter() - t0
    exact = all(o.shape == buf.shape and bool((o == world).all()) for o in outs)
    del outs
    st = eng.stats()
    eng.shutdown()
    out.append({"rank": rank, "local": local, "hier": hier, "seconds": dt,
                "exact": exact, "bytes_per_s": elems * 4 * iters / dt,
                "cross_bytes": st["ring_cross_bytes_sent"],
                "hier_on": st["hier_allreduce"]})
print(json.dumps({"import_s": import_s, "runs": out,
                  "launches": {**fa.launches, **rf.launches}}))
"""


def _spawn(argv: list, world: int, extra_env: dict, timeout: float) -> list[str]:
    """``world`` processes of ``argv`` with the launcher's rank variables
    and a coordinator address of their own; each rank's stdout. A rank
    that fails fails the world; every process is reaped."""
    port = _free_port()
    secret = secrets.token_hex(16)
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.update({
            "HVD_REPO": REPO,
            "HOROVOD_RANK": str(rank),
            "HOROVOD_SIZE": str(world),
            "HOROVOD_LOCAL_RANK": str(rank),
            "HOROVOD_LOCAL_SIZE": str(world),
            "HOROVOD_COORD_ADDR": f"127.0.0.1:{port}",
            "HOROVOD_SECRET": secret,
            **extra_env,
        })
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"rank failed:\n{stderr[-2000:]}")
            out.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _sum_launches(reports) -> dict:
    """The attention kernels' launches (B1-B6), summed over ``reports``:
    each rank counts its own."""
    out: dict = {}
    for r in reports:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _run_world(world: int, elems: int, iters: int, runs: list,
               timeout: float = 600) -> list[dict]:
    """One launch of ``world`` ranks running ``runs``, a list of (ranks
    per simulated host, two-level on), one engine after another; every
    rank's report. A rank whose reduced buffer of ones is not exactly
    ``world`` fails the world."""
    ports = [str(_free_port()) for _ in runs]
    out = [json.loads(stdout.strip().splitlines()[-1]) for stdout in _spawn(
        [sys.executable, "-c", _WORKER], world, {
            "HVD_SCALE_ELEMS": str(elems), "HVD_SCALE_ITERS": str(iters),
            "HVD_SCALE_RUNS": ",".join(f"{lo}:{int(h)}" for lo, h in runs),
            "HVD_SCALE_PORTS": ",".join(ports)}, timeout)]
    wrong = [(r["rank"], run["local"], run["hier"]) for r in out
             for run in r["runs"] if not run["exact"]]
    if wrong:
        raise RuntimeError(f"world {world}: (rank, local, two-level) {wrong} "
                           f"reduced a buffer of ones to something other "
                           f"than {world}")
    return out


def eager_sweep(worlds=(2, 4, 8, 16), hier_world: int | None = None,
                hier_local: int | None = None, payload_mb: float = 100.0,
                iters: int = 3) -> tuple:
    """The eager plane's launches: one per world size, each running the
    engines that size needs (the flat ring on one simulated host for the
    scaling rows; flat and two-level on a 2-host grid at ``hier_world``),
    so that a world shared by both sections starts its processes once.
    Returns ``(eager_scaling's dict or None, eager_hierarchical's dict or
    None)``."""
    elems = int(payload_mb * (1 << 20) / 4)
    run = [w for w in worlds if w <= HOST_CPUS]
    dropped = [{"world": w, "reason": f"more ranks than the host's "
                                      f"{HOST_CPUS} CPUs"}
               for w in worlds if w > HOST_CPUS]
    hier_local = hier_local or (hier_world or 0) // 2
    plans = {w: [(w, False)] for w in run}
    if hier_world:
        plans.setdefault(hier_world, []).extend(
            [(hier_local, False), (hier_local, True)])
    reports = {w: _run_world(w, elems, iters, plan) for w, plan in plans.items()}

    def runs(w, local, hier):
        return [next(x for x in r["runs"]
                     if x["local"] == local and x["hier"] == hier)
                for r in reports[w]]

    scaling = None
    if run:
        rows = []
        for w in run:
            res = runs(w, w, False)
            # the slowest rank bounds the collective
            rows.append({"world": w,
                         "bytes_per_s": min(r["bytes_per_s"] for r in res),
                         "import_s": round(max(r["import_s"]
                                               for r in reports[w]), 3)})
        base = rows[0]["bytes_per_s"]
        agg_base = base * run[0]
        for r in rows:
            agg = r["bytes_per_s"] * r["world"]
            r["MB_per_s_rank"] = round(r["bytes_per_s"] / (1 << 20), 1)
            r["per_rank_efficiency"] = round(r["bytes_per_s"] / base, 3)
            r["aggregate_MB_per_s"] = round(agg / (1 << 20), 1)
            r["software_efficiency"] = round(agg / agg_base, 3)
            del r["bytes_per_s"]
        scaling = {
            "payload_mb": payload_mb, "iters": iters,
            "baseline_world": run[0], "host_cpus": HOST_CPUS,
            "dropped_worlds": dropped,
            "launches": _sum_launches(r for w in run for r in reports[w]),
            "note": "single host: all ranks share one memory system and "
                    f"{HOST_CPUS} CPU(s); software_efficiency (aggregate "
                    f"against world {run[0]}) is the scaling signal, "
                    "per_rank_efficiency necessarily ~1/N",
            "worlds": rows}
    hierarchical = None
    if hier_world:
        flat, hier = (runs(hier_world, hier_local, h) for h in (False, True))
        if not all(r["hier_on"] == 1 for r in hier):
            raise RuntimeError(f"the two-level ring did not engage: {hier}")
        max_flat = max(r["cross_bytes"] for r in flat)
        max_hier = max(r["cross_bytes"] for r in hier)
        hierarchical = {
            "world": hier_world, "hosts": hier_world // hier_local,
            "ranks_per_host": hier_local, "payload_mb": payload_mb,
            "flat_worst_rank_cross_MB": round(max_flat / (1 << 20), 1),
            "hier_worst_rank_cross_MB": round(max_hier / (1 << 20), 1),
            "flat_worst_rank_cross_bytes": max_flat,
            "hier_worst_rank_cross_bytes": max_hier,
            "cross_byte_ratio": round(max_hier / max_flat, 3),
            "flat_s": round(min(r["seconds"] for r in flat), 3),
            "hier_s": round(min(r["seconds"] for r in hier), 3),
            "launches": _sum_launches(reports[hier_world]),
        }
    return scaling, hierarchical


def eager_scaling(worlds=(2, 4, 8, 16), payload_mb: float = 100.0,
                  iters: int = 3) -> dict:
    """Efficiency against world size for the native eager ring. Per rank
    the rate is reduced bytes/s (payload / time); one host shares its
    memory among the ranks, so the per-rank rate falls ~1/world on
    hardware grounds alone, and the AGGREGATE rate held against the
    smallest world's is the software-scaling signal. Worlds above the
    host's CPU count are dropped and named."""
    return eager_sweep(worlds, payload_mb=payload_mb, iters=iters)[0]


def eager_hierarchical(world: int = 8, local: int | None = None,
                       payload_mb: float = 100.0, iters: int = 3) -> dict:
    """Flat against the two-level ring on a simulated 2-host grid at the
    same world size: each rank's cross-host bytes (the quantity that
    carries over to real clusters, where cross-host links are scarce)
    beside the wall time (on one host both ride loopback)."""
    return eager_sweep((), world, local, payload_mb, iters)[1]


# -------------------------------------------------------------- (b) compiled

MODEL = "TransformerLM(vocab 256, dim 128, heads 4, layers 2, float32, dense)"
SEQ = 128


def _timed_compiled_step(global_batch: int, steps: int, reps: int,
                         num_buckets=None) -> float:
    """The 2-layer TransformerLM step through ``DistributedOptimizer`` on
    this rank's share of the fixed global batch, timed in ``reps`` windows
    of ``steps`` steps, each step fenced on the host (its loss read);
    the median window's ms per step. One implementation for every world,
    backend and launcher, so the sections time the same step."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, init_weights

    dev = hvd.device()
    model = TransformerLM(vocab=256, dim=128, heads=4, layers=2,
                          dtype=torch.float32, attention="dense").to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.01),
                                   model.named_parameters(),
                                   num_buckets=num_buckets)
    if global_batch % hvd.size():
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{hvd.size()} ranks")
    x = torch.zeros((global_batch // hvd.size(), SEQ), dtype=torch.int64,
                    device=dev)

    def step():
        opt.zero_grad()
        logits = model(x)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               x[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
        return loss.item()                        # the per-step fence

    step()                                        # first-call costs
    windows = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        windows.append(time.perf_counter() - t0)
    windows.sort()
    return windows[len(windows) // 2] / steps * 1e3


def _compiled_worker(out_path: str) -> int:
    """One rank of a compiled world: ``HVD_SCALE_DEVICE`` (cpu: gloo,
    cuda: NCCL), ``HVD_SCALE_THREADS`` CPU threads, the step timed at each
    bucket count of ``HVD_SCALE_BUCKETS`` in turn (``default``, or unset:
    the env's); each rank writes ``{"step_ms": [...], "world", "device",
    "launches"}`` to ``out_path.<rank>``."""
    import torch

    threads = int(os.environ.get("HVD_SCALE_THREADS", "0"))
    if threads:
        torch.set_num_threads(threads)
    import horovod_tpu_torch as hvd

    hvd.init(os.environ.get("HVD_SCALE_DEVICE", "cpu"))
    buckets = os.environ.get("HVD_SCALE_BUCKETS")
    step_ms = [_timed_compiled_step(
        int(os.environ.get("HVD_SCALE_BATCH", "64")),
        int(os.environ.get("HVD_SCALE_STEPS", "8")),
        int(os.environ.get("HVD_SCALE_REPS", "3")), k)
        for k in ([None if b == "default" else int(b)
                   for b in buckets.split(",")] if buckets else [None])]
    from horovod_tpu_torch.ops import flash_attention as fa, ring_flash as rf

    dev = hvd.device()
    with open(f"{out_path}.{hvd.rank()}", "w") as f:
        json.dump({"step_ms": step_ms, "world": hvd.size(),
                   "device": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
                   "launches": {**fa.launches, **rf.launches}}, f)
    hvd.shutdown()
    return 0


def _read_world(out_path: str, world: int) -> dict:
    """Rank 0's report, with the launches of every rank summed."""
    reports = []
    for rank in range(world):
        with open(f"{out_path}.{rank}") as f:
            reports.append(json.load(f))
    return dict(reports[0], launches=_sum_launches(reports))


def _compiled_env(device: str, world: int, global_batch: int, steps: int,
                  reps: int, buckets=()) -> dict:
    env = {"HVD_SCALE_DEVICE": device, "HVD_SCALE_BATCH": str(global_batch),
           "HVD_SCALE_STEPS": str(steps), "HVD_SCALE_REPS": str(reps)}
    if device == "cpu":
        env["HVD_SCALE_THREADS"] = str(max(1, HOST_CPUS // world))
    if buckets:
        env["HVD_SCALE_BUCKETS"] = ",".join(
            "default" if k is None else str(k) for k in buckets)
    return env


def _compiled_world(device: str, world: int, global_batch: int, steps: int,
                    reps: int, buckets=()) -> dict:
    """One world of ``_compiled_worker``, launched by the port's launcher
    (``runner.run_command``, as a user's job is): rank 0's report
    (``step_ms`` a list, one per bucket count) with every rank's launches
    summed."""
    from horovod_tpu_torch.runner import run_command

    with tempfile.TemporaryDirectory(prefix="hvd_scale_") as tmp:
        out = os.path.join(tmp, "r.json")
        rc = run_command([sys.executable, os.path.abspath(__file__),
                          "--compiled-worker", out], num_proc=world,
                         env=dict(_compiled_env(device, world, global_batch,
                                                steps, reps, buckets),
                                  PYTHONPATH=REPO),
                         timeout=900.0)
        if rc != 0:
            raise RuntimeError(f"the {device} world of {world} exited {rc}")
        return _read_world(out, world)


def _card_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def compiled_scaling(worlds=(1, 2, 4), global_batch: int = 64,
                     steps: int = 8, reps: int = 3, ab_grid=()) -> tuple:
    """Strong scaling of the ``DistributedOptimizer`` step: gloo worlds of
    processes on the CPU (the host's CPUs split evenly, so every world
    runs the same FLOPs on the same silicon and a rise in step time is the
    exchange's and the partition's cost), then NCCL worlds, one process per
    card, where the cards allow. With ``ab_grid``, the largest gloo world
    also runs ``compiled_buckets_ab``'s grid after its own step, in the
    same processes. Returns ``(the section, the A/B or None)``."""
    rows, ab = [], None
    for w in worlds:
        grid = (None, 1, *ab_grid) if ab_grid and w == max(worlds) else ()
        r = _compiled_world("cpu", w, global_batch, steps, reps, grid)
        rows.append({"world": w, "backend": "gloo",
                     "threads_per_rank": max(1, HOST_CPUS // w),
                     "step_ms": round(r["step_ms"][0], 3),
                     "launches": r["launches"]})
        if grid:
            ab = _buckets_ab(w, global_batch, grid[1:], r["step_ms"][1:],
                             r["launches"])
    base = rows[0]["step_ms"]
    for r in rows:
        r["efficiency"] = round(base / r["step_ms"], 3)
    cards = _card_count()
    nccl, not_run = [], []
    for w in worlds:
        if w > cards:
            not_run.append({"world": w, "reason": f"{w} cards needed, "
                                                  f"{cards} on this machine"})
            continue
        r = _compiled_world("cuda", w, global_batch, steps, reps)
        nccl.append({"world": w, "backend": "nccl", "device": r["device"],
                     "step_ms": round(r["step_ms"][0], 3),
                     "launches": r["launches"]})
    for r in nccl:
        r["efficiency"] = round(nccl[0]["step_ms"] / r["step_ms"], 3)
    return {"model": MODEL, "global_batch": global_batch, "seq": SEQ,
            "host_cpus": HOST_CPUS,
            "mode": "strong scaling, fixed global batch; gloo worlds share "
                    "the host's CPUs evenly; efficiency < 1 = exchange and "
                    "partition overhead",
            "worlds": rows, "nccl": {"worlds": nccl, "not_run": not_run}}, ab


def compiled_buckets_ab(world: int = 4, global_batch: int = 64, steps: int = 8,
                        reps: int = 3, bucket_grid=(2, 4, 8)) -> dict:
    """``num_buckets`` 1 against ``bucket_grid`` in one gloo world, one
    after another: the same step and timing, a fresh model and optimizer
    for each, the bucket count the only variable."""
    grid = (1, *bucket_grid)
    r = _compiled_world("cpu", world, global_batch, steps, reps, grid)
    return _buckets_ab(world, global_batch, grid, r["step_ms"], r["launches"])


def _buckets_ab(world, global_batch, grid, step_ms, launches) -> dict:
    rows = [{"num_buckets": k, "step_ms": round(ms, 3)}
            for k, ms in zip(grid, step_ms)]
    single_ms = rows[0]["step_ms"]
    best = min(rows[1:], key=lambda r: r["step_ms"])
    return {
        "model": MODEL, "global_batch": global_batch, "world": world,
        "mode": "fixed-batch A/B: num_buckets the only variable; "
                "speedup > 1 = the buckets pay on this platform",
        "rows": rows, "launches": launches,
        "best_num_buckets": best["num_buckets"],
        "bucketed_speedup": round(single_ms / best["step_ms"], 3),
    }


def compiled_multiprocess(global_batch: int = 64, steps: int = 6,
                          reps: int = 3, compiled: dict | None = None) -> dict:
    """The same gloo step as 1 process and as 2 processes launched through
    ``runner.run_command``, the host's CPUs split evenly: the ratio is the
    cost of crossing a process boundary (the exchange over gloo between
    processes). ``compiled``, the compiled section's result, gives its
    worlds 1 and 2, which the launcher started the same way."""
    rows = []
    for nproc in (1, 2):
        if compiled is not None:
            r = next(r for r in compiled["worlds"] if r["world"] == nproc)
            ms, launches = r["step_ms"], r["launches"]
        else:
            r = _compiled_world("cpu", nproc, global_batch, steps, reps)
            ms, launches = round(r["step_ms"][0], 3), r["launches"]
        rows.append({"procs": nproc, "threads_per_proc": max(1, HOST_CPUS // nproc),
                     "step_ms": ms, "launches": launches})
    return {
        "mode": "fixed global batch, the host's CPUs split evenly; the "
                "2-process row exchanges gradients across the process "
                "boundary over gloo",
        "global_batch": global_batch,
        "rows": rows,
        "process_boundary_overhead": round(rows[1]["step_ms"] / rows[0]["step_ms"] - 1.0, 3),
    }


# ------------------------------------------------------------ (c) projection

# NVLink 4: 900 GB/s per GPU, the total of both directions (NVIDIA H100
# Tensor Core GPU datasheet). Charged at half, 450 GB/s, as the JAX
# model charges its intra-pod links half their aggregate.
NVLINK_GBS = 900.0
NVLINK_EFFECTIVE_GBS = NVLINK_GBS / 2
# InfiniBand: 8 ConnectX-7 NDR ports of 400 Gb/s per node (NVIDIA DGX H100
# datasheet) = 400 GB/s per node, 50 GB/s per GPU. Charged at the line
# rate, as the JAX model charges its cross-pod NICs.
IB_PER_NODE_GBS = 8 * 400 / 8
GPUS_PER_NODE = 8
RESNET50_PARAMS = 25.56e6


def project_pod_efficiency(step_ms: float,
                           grad_bytes: float = RESNET50_PARAMS * 4,
                           overlap: float = 0.7) -> dict:
    """An analytic model of ResNet-50 data parallelism on H100 nodes of 8.

      t_comm      = the allreduce's time on its bottleneck link (below)
      exposed     = max(0, t_comm - overlap * t_step)
      efficiency  = t_step / (t_step + exposed)

    One node: a ring over NVLink, 2 G (n-1)/n / NVLink. Across nodes,
    flat: every GPU's ring bytes 2 G (N-1)/N cross InfiniBand at its share
    of the node's ports; hierarchical ladder: reduce-scatter and
    all-gather over NVLink (2 G 7/8) and an allreduce of G/8 per GPU
    across the M nodes, 2 (G/8) (M-1)/M at the same share. ``step_ms``
    is the measured single-card step; ``overlap`` the share of it the
    exchange can hide behind (the JAX model's 0.7).
    """
    if not step_ms or step_ms <= 0:
        raise ValueError("step_ms must be a measured single-card step time")
    t_step = step_ms / 1e3
    nvl = NVLINK_EFFECTIVE_GBS * 1e9
    ib_gpu = IB_PER_NODE_GBS * 1e9 / GPUS_PER_NODE

    def row(gpus, fabric, t_comm):
        exposed = max(0.0, t_comm - overlap * t_step)
        return {"gpus": gpus, "fabric": fabric,
                "t_comm_ms": round(t_comm * 1e3, 3),
                "efficiency": round(t_step / (t_step + exposed), 3)}

    n = GPUS_PER_NODE
    rows = [row(n, "NVLink (one node)", 2 * grad_bytes * (n - 1) / n / nvl)]
    for gpus in (64, 256, 512):
        nodes = gpus // n
        flat = 2 * grad_bytes * (gpus - 1) / gpus / ib_gpu
        ladder = (2 * grad_bytes * (n - 1) / n / nvl
                  + 2 * (grad_bytes / n) * (nodes - 1) / nodes / ib_gpu)
        rows.append(row(gpus, f"{nodes} nodes over InfiniBand, flat", flat))
        rows.append(row(gpus, f"{nodes} nodes over InfiniBand, hierarchical "
                              "ladder", ladder))
    return {
        "model": "ResNet-50 DP on H100 nodes of 8",
        "assumptions": {
            "step_ms_single_card": step_ms,
            "grad_bytes": int(grad_bytes),
            "nvlink_GBs": NVLINK_GBS,
            "nvlink_effective_GBs": NVLINK_EFFECTIVE_GBS,
            "ib_per_node_GBs": IB_PER_NODE_GBS,
            "gpus_per_node": GPUS_PER_NODE,
            "overlap_fraction": overlap,
        },
        "rows": rows,
    }


# ---------------------------------------------------------------------- main


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for flag in ("--eager", "--hier", "--compiled", "--compiled-mp",
                 "--buckets-ab", "--project"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--step-ms", type=float,
                   help="measured single-card ResNet-50 step, for --project")
    p.add_argument("--payload-mb", type=float, default=100.0)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--compiled-worker", metavar="OUT", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.run_all = not (args.eager or args.hier or args.compiled
                        or args.compiled_mp or args.buckets_ab or args.project)
    if args.compiled_worker:
        args.run_all = False
    elif (args.run_all or args.project) and args.step_ms is None:
        p.error("the projection needs --step-ms, a measured single-card "
                "ResNet-50 step time")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.compiled_worker:
        return _compiled_worker(args.compiled_worker)
    out: dict = {}

    def took(t0):
        print(f"  took {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    eager, hier = args.run_all or args.eager, args.run_all or args.hier
    if eager or hier:
        t0 = time.perf_counter()
        worlds = (2, 4, 8, 16) if eager else ()
        print(f"eager plane: native ring, worlds {worlds}"
              f"{'; two-level ring at 8' if hier else ''} ...", file=sys.stderr)
        scaling, two_level = eager_sweep(
            worlds, 8 if hier else None, payload_mb=args.payload_mb,
            iters=args.iters)
        if scaling:
            out["eager"] = scaling
            for r in scaling["worlds"]:
                print(f"  world {r['world']:>2}: {r['MB_per_s_rank']:>8.1f} "
                      f"MB/s/rank  aggregate {r['aggregate_MB_per_s']:>8.1f} "
                      f"MB/s  software eff {r['software_efficiency']:.3f}",
                      file=sys.stderr)
            for d in scaling["dropped_worlds"]:
                print(f"  world {d['world']:>2}: not run, {d['reason']}",
                      file=sys.stderr)
        if two_level:
            out["eager_hierarchical"] = h = two_level
            print(f"  worst rank's cross-host bytes two-level / flat = "
                  f"{h['cross_byte_ratio']} (1/local_size = "
                  f"{1.0 / h['ranks_per_host']:.3f})", file=sys.stderr)
        took(t0)
    compiled_worlds = (1, 2, 4)
    ab_grid = (2, 4, 8) if args.buckets_ab else ()   # only on request
    if args.run_all or args.compiled:
        t0 = time.perf_counter()
        print(f"compiled plane: worlds {compiled_worlds}, gloo and NCCL"
              f"{'; the bucket A/B in the largest' if ab_grid else ''} ...",
              file=sys.stderr)
        out["compiled"], ab = compiled_scaling(
            compiled_worlds, steps=args.steps, reps=args.reps, ab_grid=ab_grid)
        if ab:
            out["compiled_buckets_ab"] = ab
        for r in out["compiled"]["worlds"] + out["compiled"]["nccl"]["worlds"]:
            print(f"  {r['backend']} world {r['world']}: {r['step_ms']:>8.3f} "
                  f"ms/step  eff {r['efficiency']:.3f}", file=sys.stderr)
        for d in out["compiled"]["nccl"]["not_run"]:
            print(f"  nccl world {d['world']}: not run, {d['reason']}",
                  file=sys.stderr)
        took(t0)
    if ab_grid and "compiled_buckets_ab" not in out:
        t0 = time.perf_counter()
        largest = max(compiled_worlds)
        print(f"compiled plane: 1 against 2/4/8 buckets, gloo world "
              f"{largest} ...", file=sys.stderr)
        out["compiled_buckets_ab"] = compiled_buckets_ab(
            largest, steps=args.steps, reps=args.reps)
        took(t0)
    if ab_grid:
        ab = out["compiled_buckets_ab"]
        print(f"  buckets {[(r['num_buckets'], r['step_ms']) for r in ab['rows']]}"
              f" ms: best {ab['best_num_buckets']}, speedup "
              f"{ab['bucketed_speedup']:.3f}x", file=sys.stderr)
    if args.run_all or args.compiled_mp:
        t0 = time.perf_counter()
        print("compiled plane: 1 against 2 processes (run_command) ...",
              file=sys.stderr)
        ran = {r["world"] for r in out.get("compiled", {}).get("worlds", ())}
        out["compiled_multiprocess"] = mp = compiled_multiprocess(
            steps=args.steps, reps=args.reps,
            compiled=out["compiled"] if {1, 2} <= ran else None)
        print(f"  process-boundary overhead: "
              f"{mp['process_boundary_overhead']:+.1%}", file=sys.stderr)
        took(t0)
    if args.run_all or args.project:
        out["projection"] = project_pod_efficiency(args.step_ms)
        for r in out["projection"]["rows"]:
            print(f"  {r['gpus']:>3} GPUs {r['fabric']:<52} t_comm "
                  f"{r['t_comm_ms']:>7.3f} ms  eff {r['efficiency']:.3f}",
                  file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
