"""How much of the gradient exchange the backward pass hides, and the
plan gauges of the exchange.

The counterpart of ``horovod_tpu.metrics.overlap``:

- ``record_plan(plan, threshold)``: a fusion plan's buckets in issue order
  with their bytes (pad included), the largest bucket's occupancy of the
  threshold, and the planned bound on the hidden share of the bytes,
  ``1 - last bucket / total`` for a reverse-order plan of more than one
  bucket (bucket i's collective can run under the compute that produces
  buckets i+1..K-1; nothing runs under the last one), else 0. It returns
  them and sets the reference's gauges (``horovod_fusion_*``,
  ``horovod_overlap_efficiency_planned``).
- ``record_wire_plan``, ``record_tier_plan``, ``record_shard_plan`` and
  ``record_sharded_state_bytes``: the reference's per-step gauges of the
  wire dtypes, the ladder's tiers and the ZeRO exchange, which
  ``DistributedOptimizer`` sets once per plan (the reference's compiled
  plane sets them once per trace); the ``last_*`` accessors read them
  back.
- ``parse_overlap(events)``: from a ``torch.profiler`` Chrome trace, each
  collective kernel's device time and the part of it that ran while a
  compute kernel ran on the same device; ``overlap_efficiency`` is the
  hidden share of the collective time. A kernel is a collective by the
  reference's name markers (NCCL's ``ncclDevKernel_AllReduce_*``,
  ``*ReduceScatter*``, ``*AllGather*``, ...); NCCL's other kernels
  (``SendRecv``, ``Broadcast``) are communication and count as neither;
  every other kernel is compute. ``model_hidden_ms`` and
  ``model_overlap_efficiency`` count only compute kernels that are not
  copies (``copy`` or ``fill`` in the name): the exchange's own fuse, cast,
  pad and unfuse are such kernels, so these read what the model's own
  compute hid, less the part under its own copies.
- ``measure_overlap(run_step, steps, sync)``: profiles ``steps`` calls of
  a warmed step on the card and returns ``parse_overlap``'s report.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Optional

import torch

from ..parallel.fusion import FusionPlan
from .registry import DEFAULT_BYTE_BUCKETS, registry

# The reference's markers of a collective in a device op's name.
_COLLECTIVE_MARKERS = (
    "all-reduce", "all_reduce", "allreduce",
    "all-gather", "all_gather", "allgather",
    "reduce-scatter", "reduce_scatter", "reducescatter",
    "all-to-all", "all_to_all", "alltoall",
    "collective-permute", "collective_permute",
)


# Latest recorded plan: [(issue_index, nbytes), ...] in issue order.
_last_plan: Optional[list] = None


def record_plan(plan: FusionPlan, threshold: int) -> dict:
    """``{"buckets": [(issue_index, nbytes), ...], "total_bytes",
    "occupancy", "planned_efficiency"}`` of ``plan``, also set as the
    reference's gauges."""
    global _last_plan
    sizes = []
    for i, bucket in enumerate(plan.buckets):
        elems = sum(d.size for d in bucket)
        sizes.append((i, (elems + -elems % plan.pad_to) * bucket[0].itemsize))
    total = sum(n for _, n in sizes) or 1
    planned = 0.0
    if plan.reverse_order and len(sizes) > 1:
        planned = 1.0 - sizes[-1][1] / total
    occupancy = max(n for _, n in sizes) / max(1, threshold)
    reg = registry()
    reg.gauge("horovod_fusion_buckets",
              help="buckets in the latest compiled fusion plan").set(len(sizes))
    reg.gauge("horovod_fusion_planned_bytes",
              help="total gradient bytes in the latest fusion plan").set(total)
    reg.gauge("horovod_fusion_buffer_occupancy",
              help="largest bucket bytes / fusion threshold").set(occupancy)
    hist = reg.histogram("horovod_fusion_bucket_bytes",
                         help="per-bucket byte sizes across recorded plans",
                         buckets=DEFAULT_BYTE_BUCKETS)
    for _, n in sizes:
        hist.observe(n)
    reg.gauge(
        "horovod_overlap_efficiency_planned",
        help="byte fraction of the bucketed allreduce that the plan allows "
             "XLA to hide under backward compute (0 = single fused buffer)",
    ).set(planned)
    _last_plan = sizes
    return {"buckets": sizes, "total_bytes": total, "occupancy": occupancy,
            "planned_efficiency": planned}


def last_plan() -> Optional[list]:
    """[(issue_index, nbytes), ...] of the most recently recorded plan."""
    return _last_plan


def _is_collective(name: str) -> bool:
    s = name.lower()
    return any(m in s for m in _COLLECTIVE_MARKERS)


def _kind(name: str) -> Optional[str]:
    """"coll", "copy" or "comp" for a kernel's name; None for NCCL's
    point-to-point and broadcast kernels."""
    if _is_collective(name):
        return "coll"
    s = name.lower()
    if "nccl" in s:
        return None
    return "copy" if "copy" in s or "fill" in s else "comp"


def _union(spans: list) -> list:
    """A sorted disjoint union of (start, end) spans."""
    merged: list = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _overlap_len(span: tuple, union: list) -> float:
    """Length of ``span``'s intersection with a sorted disjoint union."""
    s0, e0 = span
    out = 0.0
    for s, e in union:
        if e <= s0:
            continue
        if s >= e0:
            break
        out += min(e, e0) - max(s, s0)
    return out


def parse_overlap(events: list) -> dict:
    """The overlap report of a ``torch.profiler`` Chrome trace's events:
    ``ok``, ``collectives``, ``collective_ms``, ``hidden_ms``,
    ``overlap_efficiency`` and the first 64 ``spans`` by start, as the
    reference reports them, plus ``model_hidden_ms`` and
    ``model_overlap_efficiency`` (see the module docstring). Only device
    kernels count (``"cat": "kernel"``), grouped by device: a collective on
    one card beside compute on another is parallelism, not hiding."""
    per_dev: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel" \
                or "dur" not in e or "ts" not in e:
            continue
        name = e.get("name", "")
        kind = _kind(name)
        if kind is None:
            continue
        dev = (e.get("args") or {}).get("device", e.get("pid"))
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        per_dev.setdefault(dev, {"coll": [], "comp": [], "copy": []})[kind].append(
            (span, name))
    coll_total = hidden = model_hidden = 0.0
    n_coll = 0
    spans = []
    for dev in per_dev.values():
        model = [s for s, _ in dev["comp"]]
        every = _union(model + [s for s, _ in dev["copy"]])
        model = _union(model)
        for span, name in dev["coll"]:
            dur = span[1] - span[0]
            ov = _overlap_len(span, every)
            coll_total += dur
            hidden += ov
            model_hidden += _overlap_len(span, model)
            n_coll += 1
            spans.append({"name": name, "ms": dur / 1e3, "hidden_ms": ov / 1e3,
                          "start_us": span[0], "end_us": span[1]})
    if n_coll == 0:
        return {"ok": False,
                "reason": "no collective kernels in the trace (NCCL launches "
                          "none in a world of one)"}
    spans.sort(key=lambda b: b["start_us"])
    return {
        "ok": True,
        "collectives": n_coll,
        "collective_ms": round(coll_total / 1e3, 3),
        "hidden_ms": round(hidden / 1e3, 3),
        "overlap_efficiency": round(hidden / coll_total, 4) if coll_total else 0.0,
        "model_hidden_ms": round(model_hidden / 1e3, 3),
        "model_overlap_efficiency":
            round(model_hidden / coll_total, 4) if coll_total else 0.0,
        "spans": spans[:64],
    }


def chrome_events(prof) -> list:
    """The events of a finished ``torch.profiler.profile``'s Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def measure_overlap(run_step: Callable[[], None], steps: int = 3,
                    sync: Optional[Callable[[], None]] = None) -> dict:
    """Profile ``steps`` calls of a warmed ``run_step`` on the card
    (``sync``, if given, ends the window) and return ``parse_overlap``'s
    report of the trace."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("measure_overlap reads the card's kernels; no CUDA "
                           "device is available")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        if sync is not None:
            sync()
    return parse_overlap(chrome_events(prof))


# Latest wire-compression plan: (compression, [(orig_nbytes, compressed?,
# wire_nbytes), ...]) in bucket-issue order (tests + snapshot annotations).
_last_wire_plan: Optional[tuple] = None


def record_wire_plan(compression: str, buckets: list) -> list:
    """Record an exchange plan's per-bucket wire-compression verdicts, once
    per plan; the gauges describe the PER-STEP wire cost of the latest
    plan (the collectives count ``horovod_wire_bytes_total`` as they
    ship).

    ``buckets``: [(orig_nbytes, compressed?, wire_nbytes), ...]."""
    global _last_wire_plan
    reg = registry()
    wire_on = [(n, w) for n, c, w in buckets if c]
    sent = sum(w for _, w in wire_on) + sum(
        n for n, c, _ in buckets if not c)
    saved = sum(n - w for n, w in wire_on)
    reg.gauge(
        "horovod_compiled_wire_bytes_per_step",
        help="gradient bytes per step the latest compiled plan puts on the "
             "wire (after per-bucket compression)").set(sent)
    reg.gauge(
        "horovod_compiled_wire_bytes_saved_per_step",
        help="gradient bytes per step the wire dtype saves vs uncompressed "
             "in the latest compiled plan").set(saved)
    reg.gauge(
        "horovod_compiled_wire_buckets",
        help="buckets riding the compressed wire in the latest plan"
    ).set(len(wire_on))
    reg.set_info("wire_compression", {
        "compression": compression, "buckets": len(buckets),
        "compressed_buckets": len(wire_on)})
    _last_wire_plan = (compression, list(buckets))
    return buckets


def last_wire_plan() -> Optional[tuple]:
    """(compression, [(orig_nbytes, compressed?, wire_nbytes), ...]) of the
    most recent fused_allreduce trace."""
    return _last_wire_plan


# Latest fabric-tier plan of the hierarchical compiled path:
# {"hierarchical": bool, "ici_wire": str, "dcn_wire": str, "ici_size": int,
#  "bytes_per_step": {"ici": n, "dcn": n}, "buckets": int}.
_last_tier_plan: Optional[dict] = None


def record_tier_plan(hierarchical: bool, ici_wire: str, dcn_wire: str,
                     ici_size: int, bucket_bytes: list,
                     dcn_bucket_bytes: list) -> dict:
    """Record the latest fused_allreduce call's per-fabric-tier plan
    (trace time, once per compile — same reasoning as record_wire_plan).

    ``bucket_bytes``: per-bucket bytes each device moves over ICI (the
    reduce-scatter/all-gather stages, at the ICI wire dtype);
    ``dcn_bucket_bytes``: per-bucket bytes each device moves over DCN (the
    cross-host psum carries 1/ici_size of the bucket, at the DCN wire
    dtype). For a flat plan the DCN list is empty and ``hierarchical`` is
    False — the gauges always say which ladder the trace compiled."""
    global _last_tier_plan
    reg = registry()
    plan = {"hierarchical": bool(hierarchical), "ici_wire": ici_wire,
            "dcn_wire": dcn_wire, "ici_size": int(ici_size),
            "buckets": len(bucket_bytes),
            "bytes_per_step": {"ici": int(sum(bucket_bytes)),
                               "dcn": int(sum(dcn_bucket_bytes))}}
    reg.gauge(
        "horovod_compiled_hierarchical",
        help="1 when the latest compiled plan rides the two-level "
             "(ici, dcn) ladder, 0 for the flat allreduce").set(
        1.0 if hierarchical else 0.0)
    for tier, total in plan["bytes_per_step"].items():
        reg.gauge(
            "horovod_compiled_tier_bytes_per_step",
            help="gradient bytes per step per device the latest compiled "
                 "plan moves over each fabric tier", tier=tier).set(total)
    reg.set_info("compiled_tier_plan", plan)
    _last_tier_plan = plan
    return plan


def last_tier_plan() -> Optional[dict]:
    """The most recent fused_allreduce trace's fabric-tier plan."""
    return _last_tier_plan


# Latest sharded (ZeRO) plan of the compiled path:
# {"batch": int, "shard": int, "model": int, "buckets": int,
#  "scatter_bytes": [...], "gather_bytes": [...],
#  "bytes_per_step": {"scatter": n, "gather": n}}.
_last_shard_plan: Optional[dict] = None


def record_shard_plan(batch_size: int, shard_size: int,
                      scatter_bytes: list, gather_bytes: list,
                      model_size: int = 1) -> dict:
    """Record the latest sharded gradient exchange's plan (trace time, once
    per compile — same reasoning as record_wire_plan).

    ``scatter_bytes``: per-bucket bytes of the reduce-scatter operand (at
    the wire dtype — what each bucket's collective moves);
    ``gather_bytes``: per-bucket bytes of the parameter-refresh allgather
    (at the storage dtype). On a degenerate shard=1 mesh the gauges still
    record (scatter == the DP allreduce operand, gather == 0 collectives
    but the refresh bytes are reported for comparability).

    ``model_size`` is the third ('model') mesh axis: the byte
    lists are one model rank's exchange over its local slice tree, and
    the gauge is how the controller and dashboards see which 3-D shape
    the step compiled (1 = the 2-D plan)."""
    global _last_shard_plan
    reg = registry()
    plan = {"batch": int(batch_size), "shard": int(shard_size),
            "model": int(model_size),
            "buckets": len(scatter_bytes),
            "scatter_bytes": [int(n) for n in scatter_bytes],
            "gather_bytes": [int(n) for n in gather_bytes],
            "bytes_per_step": {"scatter": int(sum(scatter_bytes)),
                               "gather": int(sum(gather_bytes))}}
    for axis, size in (("batch", batch_size), ("shard", shard_size),
                       ("model", model_size)):
        reg.gauge(
            "horovod_compiled_shard_plan",
            help="axis sizes of the latest compiled sharded "
                 "(reduce-scatter/allgather) plan's "
                 "('batch','shard','model') mesh (model=1 = the 2-D plan)",
            axis=axis).set(int(size))
    for stage, total in plan["bytes_per_step"].items():
        reg.gauge(
            "horovod_compiled_shard_bytes_per_step",
            help="gradient-exchange bytes per step per device the latest "
                 "compiled sharded plan moves in each stage (scatter = "
                 "reduce-scatter operand at wire dtype, gather = parameter "
                 "refresh at storage dtype)", stage=stage).set(total)
    reg.set_info("compiled_shard_plan", plan)
    _last_shard_plan = plan
    return plan


def last_shard_plan() -> Optional[dict]:
    """The most recent sharded gradient exchange's plan."""
    return _last_shard_plan


def record_sharded_state_bytes(total_bytes: int, shard_size: int,
                               model_size: int = 1) -> float:
    """Publish the per-rank parameter+optimizer-state footprint of a sharded
    training state (~shard-fold smaller than DP's
    fully-replicated state). ``total_bytes`` is the global state
    size; each rank persists 1/(shard_size*model_size) of it — the model
    axis slices the state again on top of the ZeRO partition."""
    per_rank = total_bytes / max(1, shard_size * model_size)
    registry().gauge(
        "horovod_sharded_state_bytes_per_rank",
        help="bytes of parameters + optimizer state each rank persists "
             "under the current sharded (ZeRO) layout; equals the full "
             "state size when shard=1 (plain DP)").set(per_rank)
    return per_rank
