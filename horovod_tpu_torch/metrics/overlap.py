"""How much of the gradient exchange the backward pass hides.

The counterpart of ``horovod_tpu.metrics.overlap``. The port keeps no
metrics registry, so each function returns its values:

- ``record_plan(plan, threshold)``: a fusion plan's buckets in issue order
  with their bytes (pad included), the largest bucket's occupancy of the
  threshold, and the planned bound on the hidden share of the bytes,
  ``1 - last bucket / total`` for a reverse-order plan of more than one
  bucket (bucket i's collective can run under the compute that produces
  buckets i+1..K-1; nothing runs under the last one), else 0.
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

# The reference's markers of a collective in a device op's name.
_COLLECTIVE_MARKERS = (
    "all-reduce", "all_reduce", "allreduce",
    "all-gather", "all_gather", "allgather",
    "reduce-scatter", "reduce_scatter", "reducescatter",
    "all-to-all", "all_to_all", "alltoall",
    "collective-permute", "collective_permute",
)


def record_plan(plan: FusionPlan, threshold: int) -> dict:
    """``{"buckets": [(issue_index, nbytes), ...], "total_bytes",
    "occupancy", "planned_efficiency"}`` of ``plan``."""
    sizes = []
    for i, bucket in enumerate(plan.buckets):
        elems = sum(d.size for d in bucket)
        sizes.append((i, (elems + -elems % plan.pad_to) * bucket[0].itemsize))
    total = sum(n for _, n in sizes) or 1
    planned = 0.0
    if plan.reverse_order and len(sizes) > 1:
        planned = 1.0 - sizes[-1][1] / total
    return {"buckets": sizes, "total_bytes": total,
            "occupancy": max(n for _, n in sizes) / max(1, threshold),
            "planned_efficiency": planned}


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
