"""Trace collector: merge per-rank span logs into ONE Perfetto-loadable
Chrome trace, clock-aligned to the coordinator (rank 0). The port's own
copy of ``horovod_tpu.tracing.collector``.

Input: a trace directory of ``spans-rank<k>.jsonl`` files (recorder.py) —
on a single host every rank writes into the same directory; on a multi-host
pod, copy each host's files into one place first (docs/tracing.md). Each
file's meta line carries that rank's clock offset to the coordinator
(clock.py), so ``aligned = local + offset`` puts every span on one axis.

Output (strict JSON, the Chrome trace-event format Perfetto and
chrome://tracing both load): one *process* per rank, one *thread lane* per
phase, complete ("X") events for spans and instant ("i") events for points,
all timestamps in microseconds from the earliest span. Every event's args
carry the trace ID, so searching one ID in the UI lights up the same
allreduce's lifecycle on every rank — the pod-wide view the per-rank
timeline (utils/timeline.py) cannot give.

CLI:  python -m horovod_tpu_torch.tracing.collector <trace_dir> [-o trace.json]
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

# Stable lane ids per phase so every rank's track layout matches. Lanes
# 0-5 are the training planes' collective lifecycle; 6-12 are the serving
# plane's request lifecycle (tracing/serve.py), so a mixed training +
# serving capture lays out identically on every process row.
_PHASE_LANES = {"enqueue": 0, "negotiate": 1, "cache_tick": 1, "wire": 2,
                "wire_send": 2, "wire_recv": 3, "reduce": 4, "done": 5,
                "admit": 6, "queue": 7, "prefill": 8, "handoff": 9,
                "decode": 10, "infer": 10, "retire": 11, "preempt": 12,
                "kv_pressure": 12, "stall": 12, "anomaly": 12, "flight": 12}
_LANE_NAMES = {0: "enqueue", 1: "negotiate", 2: "wire send", 3: "wire recv",
               4: "reduce", 5: "done", 6: "admit", 7: "queue", 8: "prefill",
               9: "handoff", 10: "decode", 11: "retire", 12: "events"}
_TRAIN_LANES = (0, 1, 2, 3, 4, 5)


def span_files(trace_dir: str) -> list:
    """Sorted ``spans-*.jsonl`` paths in a trace directory — one
    enumeration shared by the local collector and the telemetry-tree
    leaders' ``sweep`` endpoint (telemetry/agent.py), so a bundle built
    through leaders sees the same file set a local merge would."""
    return sorted(glob.glob(os.path.join(trace_dir, "spans-*.jsonl")))


def load_spans(trace_dir: str) -> tuple[list[dict], dict]:
    """Read every span file — training ranks (``spans-rank<k>.jsonl``) AND
    serving processes (``spans-<proc>.jsonl``, tracing/serve.py) — apply
    each file's meta clock offset, and return (spans, metas). Rank files
    key their meta by int rank; serving files by their proc string. Span
    ``t0``/``t1`` are ALIGNED ns after this. Unparseable lines are skipped
    (a crashed rank or a SIGKILL'd replica may leave a torn tail); a
    missing meta line degrades to offset 0 rather than dropping the file.
    """
    spans: list[dict] = []
    metas: dict = {}
    for path in span_files(trace_dir):
        offset = 0
        proc = None
        pending: list[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("meta"):
                    # last meta wins (the offset estimate lands after the
                    # recorder opens, re-announced as a later meta line)
                    offset = int(rec.get("clock_offset_ns", 0))
                    proc = rec.get("proc") or proc
                    metas[proc if proc else int(rec["rank"])] = rec
                    continue
                pending.append(rec)
        for rec in pending:
            rec["t0"] = int(rec.get("t0", 0)) + offset
            rec["t1"] = int(rec.get("t1", rec.get("t0", 0))) + offset
            if proc and "proc" not in rec:
                rec["proc"] = proc
            spans.append(rec)
    return spans, metas


def build_trace(spans: list[dict], metas: Optional[dict] = None) -> dict:
    """Chrome trace-event JSON object from ALIGNED spans. Training ranks
    keep their rank number as the Perfetto pid; serving processes (spans
    carrying a ``proc`` label) get deterministic pids above the highest
    rank, one process row per proc — "process per replica, lane per
    phase", mirroring the per-rank layout of the training planes."""
    events: list[dict] = []
    ranks = sorted({int(s.get("rank", 0)) for s in spans
                    if "proc" not in s})
    procs = sorted({str(s["proc"]) for s in spans if "proc" in s})
    proc_base = (max(ranks) + 1) if ranks else 0
    proc_pid = {p: proc_base + i for i, p in enumerate(procs)}
    lanes_used: dict[int, set] = {}
    for s in spans:
        pid = proc_pid[str(s["proc"])] if "proc" in s \
            else int(s.get("rank", 0))
        lanes_used.setdefault(pid, set()).add(
            _PHASE_LANES.get(str(s.get("phase", "?")), 1))
    for r in ranks:
        events.append({"name": "process_name", "ph": "M", "pid": r, "tid": 0,
                       "args": {"name": f"rank {r}"}})
        for lane in sorted(set(_TRAIN_LANES) | lanes_used.get(r, set())):
            events.append({"name": "thread_name", "ph": "M", "pid": r,
                           "tid": lane, "args": {"name": _LANE_NAMES[lane]}})
    for p in procs:
        pid = proc_pid[p]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": p}})
        for lane in sorted(lanes_used.get(pid, set())):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": lane, "args": {"name": _LANE_NAMES[lane]}})
    t_base = min((s["t0"] for s in spans), default=0)
    for s in spans:
        phase = str(s.get("phase", "?"))
        lane = _PHASE_LANES.get(phase, 1)
        ts_us = (s["t0"] - t_base) / 1000.0
        dur_us = max(0.0, (s["t1"] - s["t0"]) / 1000.0)
        args = {k: v for k, v in s.items()
                if k not in ("t0", "t1", "rank", "phase")}
        pid = proc_pid[str(s["proc"])] if "proc" in s \
            else int(s.get("rank", 0))
        ev = {"name": f"{phase} {s.get('name', '')}".strip(), "cat": phase,
              "pid": pid, "tid": lane,
              "ts": round(ts_us, 3), "args": args}
        if s["t1"] > s["t0"]:
            ev["ph"] = "X"
            ev["dur"] = round(dur_us, 3)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if metas:
        out["metadata"] = {
            "ranks": sorted(k for k in metas if isinstance(k, int)),
            "procs": sorted(str(k) for k in metas
                            if not isinstance(k, int)),
            "clock_offsets_ns": {str(r): m.get("clock_offset_ns", 0)
                                 for r, m in sorted(metas.items(),
                                                    key=lambda kv:
                                                    str(kv[0]))},
        }
    return out


def merge_trace(trace_dir: str, out_path: Optional[str] = None) -> dict:
    """Merge a trace directory into one Chrome trace; write it to
    ``out_path`` (default ``<trace_dir>/trace.json``) and return it."""
    spans, metas = load_spans(trace_dir)
    trace = build_trace(spans, metas)
    path = out_path or os.path.join(trace_dir, "trace.json")
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Merge per-rank span logs into one Perfetto trace")
    ap.add_argument("trace_dir")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default <trace_dir>/trace.json)")
    ap.add_argument("--critical-path", action="store_true",
                    help="also print the critical-path attribution summary")
    args = ap.parse_args(argv)
    spans, metas = load_spans(args.trace_dir)
    if not spans:
        print(f"no spans under {args.trace_dir}")
        return 1
    trace = build_trace(spans, metas)
    path = args.out or os.path.join(args.trace_dir, "trace.json")
    with open(path, "w") as f:
        json.dump(trace, f)
    print(f"merged {len(spans)} spans from {len(metas)} ranks -> {path}")
    if args.critical_path:
        from .critical_path import analyze, format_summary

        print(format_summary(analyze(spans)))
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    raise SystemExit(main())
