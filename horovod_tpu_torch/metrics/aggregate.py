"""Pod-wide aggregation of per-rank metrics snapshots: the port's own copy
of ``horovod_tpu.metrics.aggregate``.

A snapshot (registry.MetricsRegistry.snapshot) is process-local. The pod
view merges one snapshot per rank, gathered with ``allgather_object``
(``callbacks.MetricsCallback``). Merge rules:

- counters: summed (they are per-rank totals; the pod total is the sum);
- gauges: min / max / mean across ranks (a pod has no single "the" value —
  the spread IS the signal: a straggler shows up as max >> min);
- histograms: bucket-wise sum (boundaries are identical by construction —
  every rank runs the same build), percentiles re-estimated on the merged
  distribution;
- info: kept per rank (``stall_report`` from rank 0 names missing ranks).

The merge is a monoid: ``lift_snapshot`` turns one rank's snapshot into a
*partial*, ``combine_partials`` is associative, and ``finalize_partial``
renders the pod view. ``merge_snapshots`` is finalize∘reduce(combine)∘lift,
so a host-level merge followed by a root-level merge of the host partials
is bitwise-identical to the flat merge of every rank, so a tree of merges
keeps the root's ingest O(hosts). Associativity of the float sums is real,
not approximate: sums are carried as exact rationals (every float is a
dyadic rational, so the exact sum is grouping-independent) and rounded to
float once, at finalize.

Deltas: ``snapshot_delta``/``apply_snapshot_delta`` give the wire form for
rank→leader pushes — only series whose value changed since the last acked
snapshot travel, and applying the delta reconstructs the full snapshot
exactly (per-series values are replaced wholesale, never patched).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional, Sequence

PARTIAL_SCHEMA = "horovod_tpu.metrics.partial.v1"
POD_SCHEMA = "horovod_tpu.metrics.pod.v1"
DELTA_SCHEMA = "horovod_tpu.metrics.delta.v1"

_TABLES = ("counters", "gauges", "histograms", "info")


def _to_frac(v) -> Fraction:
    # Non-finite values would poison every pod-level sum they touch (and
    # have no exact rational form); drop them from the sum.
    try:
        f = float(v)
    except (TypeError, ValueError):
        return Fraction(0)
    if not math.isfinite(f):
        return Fraction(0)
    return Fraction(f)


def _frac_pair(fr: Fraction) -> list:
    return [fr.numerator, fr.denominator]


def _pair_frac(pair) -> Fraction:
    return Fraction(int(pair[0]), int(pair[1]))


def _percentile_from_cum(buckets: list, count: int, p: float) -> float:
    if count == 0:
        return 0.0
    target = count * p / 100.0
    prev = 0.0
    for le, cum in buckets:
        if le == "+Inf":
            return float(prev)
        if cum >= target:
            return float(le)
        prev = le
    return float(prev)


def _lift_histogram(h: dict) -> dict:
    cums: dict = {}
    order: list = []
    for le, cum in h.get("buckets", []):
        key = str(le)
        if key not in cums:
            cums[key] = 0
            order.append([le, key])
        cums[key] += int(cum)
    return {
        "count": int(h.get("count", 0)),
        "sum": _frac_pair(_to_frac(h.get("sum", 0.0))),
        "cums": cums,
        "order": order,
    }


def lift_snapshot(rank: int, snap: Optional[dict]) -> dict:
    """Turn one rank's snapshot into a partial (the monoid element).

    ``snap`` may be None — a rank slot that reported nothing still counts
    toward ``ranks`` so ``ranks_reporting`` keeps its meaning.
    """
    out = {
        "schema": PARTIAL_SCHEMA,
        "ranks": 1,
        "ranks_reporting": 0,
        "rank_ids": [],
        "time_unix_s": 0.0,
        "counters": {},
        "gauges": {},
        "histograms": {},
        "info": {},
    }
    if not snap:
        return out
    out["ranks_reporting"] = 1
    out["rank_ids"] = [int(rank)]
    out["time_unix_s"] = float(snap.get("time_unix_s", 0.0))
    for name, v in snap.get("counters", {}).items():
        out["counters"][name] = _frac_pair(_to_frac(v))
    for name, v in snap.get("gauges", {}).items():
        f = float(v)
        out["gauges"][name] = {
            "min": f, "max": f, "sum": _frac_pair(_to_frac(v)), "n": 1,
        }
    for name, h in snap.get("histograms", {}).items():
        out["histograms"][name] = _lift_histogram(h or {})
    info = snap.get("info") or {}
    if info:
        out["info"][str(rank)] = info
    return out


def empty_partial() -> dict:
    return {
        "schema": PARTIAL_SCHEMA,
        "ranks": 0,
        "ranks_reporting": 0,
        "rank_ids": [],
        "time_unix_s": 0.0,
        "counters": {},
        "gauges": {},
        "histograms": {},
        "info": {},
    }


def combine_partials(a: dict, b: dict) -> dict:
    """Associative combine of two partials. Order of arguments follows rank
    order (bucket first-seen order and rank-keyed info are order-sensitive
    but grouping-insensitive — ordered concat-dedup is associative)."""
    out = empty_partial()
    out["ranks"] = int(a.get("ranks", 0)) + int(b.get("ranks", 0))
    out["ranks_reporting"] = (int(a.get("ranks_reporting", 0))
                              + int(b.get("ranks_reporting", 0)))
    out["rank_ids"] = list(a.get("rank_ids", [])) + list(b.get("rank_ids", []))
    out["time_unix_s"] = max(float(a.get("time_unix_s", 0.0)),
                             float(b.get("time_unix_s", 0.0)))
    for side in (a, b):
        for name, pair in side.get("counters", {}).items():
            if name in out["counters"]:
                fr = _pair_frac(out["counters"][name]) + _pair_frac(pair)
                out["counters"][name] = _frac_pair(fr)
            else:
                out["counters"][name] = list(pair)
        for name, g in side.get("gauges", {}).items():
            cur = out["gauges"].get(name)
            if cur is None:
                out["gauges"][name] = {"min": g["min"], "max": g["max"],
                                       "sum": list(g["sum"]),
                                       "n": int(g["n"])}
            else:
                cur["min"] = min(cur["min"], g["min"])
                cur["max"] = max(cur["max"], g["max"])
                cur["sum"] = _frac_pair(
                    _pair_frac(cur["sum"]) + _pair_frac(g["sum"]))
                cur["n"] = int(cur["n"]) + int(g["n"])
        for name, h in side.get("histograms", {}).items():
            cur = out["histograms"].get(name)
            if cur is None:
                out["histograms"][name] = {
                    "count": int(h["count"]),
                    "sum": list(h["sum"]),
                    "cums": dict(h["cums"]),
                    "order": [list(e) for e in h["order"]],
                }
            else:
                cur["count"] = int(cur["count"]) + int(h["count"])
                cur["sum"] = _frac_pair(
                    _pair_frac(cur["sum"]) + _pair_frac(h["sum"]))
                for le, key in h["order"]:
                    if key not in cur["cums"]:
                        cur["cums"][key] = 0
                        cur["order"].append([le, key])
                    cur["cums"][key] += int(h["cums"][key])
        for rank_key, info in side.get("info", {}).items():
            out["info"][rank_key] = info
    return out


def merge_partials(parts: Sequence[dict]) -> dict:
    acc = empty_partial()
    for p in parts:
        acc = combine_partials(acc, p)
    return acc


def finalize_partial(part: dict) -> dict:
    """Render a partial as the pod view (schema pod.v1) — the single point
    where exact rational sums are rounded to float."""
    out = {
        "schema": POD_SCHEMA,
        "ranks": int(part.get("ranks", 0)),
        "ranks_reporting": int(part.get("ranks_reporting", 0)),
        "time_unix_s": float(part.get("time_unix_s", 0.0)),
        "counters": {},
        "gauges": {},
        "histograms": {},
        "info": {},
    }
    for name in sorted(part.get("counters", {})):
        out["counters"][name] = float(_pair_frac(part["counters"][name]))
    for name in sorted(part.get("gauges", {})):
        g = part["gauges"][name]
        n = max(1, int(g.get("n", 1)))
        out["gauges"][name] = {
            "min": float(g["min"]), "max": float(g["max"]),
            "mean": float(_pair_frac(g["sum"]) / n),
        }
    for name in sorted(part.get("histograms", {})):
        h = part["histograms"][name]
        count = int(h.get("count", 0))
        buckets = [[le, int(h["cums"][key])] for le, key in h.get("order", [])]
        merged = {"count": count, "sum": float(_pair_frac(h["sum"])),
                  "buckets": buckets}
        for p, key in ((50, "p50"), (90, "p90"), (99, "p99")):
            merged[key] = _percentile_from_cum(buckets, count, p)
        out["histograms"][name] = merged
    # Rank-keyed info, in rank order (flat merge iterated ranks in order).
    for rank_key in sorted(part.get("info", {}), key=lambda k: (len(k), k)):
        out["info"][rank_key] = part["info"][rank_key]
    return out


def merge_snapshots(snaps: Sequence[Optional[dict]]) -> dict:
    """Merge per-rank snapshots (index = rank; None entries are ranks that
    reported nothing) into one pod-wide view."""
    return finalize_partial(merge_partials(
        [lift_snapshot(r, s) for r, s in enumerate(snaps)]))


def snapshot_delta(prev: Optional[dict], cur: dict) -> dict:
    """Wire delta from ``prev`` (the last snapshot the receiver acked; None
    means "send everything") to ``cur``. Series travel wholesale when their
    value changed; unchanged series are omitted; series that vanished are
    listed under ``removed``."""
    prev = prev or {}
    delta: dict = {"schema": DELTA_SCHEMA, "top": {}, "removed": {}}
    for k, v in cur.items():
        if k in _TABLES:
            continue
        if prev.get(k) != v:
            delta["top"][k] = v
    for table in _TABLES:
        pt = prev.get(table, {}) or {}
        ct = cur.get(table, {}) or {}
        changed = {n: v for n, v in ct.items() if pt.get(n) != v}
        removed = [n for n in pt if n not in ct]
        if changed:
            delta[table] = changed
        if removed:
            delta["removed"][table] = removed
    return delta


def apply_snapshot_delta(prev: Optional[dict], delta: dict) -> dict:
    """Reconstruct the full snapshot: ``apply(prev, delta(prev, cur)) == cur``
    exactly, for any prev/cur pair."""
    out: dict = {}
    for k, v in (prev or {}).items():
        out[k] = dict(v) if k in _TABLES else v
    out.update(delta.get("top", {}))
    for table in _TABLES:
        if table in delta:
            out.setdefault(table, {})
            out[table].update(delta[table])
        for name in delta.get("removed", {}).get(table, []):
            out.get(table, {}).pop(name, None)
    return out
