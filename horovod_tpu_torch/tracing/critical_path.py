"""Critical-path analyzer: turn merged spans into straggler attribution.
The port's own copy of ``horovod_tpu.tracing.critical_path``. The port has
no negotiation, so its spans carry only ``enqueue``, ``wire`` and ``done``
phases and ``negotiation`` and ``cache`` stay 0.

The stall watchdog (metrics/watchdog.py) can say a collective is waiting
and WHICH ranks are missing; this module says WHY — it walks every traced
collective's clock-aligned spans and splits the blocked time into the
phases that compose an eager collective's lifecycle:

- ``compute_skew`` — the spread between the first and last rank's enqueue.
  The collective cannot start before the last enqueue, so this whole window
  is attributed to the LAST-arriving rank (the straggler): it is time every
  other rank spent waiting on that rank's compute.
- ``negotiation`` — coordinator round-trips carrying full request lists.
- ``cache`` — negotiation ticks that rode the response-cache bitvector
  (steady state; large values here mean re-poll churn, not cache cost).
- ``wire`` — ring/star hop time (wire_send / wire_recv spans).
- ``reduce`` — local reduction arithmetic (ring partial adds, or the
  coordinator's star-plane reduction).

Per phase the critical value is the MAX over ranks (the slowest rank gates
the collective), summed over collectives. The per-rank skew attribution is
what the smoke test asserts on: an injected sleep on rank k must land >=80%
of its duration in ``skew_seconds_by_rank[k]``.

Results feed three consumers: ``horovod_critical_path_seconds{phase=...}``
/ ``horovod_straggler_*`` gauges in the metrics registry, the stall
watchdog's report (which attaches the latest attribution), and the
``collector.py --critical-path`` CLI summary.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

PHASES = ("compute_skew", "negotiation", "cache", "wire", "reduce")

_WIRE_PHASES = ("wire", "wire_send", "wire_recv")


def _category(span: dict) -> Optional[str]:
    phase = span.get("phase")
    if phase in _WIRE_PHASES:
        return "wire"
    if phase == "reduce":
        return "reduce"
    if phase in ("negotiate", "cache_tick"):
        return "cache" if span.get("cached") or phase == "cache_tick" \
            else "negotiation"
    return None


def analyze(spans: list[dict]) -> dict:
    """Attribute blocked time across clock-ALIGNED spans (collector.py
    load_spans output). Returns a JSON-able report; collectives seen by
    fewer than two ranks contribute phase times but no skew."""
    by_tid: dict[str, list[dict]] = defaultdict(list)
    for s in spans:
        if s.get("tid"):
            by_tid[s["tid"]].append(s)

    phase_ns = dict.fromkeys(PHASES, 0)
    wire_tier_ns: dict[str, int] = defaultdict(int)
    skew_by_rank: dict[int, int] = defaultdict(int)
    wait_by_rank: dict[int, int] = defaultdict(int)
    per_tid: dict[str, dict] = {}
    n_multi = 0
    for tid, tspans in by_tid.items():
        enq: dict[int, int] = {}
        done: dict[int, int] = {}
        cat_spans: dict[str, dict[int, list]] = {
            c: defaultdict(list) for c in PHASES}
        for s in tspans:
            r = int(s.get("rank", 0))
            if s.get("phase") == "enqueue":
                # first enqueue point wins (re-announcements are possible)
                enq[r] = min(enq.get(r, s["t0"]), s["t0"])
                continue
            if s.get("phase") == "done":
                done[r] = max(done.get(r, s["t1"]), s["t1"])
                continue
            cat = _category(s)
            if cat:
                cat_spans[cat][r].append((s["t0"], s["t1"]))
        # Fabric-tier split of wire time: tier-tagged wire spans
        # (local = same host, cross = the host boundary) accumulate
        # separately so the report can say WHICH fabric is slow.
        tier_spans: dict[str, dict[int, list]] = defaultdict(
            lambda: defaultdict(list))
        for s in tspans:
            if _category(s) == "wire" and s.get("tier"):
                tier_spans[str(s["tier"])][int(s.get("rank", 0))].append(
                    (s["t0"], s["t1"]))
        entry: dict = {"ranks": sorted(set(enq) | set(done))}
        gate = None
        if len(enq) >= 2:
            n_multi += 1
            gate = max(enq.values())
            first = min(enq.values())
            straggler = max(enq, key=lambda r: (enq[r], r))
            skew = gate - first
            phase_ns["compute_skew"] += skew
            skew_by_rank[straggler] += skew
            for r, t in enq.items():
                wait_by_rank[r] += gate - t
            entry.update({"straggler_rank": straggler,
                          "skew_s": skew / 1e9})
        # Negotiation/cache spans are CLIPPED to the post-gate window: a
        # punctual rank's exchange blocks until the straggler's enqueue
        # arrives, so the pre-gate part of its negotiate span IS the skew
        # already attributed above — counting it twice would dilute the
        # straggler verdict. Wire/reduce start after readiness by
        # construction and stay unclipped.
        cat_ns: dict[str, dict[int, int]] = {}
        for cat, by_rank in cat_spans.items():
            clip = gate if (gate is not None
                            and cat in ("negotiation", "cache")) else None
            cat_ns[cat] = {
                r: sum(max(0, t1 - (max(t0, clip) if clip is not None
                                    else t0))
                       for t0, t1 in iv)
                for r, iv in by_rank.items()}
        for cat in ("negotiation", "cache", "wire", "reduce"):
            if cat_ns.get(cat):
                crit = max(cat_ns[cat].values())
                phase_ns[cat] += crit
                entry[f"{cat}_s"] = crit / 1e9
        for tier, by_rank in tier_spans.items():
            crit = max(sum(t1 - t0 for t0, t1 in iv)
                       for iv in by_rank.values())
            wire_tier_ns[tier] += crit
            entry[f"wire_{tier}_s"] = crit / 1e9
        if enq and done:
            entry["total_s"] = (max(done.values()) - min(enq.values())) / 1e9
        per_tid[tid] = entry

    total_ns = sum(phase_ns.values())
    dominant = max(PHASES, key=lambda p: phase_ns[p]) if total_ns else None
    straggler_rank = (max(skew_by_rank, key=lambda r: (skew_by_rank[r], -r))
                      if skew_by_rank else None)
    report = {
        "collectives": len(by_tid),
        "multi_rank_collectives": n_multi,
        "phase_seconds": {p: phase_ns[p] / 1e9 for p in PHASES},
        # Which fabric the wire time went to (tier-tagged spans only; the
        # spans without a tier tag are not in it, so this may
        # cover less than phase_seconds["wire"]).
        "wire_seconds_by_tier": {t: v / 1e9
                                 for t, v in sorted(wire_tier_ns.items())},
        "dominant_phase": dominant,
        "skew_seconds_by_rank": {int(r): v / 1e9
                                 for r, v in sorted(skew_by_rank.items())},
        "wait_seconds_by_rank": {int(r): v / 1e9
                                 for r, v in sorted(wait_by_rank.items())},
        "per_collective": per_tid,
    }
    if straggler_rank is not None and total_ns:
        # The straggler's phase: where did ITS gating time go? When the skew
        # it caused dominates the pod's blocked time the answer is compute
        # skew on that rank; otherwise name the pod-dominant phase.
        s_ns = skew_by_rank[straggler_rank]
        report["straggler"] = {
            "rank": int(straggler_rank),
            "seconds": s_ns / 1e9,
            "phase": ("compute_skew"
                      if s_ns >= phase_ns[dominant] or dominant is None
                      else dominant),
            "share_of_blocked": s_ns / total_ns,
        }
        if report["straggler"]["phase"] == "wire" and wire_tier_ns:
            # Name WHICH fabric is slow: the intra-host plane or the
            # cross-host boundary (docs/troubleshooting.md "my cross-pod
            # allreduce is slow").
            report["straggler"]["fabric"] = max(
                wire_tier_ns, key=lambda t: (wire_tier_ns[t], t))
    else:
        report["straggler"] = None
    return report


def export_gauges(report: dict, reg=None) -> None:
    """Publish the attribution into the metrics registry :
    ``horovod_critical_path_seconds{phase=...}`` per phase plus the
    straggler verdict gauges, and the info blob the stall watchdog attaches
    to its report (docs/troubleshooting.md)."""
    if reg is None:
        from ..metrics import registry

        reg = registry()
    for phase, secs in report.get("phase_seconds", {}).items():
        reg.gauge("horovod_critical_path_seconds",
                  help="blocked seconds attributed to each collective "
                       "lifecycle phase (tracing/critical_path.py)",
                  phase=phase).set(secs)
    for tier, secs in report.get("wire_seconds_by_tier", {}).items():
        reg.gauge("horovod_critical_path_wire_seconds",
                  help="wire-phase blocked seconds split by fabric tier "
                       "(local = intra-host, cross = host boundary)",
                  tier=tier).set(secs)
    strag = report.get("straggler")
    reg.gauge("horovod_straggler_rank",
              help="rank attributed the most compute skew (-1 = none)"
              ).set(strag["rank"] if strag else -1)
    reg.gauge("horovod_straggler_seconds",
              help="blocked seconds attributed to the straggler rank"
              ).set(strag["seconds"] if strag else 0.0)
    reg.set_info("straggler_attribution", {
        "phase_seconds": report.get("phase_seconds"),
        "dominant_phase": report.get("dominant_phase"),
        "straggler": strag,
        "skew_seconds_by_rank": report.get("skew_seconds_by_rank"),
        "collectives": report.get("collectives"),
    })


def analyze_dir(trace_dir: str, reg=None) -> dict:
    """Convenience: load + analyze a trace directory and export gauges."""
    from .collector import load_spans

    spans, _ = load_spans(trace_dir)
    report = analyze(spans)
    export_gauges(report, reg)
    return report


def format_summary(report: dict) -> str:
    lines = [f"critical path over {report['collectives']} collectives "
             f"({report['multi_rank_collectives']} multi-rank):"]
    for p in PHASES:
        lines.append(f"  {p:<13} {report['phase_seconds'][p] * 1e3:9.2f} ms")
    for tier, secs in report.get("wire_seconds_by_tier", {}).items():
        lines.append(f"    wire[{tier}] {secs * 1e3:9.2f} ms")
    strag = report.get("straggler")
    if strag:
        fabric = f", {strag['fabric']} fabric" if strag.get("fabric") else ""
        lines.append(
            f"  straggler: rank {strag['rank']} ({strag['phase']}{fabric}, "
            f"{strag['seconds'] * 1e3:.2f} ms, "
            f"{strag['share_of_blocked'] * 100:.0f}% of blocked time)")
    else:
        lines.append("  straggler: none detected")
    return "\n".join(lines)
