"""One-command debug bundles: ``python -m horovod_tpu_torch.tracing.bundle``.

Sweeps everything the observability layer left behind into ONE directory
a human (or a bug report) can carry:

- every flight-recorder dump (``flight-*.json``) AND every ring file
  (``flight-*.ring``) in ``--flight-dir`` — rings are decoded here, so a
  SIGKILL'd replica's final seconds land in the bundle even though the
  process never got to write a dump;
- the merged clock-aligned Perfetto trace of ``--trace-dir`` (training
  ranks and serving processes in one strict ``trace.json``) plus the
  critical-path attribution report over the training spans;
- any ``--stats`` sources: a running router's ``http://.../stats`` (and
  ``/debug/sequences``) or already-saved snapshot files;
- ``MANIFEST.md`` — the human-readable index: which processes dumped and
  why, which replicas died, which anomalies fired, what is in each file.

The port's own copy of ``horovod_tpu.tracing.bundle``. At pod scale the
interesting flight rings and span files live on OTHER hosts. ``--leader
host:port`` (repeatable) sweeps them through the
telemetry-tree host leaders (telemetry/agent.py ``sweep``): rings are
decoded host-side and streamed back host-by-host, so the bundle machine
opens O(hosts) connections, never O(world). Every leader is accounted for
in the MANIFEST's **Pod coverage** section — a leader that cannot be
reached, a rank that stopped pushing, or a ring that fails to decode is
NAMED (host, reason, what is missing), because a silent gap in a debug
bundle reads as "nothing happened there", which is exactly backwards.

Exit 0 with the bundle path on stdout; 1 when there was nothing at all
to collect. docs/debugging.md walks through reading the result.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
from typing import Optional

from . import flight as _flight

_EVENT_KINDS = ("replica_death", "anomaly", "stall", "plane_demote")


def _flight_row_and_events(name: str, kind: str, doc: dict
                           ) -> tuple[dict, list]:
    row = {"file": f"flight/{name}", "kind": kind,
           "proc": doc.get("proc", "?"),
           "reason": doc.get("reason", "?") if kind == "dump" else "-",
           "records": len(doc.get("records", []))}
    events = [dict(rec, _source=name) for rec in doc.get("records", [])
              if rec.get("flight_event") in _EVENT_KINDS]
    return row, events


def _collect_flight(flight_dir: str, out: str) -> tuple[list, list, list]:
    """Copy dumps + decode rings into ``out``/flight; returns
    (inventory rows, notable events, NAMED decode failures)."""
    rows: list[dict] = []
    events: list[dict] = []
    errors: list[dict] = []
    if not flight_dir or not os.path.isdir(flight_dir):
        return rows, events, errors
    dst = os.path.join(out, "flight")
    os.makedirs(dst, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(flight_dir,
                                              "flight-*.json"))):
        name = os.path.basename(path)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            errors.append({"file": name, "host": "local",
                           "error": str(e)[:200]})
            continue
        shutil.copy(path, os.path.join(dst, name))
        row, evs = _flight_row_and_events(name, "dump", doc)
        rows.append(row)
        events.extend(evs)
    for path in sorted(glob.glob(os.path.join(flight_dir,
                                              "flight-*.ring"))):
        try:
            ring = _flight.read_ring(path)
        except Exception as e:  # torn rings raise struct.error too
            errors.append({"file": os.path.basename(path), "host": "local",
                           "error": str(e)[:200]})
            continue
        name = os.path.basename(path) + ".json"
        with open(os.path.join(dst, name), "w") as f:
            json.dump(ring, f)
        row, evs = _flight_row_and_events(name, "ring", ring)
        rows.append(row)
        events.extend(evs)
    return rows, events, errors


def _leader_key(hex_key: Optional[str]) -> bytes:
    """The sweep credential: ``--leader-key`` hex, else the job secret the
    ranks already hold (HOROVOD_SECRET / HOROVOD_AGENT_SECRET)."""
    raw = hex_key or os.environ.get("HOROVOD_SECRET") \
        or os.environ.get("HOROVOD_AGENT_SECRET")
    if not raw:
        raise SystemExit(
            "bundle --leader needs the telemetry secret: pass --leader-key "
            "or set HOROVOD_SECRET (hex)")
    return bytes.fromhex(raw)


def _judge_coverage(host: str, cov: dict) -> dict:
    """Turn one leader's per-rank coverage into a named verdict row.
    A rank is STALE past TELEMETRY_LAG_TICKS collection intervals — the
    same threshold the ``telemetry_lag`` anomaly fires on."""
    from ..metrics.anomaly import TELEMETRY_LAG_TICKS

    interval = float(cov.get("interval_s") or 1.0)
    expected = [int(r) for r in cov.get("expected") or []]
    ranks = cov.get("ranks") or {}
    missing = [r for r in expected if str(r) not in ranks]
    stale = [int(r) for r, st in ranks.items()
             if float(st.get("age_s", 0.0))
             > TELEMETRY_LAG_TICKS * interval]
    if missing or stale:
        why = []
        if missing:
            why.append(f"ranks {missing} never pushed")
        if stale:
            why.append(f"ranks {sorted(stale)} stale "
                       f">{TELEMETRY_LAG_TICKS} intervals")
        status, reason = "partial", "; ".join(why)
    else:
        status, reason = "ok", "-"
    return {"host": host, "status": status, "reason": reason,
            "expected": len(expected), "reporting": len(ranks),
            "missing": missing, "stale": sorted(stale)}


def _collect_leaders(leaders: list, key: bytes, out: str
                     ) -> tuple[list, list, list, list, Optional[str]]:
    """Sweep every telemetry-tree leader; returns (coverage rows,
    flight rows, flight decode failures, events, staged spans dir)."""
    from ..runner.network import BasicClient

    coverage: list[dict] = []
    rows: list[dict] = []
    errors: list[dict] = []
    events: list[dict] = []
    spans_dir: Optional[str] = None
    dst = os.path.join(out, "flight")
    for addr in leaders:
        host_part, _, port_part = addr.rpartition(":")
        try:
            client = BasicClient([(host_part or "127.0.0.1",
                                   int(port_part))], key,
                                 timeout=60.0, connect_retry_s=5.0)
        except (OSError, ValueError) as e:
            coverage.append({"host": addr, "status": "unreachable",
                             "reason": str(e)[:200], "expected": 0,
                             "reporting": 0, "missing": [], "stale": []})
            continue
        try:
            resp = client.request({"kind": "sweep",
                                   "want": ["flight", "spans"]})
        except Exception as e:  # noqa: BLE001 - a dead leader is the finding
            coverage.append({"host": addr, "status": "unreachable",
                             "reason": str(e)[:200], "expected": 0,
                             "reporting": 0, "missing": [], "stale": []})
            continue
        finally:
            try:
                client.close()
            except Exception:
                pass
        host = str(resp.get("host", addr))
        coverage.append(_judge_coverage(host, resp.get("coverage") or {}))
        for item in resp.get("flight") or []:
            os.makedirs(dst, exist_ok=True)
            name = f"{host}-{item['name']}"
            with open(os.path.join(dst, name), "w") as f:
                json.dump(item["doc"], f)
            row, evs = _flight_row_and_events(name, item.get("kind", "?"),
                                              item["doc"])
            rows.append(row)
            events.extend(evs)
        for err in resp.get("flight_errors") or []:
            errors.append(dict(err, host=host))
        for item in resp.get("spans") or []:
            if spans_dir is None:
                spans_dir = os.path.join(out, "spans")
                os.makedirs(spans_dir, exist_ok=True)
            name = item["name"]
            if os.path.exists(os.path.join(spans_dir, name)):
                # same rank file swept from two leaders (shared FS): the
                # copies are identical, keep the first
                continue
            with open(os.path.join(spans_dir, name), "w") as f:
                f.write(item["text"])
    return coverage, rows, errors, events, spans_dir


def _collect_trace(trace_dir: str, out: str) -> tuple[Optional[dict],
                                                      Optional[str]]:
    """Merge span files into ``out``/trace.json; returns (critical-path
    report over the training spans, trace path)."""
    if not trace_dir or not glob.glob(os.path.join(trace_dir,
                                                   "spans-*.jsonl")):
        return None, None
    from .collector import build_trace, load_spans
    from .critical_path import analyze, format_summary

    spans, metas = load_spans(trace_dir)
    if not spans:
        return None, None
    trace = build_trace(spans, metas)
    trace_path = os.path.join(out, "trace.json")
    with open(trace_path, "w") as f:
        json.dump(trace, f)
    train_spans = [s for s in spans if "proc" not in s]
    report = analyze(train_spans) if train_spans else None
    if report:
        with open(os.path.join(out, "critical_path.json"), "w") as f:
            json.dump(report, f, indent=1)
        with open(os.path.join(out, "critical_path.txt"), "w") as f:
            f.write(format_summary(report) + "\n")
    return report, trace_path


def _collect_stats(sources: list, out: str) -> list:
    rows = []
    for i, src in enumerate(sources):
        name = f"stats-{i}.json"
        try:
            if src.startswith("http://") or src.startswith("https://"):
                import urllib.request

                with urllib.request.urlopen(src, timeout=10) as r:
                    data = r.read()
                with open(os.path.join(out, name), "wb") as f:
                    f.write(data)
            else:
                shutil.copy(src, os.path.join(out, name))
        except Exception as e:  # noqa: BLE001 - a dead router is expected
            rows.append({"file": "-", "source": src,
                         "error": str(e)[:120]})
            continue
        rows.append({"file": name, "source": src})
    return rows


def _manifest(out: str, flight_rows: list, events: list,
              report: Optional[dict], trace_path: Optional[str],
              stats_rows: list, coverage_rows: Optional[list] = None,
              flight_errors: Optional[list] = None) -> str:
    lines = ["# horovod_tpu_torch debug bundle", "",
             f"Collected {time.strftime('%Y-%m-%d %H:%M:%S')} by "
             f"`python -m horovod_tpu_torch.tracing.bundle`. How to read this: "
             f"docs/debugging.md.", ""]
    deaths = [e for e in events if e.get("flight_event") == "replica_death"]
    anomalies = [e for e in events if e.get("flight_event") == "anomaly"]
    other = [e for e in events
             if e.get("flight_event") in ("stall", "plane_demote")]
    lines.append("## Verdict")
    lines.append("")
    if deaths:
        for e in deaths:
            lines.append(f"- **replica {e.get('replica', '?')} died** "
                         f"(pid {e.get('pid', '?')}, was "
                         f"{e.get('state_was', '?')}): "
                         f"{e.get('reason', '?')} — final seconds in its "
                         f"ring decode under `flight/`")
    if anomalies:
        for e in anomalies:
            detail = {k: v for k, v in e.items()
                      if k not in ("flight_event", "t", "_source")}
            lines.append(f"- **anomaly `{e.get('kind', '?')}` fired**: "
                         f"{json.dumps(detail)}")
    for e in other:
        lines.append(f"- event `{e.get('flight_event')}`: "
                     f"{json.dumps({k: v for k, v in e.items() if k not in ('flight_event', 't', '_source')})}")
    gaps = [r for r in (coverage_rows or []) if r["status"] != "ok"]
    for r in gaps:
        lines.append(f"- **host `{r['host']}` coverage {r['status']}**: "
                     f"{r['reason']}")
    for e in (flight_errors or []):
        lines.append(f"- **flight file `{e['file']}` on {e['host']} "
                     f"failed to decode**: {e['error']}")
    if not (deaths or anomalies or other or gaps or flight_errors):
        lines.append("- no death/anomaly/stall events in the captured "
                     "window")
    lines.append("")
    if coverage_rows is not None:
        lines.append("## Pod coverage")
        lines.append("")
        lines.append("Per telemetry-tree leader: every swept host is "
                     "accounted for — `unreachable` and `partial` rows "
                     "mean the bundle is MISSING that host's data, not "
                     "that nothing happened there.")
        lines.append("")
        lines.append("| host | status | expected | reporting | detail |")
        lines.append("|---|---|---|---|---|")
        for r in coverage_rows:
            lines.append(f"| {r['host']} | {r['status']} | "
                         f"{r['expected']} | {r['reporting']} | "
                         f"{r['reason']} |")
        lines.append("")
    if trace_path:
        lines.append("## Merged trace")
        lines.append("")
        lines.append("- `trace.json` — load in https://ui.perfetto.dev; "
                     "search a request's trace ID (`req:gen:<rid>`) to "
                     "light up its admit/queue/prefill/handoff/decode/"
                     "retire chain across router and replicas")
        if report and report.get("straggler"):
            s = report["straggler"]
            lines.append(f"- critical path (training spans): straggler "
                         f"rank {s['rank']} in {s['phase']} "
                         f"({s['seconds'] * 1e3:.1f} ms) — "
                         f"`critical_path.txt`")
        lines.append("")
    lines.append("## Flight recorders")
    lines.append("")
    if flight_rows:
        lines.append("| file | kind | proc | reason | records |")
        lines.append("|---|---|---|---|---|")
        for r in flight_rows:
            lines.append(f"| {r['file']} | {r['kind']} | {r['proc']} | "
                         f"{r['reason']} | {r['records']} |")
    else:
        lines.append("(none found)")
    for e in (flight_errors or []):
        lines.append(f"- `{e['file']}` ({e['host']}): DECODE FAILED — "
                     f"{e['error']}")
    lines.append("")
    if stats_rows:
        lines.append("## Stats snapshots")
        lines.append("")
        for r in stats_rows:
            if r.get("error"):
                lines.append(f"- {r['source']}: UNREACHABLE "
                             f"({r['error']})")
            else:
                lines.append(f"- `{r['file']}` from {r['source']}")
        lines.append("")
    text = "\n".join(lines) + "\n"
    with open(os.path.join(out, "MANIFEST.md"), "w") as f:
        f.write(text)
    return text


def make_bundle(out: str, trace_dir: str = "", flight_dir: str = "",
                stats: Optional[list] = None,
                leaders: Optional[list] = None,
                leader_key: Optional[bytes] = None) -> dict:
    """Assemble a bundle directory; returns a summary dict (the CLI's
    machine-readable line). With ``leaders`` the flight rings and span
    files are swept through telemetry-tree host leaders host-by-host
    (O(hosts) connections) and a Pod-coverage section names every gap."""
    os.makedirs(out, exist_ok=True)
    flight_rows, events, flight_errors = _collect_flight(flight_dir, out)
    coverage_rows: Optional[list] = None
    if leaders:
        coverage_rows, l_rows, l_errors, l_events, swept_spans = \
            _collect_leaders(list(leaders), leader_key or _leader_key(None),
                             out)
        flight_rows += l_rows
        flight_errors += l_errors
        events += l_events
        if swept_spans:
            # Stage local span files next to the swept ones so the merged
            # trace covers every host (names are per-rank/per-proc).
            if trace_dir and os.path.isdir(trace_dir):
                from .collector import span_files

                for path in span_files(trace_dir):
                    name = os.path.basename(path)
                    if not os.path.exists(os.path.join(swept_spans, name)):
                        shutil.copy(path, os.path.join(swept_spans, name))
            trace_dir = swept_spans
    # A ring and its dumps overlap; report each underlying event once.
    seen: set = set()
    unique = []
    for e in events:
        key = json.dumps({k: v for k, v in sorted(e.items())
                          if k != "_source"}, default=str)
        if key not in seen:
            seen.add(key)
            unique.append(e)
    events = unique
    report, trace_path = _collect_trace(trace_dir, out)
    stats_rows = _collect_stats(list(stats or []), out)
    _manifest(out, flight_rows, events, report, trace_path, stats_rows,
              coverage_rows, flight_errors)
    return {"bundle": out, "flight_files": len(flight_rows),
            "events": len(events), "trace": bool(trace_path),
            "stats": len([r for r in stats_rows if not r.get("error")]),
            "hosts_swept": len(coverage_rows or []),
            "coverage_gaps": [r["host"] for r in (coverage_rows or [])
                              if r["status"] != "ok"],
            "flight_decode_failures": len(flight_errors),
            "dead_replicas": sorted({e.get("replica") for e in events
                                     if e.get("flight_event") ==
                                     "replica_death"
                                     and e.get("replica") is not None})}


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Collect flight dumps, rings, merged trace and stats "
                    "into one debug-bundle directory")
    ap.add_argument("-o", "--out", default=None,
                    help="bundle directory (default ./debug-bundle-<ts>)")
    ap.add_argument("--trace-dir",
                    default=os.environ.get("HOROVOD_TRACE_DIR", ""),
                    help="span directory (default $HOROVOD_TRACE_DIR)")
    ap.add_argument("--flight-dir",
                    default=os.environ.get("HOROVOD_FLIGHT_DIR", ""),
                    help="flight-ring/dump directory (default "
                         "$HOROVOD_FLIGHT_DIR)")
    ap.add_argument("--stats", action="append", default=[],
                    help="a /stats URL or saved snapshot file "
                         "(repeatable)")
    ap.add_argument("--leader", action="append", default=[],
                    help="a telemetry-tree host leader host:port to sweep "
                         "flight rings and spans from (repeatable; every "
                         "leader is accounted for in the MANIFEST's Pod "
                         "coverage section)")
    ap.add_argument("--leader-key", default=None,
                    help="hex secret for the leaders (default "
                         "$HOROVOD_SECRET or $HOROVOD_AGENT_SECRET)")
    args = ap.parse_args(argv)
    out = args.out or f"debug-bundle-{time.strftime('%Y%m%d-%H%M%S')}"
    summary = make_bundle(out, trace_dir=args.trace_dir,
                          flight_dir=args.flight_dir, stats=args.stats,
                          leaders=args.leader,
                          leader_key=_leader_key(args.leader_key)
                          if args.leader else None)
    if not summary["flight_files"] and not summary["trace"] \
            and not summary["stats"] and not summary["hosts_swept"]:
        print(f"bundle: nothing to collect (trace_dir="
              f"{args.trace_dir or '-'}, flight_dir="
              f"{args.flight_dir or '-'})")
        return 1
    print(json.dumps(summary))
    print(f"bundle ready: {out}/MANIFEST.md")
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    raise SystemExit(main())
