"""Per-host telemetry leader + the rank-side client: the port's own copy
of ``horovod_tpu.telemetry.agent``, with the same protocol.

:class:`TelemetryAgent` is the host-local collection daemon — the Dapper
move: ranks talk to a process one loopback hop away, and only the MERGED
host view crosses the slow tier to the coordinator. It is a
:class:`~..runner.network.BasicService` (HMAC-authenticated,
session-keyed), normally hosted by the runner HostAgent process under the
job-derived secret, so the ranks' existing ``HOROVOD_SECRET`` authenticates
them to it and nothing new crosses the wire in the clear.

What it does per hop:

- **rank → leader** (push): ranks push metrics snapshots as DELTAS
  (aggregate.snapshot_delta) every collection interval; a sequence gap —
  agent restart, dropped push — answers ``need_full`` and the rank resends
  the whole snapshot. Watchdog/anomaly events ride ``telemetry_events``
  and are batched.
- **leader → root** (push): every interval the agent merges its ranks'
  latest snapshots into ONE host partial (the associative merge) and
  pushes it — itself delta-compressed — to the driver's ``host_metrics``
  endpoint, piggybacking the batched events and per-rank ages. Root
  ingest per tick is O(hosts).
- **clock**: the agent answers rank ``clock_probe``s locally (BasicService
  built-in) and serves ``clock_info`` — its own cached NTP estimate
  against the root — so a rank composes rank→leader + leader→root
  (clock.compose_offsets) instead of probing the root directly.
- **sweeps** (pull): ``sweep`` returns the host's flight rings (decoded),
  flight dumps, and trace-span files, plus per-rank coverage (last push
  age, seq) — ``python -m horovod_tpu_torch.tracing.bundle --leader`` streams a
  pod's telemetry host-by-host through these.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from ..metrics.aggregate import (
    apply_snapshot_delta,
    finalize_partial,
    lift_snapshot,
    merge_partials,
    snapshot_delta,
)
from ..metrics.registry import MetricsRegistry, registry
from ..runner.network import BasicClient, BasicService
from ..tracing.clock import compose_offsets, estimate_offset_ns
from .tree import interval_s_from_env

#: events kept while waiting for the next root push (leader) — bounded so
#: a storm of stall warnings can't grow the agent without limit.
EVENT_QUEUE_LIMIT = 2048


def _event_source(event: dict) -> str:
    kind = str(event.get("kind", ""))
    if kind == "stall":
        return "watchdog"
    if kind in ("anomaly",) or event.get("flight_event") == "anomaly":
        return "anomaly"
    return "other"


class TelemetryAgent(BasicService):
    """One host's telemetry leader. Protocol (request ``kind`` → response):

    - ``telemetry_hello`` ``{rank}`` → ``{ok, interval_s}`` — registers the
      rank as expected on this host and tells it the collection interval.
    - ``telemetry_push`` ``{rank, seq, full, body}`` → ``{ok, need_full}``
      — a full snapshot (``full``) or a delta against the last acked one.
    - ``telemetry_events`` ``{rank, events}`` → ``{ok}`` — batch of
      structured watchdog/anomaly events, forwarded on the next root push.
    - ``clock_info`` → ``{ok, synced, offset_ns, error_ns}`` — this
      agent's cached offset to the root clock (for composition).
    - ``host_metrics`` → ``{ok, host, partial, ages_s, expected}`` — the
      current host partial (pull; the push loop uses the same builder).
    - ``sweep`` ``{want: ["flight","spans"]}`` → rings/dumps/span files +
      per-rank coverage (the bundle's per-host collection endpoint).
    """

    def __init__(self, key: bytes, host_name: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 flight_dir: Optional[str] = None,
                 trace_dir: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 expected_ranks=None,
                 reg: Optional[MetricsRegistry] = None) -> None:
        super().__init__(key, host=host, port=port)
        from ..runner.service import host_hash

        self.host_name = host_name or host_hash()
        self.flight_dir = flight_dir if flight_dir is not None \
            else os.environ.get("HOROVOD_FLIGHT_DIR", "")
        self.trace_dir = trace_dir if trace_dir is not None \
            else os.environ.get("HOROVOD_TRACE_DIR", "")
        self.interval_s = float(interval_s) if interval_s is not None \
            else interval_s_from_env()
        self.reg = reg or registry()
        self._state_lock = threading.Lock()
        self._ranks: dict[int, dict] = {}   # rank -> {snap, seq, t, pushes}
        self._expected: set[int] = set(int(r) for r in expected_ranks or ())
        self._events: deque = deque(maxlen=EVENT_QUEUE_LIMIT)
        # leader → root push state
        self._root_lock = threading.Lock()
        self._root_addresses = None
        self._root_key: Optional[bytes] = None
        self._root_client: Optional[BasicClient] = None
        self._root_offset: Optional[tuple] = None
        self._root_seq = 0
        self._root_acked: Optional[dict] = None
        self._push_stop = threading.Event()
        self._push_thread: Optional[threading.Thread] = None
        self._rank_push_c = self.reg.counter(
            "horovod_telemetry_pushes_total",
            help="telemetry-tree snapshot pushes received, by hop "
                 "(rank→leader on agents, leader→root at the root)",
            hop="rank")

    # -- protocol ------------------------------------------------------------

    def handle(self, req: Any, client_addr) -> Any:
        kind = req.get("kind")
        if kind == "telemetry_hello":
            with self._state_lock:
                self._expected.add(int(req["rank"]))
            return {"ok": True, "interval_s": self.interval_s,
                    "host": self.host_name}
        if kind == "telemetry_push":
            return self._handle_push(req)
        if kind == "telemetry_events":
            events = list(req.get("events") or [])
            with self._state_lock:
                for e in events:
                    self._events.append(dict(e, _rank=req.get("rank")))
            for e in events:
                self.reg.counter(
                    "horovod_telemetry_events_total",
                    help="watchdog/anomaly events batched through the "
                         "telemetry tree, by source",
                    source=_event_source(e)).inc()
            return {"ok": True}
        if kind == "clock_info":
            with self._root_lock:
                off = self._root_offset
            return {"ok": True, "synced": off is not None,
                    "offset_ns": int(off[0]) if off else 0,
                    "error_ns": int(off[1]) if off else 0}
        if kind == "host_metrics":
            partial, ages = self._partial_and_ages()
            return {"ok": True, "host": self.host_name, "partial": partial,
                    "ages_s": ages, "expected": self.expected_ranks(),
                    "interval_s": self.interval_s}
        if kind == "sweep":
            return self._handle_sweep(req)
        return {"ok": False, "error": f"unknown request {kind}"}

    def _handle_push(self, req: dict) -> dict:
        rank = int(req["rank"])
        seq = int(req.get("seq", 0))
        now = time.monotonic()
        with self._state_lock:
            self._expected.add(rank)
            st = self._ranks.get(rank)
            if req.get("full"):
                snap = req["body"]
            else:
                if st is None or seq != st["seq"] + 1:
                    # Resync: agent restarted, or a push was lost. The rank
                    # answers with a full snapshot; meanwhile the last good
                    # snapshot (if any) keeps feeding the host partial.
                    return {"ok": True, "need_full": True}
                snap = apply_snapshot_delta(st["snap"], req["body"])
            self._ranks[rank] = {
                "snap": snap, "seq": seq, "t": now,
                "pushes": (st["pushes"] + 1) if st else 1,
            }
        self._rank_push_c.inc()
        return {"ok": True, "need_full": False}

    def _handle_sweep(self, req: dict) -> dict:
        want = req.get("want") or ["flight", "spans"]
        resp: dict = {"ok": True, "host": self.host_name,
                      "coverage": self.coverage()}
        if "flight" in want:
            items: list = []
            errors: list = []
            if self.flight_dir and os.path.isdir(self.flight_dir):
                from ..tracing import flight as _flight

                for path in _flight.ring_files(self.flight_dir):
                    name = os.path.basename(path)
                    try:
                        items.append({"name": name + ".json", "kind": "ring",
                                      "doc": _flight.read_ring(path)})
                    except Exception as e:
                        # torn/truncated rings raise struct.error and
                        # friends — a bad ring must become a NAMED row in
                        # the bundle, never a crashed sweep
                        errors.append({"file": name, "error": str(e)[:200]})
                for path in _flight.dump_files(self.flight_dir):
                    name = os.path.basename(path)
                    try:
                        with open(path) as f:
                            items.append({"name": name, "kind": "dump",
                                          "doc": json.load(f)})
                    except Exception as e:
                        errors.append({"file": name, "error": str(e)[:200]})
            resp["flight"] = items
            resp["flight_errors"] = errors
        if "spans" in want:
            spans: list = []
            if self.trace_dir and os.path.isdir(self.trace_dir):
                from ..tracing.collector import span_files

                for path in span_files(self.trace_dir):
                    try:
                        with open(path) as f:
                            spans.append({"name": os.path.basename(path),
                                          "text": f.read()})
                    except OSError as e:
                        resp.setdefault("flight_errors", []).append(
                            {"file": os.path.basename(path),
                             "error": str(e)[:200]})
            resp["spans"] = spans
        return resp

    # -- host views ----------------------------------------------------------

    def _partial_and_ages(self) -> tuple:
        now = time.monotonic()
        with self._state_lock:
            items = sorted(self._ranks.items())
            ages = {str(r): round(now - st["t"], 3) for r, st in items}
        partial = merge_partials(
            [lift_snapshot(r, st["snap"]) for r, st in items])
        return partial, ages

    def host_partial(self) -> dict:
        """The associative merge of every local rank's latest snapshot."""
        return self._partial_and_ages()[0]

    def host_view(self) -> Optional[dict]:
        """Finalized host-merged snapshot for ``/metrics.json?host=1``
        (exposition.MetricsServer ``host_view=``); None before any push."""
        with self._state_lock:
            empty = not self._ranks
        if empty:
            return None
        return finalize_partial(self.host_partial())

    def expected_ranks(self) -> list:
        with self._state_lock:
            return sorted(self._expected | set(self._ranks))

    def coverage(self) -> dict:
        """Per-rank liveness as this leader sees it — what the bundle's
        MANIFEST per-host accounting is built from."""
        now = time.monotonic()
        with self._state_lock:
            ranks = {str(r): {"age_s": round(now - st["t"], 3),
                              "seq": st["seq"], "pushes": st["pushes"]}
                     for r, st in sorted(self._ranks.items())}
            expected = sorted(self._expected | set(self._ranks))
        return {"host": self.host_name, "expected": expected,
                "ranks": ranks, "interval_s": self.interval_s}

    def drain_events(self) -> list:
        with self._state_lock:
            out = list(self._events)
            self._events.clear()
        return out

    # -- leader → root push loop ---------------------------------------------

    def attach_root(self, addresses, key: Optional[bytes] = None,
                    probe_rounds: int = 8, start_loop: bool = True) -> None:
        """Connect to the root (DriverService), estimate this agent's clock
        offset against it (served back to ranks via ``clock_info``), and —
        unless ``start_loop`` is False — start pushing the host partial
        every collection interval."""
        with self._root_lock:
            self._root_addresses = list(addresses)
            self._root_key = key or self.key
        self._connect_root(probe_rounds)
        if start_loop and self._push_thread is None:
            self._push_thread = threading.Thread(
                target=self._push_loop, name="hvd_telemetry_push",
                daemon=True)
            self._push_thread.start()

    def _connect_root(self, probe_rounds: int = 8) -> None:
        with self._root_lock:
            addresses, key = self._root_addresses, self._root_key
        client = BasicClient(addresses, key, timeout=30.0,
                             connect_retry_s=10.0)
        offset = estimate_offset_ns(
            lambda: client.request({"kind": "clock_probe"})["t"],
            rounds=probe_rounds)
        with self._root_lock:
            self._root_client = client
            self._root_offset = offset
            self._root_acked = None   # fresh connection → resend full

    def _push_loop(self) -> None:
        while not self._push_stop.wait(self.interval_s):
            try:
                self.push_to_root_once()
            except Exception:   # telemetry must never take the host down
                with self._root_lock:
                    client, self._root_client = self._root_client, None
                if client is not None:
                    try:
                        client.close()
                    except Exception:
                        pass
                try:
                    self._connect_root()
                except Exception:
                    pass   # root still gone; retry next tick

    def push_to_root_once(self) -> dict:
        """One leader→root tick: host partial (delta-compressed against the
        last acked push), batched events, per-rank ages."""
        partial, ages = self._partial_and_ages()
        events = self.drain_events()
        with self._root_lock:
            client = self._root_client
            acked = self._root_acked
            seq = self._root_seq
        if client is None:
            raise ConnectionError("no root attached")
        full = acked is None
        body = partial if full else snapshot_delta(acked, partial)
        req = {"kind": "host_metrics", "host": self.host_name, "seq": seq,
               "full": full, "body": body, "events": events,
               "ages_s": ages, "expected": self.expected_ranks(),
               "interval_s": self.interval_s}
        try:
            resp = client.request(req)
            if resp.get("need_full") and not full:
                req.update(full=True, body=partial, events=[])
                resp = client.request(req)
        except Exception:
            # Re-queue the drained events so a root blip doesn't lose them.
            with self._state_lock:
                for e in events:
                    self._events.append(e)
            raise
        with self._root_lock:
            self._root_acked = partial
            self._root_seq = seq + 1
        return resp

    def stop(self) -> None:
        self._push_stop.set()
        if self._push_thread is not None:
            self._push_thread.join(timeout=5)
        with self._root_lock:
            client, self._root_client = self._root_client, None
        if client is not None:
            try:
                client.close()
            except Exception:
                pass
        super().stop()


class RankTelemetryClient:
    """The rank side of the rank→leader hop.

    Owns one authenticated connection to the host's TelemetryAgent and
    pushes this process's metrics snapshot as deltas (full on first push
    or whenever the agent asks ``need_full``). ``event_sink`` plugs into
    ``StallWatchdog(event_sink=...)`` / ``AnomalyDetector.subscribe`` so
    rank-local events batch through the leader instead of each rank
    talking to the root. ``composed_clock_offset`` is the tree's clock
    path: rank→leader probe (local, tight RTT) composed with the leader's
    cached leader→root estimate.
    """

    def __init__(self, addresses, key: bytes, rank: int,
                 snapshot_fn: Optional[Callable[[], dict]] = None) -> None:
        self.rank = int(rank)
        self._snapshot_fn = snapshot_fn
        self._lock = threading.Lock()
        self._seq = 0
        self._acked: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.client = BasicClient(addresses, key, timeout=30.0,
                                  connect_retry_s=10.0)
        hello = self.client.request({"kind": "telemetry_hello",
                                     "rank": self.rank})
        self.interval_s = float(hello.get("interval_s",
                                          interval_s_from_env()))

    def _snapshot(self) -> dict:
        if self._snapshot_fn is not None:
            return self._snapshot_fn()
        from ..metrics import snapshot

        return snapshot()

    def push(self, snap: Optional[dict] = None) -> dict:
        """Push the current snapshot (delta-compressed); returns the wire
        request actually sent (tests and the bench read its size)."""
        snap = snap if snap is not None else self._snapshot()
        with self._lock:
            acked, seq = self._acked, self._seq
            full = acked is None
            body = snap if full else snapshot_delta(acked, snap)
            req = {"kind": "telemetry_push", "rank": self.rank, "seq": seq,
                   "full": full, "body": body}
            resp = self.client.request(req)
            if resp.get("need_full") and not full:
                req = {"kind": "telemetry_push", "rank": self.rank,
                       "seq": seq, "full": True, "body": snap}
                resp = self.client.request(req)
            if resp.get("ok"):
                self._acked = snap
                self._seq = seq + 1
        return req

    def push_events(self, events: list) -> None:
        self.client.request({"kind": "telemetry_events", "rank": self.rank,
                             "events": list(events)})

    def event_sink(self, event: dict) -> None:
        """Single-event convenience for watchdog/anomaly hooks; never
        raises (a telemetry blip must not kill the caller's thread)."""
        try:
            self.push_events([event])
        except Exception:
            pass

    def composed_clock_offset(self, rounds: int = 8) -> tuple:
        """(offset_ns, error_bound_ns) of the ROOT clock relative to this
        rank: rank→leader estimate composed with the leader's cached
        leader→root estimate. Falls back to the rank→leader estimate alone
        when the leader is not synced to a root (single-host runs: the
        leader IS the reference)."""
        local = estimate_offset_ns(
            lambda: self.client.request({"kind": "clock_probe"})["t"],
            rounds=rounds)
        info = self.client.request({"kind": "clock_info"})
        if not info.get("synced"):
            return local
        return compose_offsets(
            local, (int(info["offset_ns"]), int(info["error_ns"])))

    def start(self) -> "RankTelemetryClient":
        """Push every collection interval on a daemon thread."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="hvd_telemetry_rank", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.push()
            except Exception:
                pass   # leader blip: keep the training loop alive, retry

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            self.client.close()
        except Exception:
            pass
