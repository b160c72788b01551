"""Always-on flight recorder — the last seconds of every process, kept
cheaply, recoverable even from a SIGKILL: the port's own copy of
``horovod_tpu.tracing.flight``, with the same ring format byte for byte,
so each package's ``read_ring`` reads the other's ring file.

Every process (training ranks, serving router, serving/LLM replicas, the
coordinator) owns one bounded ring of recent records: spans (mirrored from
the tracer when one is active, retained directly when not), structured
events (replica deaths, stalls, anomalies, plane demotions), and periodic
metric-delta snapshots — plus the process's config fingerprint. The ring
only RETAINS; it never logs, so it stays near-zero cost and always on.

Two backings, selected by ``HOROVOD_FLIGHT_DIR``:

- **unset**: an in-memory deque. Post-mortem only through an explicit
  :meth:`FlightRecorder.dump` (crash handlers, tests).
- **set**: an mmap'd ring file ``flight-<proc>.ring`` in that directory.
  Writes are memcpys into the page cache — no syscall, no fsync, no
  flush on the hot path — yet the kernel keeps the file contents when
  the process dies, *including SIGKILL*, which no write-on-crash scheme
  survives. ``read_ring`` decodes a ring file (live or orphaned) back
  into records; the bundle CLI (tracing/bundle.py) sweeps every ring and
  dump in the directory into one debug bundle.

On a trigger (crash, stall-watchdog escalation, replica death, plane
demotion, SLO breach / anomaly firing) :meth:`dump` writes the ring plus
a full metrics snapshot as ``flight-<proc>-<n>-<reason>.json`` — the
human-readable artifact the bundle's MANIFEST.md points at. Ring capacity
is ``HOROVOD_FLIGHT_SPANS`` records (default 4096).
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import re
import struct
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_CAPACITY = 4096          # HOROVOD_FLIGHT_SPANS
SLOT_BYTES = 768                 # fixed record slot (len-prefixed JSON)
_MAGIC = b"HVDFLT1\n"
_HEADER_BYTES = 64               # magic + slot_bytes + capacity + next_seq
_META_BYTES = 4096               # len-prefixed meta JSON (fingerprint)
_DATA_OFF = _HEADER_BYTES + _META_BYTES

#: env names that must never land in a fingerprint or dump
_REDACT = re.compile(r"SECRET|TOKEN|KEY|PASSWORD", re.IGNORECASE)


def flight_dir_from_env() -> str:
    return os.environ.get("HOROVOD_FLIGHT_DIR", "")


def config_fingerprint() -> dict:
    """The process's config surface: every HOROVOD_*/HVD_* env var
    (secrets redacted) plus a stable hash — the "what exactly was this
    process running with" record every dump carries."""
    env = {k: v for k, v in sorted(os.environ.items())
           if (k.startswith("HOROVOD_") or k.startswith("HVD_"))
           and not _REDACT.search(k)}
    digest = hashlib.sha1(
        "\n".join(f"{k}={v}" for k, v in env.items()).encode()).hexdigest()
    return {"hash": digest[:16], "env": env}


class FlightRecorder:
    """One process's bounded record ring. Thread-safe; every operation is
    one lock + one memcpy (mmap) or deque append (memory)."""

    def __init__(self, proc: str, flight_dir: Optional[str] = None,
                 capacity: Optional[int] = None) -> None:
        self.proc = str(proc)
        self.flight_dir = flight_dir if flight_dir is not None \
            else flight_dir_from_env()
        self.capacity = int(capacity if capacity is not None else
                            os.environ.get("HOROVOD_FLIGHT_SPANS", "")
                            or DEFAULT_CAPACITY)
        self.capacity = max(self.capacity, 16)
        self._lock = threading.Lock()
        self._mm: Optional[mmap.mmap] = None
        self._mem: Optional[deque] = None
        self._seq = 0
        self._dumps = 0
        self._last_counters: dict = {}
        self.fingerprint = config_fingerprint()
        meta = {"flight_meta": 1, "proc": self.proc, "pid": os.getpid(),
                "time_unix_s": time.time(), "capacity": self.capacity,
                "fingerprint": self.fingerprint}
        if self.flight_dir:
            try:
                os.makedirs(self.flight_dir, exist_ok=True)
                path = self.ring_path(self.flight_dir, self.proc)
                size = _DATA_OFF + self.capacity * SLOT_BYTES
                fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
                try:
                    os.ftruncate(fd, size)
                    self._mm = mmap.mmap(fd, size)
                finally:
                    os.close(fd)
                self._mm[0:len(_MAGIC)] = _MAGIC
                struct.pack_into("<II", self._mm, len(_MAGIC),
                                 SLOT_BYTES, self.capacity)
                mb = json.dumps(meta).encode()[:_META_BYTES - 4]
                struct.pack_into("<I", self._mm, _HEADER_BYTES, len(mb))
                self._mm[_HEADER_BYTES + 4:_HEADER_BYTES + 4 + len(mb)] = mb
                self._write_seq(0)
            except (OSError, ValueError):
                # Unwritable dir: telemetry never takes the process down —
                # degrade to the in-memory ring.
                self._mm = None
        if self._mm is None:
            self._mem = deque(maxlen=self.capacity)
        self.meta = meta
        from ..metrics import registry as _registry

        self._dump_c = _registry().counter(
            "horovod_flight_dumps_total",
            help="flight-recorder dumps written on crash/stall/death/"
                 "anomaly triggers")

    @staticmethod
    def ring_path(flight_dir: str, proc: str) -> str:
        return os.path.join(flight_dir, f"flight-{proc}.ring")

    # -- retention (the always-on hot path) ----------------------------------

    def retain(self, rec: dict) -> None:
        if self._mm is None:
            self._mem.append(rec)
            with self._lock:
                self._seq += 1
            return
        payload = json.dumps(rec).encode()
        if len(payload) > SLOT_BYTES - 4:
            payload = json.dumps(
                {"flight_truncated": 1, "tid": rec.get("tid"),
                 "phase": rec.get("phase"),
                 "flight_event": rec.get("flight_event")}).encode()
        with self._lock:
            slot = self._seq % self.capacity
            off = _DATA_OFF + slot * SLOT_BYTES
            try:
                struct.pack_into("<I", self._mm, off, len(payload))
                self._mm[off + 4:off + 4 + len(payload)] = payload
                self._seq += 1
                self._write_seq(self._seq)
            except (ValueError, OSError):
                pass

    def event(self, event_kind: str, **attrs) -> None:
        """Retain one structured event record (replica_death, stall,
        anomaly, plane_demote, ...). ``attrs`` may itself carry a ``kind``
        key (anomaly events do) — the event name is positional-only by
        convention so the two never collide."""
        rec = {"flight_event": str(event_kind), "t": time.monotonic_ns(),
               "time_unix_s": round(time.time(), 3)}
        rec.update(attrs)
        self.retain(rec)

    def note_metrics(self) -> None:
        """Retain a counter-delta snapshot (what moved since the last
        note): the step/token/byte trajectory of the final seconds without
        retaining full snapshots."""
        try:
            from ..metrics import registry as _registry

            snap = _registry().snapshot()["counters"]
        except Exception:  # noqa: BLE001 - telemetry never kills the host
            return
        delta = {k: round(v - self._last_counters.get(k, 0.0), 3)
                 for k, v in snap.items()
                 if v != self._last_counters.get(k, 0.0)}
        self._last_counters = snap
        if delta:
            self.event("metrics_delta", d=delta)

    # -- views ---------------------------------------------------------------

    def records(self) -> list:
        """The retained records, oldest first."""
        if self._mm is None:
            return list(self._mem)
        with self._lock:
            mm, seq = self._mm, self._seq
            return _decode_slots(mm, seq, self.capacity)

    # -- the dump ------------------------------------------------------------

    def dump(self, reason: str, out_dir: Optional[str] = None) -> str:
        """Write ring + metrics snapshot as one JSON dump; returns the
        path ('' when no directory is available). Never raises."""
        out_dir = out_dir or self.flight_dir
        if not out_dir:
            return ""
        try:
            from ..metrics import registry as _registry

            metrics = _registry().snapshot()
        except Exception:  # noqa: BLE001
            metrics = {}
        safe = re.sub(r"[^A-Za-z0-9._-]+", "_", str(reason))[:80]
        with self._lock:
            self._dumps += 1
            n = self._dumps
        path = os.path.join(out_dir,
                            f"flight-{self.proc}-{n:03d}-{safe}.json")
        doc = {"flight_dump": 1, "proc": self.proc, "pid": os.getpid(),
               "reason": str(reason), "time_unix_s": time.time(),
               "fingerprint": self.fingerprint,
               "records": self.records(), "metrics": metrics}
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.rename(tmp, path)
        except (OSError, ValueError):
            return ""
        self._dump_c.inc()
        return path

    # -- internals -----------------------------------------------------------

    def _write_seq(self, seq: int) -> None:
        struct.pack_into("<Q", self._mm, len(_MAGIC) + 8, seq)

    def close(self) -> None:
        with self._lock:
            if self._mm is not None:
                try:
                    self._mm.flush()
                    self._mm.close()
                except (OSError, ValueError):
                    pass
                self._mm = None
                self._mem = deque(maxlen=self.capacity)


def _decode_slots(mm, seq: int, capacity: int) -> list:
    out = []
    first = max(seq - capacity, 0)
    for i in range(first, seq):
        off = _DATA_OFF + (i % capacity) * SLOT_BYTES
        try:
            (n,) = struct.unpack_from("<I", mm, off)
            if not 0 < n <= SLOT_BYTES - 4:
                continue
            out.append(json.loads(mm[off + 4:off + 4 + n]))
        except (ValueError, struct.error):
            continue
    return out


def ring_files(flight_dir: str) -> list:
    """Sorted ``flight-*.ring`` paths in a directory — one enumeration
    shared by the local bundle sweep and the telemetry-tree leaders'
    ``sweep`` endpoint (telemetry/agent.py), so both see the same set."""
    import glob

    return sorted(glob.glob(os.path.join(flight_dir, "flight-*.ring")))


def dump_files(flight_dir: str) -> list:
    """Sorted ``flight-*.json`` dump paths in a directory (same sharing
    rationale as :func:`ring_files`)."""
    import glob

    return sorted(glob.glob(os.path.join(flight_dir, "flight-*.json")))


def read_ring(path: str) -> dict:
    """Decode a ring file (live or left behind by a dead process) into
    ``{"proc", "meta", "records"}``. Tolerates torn slots — a process
    killed mid-memcpy leaves at most one unparseable record."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a flight ring (bad magic)")
    slot_bytes, capacity = struct.unpack_from("<II", data, len(_MAGIC))
    (seq,) = struct.unpack_from("<Q", data, len(_MAGIC) + 8)
    if slot_bytes != SLOT_BYTES:
        raise ValueError(f"{path}: slot size {slot_bytes} != {SLOT_BYTES}")
    (mn,) = struct.unpack_from("<I", data, _HEADER_BYTES)
    meta = {}
    if 0 < mn <= _META_BYTES - 4:
        try:
            meta = json.loads(data[_HEADER_BYTES + 4:_HEADER_BYTES + 4 + mn])
        except ValueError:
            meta = {}
    return {"proc": meta.get("proc", os.path.basename(path)),
            "meta": meta,
            "records": _decode_slots(data, seq, capacity)}


# -- the process singleton ----------------------------------------------------

_lock = threading.Lock()
_flight: Optional[FlightRecorder] = None


def init_flight(proc: str) -> FlightRecorder:
    """Open (or return) this process's flight ring. Idempotent; a second
    call with a different proc name, or under another HOROVOD_FLIGHT_DIR
    (a world formed again in the process), re-points it."""
    global _flight
    with _lock:
        if _flight is not None and _flight.proc == proc \
                and _flight.flight_dir == flight_dir_from_env():
            return _flight
        if _flight is not None:
            _flight.close()
        _flight = FlightRecorder(proc)
        return _flight


def get_flight() -> FlightRecorder:
    """The process flight recorder, auto-initialized from the process
    identity (``rank<k>`` for training ranks, ``proc<pid>`` otherwise —
    serving processes name themselves via init_flight first)."""
    global _flight
    with _lock:
        if _flight is None:
            rank = os.environ.get("HOROVOD_RANK", "")
            proc = f"rank{rank}" if rank else f"proc{os.getpid()}"
            _flight = FlightRecorder(proc)
        return _flight
