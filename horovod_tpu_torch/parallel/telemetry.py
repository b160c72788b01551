"""The telemetry of the port's collectives (``parallel/collectives.py``):
the counters, the device times, the spans and the stall watchdog's view.

The counterpart of the JAX package's eager-engine telemetry
(``horovod_tpu/common/engine.py``), fed by the port's own data plane:

- **Counters**, always on, counted on the host at issue under the engine's
  names: ``horovod_collectives_total{op}``,
  ``horovod_collective_bytes_total{op}``,
  ``horovod_collective_size_bytes{op}`` and, where ``backend_errors``
  translates a failure, ``horovod_collective_errors_total{op}``;
  ``horovod_wire_bytes_total{plane="eager"}`` for the bytes an exchange
  ships at a compressed wire dtype, ``{tier="local"|"cross"}`` for the
  ladder's ICI and DCN collectives (``count_wire``).
- **Device times.** On the card a collective is timed by a pair of CUDA
  events on its stream: the first recorded on the issuing stream before
  the NCCL call (NCCL's stream waits for it, so it reads when the input
  was ready), the second after it: on the issuing stream for a
  synchronous call (which makes that stream wait for NCCL's), on a stream
  of this module that waits for the work alone for an asynchronous one.
  The events are read only once the second has completed (``query()``),
  at a later issue or wait, never by a synchronization of their own. They
  are mapped onto the host's ``time.monotonic_ns()`` through an anchor
  event recorded on an idle stream of this module and synchronized (it
  waits for nothing else), taken again every half second. On gloo the
  times are host clocks, the end the first poll of the host's wait that
  found the work complete. A time that
  cannot be read drops its span and counts it in
  ``horovod_trace_dropped_total``; no host time around an asynchronous
  NCCL call stands in for it.
- **Spans**, written only when ``HOROVOD_TRACE_DIR`` is set: per
  collective, under the trace ID ``<name>#<seq>`` (the k-th issue of that
  name in this world, the same on every rank), ``enqueue`` at the first
  event, one ``wire`` span per segment (the hierarchical ladder's three
  carry ``tier``), and ``done`` when the host's wait returned.
  ``horovod_collective_seconds{op}`` observes the device seconds.
- **The stall watchdog's source**: the collectives whose end has not
  completed. Past ``HOROVOD_STALL_SHUTDOWN_TIME`` the watchdog's abort
  aborts NCCL's communicators (gloo's waits are woken instead) and every
  later wait or issue raises ``HorovodInternalError``: a wait on gloo
  polls its work, so the abort ends it too.

Under CUDA-graph capture (``torch.cuda.is_current_stream_capturing()``)
nothing is recorded or counted: a replay issues no host call, as the
reference's compiled plane is static. Nothing here changes a value.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import torch

from ..tracing import get_recorder, trace_id

# How often the device clock's anchor to the host clock is taken again.
_ANCHOR_EVERY_NS = 500_000_000


class Flight:
    """One collective in flight: its identity, its markers (CUDA events on
    the card, ``monotonic_ns`` readings on the host) and its state."""

    __slots__ = ("op", "name", "tid", "nbytes", "issued_ns", "device",
                 "cuda", "anchor", "marks", "tiers", "end", "done_ns", "future")

    def __init__(self, op: str, name: str, tid: str, nbytes: int,
                 device: Optional[torch.device]) -> None:
        self.op, self.name, self.tid, self.nbytes = op, name, tid, nbytes
        self.issued_ns = time.monotonic_ns()
        self.device = device
        self.cuda = device is not None and device.type == "cuda"
        # (event, host ns) on the card
        self.anchor = _anchor(device) if self.cuda else None
        self.marks: list = []       # start, then one end per segment
        self.tiers: list = []       # per segment: None or its tier
        self.end = None             # the last mark, once recorded
        self.done_ns: Optional[int] = None
        self.future = None          # gloo: the work's future, polled


    def completed(self) -> bool:
        if self.cuda:
            return self.end is not None and self.end.query()
        return self.end is not None or (self.future is not None
                                        and self.future.done())


class _State:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.timing = False
        self.inflight: list[Flight] = []
        self.seq: dict[str, int] = {}
        self.stall_error: Optional[BaseException] = None
        self.capturing = False
        self.anchors: dict = {}
        self.streams: dict = {}
        self.metrics: dict = {}


_s = _State()


def _reg():
    from ..metrics import registry

    return registry()


def _metric(kind: str, name: str, help_: str, **labels):
    key = (kind, name, tuple(sorted(labels.items())))
    m = _s.metrics.get(key)
    if m is None:
        reg = _reg()
        if kind == "histogram":
            from ..metrics.registry import DEFAULT_BYTE_BUCKETS

            m = reg.histogram(name, help=help_, buckets=DEFAULT_BYTE_BUCKETS
                              if "bytes" in name else None, **labels)
        else:
            m = reg.counter(name, help=help_, **labels)
        _s.metrics[key] = m
    return m


def configure(timing: bool) -> None:
    """Start a world: events and spans on or off (on where a recorder or
    the watchdog reads them), trace IDs from 1, no stall."""
    with _s.lock:
        _s.timing = bool(timing)
        _s.inflight = []
        _s.seq = {}
        _s.stall_error = None
        _s.capturing = False
        _s.metrics = {}


def reset(flush: bool = True) -> None:
    """Leave a world: the completed collectives' spans written (unless the
    world is being aborted), the rest dropped."""
    if flush and _s.timing:
        resolve()
    with _s.lock:
        _s.timing = False
        _s.inflight = []


def _capturing(tensor: Optional[torch.Tensor]) -> bool:
    return tensor is not None and tensor.is_cuda \
        and torch.cuda.is_current_stream_capturing()


def check() -> None:
    """Raise the stall watchdog's error, once it aborted the world."""
    err = _s.stall_error
    if err is not None:
        raise err


def _stream(kind: str, device: torch.device):
    key = (kind, device.index)
    st = _s.streams.get(key)
    if st is None:
        st = _s.streams[key] = torch.cuda.Stream(device)
    return st


def _anchor(device: torch.device):
    a = _s.anchors.get(device.index)
    now = time.monotonic_ns()
    if a is None or now - a[1] > _ANCHOR_EVERY_NS:
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic_ns()
        ev.record(_stream("anchor", device))
        ev.synchronize()
        t1 = time.monotonic_ns()
        a = _s.anchors[device.index] = (ev, (t0 + t1) // 2)
    return a


def _mark(f: Flight, stream=None):
    if not f.cuda:
        return time.monotonic_ns()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def begin(op: str, tensor: Optional[torch.Tensor], nbytes: int,
          name: Optional[str] = None) -> Optional[Flight]:
    """A collective is about to be issued on ``tensor``'s device (None: a
    host-side object collective): count it and, with timing on, register
    it and mark its start. None under graph capture."""
    if _capturing(tensor):
        return None
    check()
    _metric("counter", "horovod_collectives_total",
            "collectives issued by the port's data plane", op=op).inc()
    _metric("counter", "horovod_collective_bytes_total",
            "tensor bytes of the issued collectives", op=op).inc(nbytes)
    _metric("histogram", "horovod_collective_size_bytes",
            "per-collective tensor sizes", op=op).observe(nbytes)
    if not _s.timing:
        return None
    name = name or op
    with _s.lock:
        seq = _s.seq[name] = _s.seq.get(name, 0) + 1
    resolve()
    f = Flight(op, name, trace_id(name, seq), nbytes,
               tensor.device if tensor is not None else None)
    f.marks.append(_mark(f))
    with _s.lock:
        _s.inflight.append(f)
    return f


def segment(f: Optional[Flight], tier: Optional[str] = None) -> None:
    """Close a segment of ``f`` on the current stream: the ladder's
    collectives run back to back, and each tier gets its own span."""
    if f is None:
        return
    f.marks.append(_mark(f))
    f.tiers.append(tier)


def finish(f: Optional[Flight], tier: Optional[str] = None) -> None:
    """A synchronous collective returned on the host: its end is marked on
    the current stream (which now waits for NCCL's), and it is done."""
    if f is None:
        return
    segment(f, tier)
    f.end = f.marks[-1]
    f.done_ns = time.monotonic_ns()
    resolve()


def _blocking_wait() -> bool:
    return os.environ.get("TORCH_NCCL_BLOCKING_WAIT",
                          os.environ.get("NCCL_BLOCKING_WAIT", "")) == "1"


def issued(f: Optional[Flight], work) -> None:
    """An asynchronous collective was issued: on the card its end is
    marked on a stream that waits for the work alone (skipped where the
    wait blocks the host, ``TORCH_NCCL_BLOCKING_WAIT``: then ``wait``
    marks it); on gloo ``wait`` polls the work's future (a work without
    one, as gloo's ``reduce_scatter_tensor`` has, completes only in its
    ``wait``, which then blocks)."""
    if f is None:
        return
    if not f.cuda:
        try:
            f.future = work.get_future()
        except RuntimeError:
            pass
        return
    if _blocking_wait():
        return
    st = _stream("end", f.device)
    with torch.cuda.stream(st):
        work.wait()
        f.marks.append(_mark(f, st))
    f.tiers.append(None)
    f.end = f.marks[-1]


def wait(f: Optional[Flight], work) -> None:
    """The host's wait for an issued collective. On gloo the work's future
    is polled, so the watchdog's abort ends the wait, and its end is the
    first reading that found it complete; then ``work.wait()`` (which
    raises a failure of the backend). The end is marked here where
    ``issued`` could not; ``done`` is now."""
    check()
    if f is not None and f.future is not None:
        delay = 1e-5
        while not f.future.done():
            check()
            time.sleep(delay)
            delay = min(2 * delay, 1e-3)
    work.wait()
    if f is None:
        return
    if f.end is None:
        segment(f)
        f.end = f.marks[-1]
    f.done_ns = time.monotonic_ns()
    resolve()


def count_wire(nbytes: int, tensor: torch.Tensor,
               tier: Optional[str] = None) -> None:
    """``horovod_wire_bytes_total``: at a compressed wire dtype
    (``plane="eager"``) or on a tier of the ladder."""
    if _capturing(tensor):
        return
    labels = {"tier": tier} if tier else {"plane": "eager"}
    _metric("counter", "horovod_wire_bytes_total",
            "gradient payload bytes moved at the compressed wire dtype"
            if not tier else "bytes sent per fabric tier (local = ICI, "
            "cross = DCN)", **labels).inc(nbytes)


def count_error(op: str) -> None:
    _metric("counter", "horovod_collective_errors_total",
            "collectives finished with an error", op=op).inc()


def _ns(f: Flight, mark) -> int:
    if not f.cuda:
        return int(mark)
    ev, host = f.anchor
    return host + int(round(ev.elapsed_time(mark) * 1e6))


def resolve() -> None:
    """Emit every collective that completed and was waited for: its device
    seconds and, with a recorder, its spans."""
    if not _s.timing or _s.capturing:
        return
    with _s.lock:
        ready = [f for f in _s.inflight
                 if f.done_ns is not None and f.completed()]
        if not ready:
            return
        gone = set(map(id, ready))
        _s.inflight = [f for f in _s.inflight if id(f) not in gone]
    rec = get_recorder()
    for f in ready:
        try:
            times = [_ns(f, m) for m in f.marks]
        except RuntimeError:
            # An event that cannot be timed: the span is dropped, never
            # replaced by a host time.
            _metric("counter", "horovod_trace_dropped_total",
                    "trace spans dropped (writer failure or span cap)").inc()
            continue
        _metric("histogram", "horovod_collective_seconds",
                "device seconds of a collective, from its input ready to "
                "its end (host seconds on gloo)",
                op=f.op).observe((times[-1] - times[0]) / 1e9)
        if rec is None:
            continue
        rec.span(f.tid, f.name, f.op, "enqueue", times[0])
        for t0, t1, tier in zip(times, times[1:], f.tiers):
            attrs = {"bytes": f.nbytes}
            if tier:
                attrs["tier"] = tier
            rec.span(f.tid, f.name, f.op, "wire", t0, t1, **attrs)
        rec.span(f.tid, f.name, f.op, "done", f.done_ns, ok=True)


class capture_guard:
    """Around a CUDA-graph capture: the completed collectives are written
    first, and the watchdog queries no event while the capture runs."""

    def __enter__(self):
        resolve()
        _s.capturing = True
        return self

    def __exit__(self, *exc):
        _s.capturing = False
        return False


def stall_source() -> list:
    """The watchdog's view: every collective whose end has not completed,
    named by its trace ID (which ranks are missing is unknown here)."""
    from ..metrics.watchdog import StallInfo

    if _s.capturing:
        return []
    now = time.monotonic_ns()
    with _s.lock:
        flights = list(_s.inflight)
    return [StallInfo(name=f.tid, op=f.op, age_s=(now - f.issued_ns) / 1e9)
            for f in flights if not f.completed()]


def abort_stalled(info) -> bool:
    """The watchdog's escalation past HOROVOD_STALL_SHUTDOWN_TIME: every
    later wait or issue raises, and NCCL's
    communicators are aborted (as the elastic reset does), so a wait on
    the card returns; a wait on gloo sees the error at its next poll."""
    from ..common import basics

    shutdown_s = basics.config().stall_shutdown_s if basics.is_initialized() \
        else 0.0
    _s.stall_error = basics.HorovodInternalError(
        f"collective {info.name} ({info.op}) stalled for {info.age_s:.1f}s, "
        f"past HOROVOD_STALL_SHUTDOWN_TIME={shutdown_s:g}s: the "
        "communicators were aborted")
    try:
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_backend() == "nccl":
            dist.distributed_c10d._abort_process_group()
    except Exception:  # noqa: BLE001 - the abort is best effort
        pass
    return True
