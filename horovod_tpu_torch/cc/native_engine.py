"""ctypes wrapper over the native core (``libhvd_core``, built from
``cc/src`` by ``cc/__init__.py``): the eager engine in C++.

Presents the same interface as the Python ``PyEngine``
(``common/engine.py``): enqueue/poll/synchronize/run/shutdown, so that
``basics.engine()`` attaches either. Its wire is the JAX package's native
core's byte for byte, so a world may mix the two packages' native engines.

bfloat16 travels as its 16-bit patterns: ``compression.BFLOAT16`` (and an
``ml_dtypes`` bfloat16, where one is installed) map to the core's dtype 5,
and a bfloat16 result comes back as ``compression.BFLOAT16``.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Any, Optional

import numpy as np

from . import lib_path
from ..common.config import clamp_shm_bytes
# Shared exception types: user except clauses must match regardless of which
# engine implementation is active.
from ..common.engine import (HorovodInternalError, StoreRendezvous,  # noqa: F401
                             TensorShapeMismatchError)
from ..compression import BFLOAT16, normalize as _comp_normalize
from ..metrics import registry as _metrics_registry
from ..metrics.registry import DEFAULT_BYTE_BUCKETS

# Order in sync with hvd_common.h.
OPS = {"allreduce": 0, "allgather": 1, "broadcast": 2, "reducescatter": 3, "alltoall": 4}
DTYPES = ["uint8", "int8", "int32", "int64", "float16", "bfloat16", "float32", "float64", "bool"]
_STATUS_NAMES = {1: "UnknownError", 2: "PreconditionError", 3: "Aborted", 4: "InvalidArgument"}

# c_api.cc copies result shapes into a fixed 64-slot buffer (numpy's own
# maximum is 64 dims, NPY_MAXDIMS).
MAX_NDIM = 64

# Named counters the C++ engine exports through hvd_metric (c_api.cc); the
# collector mirrors each into the Python metrics registry as
# horovod_native_<name>.
NATIVE_METRICS = (
    "allreduce_count", "allgather_count", "broadcast_count",
    "reducescatter_count", "alltoall_count", "collective_bytes",
    "collective_errors", "negotiation_us", "execution_us",
    "stall_warnings", "cycles", "timeline_dropped",
    "cache_hits", "cache_misses", "wire_bytes", "wire_bytes_saved",
    "topk_wire_bytes", "topk_wire_bytes_saved",
)


BF16_ID = DTYPES.index("bfloat16")


def _np_dtype_id(dt: np.dtype) -> int:
    if dt == BFLOAT16:
        return BF16_ID
    name = dt.name
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name}")
    return DTYPES.index(name)


def _dtype_from_id(i: int) -> np.dtype:
    return BFLOAT16 if i == BF16_ID else np.dtype(DTYPES[i])


def _load():
    lib = ctypes.CDLL(lib_path())
    lib.hvd_init.restype = ctypes.c_int
    lib.hvd_init.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
        ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    for fn in ("hvd_knob_version", "hvd_ring_passes", "hvd_ring_bytes_sent",
               "hvd_ring_cross_bytes_sent", "hvd_fusion_threshold"):
        getattr(lib, fn).restype = ctypes.c_longlong
        getattr(lib, fn).argtypes = []
    for fn in ("hvd_hier_allreduce_on", "hvd_hier_allgather_on",
               "hvd_hier_capable"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = []
    lib.hvd_cycle_time_ms.restype = ctypes.c_double
    lib.hvd_cycle_time_ms.argtypes = []
    lib.hvd_metric.restype = ctypes.c_longlong
    lib.hvd_metric.argtypes = [ctypes.c_char_p]
    lib.hvd_last_stall.restype = ctypes.c_int
    lib.hvd_last_stall.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.hvd_cache_size.restype = ctypes.c_int
    lib.hvd_cache_size.argtypes = []
    lib.hvd_compression.restype = ctypes.c_int
    lib.hvd_compression.argtypes = []
    lib.hvd_cache_flush.restype = None
    lib.hvd_cache_flush.argtypes = []
    lib.hvd_set_wire_format.restype = ctypes.c_int
    lib.hvd_set_wire_format.argtypes = [ctypes.c_char_p, ctypes.c_double]
    lib.hvd_timeline_start.restype = ctypes.c_int
    lib.hvd_timeline_start.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.hvd_timeline_stop.restype = None
    lib.hvd_timeline_stop.argtypes = []
    lib.hvd_trace_enabled.restype = ctypes.c_int
    lib.hvd_trace_enabled.argtypes = []
    lib.hvd_trace_drain.restype = ctypes.c_longlong
    lib.hvd_trace_drain.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.hvd_shutdown.restype = None
    lib.hvd_shm_links.restype = ctypes.c_int
    lib.hvd_shm_links.argtypes = []
    lib.hvd_coord_listen.restype = ctypes.c_int
    lib.hvd_coord_listen.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int]
    lib.hvd_enqueue.restype = ctypes.c_longlong
    lib.hvd_enqueue.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.hvd_poll.restype = ctypes.c_int
    lib.hvd_poll.argtypes = [ctypes.c_longlong]
    lib.hvd_wait.restype = ctypes.c_int
    lib.hvd_wait.argtypes = [
        ctypes.c_longlong, ctypes.c_double, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.hvd_fetch.restype = ctypes.c_int
    lib.hvd_fetch.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
    lib.hvd_release.restype = None
    lib.hvd_release.argtypes = [ctypes.c_longlong]
    return lib


class NativeEngine:
    """Drop-in replacement for PyEngine backed by the C++ core.

    ``rendezvous`` (a ``StoreRendezvous``) locates the coordinator through
    a store, as for ``PyEngine``: rank 0's core binds a port the kernel
    picks (``hvd_coord_listen``) and publishes ``host:port`` under the key
    before its init waits for the other ranks; without one, rank 0 binds
    ``HOROVOD_COORD_ADDR``. ``watchdog`` is accepted for the interface and
    not used: the core checks for stalls itself and names the missing
    ranks."""

    def __init__(self, topo, config,
                 rendezvous: Optional[StoreRendezvous] = None,
                 watchdog=None) -> None:
        self.topo = topo
        self.config = config
        self._lib = _load()
        self._knob_epoch_seen = 0   # local set_knobs applies
        host, port = "", 0
        if topo.size > 1:
            addr = os.environ.get("HOROVOD_COORD_ADDR")
            if rendezvous is not None:
                host, port = self._coordinator_via_store(rendezvous)
            elif addr:
                host, p = addr.rsplit(":", 1)
                port = int(p)
            else:
                raise HorovodInternalError(
                    "multi-process eager collectives need the world of "
                    "init() (its store carries the coordinator's address) "
                    "or HOROVOD_COORD_ADDR (set by the launcher)"
                )
        # The shm knobs cross into C++ via the env (shm_enabled() /
        # shm_ring_capacity() read getenv at link-establish time, and are
        # deliberately uncached so this works on re-init too): export the
        # Config values so Config(shm=..., shm_bytes=...) behaves like every
        # other field instead of silently deferring to the ambient env.
        os.environ["HOROVOD_SHM"] = "1" if getattr(config, "shm", True) else "0"
        os.environ["HOROVOD_SHM_BYTES"] = str(
            clamp_shm_bytes(getattr(config, "shm_bytes", 16 << 20)))
        # The response-cache capacity crosses into C++ the same way (cache.h
        # cache_capacity_from_env reads getenv at coordinator construction).
        os.environ["HOROVOD_CACHE_CAPACITY"] = str(
            max(0, int(getattr(config, "cache_capacity", 1024))))
        # And the wire-compression knobs (engine.h wire_dtype_from_env /
        # sparse_spec_from_env, read at Engine construction): export the
        # Config values so Config(compression=...) behaves like every
        # other field. The native core implements the full format surface:
        # bf16/fp16 casts, topk select/pack/index-merge with error-feedback
        # residuals, and the adaptive per-tensor table.
        _comp = str(getattr(config, "compression", "none") or "none")
        os.environ["HOROVOD_COMPRESSION"] = _comp
        _ratio = float(getattr(config, "topk_ratio", 0.0) or 0.0)
        if _ratio > 0:
            os.environ["HOROVOD_TOPK_RATIO"] = repr(_ratio)
        os.environ["HOROVOD_COMPRESSION_MIN_BYTES"] = str(
            int(getattr(config, "compression_min_bytes", 4096) or 4096))
        if getattr(config, "compression_error_feedback", False):
            # Only an explicit True is exported: an UNSET env means
            # "EF defaults on for topk, off for the casts" on both sides
            # of the bridge, and writing "0" here would clobber that.
            os.environ["HOROVOD_COMPRESSION_ERROR_FEEDBACK"] = "1"
        # Distributed tracing: same env crossing as the knobs
        # above (the C++ engine reads HOROVOD_TRACE_DIR at construction).
        trace_dir = getattr(config, "trace_dir", "") or ""
        os.environ["HOROVOD_TRACE_DIR"] = trace_dir
        err = ctypes.create_string_buffer(1024)
        timeline = config.timeline if topo.rank == 0 else ""
        pinned = getattr(config, "pinned", set())
        rc = self._lib.hvd_init(
            topo.rank, topo.size, topo.local_rank, topo.local_size,
            topo.cross_rank, topo.cross_size, host.encode(), port,
            float(config.cycle_time_ms), int(config.fusion_threshold),
            timeline.encode(), int(config.timeline_mark_cycles),
            int(config.stall_check_disable),
            float(getattr(config, "stall_warning_s", 60.0)),
            int(getattr(config, "autotune", False)),
            str(getattr(config, "autotune_log", "") or "").encode(),
            int("HOROVOD_FUSION_THRESHOLD" in pinned),
            int("HOROVOD_CYCLE_TIME" in pinned),
            int(getattr(config, "hierarchical_allreduce", False)),
            int(getattr(config, "hierarchical_allgather", False)),
            int("HOROVOD_HIERARCHICAL_ALLREDUCE" in pinned),
            int("HOROVOD_HIERARCHICAL_ALLGATHER" in pinned), err, 1024,
        )
        if rc != 0:
            raise HorovodInternalError(f"native init failed: {err.value.decode()}")
        # Pull-model telemetry: the C++ core keeps lock-free atomics
        # (EngineMetrics, engine.h); this collector copies them into the
        # process-wide registry right before every snapshot/render, so
        # native and Python engines expose one metrics surface.
        self._registry = _metrics_registry()
        self._registry.register_collector(self._collect_metrics)
        # Last native counter values seen by the collector: the registry
        # series are Prometheus counters (inc-only), so the collector feeds
        # them the DELTA since its previous scrape.
        self._cache_last = {"cache_hits": 0, "cache_misses": 0}
        self._wire_last = {"wire_bytes": 0, "wire_bytes_saved": 0}
        self._tier_last = {"total": 0, "cross": 0}
        # Method-labeled savings: the native counters split the
        # sparse (topk) subset out of the wire totals, so the collector can
        # feed the SAME horovod_wire_bytes_saved_total{method=...} series
        # the Python engine labels per format.
        self._method_last: dict[str, int] = {}
        self._cast_method = {"bf16": "bf16", "fp16": "fp16",
                             "adaptive": "bf16"}.get(
            _comp_normalize(getattr(config, "compression", "none")))
        # handle -> (op, nbytes, enqueue time): feeds the SAME per-op
        # count/bytes/latency series the Python engine emits
        # (horovod_collective_*), so dashboards read one surface no matter
        # which engine implementation is active. The C++ core's own
        # counters (horovod_native_*) remain the background-thread view —
        # this layer measures the caller-visible enqueue->synchronize time.
        self._pending: dict[int, tuple] = {}
        # Distributed tracing: this rank's span recorder; the C++ core's
        # spans (hvd_trace_drain) are appended through it so ONE writer owns
        # the file. Drained on every metrics collection and at shutdown.
        self._trace = None
        self._trace_buf = None
        if trace_dir:
            from ..tracing import init_recorder

            self._trace = init_recorder(trace_dir, topo.rank)
            self._trace_buf = ctypes.create_string_buffer(1 << 20)

    def _coordinator_via_store(self, rv: StoreRendezvous) -> tuple[str, int]:
        """Rank 0's core binds the coordinator's listener on ``rv.host`` at
        a port the kernel picks and publishes ``host:port`` under
        ``rv.key``; every rank reads it there."""
        if self.topo.rank == 0:
            err = ctypes.create_string_buffer(512)
            port = int(self._lib.hvd_coord_listen(
                rv.host.encode(), self.topo.size + 4, err, 512))
            if port < 0:
                raise HorovodInternalError(
                    f"native coordinator bind failed: {err.value.decode()}")
            rv.store.set(rv.key, f"{rv.host}:{port}")
        host, port = rv.store.get(rv.key).decode().rsplit(":", 1)
        return host, int(port)

    def enqueue(self, op: str, array: np.ndarray, name: Optional[str] = None,
                root_rank: int = 0, average: bool = True) -> int:
        if op == "allgather" and np.asarray(array).ndim == 0:
            # np.ascontiguousarray would silently promote the scalar to (1,)
            raise HorovodInternalError(
                "Allgather requires tensors of rank >= 1 (got a scalar)")
        arr = np.ascontiguousarray(array)
        if arr.dtype.name == "bfloat16":  # an ml_dtypes array: its patterns
            arr = arr.view(BFLOAT16)
        if arr.ndim > MAX_NDIM:
            raise ValueError(f"tensor rank {arr.ndim} exceeds maximum {MAX_NDIM}")
        shape = (ctypes.c_longlong * arr.ndim)(*arr.shape)
        err = ctypes.create_string_buffer(512)
        h = self._lib.hvd_enqueue(
            OPS[op], (name or "").encode(), _np_dtype_id(arr.dtype), shape, arr.ndim,
            arr.ctypes.data_as(ctypes.c_void_p), root_rank, int(average),
            err, 512,
        )
        if h < 0:
            raise HorovodInternalError(f"enqueue failed: {err.value.decode()}")
        self._registry.counter(
            "horovod_collectives_enqueued_total",
            help="collectives submitted to the eager engine", op=op).inc()
        # `arr` rides along to PIN the buffer: the zero-copy hot path
        # borrows uncompressed allreduce contributions instead
        # of copying them into the tensor table, so the bytes must stay
        # alive — and unmutated, the standing collective contract — until
        # the handle completes (_observe_done drops the reference).
        self._pending[int(h)] = (op, int(arr.nbytes), time.monotonic(), arr)
        return int(h)

    def poll(self, handle: int) -> bool:
        return bool(self._lib.hvd_poll(handle))

    def synchronize(self, handle: int, timeout: Optional[float] = None) -> Any:
        dtype_out = ctypes.c_int()
        ndim_out = ctypes.c_int()
        nbytes_out = ctypes.c_longlong()
        shape_out = (ctypes.c_longlong * MAX_NDIM)()
        err = ctypes.create_string_buffer(1024)
        # C side: timeout < 0 = wait forever, 0 = immediate poll.
        rc = self._lib.hvd_wait(
            handle, -1.0 if timeout is None else float(timeout),
            ctypes.byref(dtype_out), shape_out,
            MAX_NDIM, ctypes.byref(ndim_out), ctypes.byref(nbytes_out), err, 1024,
        )
        if rc != 0:
            msg = err.value.decode() or _STATUS_NAMES.get(rc, f"status {rc}")
            if rc == 5:  # IN_PROGRESS: still in flight, handle stays valid
                raise TimeoutError(msg)
            self._observe_done(handle, ok=False)
            if rc == 2:
                raise TensorShapeMismatchError(msg)
            raise HorovodInternalError(msg)
        self._observe_done(handle, ok=True)
        shape = tuple(shape_out[i] for i in range(ndim_out.value))
        out = np.empty(shape, dtype=_dtype_from_id(dtype_out.value))
        assert out.nbytes == nbytes_out.value, (out.nbytes, nbytes_out.value)
        rc = self._lib.hvd_fetch(
            handle, out.ctypes.data_as(ctypes.c_void_p), out.nbytes
        )
        if rc != 0:
            raise HorovodInternalError(f"fetch failed rc={rc}")
        return out

    def run(self, op: str, array: np.ndarray, name: str, **kw) -> Any:
        return self.synchronize(self.enqueue(op, array, name, **kw))

    def _observe_done(self, handle: int, ok: bool) -> None:
        rec = self._pending.pop(handle, None)
        if rec is None:
            return
        op, nbytes, t0, _pin = rec  # _pin: the borrowed buffer, now free
        if not ok:
            self._registry.counter(
                "horovod_collective_errors_total",
                help="collectives finished with an error", op=op).inc()
            return
        self._registry.counter(
            "horovod_collectives_total",
            help="collectives completed by the eager engine", op=op).inc()
        self._registry.counter(
            "horovod_collective_bytes_total",
            help="tensor bytes processed by completed collectives",
            op=op).inc(nbytes)
        self._registry.histogram(
            "horovod_collective_size_bytes", help="per-collective tensor sizes",
            buckets=DEFAULT_BYTE_BUCKETS, op=op).observe(nbytes)
        self._registry.histogram(
            "horovod_collective_seconds",
            help="enqueue-to-completion wall time (negotiation + "
                 "execution + relay)", op=op).observe(time.monotonic() - t0)

    def stats(self) -> dict:
        """Live engine counters: ring passes executed, bytes sent to the
        next neighbour, autotuner knob state."""
        return {
            "ring_passes": int(self._lib.hvd_ring_passes()),
            "ring_bytes_sent": int(self._lib.hvd_ring_bytes_sent()),
            "ring_cross_bytes_sent": int(self._lib.hvd_ring_cross_bytes_sent()),
            "knob_version": int(self._lib.hvd_knob_version()),
            "fusion_threshold": int(self._lib.hvd_fusion_threshold()),
            "cycle_time_ms": float(self._lib.hvd_cycle_time_ms()),
            "hier_allreduce": int(self._lib.hvd_hier_allreduce_on()),
            "hier_allgather": int(self._lib.hvd_hier_allgather_on()),
            "hier_capable": int(self._lib.hvd_hier_capable()),
            "shm_links": int(self._lib.hvd_shm_links()),
            "wire_dtype": self.wire_dtype(),
        }

    def wire_dtype(self) -> Optional[str]:
        """Name of the HOROVOD_COMPRESSION wire dtype the engine casts
        allreduce payloads to, or None when compression is off."""
        wid = int(self._lib.hvd_compression())
        return DTYPES[wid] if 0 <= wid < len(DTYPES) else None

    def metrics(self) -> dict:
        """Raw native telemetry counters (c_api hvd_metric)."""
        return {name: int(self._lib.hvd_metric(name.encode()))
                for name in NATIVE_METRICS}

    def last_stall(self) -> str:
        """Latest stall-warning text seen by this rank ('' when none)."""
        buf = ctypes.create_string_buffer(4096)
        n = self._lib.hvd_last_stall(buf, 4096)
        return buf.value.decode(errors="replace") if n > 0 else ""

    def cache_stats(self) -> dict:
        """Response-cache counters, same shape as PyEngine.cache_stats
        (the native data plane is always the peer ring)."""
        hits = int(self._lib.hvd_metric(b"cache_hits"))
        misses = int(self._lib.hvd_metric(b"cache_misses"))
        comp = _comp_normalize(getattr(self.config, "compression", "none"))
        if comp not in ("topk", "adaptive") and self.wire_dtype() is None:
            comp = "none"  # unknown names degraded to dense at the parser
        return {
            "enabled": int(getattr(self.config, "cache_capacity", 1024)) > 0,
            "ring_active": self.topo.size > 1,
            "compression": comp,
            "plane": ("hier" if int(self._lib.hvd_hier_allreduce_on())
                      else "ring") if self.topo.size > 1 else "star",
            "mirror": {"size": int(self._lib.hvd_cache_size()),
                       "hits": max(hits, 0), "misses": max(misses, 0)},
        }

    def cache_flush(self) -> None:
        """Drop this rank's cached negotiations (elastic reset path); the
        mirror self-heals from the coordinator's re-announcements."""
        self._lib.hvd_cache_flush()

    # -- live knob retuning ---------------------------------------------------

    def set_knobs(self, table: dict) -> int:
        """Apply a knob table to the native core. Rank-LOCAL: the C++
        coordinator has no knob-epoch protocol yet, so a multi-process
        caller (the runtime controller) must invoke this on every rank at
        the same step boundary — the Python engine's set_knobs is the
        epoch-coordinated path. Returns the local knob-apply count."""
        fn = self._lib.hvd_set_wire_format
        comp = table.get("compression")
        ratio = float(table.get("topk_ratio", 0.0) or 0.0)
        if comp is None and not ratio:
            return self._knob_epoch_seen
        if comp is None:
            comp = str(getattr(self.config, "compression", "none") or
                       "none")
        if not int(fn(str(comp).encode(), ratio)):
            raise HorovodInternalError("native engine not initialized")
        self._knob_epoch_seen += 1
        return self._knob_epoch_seen

    def knob_epoch(self) -> int:
        return self._knob_epoch_seen

    def trace_drain(self) -> int:
        """Move pending native span records into this rank's span file;
        returns the number of drained lines. Safe no-op when tracing is off
        or the engine is gone."""
        if self._trace is None:
            return 0
        import json as _json

        total = 0
        while True:
            n = int(self._lib.hvd_trace_drain(self._trace_buf,
                                              len(self._trace_buf)))
            if n <= 0:
                break
            for line in self._trace_buf.raw[:n].decode(
                    errors="replace").splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    self._trace.emit_raw(_json.loads(line))
                    total += 1
                except ValueError:  # torn line: shed, never raise
                    continue
        return total

    def _collect_metrics(self, reg) -> None:
        self.trace_drain()
        vals = self.metrics()
        if all(v < 0 for v in vals.values()):
            return  # engine already shut down
        for name, v in vals.items():
            if v >= 0:
                reg.gauge(f"horovod_native_{name}",
                          help="native engine counter (cc/src/engine.h "
                               "EngineMetrics)").set(v)
        # Both engines expose ONE response-cache series pair
        # (horovod_engine_cache_{hits,misses}_total): the Python engine
        # increments directly; here the native atomics feed the counters
        # by delta so dashboards read one surface either way.
        for series, native in (("horovod_engine_cache_hits_total", "cache_hits"),
                               ("horovod_engine_cache_misses_total",
                                "cache_misses")):
            v = vals.get(native, -1)
            if v >= 0:
                last = self._cache_last.get(native, 0)
                if v > last:
                    reg.counter(
                        series,
                        help="response-cache negotiations by outcome",
                    ).inc(v - last)
                self._cache_last[native] = max(v, last)
        # Same delta pattern for the wire-compression counters: the native
        # atomics feed the SAME horovod_wire_bytes_* series the Python
        # engine increments directly, labeled by plane.
        for series, native, hlp in (
                ("horovod_wire_bytes_total", "wire_bytes",
                 "gradient payload bytes moved at the compressed wire "
                 "dtype"),
                ("horovod_wire_bytes_saved_total", "wire_bytes_saved",
                 "bytes the compressed wire avoided sending vs the "
                 "uncompressed plane")):
            v = vals.get(native, -1)
            if v >= 0:
                last = self._wire_last.get(native, 0)
                if v > last:
                    reg.counter(series, help=hlp,
                                plane="native").inc(v - last)
                self._wire_last[native] = max(v, last)
        # Per-method savings: the topk subset feeds method="topk"; the
        # remainder (16-bit casts) feeds the configured cast format, so
        # dashboards attribute the win per method whichever engine ran.
        topk_saved = vals.get("topk_wire_bytes_saved", -1)
        total_saved = vals.get("wire_bytes_saved", -1)
        for method, v in (
                ("topk", topk_saved),
                (self._cast_method,
                 total_saved - max(topk_saved, 0)
                 if total_saved >= 0 else -1)):
            if method is None or v < 0:
                continue
            last = self._method_last.get(method, 0)
            if v > last:
                reg.counter(
                    "horovod_wire_bytes_saved_total",
                    help="bytes avoided per compression method "
                         "(bf16/fp16 casts vs topk sparse frames)",
                    method=method).inc(v - last)
            self._method_last[method] = max(v, last)
        # Per-fabric-tier wire bytes: the native ring stats split
        # total vs cross-host bytes; the deltas feed the SAME
        # horovod_wire_bytes_total{tier=...} series the Python engine's
        # data plane increments directly, so the hier A/B reads one
        # surface whichever engine is active.
        try:
            total = int(self._lib.hvd_ring_bytes_sent())
            cross = int(self._lib.hvd_ring_cross_bytes_sent())
        except Exception:  # pragma: no cover - engine gone mid-scrape
            total = cross = -1
        if total >= 0 and cross >= 0:
            d_total = total - self._tier_last["total"]
            d_cross = cross - self._tier_last["cross"]
            if d_cross > 0:
                reg.counter(
                    "horovod_wire_bytes_total",
                    help="eager data-plane bytes sent per fabric tier "
                         "(local = same host, cross = host boundary)",
                    tier="cross").inc(d_cross)
            if d_total - d_cross > 0:
                reg.counter(
                    "horovod_wire_bytes_total",
                    help="eager data-plane bytes sent per fabric tier "
                         "(local = same host, cross = host boundary)",
                    tier="local").inc(d_total - d_cross)
            self._tier_last["total"] = max(total, self._tier_last["total"])
            self._tier_last["cross"] = max(cross, self._tier_last["cross"])
        stall = self.last_stall()
        if stall:
            reg.set_info("stall_report", {
                "rank": self.topo.rank, "source": "native", "text": stall})

    def timeline_start(self, path: str, mark_cycles: bool = False) -> int:
        """Scoped timeline attach (hvd.timeline.trace): 1 if this call
        opened it (caller owns the stop), 0 otherwise."""
        return int(self._lib.hvd_timeline_start(path.encode(),
                                                int(mark_cycles)))

    def timeline_stop(self) -> None:
        self._lib.hvd_timeline_stop()

    def shutdown(self) -> None:
        _metrics_registry().unregister_collector(self._collect_metrics)
        self.trace_drain()  # final spans, while the engine still answers
        self._lib.hvd_shutdown()
        if self._trace is not None:
            self._trace.flush()
