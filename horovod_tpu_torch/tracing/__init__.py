"""Pod-wide distributed tracing of the port: the counterpart of
``horovod_tpu.tracing``.

Set ``HOROVOD_TRACE_DIR=/path`` and every collective of the port gets a
trace ID at issue, ``<name>#<seq>``, deterministic and identical across
ranks because every rank issues the same collectives in the same order.
The exchange names bucket ``b`` ``grad.<b>``; other collectives take the
caller's ``name=`` or their op. Each collective records ``enqueue`` (the
device time its input was ready, from the first of a pair of CUDA events
on its stream), ``wire`` (both events; the hierarchical ladder one span
per tier, ZeRO one per scatter and gather) and ``done`` (when the host's
wait returned); on gloo the times are host clocks
(``parallel/collectives.py``). A CUDA-graph capture records no span, and
writes its plan once (``record_compiled_plan``). Workflow:

    python -m horovod_tpu_torch.tracing.collector /tmp/trace --critical-path

writes one clock-aligned Perfetto/Chrome ``trace.json`` and prints the
per-phase straggler attribution (``critical_path.py``). The flight ring
(``flight.py``) keeps the last records of every process, and
``python -m horovod_tpu_torch.tracing.bundle`` sweeps rings, dumps and
the merged trace into one directory.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .clock import estimate_offset_ns  # noqa: F401
from .collector import build_trace, load_spans, merge_trace  # noqa: F401
from .critical_path import (  # noqa: F401
    PHASES,
    analyze,
    analyze_dir,
    export_gauges,
    format_summary,
)
from .flight import (  # noqa: F401
    FlightRecorder,
    config_fingerprint,
    get_flight,
    init_flight,
    read_ring,
)
from .recorder import (  # noqa: F401
    TraceRecorder,
    proc_span_path,
    span_path,
    trace_id,
)
from .serve import (  # noqa: F401
    ServeTracer,
    get_serve_tracer,
    init_serve_tracer,
    serve_trace_id,
)

_lock = threading.Lock()
_recorder: Optional[TraceRecorder] = None


def trace_dir_from_env() -> str:
    return os.environ.get("HOROVOD_TRACE_DIR", "")


def init_recorder(trace_dir: str, rank: int) -> Optional[TraceRecorder]:
    """Open (or return) this process's span recorder. Idempotent per
    process; a later call with a different directory re-points it (elastic
    re-init)."""
    global _recorder
    if not trace_dir:
        return None
    with _lock:
        if _recorder is not None and _recorder.path == span_path(trace_dir,
                                                                 rank):
            return _recorder
        if _recorder is not None:
            _recorder.close()
        _recorder = TraceRecorder(span_path(trace_dir, rank), rank)
        return _recorder


def get_recorder() -> Optional[TraceRecorder]:
    """The process recorder, or None when tracing is off."""
    return _recorder


def close_recorder() -> None:
    global _recorder
    with _lock:
        if _recorder is not None:
            _recorder.close()
            _recorder = None


def record_compiled_plan(num_buckets: int, bucket_bytes: list,
                         compression: str = "none",
                         wire_flags: Optional[list] = None, **extra) -> None:
    """Annotation of a fusion plan: drop the bucket geometry into the trace
    directory so the merged pod trace can be read next to the device
    profile. ``DistributedOptimizer`` writes it once per plan, and
    ``loop.py`` once per CUDA-graph capture (with ``capture=<n>`` in
    ``extra``), the port's counterpart of a compile. No-op when tracing is
    off; never raises (annotation must not break a capture)."""
    trace_dir = trace_dir_from_env()
    if not trace_dir:
        return
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    rec = {
        "compiled_plan": 1,
        "rank": rank,
        "time_unix_s": time.time(),
        "num_buckets": int(num_buckets),
        "bucket_bytes": [int(b) for b in bucket_bytes],
        "compression": str(compression),
        "wire_compressed": [bool(w) for w in (wire_flags or [])],
        **extra,
    }
    try:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"compiled-plan-rank{rank}.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass
