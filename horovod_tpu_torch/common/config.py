"""Runtime configuration read from the environment.

The subset of ``horovod_tpu.common.config`` that the PyTorch port's data
plane reads: the fusion threshold, the bucket count, the wire compression,
the hierarchical ladder's switch and DCN-tier bucket cap, the sharded
layout, the latency-hiding switch, the elastic switch, the stall
watchdog's times (the shutdown time also bounds a collective's wait
under the elastic switch), the tracing and metrics exposition knobs, and
the eager engines' (``common/engine.py`` and the native core,
``cc/native_engine.py``: cycle time, timeline, response cache, ring plane,
error feedback, top-k ratio, the same-host shm links, the engine-embedded
autotuner and the knobs the environment pinned), with the same env knobs
and the same defaults, so one env var tunes both packages the same way.
The engine's cache, ring and compression fields read the env also when a
``Config`` is built directly, as the JAX package's do. Three knobs are read where the JAX package's compiled plane
reads them, when the wires are chosen: HOROVOD_DCN_COMPRESSION
(``env_dcn_compression``), HOROVOD_TOPK_RATIO
(``compression.topk_ratio_from_env``) and HOROVOD_TOPK_MIN_BYTES
(``common/policy.py``).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

from ..compression import WIRE_DTYPES, parse_spec

# Default tensor fusion threshold: 64 MiB (the reference's default).
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
# 1 keeps the single greedy pass; K > 1 plans K reverse-order buckets.
DEFAULT_NUM_BUCKETS = 1
# Buckets below this byte size skip wire compression: the cast pair costs
# more than it saves, and scalars keep full precision.
DEFAULT_COMPRESSION_MIN_BYTES = 4096
# The eager engine's negotiation cycle: 5 ms (the reference's default).
DEFAULT_CYCLE_TIME_MS = 5.0


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.lower() not in ("0", "false", "no")


def _env_compression() -> str:
    """HOROVOD_COMPRESSION; ``topk@<ratio>`` specs are kept as they are.
    Unknown values warn and mean 'none'."""
    v = os.environ.get("HOROVOD_COMPRESSION", "none").lower() or "none"
    if v not in WIRE_DTYPES and parse_spec(v) == ("none", None):
        print(f"[horovod_tpu_torch/warning] unknown HOROVOD_COMPRESSION={v!r}; "
              f"expected one of {sorted(WIRE_DTYPES)} or 'topk@<ratio>'; "
              "using 'none'", file=sys.stderr)
        return "none"
    return v


# Stall-check warning period: 60 s (the reference's STALL_WARNING_TIME).
STALL_WARNING_TIME_S = 60.0


def _env_stall_check_time(default: float = STALL_WARNING_TIME_S) -> float:
    """HOROVOD_STALL_CHECK_TIME with HOROVOD_STALL_WARNING_TIME accepted as
    a fallback alias, as the JAX package reads them."""
    v = os.environ.get("HOROVOD_STALL_CHECK_TIME")
    if v not in (None, ""):
        try:
            return float(v)
        except ValueError:
            pass
    return _env_float("HOROVOD_STALL_WARNING_TIME", default)


def env_dcn_compression() -> str:
    """HOROVOD_DCN_COMPRESSION, lower case; "" when unset."""
    return os.environ.get("HOROVOD_DCN_COMPRESSION", "").lower()


def clamp_shm_bytes(v: int) -> int:
    """Mirror of the native clamp (shm_ring.h shm_ring_capacity): power of
    two in [64 KiB, 1 GiB], so config() reports the EFFECTIVE capacity."""
    v = max(1 << 16, min(int(v), 1 << 30))
    p = 1
    while p * 2 <= v:
        p *= 2
    return p


# The knobs whose explicit setting pins them: the native engine's autotuner
# leaves a pinned knob as it is.
PINNABLE = ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_NUM_BUCKETS",
            "HOROVOD_CYCLE_TIME", "HOROVOD_HIERARCHICAL_ALLREDUCE",
            "HOROVOD_HIERARCHICAL_ALLGATHER")


@dataclass
class Config:
    fusion_threshold: int = DEFAULT_FUSION_THRESHOLD    # HOROVOD_FUSION_THRESHOLD
    num_buckets: int = DEFAULT_NUM_BUCKETS              # HOROVOD_NUM_BUCKETS
    compression: str = "none"                           # HOROVOD_COMPRESSION
    compression_min_bytes: int = DEFAULT_COMPRESSION_MIN_BYTES  # HOROVOD_COMPRESSION_MIN_BYTES
    hierarchical_allreduce: bool = False                # HOROVOD_HIERARCHICAL_ALLREDUCE
    # The DCN tier's bucket cap; 0 means none of its own. Its wire dtype,
    # HOROVOD_DCN_COMPRESSION, is read where the wires are chosen
    # (parallel/fusion.py tier_wires), as the reference reads it.
    dcn_fusion_threshold: int = 0                       # HOROVOD_DCN_FUSION_THRESHOLD
    # Sharded data parallelism: the ('batch', 'shard'[, 'model']) shape as
    # "<b>", "<b>x<s>" or "<b>x<s>x<m>" (empty: pure DP), and the switch
    # that puts DistributedOptimizer on the reduce-scatter exchange.
    mesh: str = ""                                      # HOROVOD_MESH
    shard_params: bool = False                          # HOROVOD_SHARD_PARAMS
    # The reference's switch for XLA's latency-hiding scheduler; here it
    # starts each bucket's exchange from the gradient hooks as soon as the
    # bucket's last gradient lands (optimizer.py).
    latency_hiding: bool = False                        # HOROVOD_LATENCY_HIDING
    # Set by the elastic launcher in its workers' env: the world may be
    # torn down and re-formed (elastic/run.py), so the layouts that it
    # cannot carry across a reset refuse to build.
    elastic: bool = False                               # HOROVOD_ELASTIC
    # Seconds a collective may stay in flight before the stall watchdog
    # aborts the communicators (0: never), and the process group's timeout
    # under HOROVOD_ELASTIC (0: the default).
    stall_shutdown_s: float = 0.0                       # HOROVOD_STALL_SHUTDOWN_TIME
    # The stall watchdog: off switch and warning period.
    stall_check_disable: bool = False                   # HOROVOD_STALL_CHECK_DISABLE
    # HOROVOD_STALL_CHECK_TIME (alias: HOROVOD_STALL_WARNING_TIME)
    stall_warning_s: float = STALL_WARNING_TIME_S
    # Per-rank span files of the collectives (empty: no spans).
    trace_dir: str = ""                                 # HOROVOD_TRACE_DIR
    # Rank r serves /metrics at this port + its local rank (0: off).
    metrics_port: int = 0                               # HOROVOD_METRICS_PORT
    # The eager engine (common/engine.py).
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS        # HOROVOD_CYCLE_TIME
    timeline: str = ""                                  # HOROVOD_TIMELINE
    timeline_mark_cycles: bool = False                  # HOROVOD_TIMELINE_MARK_CYCLES
    # The two-stage allgather: the native engine runs it; the Python engine
    # warns and runs the allgather flat.
    hierarchical_allgather: bool = False                # HOROVOD_HIERARCHICAL_ALLGATHER
    cache_capacity: int = field(                        # HOROVOD_CACHE_CAPACITY (0 disables)
        default_factory=lambda: max(
            0, _env_int("HOROVOD_CACHE_CAPACITY", 1024)))
    ring_data_plane: bool = field(                      # HOROVOD_RING_DATA_PLANE (0 disables)
        default_factory=lambda: _env_bool("HOROVOD_RING_DATA_PLANE", True))
    compression_error_feedback: bool = field(           # HOROVOD_COMPRESSION_ERROR_FEEDBACK
        default_factory=lambda: _env_bool(
            "HOROVOD_COMPRESSION_ERROR_FEEDBACK", False))
    # 0.0: unset, resolved to HOROVOD_TOPK_RATIO or 1% at use.
    topk_ratio: float = field(                          # HOROVOD_TOPK_RATIO
        default_factory=lambda: _env_float("HOROVOD_TOPK_RATIO", 0.0))

    # Shared-memory data plane for same-host ring links of the native engine
    # (cc/src/shm_ring.h). The native binding exports these into the env
    # right before engine init; env-aware defaults, so that a Config built
    # directly honours HOROVOD_SHM=0 from the launcher env.
    shm: bool = field(                                  # HOROVOD_SHM (0 disables)
        default_factory=lambda: _env_bool("HOROVOD_SHM", True))
    shm_bytes: int = field(                             # HOROVOD_SHM_BYTES
        default_factory=lambda: clamp_shm_bytes(
            _env_int("HOROVOD_SHM_BYTES", 16 << 20)))
    # The native engine's embedded autotuner (cc/src/autotuner.h).
    autotune: bool = False                              # HOROVOD_AUTOTUNE
    autotune_log: str = ""                              # HOROVOD_AUTOTUNE_LOG
    # Which of PINNABLE the environment set: the autotuner leaves them.
    pinned: set = field(default_factory=set)

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls(
            fusion_threshold=_env_int("HOROVOD_FUSION_THRESHOLD",
                                      DEFAULT_FUSION_THRESHOLD),
            num_buckets=max(1, _env_int("HOROVOD_NUM_BUCKETS",
                                        DEFAULT_NUM_BUCKETS)),
            compression=_env_compression(),
            compression_min_bytes=max(0, _env_int(
                "HOROVOD_COMPRESSION_MIN_BYTES",
                DEFAULT_COMPRESSION_MIN_BYTES)),
            hierarchical_allreduce=_env_bool("HOROVOD_HIERARCHICAL_ALLREDUCE"),
            dcn_fusion_threshold=max(0, _env_int(
                "HOROVOD_DCN_FUSION_THRESHOLD", 0)),
            mesh=os.environ.get("HOROVOD_MESH", "").strip(),
            shard_params=_env_bool("HOROVOD_SHARD_PARAMS"),
            latency_hiding=_env_bool("HOROVOD_LATENCY_HIDING"),
            elastic=os.environ.get("HOROVOD_ELASTIC") == "1",
            stall_shutdown_s=max(0.0, _env_float("HOROVOD_STALL_SHUTDOWN_TIME",
                                                 0.0)),
            stall_check_disable=_env_bool("HOROVOD_STALL_CHECK_DISABLE"),
            stall_warning_s=_env_stall_check_time(),
            trace_dir=os.environ.get("HOROVOD_TRACE_DIR", ""),
            metrics_port=_env_int("HOROVOD_METRICS_PORT", 0),
            cycle_time_ms=_env_float("HOROVOD_CYCLE_TIME",
                                     DEFAULT_CYCLE_TIME_MS),
            timeline=os.environ.get("HOROVOD_TIMELINE", ""),
            timeline_mark_cycles=_env_bool("HOROVOD_TIMELINE_MARK_CYCLES"),
            hierarchical_allgather=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLGATHER"),
            autotune=_env_bool("HOROVOD_AUTOTUNE"),
            autotune_log=os.environ.get("HOROVOD_AUTOTUNE_LOG", ""),
        )
        cfg.pinned.update(v for v in PINNABLE
                          if os.environ.get(v) not in (None, ""))
        return cfg
