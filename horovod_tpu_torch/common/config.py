"""Runtime configuration read from the environment.

The subset of ``horovod_tpu.common.config`` that the PyTorch port's data
plane reads: the fusion threshold, the bucket count, the wire compression,
the hierarchical ladder's switch and DCN-tier bucket cap, the sharded
layout and the latency-hiding switch, with the
same env knobs and the same defaults, so one env var tunes both packages
the same way. Three knobs are read where the JAX package's compiled plane
reads them, when the wires are chosen: HOROVOD_DCN_COMPRESSION
(``env_dcn_compression``), HOROVOD_TOPK_RATIO
(``compression.topk_ratio_from_env``) and HOROVOD_TOPK_MIN_BYTES
(``common/policy.py``).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

from ..compression import WIRE_DTYPES, parse_spec

# Default tensor fusion threshold: 64 MiB (the reference's default).
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
# 1 keeps the single greedy pass; K > 1 plans K reverse-order buckets.
DEFAULT_NUM_BUCKETS = 1
# Buckets below this byte size skip wire compression: the cast pair costs
# more than it saves, and scalars keep full precision.
DEFAULT_COMPRESSION_MIN_BYTES = 4096


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
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


def env_dcn_compression() -> str:
    """HOROVOD_DCN_COMPRESSION, lower case; "" when unset."""
    return os.environ.get("HOROVOD_DCN_COMPRESSION", "").lower()


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

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
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
        )
