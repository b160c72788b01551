"""Runtime configuration read from the environment.

The subset of ``horovod_tpu.common.config`` that the PyTorch port's data
plane reads: the fusion threshold, the bucket count and the wire
compression, with the same env knobs and the same defaults, so one env var
tunes both packages the same way.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

from ..compression import WIRE_DTYPES, normalize

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


def _env_compression() -> str:
    """HOROVOD_COMPRESSION; unknown values warn and mean 'none'."""
    v = os.environ.get("HOROVOD_COMPRESSION", "none").lower() or "none"
    if v not in WIRE_DTYPES:
        print(f"[horovod_tpu_torch/warning] unknown HOROVOD_COMPRESSION={v!r}; "
              f"expected one of {sorted(WIRE_DTYPES)}; using 'none'",
              file=sys.stderr)
        return "none"
    return normalize(v)


@dataclass
class Config:
    fusion_threshold: int = DEFAULT_FUSION_THRESHOLD    # HOROVOD_FUSION_THRESHOLD
    num_buckets: int = DEFAULT_NUM_BUCKETS              # HOROVOD_NUM_BUCKETS
    compression: str = "none"                           # HOROVOD_COMPRESSION
    compression_min_bytes: int = DEFAULT_COMPRESSION_MIN_BYTES  # HOROVOD_COMPRESSION_MIN_BYTES

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
        )
