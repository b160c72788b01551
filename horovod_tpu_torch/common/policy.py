"""The adaptive compression policy's value-changing half: the per-tensor,
per-fabric-tier table of ``horovod_tpu.common.policy``.

Every rank evaluates the same inputs (size, dtype, tier, config), so the
ranks agree on each bucket's wire format without a negotiation:

    tier  | tensor                                   | format
    ------+------------------------------------------+-------
    any   | non-float, <=2-byte, < min_bytes          | none
    ici   | everything else                           | none  (full width)
    dcn   | float32 >= HOROVOD_TOPK_MIN_BYTES         | topk
    dcn   | other floats >= min_bytes                 | bf16

The port's collectives have static shapes, so a 'topk' answer ships as
``COMPILED_TOPK_SUBSTITUTE`` (``compiled_tier_format``). The live-telemetry
half (``refresh``, ``sparse_tiers``) steers the host engines' sparse
framing and waits for them.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_COMPRESSION_MIN_BYTES, _env_int
from ..compression import topk_eligible, topk_ratio_from_env

# Below this dense size the DCN tier answers bf16 rather than topk.
DEFAULT_TOPK_MIN_BYTES = 1 << 16

# Canonical tier spellings: the host engines say "local"/"cross", the
# ladder and the docs "ici"/"dcn".
TIER_ALIASES = {"local": "ici", "ici": "ici", "cross": "dcn", "dcn": "dcn"}

# The dense format that a 'topk' answer ships as where frames cannot be
# sparse: the nearest value-reducing format on the same tier.
COMPILED_TOPK_SUBSTITUTE = "bf16"


def _float_itemsize(dtype) -> int:
    """Bytes per element of a float ``dtype`` (torch or numpy), 0 for any
    other dtype (numpy's view of bf16 is not a float kind; either way
    bf16 is at most 2 bytes, which the table treats alike)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize if dtype.is_floating_point else 0
    dtype = np.dtype(dtype)
    return dtype.itemsize if dtype.kind == "f" else 0


class CompressionPolicy:
    """The HOROVOD_COMPRESSION=adaptive table. ``config`` (a
    ``common.config.Config``) supplies min_bytes, 4096 without one; the
    topk ratio and floor are HOROVOD_TOPK_RATIO and HOROVOD_TOPK_MIN_BYTES,
    as in the reference."""

    def __init__(self, config=None) -> None:
        self.min_bytes = int(getattr(config, "compression_min_bytes",
                                     DEFAULT_COMPRESSION_MIN_BYTES)
                             or DEFAULT_COMPRESSION_MIN_BYTES)
        self.topk_ratio = topk_ratio_from_env()
        self.topk_min_bytes = max(self.min_bytes, _env_int(
            "HOROVOD_TOPK_MIN_BYTES", DEFAULT_TOPK_MIN_BYTES))

    def decide(self, nbytes: int, dtype, tier: str) -> str:
        """Wire format for a tensor of ``nbytes`` and ``dtype`` (torch or
        numpy) on ``tier``; unknown tiers count as DCN."""
        if _float_itemsize(dtype) <= 2 or nbytes < self.min_bytes:
            return "none"
        if TIER_ALIASES.get(tier, "dcn") == "ici":
            return "none"
        if nbytes >= self.topk_min_bytes and topk_eligible(
                dtype, nbytes, self.topk_ratio, self.min_bytes):
            return "topk"
        return "bf16"


def compiled_tier_format(nbytes: int, dtype, tier: str,
                         with_fallback: bool = False):
    """The table's answer for one fused bucket on one tier, with 'topk'
    replaced by ``COMPILED_TOPK_SUBSTITUTE``: 'none' or 'bf16', or
    ``(format, substituted)`` with ``with_fallback``."""
    fmt = CompressionPolicy().decide(int(nbytes), dtype, tier)
    substituted = fmt == "topk"
    if substituted:
        fmt = COMPILED_TOPK_SUBSTITUTE
    return (fmt, substituted) if with_fallback else fmt
