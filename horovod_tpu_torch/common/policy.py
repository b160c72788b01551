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
``COMPILED_TOPK_SUBSTITUTE`` (``compiled_tier_format``). The eager engine
(``common/engine.py``) applies the table per tensor (``resolve``), and the
live-telemetry half (``refresh``, ``sparse_tiers``) steers its
value-neutral choice of sparse or dense frames per link tier.
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
    ``common.config.Config``) supplies min_bytes, 4096 without one, and the
    topk ratio (else HOROVOD_TOPK_RATIO); the floor is
    HOROVOD_TOPK_MIN_BYTES, as in the reference. ``topo`` says whether the
    world crosses a host boundary (no DCN hop: full width everywhere)."""

    def __init__(self, config=None, topo=None) -> None:
        self.min_bytes = int(getattr(config, "compression_min_bytes",
                                     DEFAULT_COMPRESSION_MIN_BYTES)
                             or DEFAULT_COMPRESSION_MIN_BYTES)
        self.topk_ratio = float(getattr(config, "topk_ratio", 0.0)
                                or topk_ratio_from_env())
        self.topk_min_bytes = max(self.min_bytes, _env_int(
            "HOROVOD_TOPK_MIN_BYTES", DEFAULT_TOPK_MIN_BYTES))
        self.has_dcn = bool(topo is None or getattr(topo, "cross_size", 1) > 1)
        # Where topk frames ship sparse: DCN until refresh() sees the wire
        # time move to the local fabric.
        self._sparse_tiers = {"cross"}
        self._diag: dict = {}

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

    def resolve(self, nbytes: int, dtype) -> str:
        """The one value-changing format the eager engine gives a tensor:
        the decision for the slowest fabric its bytes cross."""
        return self.decide(nbytes, dtype, "dcn" if self.has_dcn else "ici")

    def sparse_tiers(self) -> frozenset:
        """Link tiers ('local'/'cross') where topk hops frame sparse."""
        return frozenset(self._sparse_tiers)

    def refresh(self, snapshot: dict) -> dict:
        """Steer the sparse framing from a metrics snapshot: the per-tier
        ``horovod_wire_bytes_total`` counters and the
        ``horovod_critical_path_wire_seconds`` gauges. Value-neutral, so
        ranks may disagree. Returns (and keeps) the diagnosis."""
        counters = snapshot.get("counters", {}) or {}
        gauges = snapshot.get("gauges", {}) or {}

        def tier(series: dict, name: str, t: str) -> float:
            return float(series.get(f'{name}{{tier="{t}"}}', 0) or 0)

        local_b = tier(counters, "horovod_wire_bytes_total", "local")
        cross_b = tier(counters, "horovod_wire_bytes_total", "cross")
        local_s = tier(gauges, "horovod_critical_path_wire_seconds", "local")
        cross_s = tier(gauges, "horovod_critical_path_wire_seconds", "cross")
        if local_s or cross_s:
            bottleneck = "dcn" if cross_s >= local_s else "ici"
        elif local_b or cross_b:
            bottleneck = "dcn" if cross_b >= local_b else "ici"
        else:
            bottleneck = "dcn" if self.has_dcn else "ici"
        tiers = {"cross"}
        if bottleneck == "ici" and (local_s > 0 or local_b > 0):
            tiers.add("local")
        self._sparse_tiers = tiers
        self._diag = {
            "bottleneck_tier": bottleneck,
            "wire_bytes": {"local": local_b, "cross": cross_b},
            "wire_seconds": {"local": local_s, "cross": cross_s},
            "sparse_tiers": sorted(tiers),
        }
        return dict(self._diag)

    def report(self, nbytes: int = 1 << 22, dtype=np.float32) -> dict:
        """The table for a representative large gradient plus the live
        diagnosis (``PyEngine.cache_stats()['policy']``)."""
        return {
            "ici": self.decide(nbytes, dtype, "ici"),
            "dcn": self.decide(nbytes, dtype, "dcn"),
            "resolved": self.resolve(nbytes, dtype),
            "topk_ratio": self.topk_ratio,
            "has_dcn": self.has_dcn,
            "sparse_tiers": sorted(self._sparse_tiers),
            "diag": dict(self._diag),
        }


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
