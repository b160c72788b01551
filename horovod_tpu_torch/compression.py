"""Gradient wire compression: ``Compression.none/fp16/bf16/topk/adaptive``.

The same names and the same per-dtype rule as ``horovod_tpu.compression``:
a float gradient wider than two bytes travels at the 16-bit wire dtype;
integers and floats already at or below two bytes travel as they are
(an f16 tensor cast to bf16 would lose mantissa for no saving).

``topk`` and ``adaptive`` are names, not casts, as on the JAX package's
compiled plane: the port's collectives have static shapes, so topk ships
dense, and adaptive resolves per fabric tier through the policy table
(``common/policy.py``): full width on ICI, a per-bucket format on DCN
(``compiled_formats``, ``parallel/fusion.py``). The sparse frames belong
to the host engines, which the port does not have yet.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

# HOROVOD_COMPRESSION values -> wire dtype (None: no cast).
WIRE_DTYPES = {"none": None, "fp16": torch.float16, "bf16": torch.bfloat16,
               "topk": None, "adaptive": None}

# Default HOROVOD_TOPK_RATIO: keep the top 1% of entries by magnitude.
DEFAULT_TOPK_RATIO = 0.01
# topk takes float32 tensors alone: an int32 index and a float32 value
# cost 8 bytes per kept entry against 4 dense.
TOPK_DTYPE = np.dtype(np.float32)


def parse_spec(name: Optional[str]) -> tuple[str, Optional[float]]:
    """``(name, topk ratio or None)`` of a compression spec: ``"topk@0.05"``
    gives ``("topk", 0.05)``; anything unknown ``("none", None)``."""
    s = (name or "none").lower()
    if s.startswith("topk@"):
        try:
            ratio = float(s.split("@", 1)[1])
        except ValueError:
            return "none", None
        return ("topk", ratio) if 0.0 < ratio else ("none", None)
    return (s, None) if s in WIRE_DTYPES else ("none", None)


def normalize(name: Optional[str]) -> str:
    """Normalize a compression name; unknown names mean 'none'."""
    return parse_spec(name)[0]


def topk_ratio_from_env(default: float = DEFAULT_TOPK_RATIO) -> float:
    """HOROVOD_TOPK_RATIO, clamped to (0, 0.5]: past half the entries a
    sparse frame is bigger than the dense one. Unset, unparsable or not
    positive: ``default``."""
    v = os.environ.get("HOROVOD_TOPK_RATIO")
    if v in (None, ""):
        return default
    try:
        ratio = float(v)
    except ValueError:
        return default
    if ratio <= 0.0:
        return default
    return min(ratio, 0.5)


def topk_k(n: int, ratio: float) -> int:
    """Entries topk keeps of an n-element tensor: ratio of n, at least 1."""
    return max(1, min(int(round(n * float(ratio))), int(n)))


def _is_topk_dtype(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == TOPK_DTYPE


def topk_eligible(dtype, nbytes: int, ratio: float, min_bytes: int) -> bool:
    """Whether a tensor of ``dtype`` (torch or numpy) and ``nbytes``
    sparsifies at all: float32 only, at least ``min_bytes``, and a k small
    enough that the sparse frame beats the dense one."""
    if not _is_topk_dtype(dtype) or nbytes < max(int(min_bytes), 1):
        return False
    n = nbytes // TOPK_DTYPE.itemsize
    return topk_k(n, ratio) * 8 + 8 < n * 4


def compiled_formats(name: Optional[str]) -> tuple[str, str]:
    """(ICI, DCN) dense formats that the policy names resolve to on a
    static-shape data plane: adaptive is full width on ICI and bf16 on
    DCN; topk is dense on both (the caller warns)."""
    base = normalize(name)
    if base == "adaptive":
        return ("none", "bf16")
    if base == "topk":
        return ("none", "none")
    return (base, base)


def wire_dtype(compression, dtype: torch.dtype) -> Optional[torch.dtype]:
    """The dtype a ``dtype`` tensor travels as under ``compression``, or
    None when compression is a no-op for it."""
    wire = WIRE_DTYPES[compression_name(compression)]
    if wire is None or not dtype.is_floating_point or dtype.itemsize <= 2:
        return None
    return wire


class Compressor:
    """A compression choice, named as HOROVOD_COMPRESSION names it."""

    name = "none"


class NoneCompressor(Compressor):
    name = "none"


class FP16Compressor(Compressor):
    name = "fp16"


class BF16Compressor(Compressor):
    name = "bf16"


class TopKCompressor(Compressor):
    """Top-k sparsification by name; the port's collectives ship dense."""

    name = "topk"


class AdaptiveCompressor(Compressor):
    """The per-tier policy by name: full width on ICI, the table's format
    per bucket on DCN."""

    name = "adaptive"


class Compression:
    """Selector class, as in the reference: ``Compression.bf16``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    topk = TopKCompressor
    adaptive = AdaptiveCompressor

    @classmethod
    def by_name(cls, name: Optional[str]) -> type[Compressor]:
        """The compressor of a HOROVOD_COMPRESSION value (``topk@<ratio>``
        specs give the topk compressor)."""
        return {"none": cls.none, "fp16": cls.fp16, "bf16": cls.bf16,
                "topk": cls.topk, "adaptive": cls.adaptive}[normalize(name)]


def compression_name(compression) -> str:
    """Canonical name of a Compressor class, instance or name string."""
    if compression is None:
        return "none"
    if isinstance(compression, str):
        return normalize(compression)
    return normalize(getattr(compression, "name", "none"))
