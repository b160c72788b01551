"""Gradient wire compression: ``Compression.none/fp16/bf16``.

The same names and the same per-dtype rule as ``horovod_tpu.compression``:
a float gradient wider than two bytes travels at the 16-bit wire dtype;
integers and floats already at or below two bytes travel as they are
(an f16 tensor cast to bf16 would lose mantissa for no saving).
"""

from __future__ import annotations

from typing import Optional

import torch

# HOROVOD_COMPRESSION values -> wire dtype (None: no cast).
WIRE_DTYPES = {"none": None, "fp16": torch.float16, "bf16": torch.bfloat16}


def normalize(name: Optional[str]) -> str:
    """Normalize a compression name; unknown names mean 'none'."""
    s = (name or "none").lower()
    return s if s in WIRE_DTYPES else "none"


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


class Compression:
    """Selector class, as in the reference: ``Compression.bf16``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

    @classmethod
    def by_name(cls, name: Optional[str]) -> type[Compressor]:
        return {"none": cls.none, "fp16": cls.fp16,
                "bf16": cls.bf16}[normalize(name)]


def compression_name(compression) -> str:
    """Canonical name of a Compressor class, instance or name string."""
    if compression is None:
        return "none"
    if isinstance(compression, str):
        return normalize(compression)
    return normalize(getattr(compression, "name", "none"))
