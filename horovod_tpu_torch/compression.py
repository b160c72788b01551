"""Gradient wire compression: ``Compression.none/fp16/bf16/topk/adaptive``.

The same names and the same per-dtype rule as ``horovod_tpu.compression``:
a float gradient wider than two bytes travels at the 16-bit wire dtype;
integers and floats already at or below two bytes travel as they are
(an f16 tensor cast to bf16 would lose mantissa for no saving).

``topk`` and ``adaptive`` are names, not casts, as on the JAX package's
compiled plane: the port's collectives have static shapes, so topk ships
dense, and adaptive resolves per fabric tier through the policy table
(``common/policy.py``): full width on ICI, a per-bucket format on DCN
(``compiled_formats``, ``parallel/fusion.py``).

The numpy half serves the host engine (``common/engine.py``): the wire
dtype of a numpy payload (``numpy_wire_dtype``) and the top-k sparse
frames (``topk_*``), copies of ``horovod_tpu.compression``'s. numpy has no
bfloat16 and the port does not use ``ml_dtypes``, so a bfloat16 array is
carried as its 16-bit patterns under ``BFLOAT16``, a one-field structured
dtype that numpy moves, slices, pickles and concatenates but refuses to
compute with; ``cast`` converts to and from it, rounding to nearest even
as ``ml_dtypes`` does (NaN to the quiet NaN of its sign; a float64 goes
through float32 first, as there). An ``ml_dtypes`` bfloat16 array passed
in is viewed as ``BFLOAT16`` (``as_engine_array``) without importing it.
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


# ------------------------------------------------------------- bfloat16

#: numpy dtype of a bfloat16 array in the port: its 16-bit patterns.
BFLOAT16 = np.dtype([("bfloat16", "<u2")])


def np_dtype(dtype) -> np.dtype:
    """``np.dtype`` of ``dtype``, where the name ``"bfloat16"`` (and an
    ``ml_dtypes`` bfloat16) mean ``BFLOAT16``."""
    if isinstance(dtype, str):
        return numpy_dtype_by_name(dtype)
    dt = np.dtype(dtype)
    return BFLOAT16 if dt.name == "bfloat16" else dt


def is_bfloat16(dtype) -> bool:
    return np_dtype(dtype) == BFLOAT16


def is_16bit_float(dtype) -> bool:
    """float16 or bfloat16: the payloads that hop at their own width."""
    dt = np_dtype(dtype)
    return dt == BFLOAT16 or dt == np.float16


def dtype_name(dtype) -> str:
    """The name a dtype travels under in engine requests: ``str(dtype)``,
    and ``"bfloat16"`` for bfloat16 (``numpy_dtype_by_name`` inverts it)."""
    dt = np_dtype(dtype)
    return "bfloat16" if dt == BFLOAT16 else str(dt)


def numpy_dtype_by_name(name: str) -> np.dtype:
    """np.dtype of a dtype name; ``"bfloat16"`` is ``BFLOAT16``."""
    return BFLOAT16 if name == "bfloat16" else np.dtype(name)


def as_engine_array(a) -> np.ndarray:
    """``np.asarray(a)``, an ``ml_dtypes`` bfloat16 array viewed as
    ``BFLOAT16`` (same bytes)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" and a.dtype != BFLOAT16:
        return a.view(BFLOAT16)
    return a


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """uint16 patterns of float32 ``x`` rounded to nearest even, NaN as the
    quiet NaN 0x7fc0 with the input's sign. Plain numpy: the engine calls
    it from its own threads, where torch's thread pool has no place."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    b = x.view(np.uint32)
    t = b >> 16
    t &= 1
    t += b            # wraps only for NaN patterns, replaced below
    t += 0x7FFF
    t >>= 16
    bits = t.astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        bits[nan] = (((b[nan] >> 16) & 0x8000) | 0x7FC0).astype(np.uint16)
    return bits


def _bf16_widen(a: np.ndarray) -> np.ndarray:
    """float32 values of a ``BFLOAT16`` array (exact)."""
    u = np.ascontiguousarray(a).view(np.uint16)
    return (u.astype(np.uint32) << 16).view(np.float32)


def cast(a: np.ndarray, dtype) -> np.ndarray:
    """``a.astype(dtype)`` (a new array) where either side may be bfloat16."""
    dtype = np_dtype(dtype)
    a = as_engine_array(a)
    src = a.dtype
    if dtype == BFLOAT16:
        if src == BFLOAT16:
            return a.copy()
        return _bf16_bits(a.astype(np.float32, copy=False)).view(
            BFLOAT16).reshape(a.shape)
    if src == BFLOAT16:
        wide = _bf16_widen(a).reshape(a.shape)
        return wide if dtype == np.float32 else wide.astype(dtype)
    return a.astype(dtype)


def numpy_wire_dtype(compression: Optional[str], dtype) -> Optional[np.dtype]:
    """The numpy dtype a host payload of ``dtype`` travels as under
    ``compression`` (``BFLOAT16`` for bf16), or None: compression 'none',
    topk or adaptive, a non-float payload, or one already at or below two
    bytes (an f16 cast to bf16 would lose mantissa for no saving)."""
    wire_name = WIRE_DTYPES[normalize(compression)]
    if wire_name is None:
        return None
    dtype = np_dtype(dtype)
    if dtype.kind != "f" or dtype.itemsize <= 2:
        return None
    return BFLOAT16 if wire_name == torch.bfloat16 else np.dtype(np.float16)


# ------------------------------------------------------------- top-k frames
#
# A topk gradient ships as (indices, values) of its k largest-magnitude
# entries; the rest rides the engine's per-name error-feedback residual.
# Frames are little-endian and self-describing:
#
#   kind 0 (sparse): u8 0 | u32 k | i32 idx[k] (ascending) | f32 val[k]
#   kind 1 (dense):  u8 1 | f32 val[n]
#
# Values are exact float32 in either kind, and exact zeros are never
# selected, so any mix of sparse and dense hops gives the bits of the
# dense float32 fold.

_F_KIND_SPARSE = 0
_F_KIND_DENSE = 1


def topk_select(flat: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k of a flat float32 array by magnitude, ties to the lower index,
    exact zeros never selected (NaN last): ``(idx int32 ascending, val)``,
    the selection of the JAX package's lexsort, found in linear time: every
    entry above the k-th largest magnitude, then the lowest-index entries
    equal to it."""
    flat = np.ascontiguousarray(flat, dtype=TOPK_DTYPE).ravel()
    nz = np.flatnonzero(flat)
    if nz.size > k:
        mag = np.abs(flat[nz])
        mag[np.isnan(mag)] = -1.0
        kth = np.partition(mag, nz.size - k)[nz.size - k]
        above = mag > kth
        ties = np.flatnonzero(mag == kth)[:k - int(above.sum())]
        above[ties] = True
        nz = nz[above]
    return nz.astype(np.int32), flat[nz]


def topk_densify(idx: np.ndarray, val: np.ndarray, n: int) -> np.ndarray:
    """Dense float32 vector of a sparse (idx, val) pair, zeros elsewhere."""
    out = np.zeros(int(n), dtype=TOPK_DTYPE)
    if len(idx):
        out[np.asarray(idx, dtype=np.int64)] = val
    return out


def topk_sparsify(dense: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(idx, val) of a dense float32 chunk's nonzero entries."""
    dense = np.ascontiguousarray(dense, dtype=TOPK_DTYPE).ravel()
    idx = np.flatnonzero(dense)
    return idx.astype(np.int32), dense[idx]


def topk_pack(idx: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Sparse wire frame (kind 0) as a uint8 array."""
    idx = np.ascontiguousarray(idx, dtype="<i4")
    val = np.ascontiguousarray(val, dtype="<f4")
    head = np.empty(5, dtype=np.uint8)
    head[0] = _F_KIND_SPARSE
    head[1:5] = np.frombuffer(
        np.uint32(len(idx)).astype("<u4").tobytes(), np.uint8)
    return np.concatenate([head, idx.view(np.uint8), val.view(np.uint8)])


def topk_pack_dense(dense: np.ndarray) -> np.ndarray:
    """Dense wire frame (kind 1) as a uint8 array."""
    dense = np.ascontiguousarray(dense, dtype="<f4").ravel()
    head = np.array([_F_KIND_DENSE], dtype=np.uint8)
    return np.concatenate([head, dense.view(np.uint8)])


def topk_unpack(buf, n: int) -> tuple:
    """A wire frame of an ``n``-element chunk as ``("sparse", idx, val)``
    or ``("dense", arr)``; every length and index is checked first."""
    if isinstance(buf, np.ndarray):
        buf = np.ascontiguousarray(buf).view(np.uint8)
    else:
        buf = np.frombuffer(buf, dtype=np.uint8)
    if buf.size < 1:
        raise ValueError("empty topk frame")
    kind = int(buf[0])
    if kind == _F_KIND_DENSE:
        body = buf[1:]
        if body.size != n * 4:
            raise ValueError(
                f"dense topk frame carries {body.size} bytes, expected {n * 4}")
        return ("dense", body.view("<f4").astype(TOPK_DTYPE, copy=False))
    if kind != _F_KIND_SPARSE:
        raise ValueError(f"unknown topk frame kind {kind}")
    if buf.size < 5:
        raise ValueError("truncated topk frame header")
    k = int(buf[1:5].view("<u4")[0])
    if k > n or buf.size != 5 + 8 * k:
        raise ValueError(
            f"sparse topk frame k={k} size={buf.size} inconsistent with n={n}")
    idx = buf[5:5 + 4 * k].view("<i4")
    val = buf[5 + 4 * k:].view("<f4").astype(TOPK_DTYPE, copy=False)
    if k and (int(idx[0]) < 0 or int(idx[-1]) >= n
              or (k > 1 and not (np.diff(idx) > 0).all())):
        raise ValueError("sparse topk frame indices invalid")
    return ("sparse", idx.astype(np.int32, copy=False), val)


def topk_merge(i1: np.ndarray, v1: np.ndarray, i2: np.ndarray,
               v2: np.ndarray, n: int, max_nnz: Optional[int] = None
               ) -> tuple:
    """Union of two sparse chunks' supports, values summed first-argument
    first where they meet; dense past ``max_nnz`` entries (default n/2)."""
    if max_nnz is None:
        max_nnz = max(int(n) // 2, 1)
    if not len(i1):
        st = ("sparse", np.asarray(i2, np.int32), np.asarray(v2, TOPK_DTYPE))
    elif not len(i2):
        st = ("sparse", np.asarray(i1, np.int32), np.asarray(v1, TOPK_DTYPE))
    else:
        idx = np.concatenate([i1, i2])
        val = np.concatenate([v1, v2]).astype(TOPK_DTYPE, copy=False)
        order = np.argsort(idx, kind="stable")
        idx, val = idx[order], val[order]
        first = np.empty(idx.size, dtype=bool)
        first[0] = True
        np.not_equal(idx[1:], idx[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        st = ("sparse", idx[starts].astype(np.int32),
              np.add.reduceat(val, starts))
    if len(st[1]) > max_nnz:
        return ("dense", topk_densify(st[1], st[2], n))
    return st


def topk_state_add(state: tuple, idx, val, n: int) -> tuple:
    """Fold one sparse contribution into an accumulator state
    (``incoming + mine``), bitwise the dense float32 fold."""
    if state[0] == "dense":
        acc = np.array(state[1], dtype=TOPK_DTYPE, copy=True)
        if len(idx):
            np.add.at(acc, np.asarray(idx, dtype=np.int64), val)
        return ("dense", acc)
    return topk_merge(state[1], state[2], idx, val, n)


def topk_state_dense(state: tuple, n: int) -> np.ndarray:
    """Dense float32 view of a state."""
    if state[0] == "dense":
        return np.ascontiguousarray(state[1], dtype=TOPK_DTYPE)
    return topk_densify(state[1], state[2], n)


def topk_state_slice(state: tuple, lo: int, hi: int) -> tuple:
    """Sub-chunk [lo, hi) of a state, indices re-based to the slice."""
    if state[0] == "dense":
        return ("dense", state[1][lo:hi])
    idx, val = state[1], state[2]
    lo_i = int(np.searchsorted(idx, lo, side="left"))
    hi_i = int(np.searchsorted(idx, hi, side="left"))
    return ("sparse", (idx[lo_i:hi_i] - np.int32(lo)).astype(np.int32),
            val[lo_i:hi_i])


def topk_state_scale(state: tuple, world: int) -> tuple:
    """Every carried value divided by ``world`` (the AVERAGE finish)."""
    if state[0] == "dense":
        return ("dense", (state[1] / world).astype(TOPK_DTYPE, copy=False))
    return ("sparse", state[1],
            (state[2] / world).astype(TOPK_DTYPE, copy=False))


def topk_encode(state: tuple, n: int, prefer_sparse: bool = True
                ) -> np.ndarray:
    """The frame for a state: sparse when preferred and smaller, else
    dense. Both carry the same float32 values."""
    if prefer_sparse:
        if state[0] == "dense":
            state = ("sparse", *topk_sparsify(state[1]))
        if len(state[1]) * 8 + 5 < n * 4 + 1:
            return topk_pack(state[1], state[2])
    return topk_pack_dense(topk_state_dense(state, n))


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
