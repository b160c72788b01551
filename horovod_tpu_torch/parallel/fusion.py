"""Tensor fusion: many gradients packed into a few flat buffers, one
collective per buffer.

The plan is the one ``horovod_tpu.parallel.fusion.build_plan`` makes, leaf
for leaf: given the same leaves in the same order (for a model, the order
in which the JAX package flattens its parameter tree), both packages put
the same leaves in the same buckets, so their collectives move the same
bytes. On the hierarchical ladder each bucket is padded to a multiple of
the ICI size and capped by the DCN tier's threshold, and each tier's wire
dtype is chosen per bucket, as ``fused_allreduce`` chooses it there: given
the same leaves, ICI size and knobs, both packages plan the same buckets,
padded lengths and wire dtypes. The port records no telemetry of its plans.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from . import collectives
from ..common.config import (DEFAULT_COMPRESSION_MIN_BYTES,
                             DEFAULT_FUSION_THRESHOLD, env_dcn_compression)
from ..common.policy import compiled_tier_format
from ..compression import compiled_formats, compression_name, wire_dtype


@dataclass(frozen=True)
class _Leaf:
    index: int          # position in the leaf order
    shape: tuple
    dtype: str          # dtype name, e.g. "float32"
    itemsize: int
    size: int           # elements

    @property
    def nbytes(self) -> int:
        return self.size * self.itemsize


@dataclass(frozen=True)
class FusionPlan:
    """Buckets in issue order; each holds leaves of one dtype whose bytes
    stay within the threshold (a larger leaf gets a bucket of its own).
    With K > 1 buckets, bucket 0 holds the last leaves, whose gradients the
    backward pass produces first."""

    buckets: tuple[tuple[_Leaf, ...], ...]
    pad_to: int = 1     # each buffer's length is a multiple (the ladder's RS)
    reverse_order: bool = False     # the K-bucket plan, last leaves first

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


def _dtype_of(leaf) -> tuple[str, int]:
    dtype = leaf.dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch."), dtype.itemsize
    dtype = np.dtype(dtype)
    return dtype.name, dtype.itemsize


def _leaf_descs(leaves: Sequence) -> list[_Leaf]:
    descs = []
    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape)
        name, itemsize = _dtype_of(leaf)
        descs.append(_Leaf(i, shape, name, itemsize, int(np.prod(shape))))
    return descs


def build_plan(leaves: Sequence, threshold: int = DEFAULT_FUSION_THRESHOLD,
               num_buckets: int = 1, pad_to: int = 1) -> FusionPlan:
    """Plan the buckets of ``leaves`` (anything with ``shape`` and
    ``dtype``: tensors or numpy arrays).

    ``num_buckets <= 1``: one greedy pass in leaf order, packing each dtype
    up to ``threshold``. ``num_buckets = K > 1``: walk the leaves in reverse
    and pack about K byte-balanced single-dtype buckets, with ``threshold``
    still a hard cap on each. ``pad_to``: ``fuse`` zero-pads each buffer
    to a multiple of it."""
    descs = _leaf_descs(leaves)
    if num_buckets > 1:
        buckets = _reverse_order_buckets(descs, num_buckets, threshold)
        return FusionPlan(tuple(tuple(b) for b in buckets), pad_to,
                          reverse_order=True)
    buckets: list[list[_Leaf]] = []
    cur: dict[str, list[_Leaf]] = {}
    cur_bytes: dict[str, int] = {}
    for d in descs:
        key = d.dtype
        if key in cur and cur_bytes[key] + d.nbytes <= threshold:
            cur[key].append(d)
            cur_bytes[key] += d.nbytes
        else:
            if key in cur:
                buckets.append(cur[key])
            cur[key] = [d]
            cur_bytes[key] = d.nbytes
    buckets.extend(cur.values())
    buckets.sort(key=lambda b: b[0].index)
    return FusionPlan(tuple(tuple(b) for b in buckets), pad_to)


def dcn_capped_threshold(threshold: int, dcn_threshold: int,
                         scatter_width: int) -> int:
    """The bucket cap on the ladder: a bucket ships 1/``scatter_width`` of
    its bytes over DCN, so a DCN cap of ``dcn_threshold`` bytes (0: none)
    caps the bucket at ``dcn_threshold * scatter_width``, and the smaller
    of that and ``threshold`` holds (both stay hard caps)."""
    if dcn_threshold and dcn_threshold > 0:
        cap = int(dcn_threshold) * int(scatter_width)
        return min(threshold, cap) if threshold > 0 else cap
    return threshold


def _reverse_order_buckets(descs: Sequence[_Leaf], num_buckets: int,
                           threshold: int) -> list[list[_Leaf]]:
    """K-way byte-balanced split in reverse leaf order. A bucket closes on
    a dtype change, at the threshold cap, when the next leaf would
    overshoot the balanced target by more than the bucket's shortfall, or
    once it reaches the target; the last bucket takes the remainder."""
    remaining = sum(d.nbytes for d in descs)
    buckets: list[list[_Leaf]] = []
    cur: list[_Leaf] = []
    cur_bytes = 0

    def target() -> int:
        # Balance over what is left, the current bucket included.
        left = num_buckets - len(buckets)
        return max(1, -(-(cur_bytes + remaining) // max(1, left)))

    for d in reversed(descs):
        if cur and (cur[0].dtype != d.dtype
                    or (threshold > 0 and cur_bytes + d.nbytes > threshold)
                    or (2 * cur_bytes + d.nbytes > 2 * target()
                        and len(buckets) < num_buckets - 1)):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(d)
        cur_bytes += d.nbytes
        remaining -= d.nbytes
        if cur_bytes >= target() and len(buckets) < num_buckets - 1:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def fuse_bucket(tensors: Sequence[torch.Tensor], plan: FusionPlan,
                b: int) -> torch.Tensor:
    """Bucket ``b``'s flat buffer of ``tensors`` (a copy, even for a single
    leaf), zero padded to a multiple of ``plan.pad_to``."""
    bucket = plan.buckets[b]
    parts = [tensors[d.index].reshape(-1) for d in bucket]
    pad = -sum(d.size for d in bucket) % plan.pad_to
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def fuse(tensors: Sequence[torch.Tensor], plan: FusionPlan) -> list:
    """One flat buffer per bucket: ``fuse_bucket`` of each."""
    return [fuse_bucket(tensors, plan, b) for b in range(plan.num_buckets)]


def unfuse_bucket_(buf: torch.Tensor, plan: FusionPlan, b: int,
                   out: Sequence[torch.Tensor]) -> None:
    """Copy bucket ``b``'s buffer's slices back into the leaves of ``out``
    (a pad tail is left out)."""
    offset = 0
    for d in plan.buckets[b]:
        out[d.index].copy_(buf[offset:offset + d.size].view(d.shape))
        offset += d.size


def unfuse_(buffers: Sequence[torch.Tensor], plan: FusionPlan,
            out: Sequence[torch.Tensor]) -> None:
    """``unfuse_bucket_`` of each bucket's buffer."""
    for b, buf in enumerate(buffers):
        unfuse_bucket_(buf, plan, b, out)


def wire_dtype_for_bucket(compression, dtype: torch.dtype, nbytes: int, op,
                          min_bytes: Optional[int] = None
                          ) -> Optional[torch.dtype]:
    """The dtype a bucket's collective runs at, or None to send it as it is:
    only SUM/AVERAGE buckets of floats wider than 2 bytes, at least
    ``min_bytes`` long, are cast."""
    if op not in (collectives.ReduceOp.SUM, collectives.ReduceOp.AVERAGE):
        return None
    if min_bytes is None:
        min_bytes = DEFAULT_COMPRESSION_MIN_BYTES
    if nbytes < min_bytes:
        return None
    return wire_dtype(compression, dtype)


def _bucket_dtype(bucket: Sequence[_Leaf]) -> torch.dtype:
    return getattr(torch, bucket[0].dtype)


def _padded_size(bucket: Sequence[_Leaf], pad_to: int) -> int:
    """Elements of ``bucket``'s fused buffer: its leaves, zero padded to a
    multiple of ``pad_to``."""
    n = sum(d.size for d in bucket)
    return n + (-n % pad_to)


def tier_wires(plan: FusionPlan, op, compression=None,
               compression_min_bytes: Optional[int] = None,
               hierarchical: bool = False, dcn_compression=None
               ) -> tuple[list, list]:
    """Per bucket of ``plan``: the wire dtype of its ICI collective (the
    only one when flat) and of its DCN allreduce, None where a bucket
    ships as it is. The DCN verdict is taken against the dtype the bucket
    ships at, so a bucket already at 16 bits keeps them. The names resolve
    as on the JAX package's compiled plane: topk ships dense on both tiers
    (and warns); adaptive is full width on ICI. ``dcn_compression`` None
    reads HOROVOD_DCN_COMPRESSION; where that is unset too, adaptive takes
    the policy table's format per bucket on DCN, and any other name the
    ICI compression."""
    if dcn_compression is None:
        dcn_compression = env_dcn_compression() or None
    name = compression_name(compression)
    adaptive = name == "adaptive"
    if name == "topk":
        warnings.warn("topk compression ships dense buckets on the port's "
                      "collectives (use bf16 or adaptive for a smaller wire)",
                      stacklevel=3)
        compression, dcn_fmt = compiled_formats(name)
        if dcn_compression is None:
            dcn_compression = dcn_fmt
    elif adaptive:
        compression = compiled_tier_format(1 << 30, torch.float32, "ici")
    ici, dcn = [], []
    for bucket in plan.buckets:
        dtype, size = _bucket_dtype(bucket), _padded_size(bucket, plan.pad_to)
        w = wire_dtype_for_bucket(compression, dtype, size * dtype.itemsize,
                                  op, compression_min_bytes)
        ici.append(w)
        if not hierarchical:
            dcn.append(None)
            continue
        dtype = dtype if w is None else w
        nbytes = size * dtype.itemsize
        if adaptive and dcn_compression is None:
            fmt = compiled_tier_format(nbytes, dtype, "dcn")
        else:
            fmt = compression if dcn_compression is None else dcn_compression
        dcn.append(wire_dtype_for_bucket(fmt, dtype, nbytes, op,
                                         compression_min_bytes))
    return ici, dcn


def fused_allreduce_(tensors: Sequence[torch.Tensor], plan: FusionPlan,
                     op=collectives.ReduceOp.AVERAGE, compression=None,
                     compression_min_bytes: Optional[int] = None,
                     hierarchical: bool = False, groups=None,
                     dcn_compression=None, wires=None,
                     group: collectives.Group = None) -> None:
    """Fuse, cast each bucket to its wire dtype, allreduce over ``group``
    (None: the world), cast back and unfuse into ``tensors`` in place.
    ``hierarchical``: each bucket takes
    the ladder over ``groups`` (a ``parallel.mesh.Hierarchy``; the plan
    must pad to its ICI size), a SUM or AVERAGE alone. ``wires``: the
    ``tier_wires`` of these arguments, for a caller that computes them
    once (None: computed here)."""
    if hierarchical:
        if op not in (collectives.ReduceOp.SUM, collectives.ReduceOp.AVERAGE):
            raise ValueError(
                f"hierarchical fusion supports SUM/AVERAGE only (got {op}); "
                f"use hierarchical=False for {op.name}")
        if plan.pad_to != groups.ici_size:
            raise ValueError(f"plan pads to {plan.pad_to}, the ladder's ICI "
                             f"size is {groups.ici_size}")
    if wires is None:
        wires = tier_wires(plan, op, compression, compression_min_bytes,
                           hierarchical, dcn_compression)
    ici, dcn = wires
    buffers = fuse(tensors, plan)
    shipped = [b.to(w) if w is not None else b for b, w in zip(buffers, ici)]
    if hierarchical:
        reduced = [collectives.hierarchical_allreduce(
            s, groups, average=op == collectives.ReduceOp.AVERAGE,
            dcn_wire_dtype=w) for s, w in zip(shipped, dcn)]
    else:
        reduced = collectives.bucketed_allreduce(shipped, op, group)
    unfuse_([r.to(b.dtype) for r, b in zip(reduced, buffers)], plan, tensors)
