"""Tensor fusion: many gradients packed into a few flat buffers, one
collective per buffer.

The plan is the one ``horovod_tpu.parallel.fusion.build_plan`` makes, leaf
for leaf: given the same leaves in the same order (for a model, the order
in which the JAX package flattens its parameter tree), both packages put
the same leaves in the same buckets, so their collectives move the same
bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from . import collectives
from ..common.config import (DEFAULT_COMPRESSION_MIN_BYTES,
                             DEFAULT_FUSION_THRESHOLD)
from ..compression import wire_dtype


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
               num_buckets: int = 1) -> FusionPlan:
    """Plan the buckets of ``leaves`` (anything with ``shape`` and
    ``dtype``: tensors or numpy arrays).

    ``num_buckets <= 1``: one greedy pass in leaf order, packing each dtype
    up to ``threshold``. ``num_buckets = K > 1``: walk the leaves in reverse
    and pack about K byte-balanced single-dtype buckets, with ``threshold``
    still a hard cap on each."""
    descs = _leaf_descs(leaves)
    if num_buckets > 1:
        buckets = _reverse_order_buckets(descs, num_buckets, threshold)
        return FusionPlan(tuple(tuple(b) for b in buckets))
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
    return FusionPlan(tuple(tuple(b) for b in buckets))


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


def fuse(tensors: Sequence[torch.Tensor], plan: FusionPlan) -> list:
    """One flat buffer per bucket (a copy, even for a single leaf)."""
    return [torch.cat([tensors[d.index].reshape(-1) for d in bucket])
            for bucket in plan.buckets]


def unfuse_(buffers: Sequence[torch.Tensor], plan: FusionPlan,
            out: Sequence[torch.Tensor]) -> None:
    """Copy each buffer's slices back into the leaves of ``out``."""
    for bucket, buf in zip(plan.buckets, buffers):
        offset = 0
        for d in bucket:
            out[d.index].copy_(buf[offset:offset + d.size].view(d.shape))
            offset += d.size


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


def fused_allreduce_(tensors: Sequence[torch.Tensor], plan: FusionPlan,
                     op=collectives.ReduceOp.AVERAGE, compression=None,
                     compression_min_bytes: Optional[int] = None) -> None:
    """Fuse, cast each bucket to its wire dtype, allreduce, cast back and
    unfuse into ``tensors`` in place."""
    buffers = fuse(tensors, plan)
    shipped = []
    for buf in buffers:
        wire = wire_dtype_for_bucket(compression, buf.dtype,
                                     buf.numel() * buf.element_size(), op,
                                     compression_min_bytes)
        shipped.append(buf.to(wire) if wire is not None else buf)
    collectives.bucketed_allreduce(shipped, op)
    reduced = [s.to(b.dtype) for s, b in zip(shipped, buffers)]
    unfuse_(reduced, plan, tensors)
