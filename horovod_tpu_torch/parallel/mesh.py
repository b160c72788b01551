"""Layouts of the world as process groups: the ``('dcn', 'ici')`` ladder of
hierarchical data parallelism, and data parallelism over rings of sequence
parallelism.

``hierarchical_groups`` is the counterpart of
``horovod_tpu.parallel.mesh.hierarchical_mesh``: the mesh reshapes the
world row-major to (world / ici, ici), so an ICI group is ``ici``
consecutive ranks (one host's cards) and a DCN group is the ranks with the
same ICI index across hosts. The axis names stay, for readers.

``dp_sp_groups`` is the counterpart of the ``("dp", "sp")`` mesh of
``horovod_tpu.parallel.mesh.training_mesh`` as the dp×sp transformer step
lays it out (``Mesh(devices.reshape(dp, sp), ("dp", "sp"))``): row-major,
so the sp ranks of one ring are consecutive global ranks, and the ring of
global rank g is g // sp. The mesh axis "sp" becomes a process group that
``ring_shift`` runs over; "dp" needs no group of its own, because the
gradients average over the whole world, as ``axis_name=("dp", "sp")``.

``sharded_groups`` is the counterpart of ``sharded_mesh``: the
``('batch', 'shard')`` layout of sharded data parallelism, or
``('batch', 'shard', 'model')`` when the model axis is named, row-major
with ``model`` the most minor axis, so global rank ``(b * shard + s) *
model + m`` sits at mesh position ``(b, s, m)``. ``HOROVOD_MESH`` spells
its shape (``parse_mesh_spec``, a copy of the JAX package's).
``training_groups(dp, fsdp, pp, sp)`` is the ``('dp', 'fsdp', 'pp', 'sp')``
layout of ``training_mesh(dp=, fsdp=, pp=, sp=)`` that FSDP and pipeline
parallelism run on, row-major too.
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist

from ..common import basics

HVD_AXIS = "hvd"
DCN_AXIS = "dcn"
ICI_AXIS = "ici"
BATCH_AXIS = "batch"
SHARD_AXIS = "shard"
MODEL_AXIS = "model"
FSDP_AXIS = "fsdp"


@dataclass(frozen=True)
class Hierarchy:
    """This rank's place in the ``('dcn', 'ici')`` layout."""

    ici_group: dist.ProcessGroup    # this host's ranks
    ici_rank: int
    ici_size: int
    dcn_group: dist.ProcessGroup    # the ranks of this ICI index, one per host
    dcn_rank: int
    dcn_size: int


def hierarchical_groups(ici_size: Optional[int] = None) -> Hierarchy:
    """Cut the world into ICI groups of ``ici_size`` consecutive ranks and
    DCN groups across them. ``ici_size=None`` is the job's local size (or
    its gcd with the world size, where it does not divide it), as the
    reference takes the chips of one process. Every rank creates every
    group, in the same order: the ICI groups, then the DCN groups."""
    basics.require_not_elastic("hierarchical_groups() (the hierarchical layout)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if ici_size is None:
        ici_size = max(basics.local_size(), 1)
        if world % ici_size:
            ici_size = math.gcd(world, ici_size) or 1
    if ici_size < 1 or world % ici_size:
        raise ValueError(f"world size {world} not divisible by ici_size {ici_size}")
    dcn_size = world // ici_size
    ici_group = dcn_group = None
    for host in range(dcn_size):
        group = dist.new_group(list(range(host * ici_size, (host + 1) * ici_size)))
        if host == rank // ici_size:
            ici_group = group
    for index in range(ici_size):
        group = dist.new_group(list(range(index, world, ici_size)))
        if index == rank % ici_size:
            dcn_group = group
    return Hierarchy(ici_group=ici_group, ici_rank=rank % ici_size,
                     ici_size=ici_size, dcn_group=dcn_group,
                     dcn_rank=rank // ici_size, dcn_size=dcn_size)


@dataclass(frozen=True)
class DpSp:
    """This rank's place in the dp × sp layout."""

    group: dist.ProcessGroup    # this rank's ring (its sp process group)
    sp_rank: int
    sp_size: int
    dp_index: int
    dp_size: int


def dp_sp_groups(sp: int) -> DpSp:
    """Cut the world into rings of ``sp`` consecutive ranks. Every rank
    creates every ring's group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    basics.require_not_elastic("dp_sp_groups() (the sp layout)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if sp < 1 or world % sp:
        raise ValueError(f"sp {sp} must be >= 1 and divide the world size {world}")
    mine = None
    for ring in range(world // sp):
        group = dist.new_group(list(range(ring * sp, (ring + 1) * sp)))
        if ring == rank // sp:
            mine = group
    return DpSp(group=mine, sp_rank=rank % sp, sp_size=sp, dp_index=rank // sp,
                dp_size=world // sp)


def parse_mesh_spec(spec: str, n_devices: int) -> tuple[int, int, int]:
    """Parse a ``HOROVOD_MESH`` value into ``(batch, shard, model)`` sizes
    for ``n_devices`` ranks: ``"<batch>"``, ``"<batch>x<shard>"`` or
    ``"<batch>x<shard>x<model>"``, at most one size ``-1`` ("the rest");
    an empty spec is pure DP, ``(n_devices, 1, 1)``. Raises on a malformed
    spec or a shape that does not tile the ranks."""
    s = (spec or "").strip().lower().replace("×", "x")
    if not s:
        return n_devices, 1, 1
    parts = s.split("x")
    if not 1 <= len(parts) <= 3:
        raise ValueError(
            f"HOROVOD_MESH={spec!r}: expected '<batch>', '<batch>x<shard>' "
            f"or '<batch>x<shard>x<model>' (e.g. '4x2x1')")
    try:
        sizes = [int(p) for p in parts]
    except ValueError:
        raise ValueError(
            f"HOROVOD_MESH={spec!r}: sizes must be integers (or -1)") from None
    sizes += [1] * (3 - len(sizes))
    if sizes.count(-1) > 1:
        raise ValueError(f"HOROVOD_MESH={spec!r}: at most one size may be -1")
    if -1 in sizes:
        known = math.prod(v for v in sizes if v != -1)
        if known <= 0 or n_devices % known:
            raise ValueError(
                f"HOROVOD_MESH={spec!r}: {n_devices} devices not divisible "
                f"by the fixed sizes' product {known}")
        sizes[sizes.index(-1)] = n_devices // known
    batch, shard, model = sizes
    if batch <= 0 or shard <= 0 or model <= 0 or \
            batch * shard * model != n_devices:
        raise ValueError(
            f"HOROVOD_MESH={spec!r} needs {batch}x{shard}x{model}="
            f"{batch * shard * model} devices, have {n_devices}")
    return batch, shard, model


def _spec_names_model(spec: str) -> bool:
    """Whether a ``HOROVOD_MESH`` spelling names the third (model) axis:
    ``"4x2x1"`` does, ``"4x2"`` does not."""
    return (spec or "").strip().lower().replace("×", "x").count("x") >= 2


def mesh_model_axis(spec: Optional[str] = None) -> bool:
    """Whether a ``HOROVOD_MESH`` spelling (None: the variable's, as
    ``sharded_groups()`` reads it) lays out a model axis: three sizes, or
    a model size above 1. ``sharded_groups`` of it has a model group."""
    if spec is None:
        spec = os.environ.get("HOROVOD_MESH", "")
    return _spec_names_model(spec) or \
        parse_mesh_spec(spec, dist.get_world_size())[2] != 1


@dataclass(frozen=True)
class ShardedLayout:
    """This rank's place in the ``('batch', 'shard'[, 'model'])`` layout.
    ``model_group`` is None when the model axis is not named."""

    batch_group: dist.ProcessGroup    # the ranks of this (shard, model) index
    batch_rank: int
    batch_size: int
    shard_group: dist.ProcessGroup    # the ranks of this (batch, model) index
    shard_rank: int
    shard_size: int
    model_group: Optional[dist.ProcessGroup]
    model_rank: int
    model_size: int


def _mesh_sizes(world: int, batch, shard, model) -> tuple[int, int, int, bool]:
    """(batch, shard, model, whether the model axis is named), resolved as
    ``sharded_mesh`` resolves its arguments."""
    if batch is None and shard is None and model is None:
        spec = os.environ.get("HOROVOD_MESH", "")
        return (*parse_mesh_spec(spec, world), _spec_names_model(spec))
    named = model is not None
    m = 1 if model is None else model
    if batch is None and shard is None:
        spec = f"-1x1x{m}"
    elif batch is None:
        spec = f"-1x{shard}x{m}"
    elif shard is None:
        spec = f"{batch}x-1x{m}"
    else:
        spec = f"{batch}x{shard}x{m}"
    return (*parse_mesh_spec(spec, world), named)


def sharded_groups(batch: Optional[int] = None, shard: Optional[int] = None,
                   model: Optional[int] = None) -> ShardedLayout:
    """The ``sharded_mesh`` layout as process groups. With every size None
    the shape comes from ``HOROVOD_MESH``; the model axis is named when
    ``model`` is given (any value, 1 too) or the spec has three sizes.
    Every rank creates every group, in one order: the batch groups, the
    shard groups, then the model groups."""
    basics.require_not_elastic("sharded_groups() (the sharded and tp layouts)")
    world, rank = dist.get_world_size(), dist.get_rank()
    b_size, s_size, m_size, named = _mesh_sizes(world, batch, shard, model)
    b, s, m = rank // (s_size * m_size), rank // m_size % s_size, rank % m_size

    def rank_of(bi, si, mi):
        return (bi * s_size + si) * m_size + mi

    def build(groups, mine):
        """One group per key of ``groups``; this rank's is ``mine``'s."""
        out = None
        for key, ranks in groups:
            group = dist.new_group(ranks)
            if key == mine:
                out = group
        return out

    batch_group = build(
        [((si, mi), [rank_of(bi, si, mi) for bi in range(b_size)])
         for si in range(s_size) for mi in range(m_size)], (s, m))
    shard_group = build(
        [((bi, mi), [rank_of(bi, si, mi) for si in range(s_size)])
         for bi in range(b_size) for mi in range(m_size)], (b, m))
    model_group = build(
        [((bi, si), [rank_of(bi, si, mi) for mi in range(m_size)])
         for bi in range(b_size) for si in range(s_size)], (b, s)) \
        if named or m_size != 1 else None
    return ShardedLayout(batch_group=batch_group, batch_rank=b,
                         batch_size=b_size, shard_group=shard_group,
                         shard_rank=s, shard_size=s_size,
                         model_group=model_group, model_rank=m,
                         model_size=m_size)


@dataclass(frozen=True)
class DpFsdp:
    """This rank's place in the ``('dp', 'fsdp', 'pp', 'sp')`` layout."""

    dp_group: dist.ProcessGroup       # the ranks of this (fsdp, pp, sp) index
    dp_rank: int
    dp_size: int
    fsdp_group: dist.ProcessGroup     # the ranks of this (dp, pp, sp) index
    fsdp_rank: int
    fsdp_size: int
    pp_group: dist.ProcessGroup       # this rank's pipeline: (dp, fsdp, sp)
    pp_rank: int                      # this rank's stage
    pp_size: int
    sp_group: dist.ProcessGroup       # this rank's ring: (dp, fsdp, pp)
    sp_rank: int
    sp_size: int


def training_groups(dp: int, fsdp: int, pp: int = 1, sp: int = 1) -> DpFsdp:
    """``training_mesh(dp=, fsdp=, pp=, sp=)`` as process groups, tp and ep
    of size 1: global rank ``((d * fsdp + f) * pp + p) * sp + s`` at ``(d,
    f, p, s)``, row-major in the mesh's axis order. Every rank creates
    every group, in one order: the dp groups, the fsdp groups, the pp
    groups, then the sp groups; an axis of size 1 has one group of one
    rank per rank."""
    basics.require_not_elastic("training_groups() (the FSDP, pp and sp layouts)")
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = (dp, fsdp, pp, sp)
    if min(sizes) < 1 or math.prod(sizes) != world:
        raise ValueError(f"dp {dp} x fsdp {fsdp} x pp {pp} x sp {sp} must be "
                         f"the world size {world}")
    me = (rank // (fsdp * pp * sp), rank // (pp * sp) % fsdp, rank // sp % pp,
          rank % sp)

    def rank_of(index):
        d, f, p, s = index
        return ((d * fsdp + f) * pp + p) * sp + s

    def build(axis: int):
        """One group per index of the other axes, in row-major order; this
        rank's is the one of its own index."""
        mine = None
        others = [range(n) if a != axis else range(1) for a, n in enumerate(sizes)]
        for key in itertools.product(*others):
            ranks = [rank_of(key[:axis] + (i,) + key[axis + 1:])
                     for i in range(sizes[axis])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        return mine

    groups = [build(axis) for axis in range(4)]
    return DpFsdp(dp_group=groups[0], dp_rank=me[0], dp_size=dp,
                  fsdp_group=groups[1], fsdp_rank=me[1], fsdp_size=fsdp,
                  pp_group=groups[2], pp_rank=me[2], pp_size=pp,
                  sp_group=groups[3], sp_rank=me[3], sp_size=sp)
