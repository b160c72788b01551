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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist

from ..common import basics

HVD_AXIS = "hvd"
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


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
