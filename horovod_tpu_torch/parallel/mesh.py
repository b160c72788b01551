"""The dp × sp layout of the world: data parallelism over rings of
sequence parallelism.

The counterpart of the ``("dp", "sp")`` mesh of
``horovod_tpu.parallel.mesh.training_mesh`` as the dp×sp transformer step
lays it out (``Mesh(devices.reshape(dp, sp), ("dp", "sp"))``): row-major,
so the sp ranks of one ring are consecutive global ranks, and the ring of
global rank g is g // sp. The mesh axis "sp" becomes a process group that
``ring_shift`` runs over; "dp" needs no group of its own, because the
gradients average over the whole world, as ``axis_name=("dp", "sp")``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


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
