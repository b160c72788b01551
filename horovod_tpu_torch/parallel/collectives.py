"""Collectives over ``torch.distributed``: allreduce, broadcast, allgather.

The counterparts of ``horovod_tpu.parallel.collectives``, where the mesh
axis becomes the default process group. AVERAGE is a SUM followed by a
divide by the world size on every backend (gloo has no AVG). Every call
is issued through ``torch.distributed``, also in a world of one, so the
single-card run takes the same path as a multi-card one.
"""

from __future__ import annotations

from enum import Enum
from typing import Sequence

import torch
import torch.distributed as dist


class ReduceOp(Enum):
    SUM = "sum"
    AVERAGE = "average"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"


_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def allreduce_(tensor: torch.Tensor,
               op: ReduceOp = ReduceOp.AVERAGE) -> torch.Tensor:
    """Allreduce ``tensor`` in place and return it."""
    dist.all_reduce(tensor, op=_DIST_OPS[op])
    if op == ReduceOp.AVERAGE:
        tensor.div_(dist.get_world_size())
    return tensor


def allreduce(tensor: torch.Tensor,
              op: ReduceOp = ReduceOp.AVERAGE) -> torch.Tensor:
    """Allreduce into a new tensor (default: average, as hvd.allreduce)."""
    return allreduce_(tensor.clone(), op)


def bucketed_allreduce(buffers: Sequence[torch.Tensor],
                       op: ReduceOp = ReduceOp.AVERAGE) -> list:
    """One collective per flat bucket buffer, in issue order, in place."""
    return [allreduce_(b, op) for b in buffers]


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Overwrite ``tensor`` with root's value, in place."""
    dist.broadcast(tensor, src=root_rank)
    return tensor


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 (shapes must match)."""
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, tensor.contiguous())
    return torch.cat(parts, dim=0)
