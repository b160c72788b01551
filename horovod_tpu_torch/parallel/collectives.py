"""Collectives over ``torch.distributed``: allreduce, broadcast, allgather,
and the point-to-point ``ppermute``/``ring_shift`` of sequence parallelism.

The counterparts of ``horovod_tpu.parallel.collectives``, where the mesh
axis becomes the default process group (or, for ``ppermute`` and
``ring_shift``, the process group given). AVERAGE is a SUM followed by a
divide by the world size on every backend (gloo has no AVG). Every
reduction is issued through ``torch.distributed``, also in a world of one,
so the single-card run takes the same path as a multi-card one; a
``ppermute`` in a group of one makes no call at all (NCCL does not send to
itself).
"""

from __future__ import annotations

from enum import Enum
from typing import Optional, Sequence

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


def ppermute(tensors: Sequence[torch.Tensor], perm: Sequence[tuple[int, int]],
             group: Optional[dist.ProcessGroup] = None) -> list:
    """Send each tensor along ``perm``, pairs ``(source, destination)`` of
    ranks within ``group`` (None: the default group), as ``lax.ppermute``:
    this rank returns what its source sent, or zeros if no pair names it as
    a destination. All tensors of the call travel in one
    ``batch_isend_irecv``; a rank that sends to itself copies locally."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    if n == 1 or (dst == src == [me]):
        return [t.clone() if dst else torch.zeros_like(t) for t in tensors]
    peer = (lambda r: dist.get_global_rank(group, r)) if group is not None \
        else (lambda r: r)
    fmt = torch.contiguous_format
    out = [torch.empty_like(t, memory_format=fmt) if src
           else torch.zeros_like(t, memory_format=fmt) for t in tensors]
    ops = []
    if dst:
        ops += [dist.P2POp(dist.isend, t.contiguous(), peer(dst[0]), group)
                for t in tensors]
    if src:
        ops += [dist.P2POp(dist.irecv, o, peer(src[0]), group) for o in out]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def ring_shift(tensors: Sequence[torch.Tensor],
               group: Optional[dist.ProcessGroup] = None,
               shift: int = 1) -> list:
    """Rank i's tensors go to rank (i + shift) % n of ``group``: one hop of
    a ring. The identity, with no call at all, in a group of one."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    return ppermute(tensors, [(i, (i + shift) % n) for i in range(n)], group)
