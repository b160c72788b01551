"""Collectives over ``torch.distributed``: the allreduces (flat, grouped
and the hierarchical ladder), broadcast, the allgathers, reduce-scatter,
all-to-all, the sparse allreduce, and the point-to-point
``ppermute``/``ring_shift`` of sequence parallelism (``PPermute``, the
differentiable ``ppermute`` of pipeline parallelism).

The counterparts of ``horovod_tpu.parallel.collectives``, where a mesh
axis becomes a process group: ``group=None`` is the whole world, and the
ladder takes the ``('dcn', 'ici')`` groups of
``parallel.mesh.hierarchical_groups``. AVERAGE is a SUM followed by a
divide by the group's size on every backend (gloo has no AVG). Every
reduction is issued through ``torch.distributed``, also in a group of one,
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


Group = Optional[dist.ProcessGroup]


def allreduce_(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
               group: Group = None) -> torch.Tensor:
    """Allreduce ``tensor`` over ``group`` in place and return it."""
    dist.all_reduce(tensor, op=_DIST_OPS[op], group=group)
    if op == ReduceOp.AVERAGE:
        tensor.div_(dist.get_world_size(group))
    return tensor


class Pending:
    """An allreduce in flight: ``wait()`` makes the caller's stream (on the
    card; the host on gloo) wait for it, divides for AVERAGE and returns
    the tensor."""

    def __init__(self, work, tensor: torch.Tensor, divisor: Optional[int]):
        self.work, self.tensor, self.divisor = work, tensor, divisor

    def wait(self) -> torch.Tensor:
        self.work.wait()
        if self.divisor is not None:
            self.tensor.div_(self.divisor)
        return self.tensor


def allreduce_async_(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                     group: Group = None) -> Pending:
    """``allreduce_`` issued with ``async_op=True``: nothing waits for it
    until ``wait()``, which divides for AVERAGE as ``allreduce_`` does."""
    work = dist.all_reduce(tensor, op=_DIST_OPS[op], group=group, async_op=True)
    divisor = dist.get_world_size(group) if op == ReduceOp.AVERAGE else None
    return Pending(work, tensor, divisor)


def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              group: Group = None) -> torch.Tensor:
    """Allreduce into a new tensor (default: average, as hvd.allreduce)."""
    return allreduce_(tensor.clone(), op, group)


def grouped_allreduce(tensors, op: ReduceOp = ReduceOp.AVERAGE,
                      group: Group = None):
    """Allreduce a list or a dict of tensors into new ones, one collective
    per tensor, in order."""
    if isinstance(tensors, dict):
        return {k: allreduce(t, op, group) for k, t in tensors.items()}
    return [allreduce(t, op, group) for t in tensors]


def bucketed_allreduce(buffers: Sequence[torch.Tensor],
                       op: ReduceOp = ReduceOp.AVERAGE,
                       group: Group = None) -> list:
    """One collective per flat bucket buffer over ``group``, in issue
    order, in place."""
    return [allreduce_(b, op, group) for b in buffers]


def _global(group: Group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              group: Group = None) -> torch.Tensor:
    """Overwrite ``tensor`` with the value of ``root_rank`` (a rank within
    ``group``), in place."""
    dist.broadcast(tensor, src=_global(group, root_rank), group=group)
    return tensor


def allgather(tensor: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 (shapes must match)."""
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def reducescatter(x: torch.Tensor, group: Group = None,
                  average: bool = False) -> torch.Tensor:
    """Sum ``x`` over ``group`` and hand group rank j the j-th of n equal
    dim-0 shards (dim 0 must divide by n)."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} not divisible by {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out.div_(n) if average else out


def alltoall(x: torch.Tensor, group: Group = None, split_dim: int = 0,
             concat_dim: int = 0) -> torch.Tensor:
    """Cut ``x`` into n pieces along ``split_dim``, send piece j to group
    rank j, and concatenate the pieces received along ``concat_dim`` in
    rank order (``lax.all_to_all(..., tiled=True)``)."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} not divisible "
                         f"by {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim))    # piece j at [j]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class AllToAll(torch.autograd.Function):
    """``alltoall`` over ``group``, differentiable: its backward sends the
    gradient back with the inverse all-to-all (split and concat dims
    swapped). ``AllToAll.apply(x, group, split_dim, concat_dim)``."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.geometry = (group, split_dim, concat_dim)
        return alltoall(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        group, split_dim, concat_dim = ctx.geometry
        return alltoall(grad.contiguous(), group, concat_dim, split_dim), None, None, None


class PPermute(torch.autograd.Function):
    """``ppermute`` of one tensor over ``group``, differentiable: its
    backward sends the gradient along the inverse permutation, as
    ``lax.ppermute``'s transpose does. In a group of one it issues no P2P
    call, forward or backward. ``PPermute.apply(x, perm, group)``."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return ppermute([x], perm, group)[0]

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return ppermute([grad.contiguous()], inverse, ctx.group)[0], None, None


def all_gather_into(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0 in one buffer (one
    ``all_gather_into_tensor``: ``lax.all_gather(..., tiled=True)``)."""
    out = x.new_empty((x.shape[0] * dist.get_world_size(group), *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def hierarchical_allgather(x: torch.Tensor, groups) -> torch.Tensor:
    """Allgather over ICI, then over DCN: the world's tensors concatenated
    along dim 0 DCN-major, which is rank order for the ``('dcn', 'ici')``
    layout. ``groups``: a ``parallel.mesh.Hierarchy``."""
    return all_gather_into(all_gather_into(x, groups.ici_group),
                            groups.dcn_group)


def sparse_allreduce(values: torch.Tensor, indices: torch.Tensor,
                     group: Group = None, average: bool = True):
    """A sparse gradient's allreduce as two allgathers: every rank's values
    (divided by the group's size first when ``average``) and indices,
    concatenated along dim 0 in rank order. The caller scatter-adds them."""
    if average:
        values = values / dist.get_world_size(group)
    return allgather(values, group), allgather(indices, group)


def hierarchical_allreduce(x: torch.Tensor, groups, average: bool = True,
                           dcn_wire_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """The ladder: reduce-scatter over ICI, allreduce over DCN (at
    ``dcn_wire_dtype`` when given: the shard is cast for that one call and
    cast back), all-gather over ICI; the average is divided last, by the
    world's size, as the reference divides it. Three collectives, each
    issued also in a group of one. dim 0 must divide by the ICI size: the
    fusion plan pads each bucket to it. ``groups``: a
    ``parallel.mesh.Hierarchy``."""
    shard = reducescatter(x, groups.ici_group)
    wire = shard
    if dcn_wire_dtype is not None and dcn_wire_dtype != shard.dtype:
        wire = shard.to(dcn_wire_dtype)
    dist.all_reduce(wire, group=groups.dcn_group)
    out = all_gather_into(wire.to(shard.dtype), groups.ici_group)
    if average:
        out.div_(groups.ici_size * groups.dcn_size)
    return out


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
