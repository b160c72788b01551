"""Collectives over ``torch.distributed``: the allreduces (flat, grouped
and the hierarchical ladder), broadcast, the allgathers, reduce-scatter,
all-to-all, the sparse allreduce, and the point-to-point
``ppermute``/``ring_shift`` of sequence parallelism (``PPermute``, the
differentiable ``ppermute`` of pipeline parallelism), and the host-side
``broadcast_object``/``allgather_object`` of picklable Python objects.

``allreduce``, ``allgather``, ``broadcast``, ``alltoall`` and
``reducescatter`` of a numpy array or a Python scalar (anything but a
``torch.Tensor``) go to the eager engine (``basics.engine()``), negotiated
by ``name`` over the whole world, and return numpy, as
``horovod_tpu``'s eager calls do; averaging is the engine's. A tensor, on
the CPU or the card, keeps the ``torch.distributed`` path below.

The counterparts of ``horovod_tpu.parallel.collectives``, where a mesh
axis becomes a process group: ``group=None`` is the whole world, and the
ladder takes the ``('dcn', 'ici')`` groups of
``parallel.mesh.hierarchical_groups``. AVERAGE is a SUM followed by a
divide by the group's size on every backend (gloo has no AVG). Every
reduction is issued through ``torch.distributed``, also in a group of one,
so the single-card run takes the same path as a multi-card one; a
``ppermute`` in a group of one makes no call at all (NCCL does not send to
itself).

A failure of the backend — a peer gone (gloo fails the next collective at
once), a wait past the process group's timeout (NCCL under
``HOROVOD_ELASTIC``) — raises ``HorovodInternalError`` from every function
here, where the collective is issued or waited on (``backend_errors``):
the one exception ``elastic.run`` heals by a reset. Any other error keeps
its type.

Every collective here reports to ``parallel/telemetry.py``: counters at
issue, device times from CUDA events (host clocks on gloo), spans under
``HOROVOD_TRACE_DIR`` named by the caller's ``name=`` (else the op), and
the stall watchdog's view of what is in flight; nothing under CUDA-graph
capture. Each synchronous call is issued as ``async_op=True`` and waited
on at once, which is what ``torch.distributed`` does for
``async_op=False``; on gloo the wait polls the work, so that the stall
watchdog's abort ends it.
"""

from __future__ import annotations

import contextlib
import functools
from enum import Enum
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..common import basics
from . import telemetry


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

# How a failed backend shows in a plain RuntimeError, where torch does not
# raise one of torch.distributed's DistError types (gloo's transport: "...
# gloo/transport/tcp/pair.cc:... Connection closed by peer ...").
_BACKEND_FAILURES = ("gloo/transport", "Connection closed by peer",
                     "Connection reset by peer", "NCCL communicator",
                     "NCCL error")


@contextlib.contextmanager
def backend_errors(what: str, op: Optional[str] = None):
    """Raise a failure of the collective backend inside the block as
    ``HorovodInternalError`` (the original chained), naming ``what``, and
    count it in ``horovod_collective_errors_total{op}`` (``op`` None:
    ``what``)."""
    try:
        yield
    except basics.HorovodInternalError:
        telemetry.count_error(op or what)
        raise
    except RuntimeError as e:
        if not isinstance(e, dist.DistError) and \
                not any(m in str(e) for m in _BACKEND_FAILURES):
            raise
        telemetry.count_error(op or what)
        raise basics.HorovodInternalError(
            f"{what}: the collective backend failed, a peer is gone or did "
            f"not take part in time ({type(e).__name__}: {e})") from e


_OP_OF = {"allreduce_": "allreduce", "allreduce_async_": "allreduce",
          "hierarchical_allreduce": "allreduce", "broadcast": "broadcast",
          "allgather": "allgather", "all_gather_into": "allgather",
          "reducescatter": "reducescatter", "alltoall": "alltoall",
          "ppermute": "ppermute", "broadcast_object": "broadcast",
          "allgather_object": "allgather"}


# Calls whose host-value (non-tensor) form runs on the eager engine, which
# counts its own errors.
_EAGER_FORMS = ("broadcast", "allgather", "reducescatter", "alltoall")


def _backend_errors(fn):
    """``fn`` with ``backend_errors`` around it (not around a host value's
    eager-engine call)."""
    op = _OP_OF.get(fn.__name__)
    eager = fn.__name__ in _EAGER_FORMS

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if eager and args and not isinstance(args[0], torch.Tensor):
            return fn(*args, **kwargs)
        with backend_errors(fn.__name__, op):
            return fn(*args, **kwargs)
    return wrapper


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _run(op: str, tensor: torch.Tensor, name: Optional[str], call) -> None:
    """One synchronous collective: ``call()`` issues it with
    ``async_op=True`` and it is waited on here, timed and counted."""
    f = telemetry.begin(op, tensor, _nbytes(tensor), name)
    work = call()
    if f is not None and not f.cuda:
        telemetry.issued(f, work)
        telemetry.wait(f, work)
        return
    work.wait()
    telemetry.finish(f)


@_backend_errors
def allreduce_(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
               group: Group = None, name: Optional[str] = None) -> torch.Tensor:
    """Allreduce ``tensor`` over ``group`` in place and return it."""
    _run("allreduce", tensor, name, lambda: dist.all_reduce(
        tensor, op=_DIST_OPS[op], group=group, async_op=True))
    if op == ReduceOp.AVERAGE:
        tensor.div_(dist.get_world_size(group))
    return tensor


class Pending:
    """An allreduce in flight: ``wait()`` makes the caller's stream (on the
    card; the host on gloo) wait for it, divides for AVERAGE and returns
    the tensor."""

    def __init__(self, work, tensor: torch.Tensor, divisor: Optional[int],
                 flight=None):
        self.work, self.tensor, self.divisor = work, tensor, divisor
        self.flight = flight

    def wait(self) -> torch.Tensor:
        with backend_errors("allreduce wait", "allreduce"):
            telemetry.wait(self.flight, self.work)
        if self.divisor is not None:
            self.tensor.div_(self.divisor)
        return self.tensor


@_backend_errors
def allreduce_async_(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                     group: Group = None, name: Optional[str] = None) -> Pending:
    """``allreduce_`` issued with ``async_op=True``: nothing waits for it
    until ``wait()``, which divides for AVERAGE as ``allreduce_`` does."""
    f = telemetry.begin("allreduce", tensor, _nbytes(tensor), name)
    work = dist.all_reduce(tensor, op=_DIST_OPS[op], group=group, async_op=True)
    telemetry.issued(f, work)
    divisor = dist.get_world_size(group) if op == ReduceOp.AVERAGE else None
    return Pending(work, tensor, divisor, f)


def _eager(op: str, value, group: Group, **kw):
    """A host value's collective through the eager engine (numpy out)."""
    import numpy as np

    if group is not None:
        raise ValueError(
            f"{op} of a host value runs on the eager engine, which spans the "
            "whole world: group= takes torch tensors only")
    return basics.engine().run(op, np.asarray(value), **kw)


def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              group: Group = None, name: Optional[str] = None) -> torch.Tensor:
    """Allreduce into a new tensor (default: average, as hvd.allreduce).
    A numpy array or scalar goes through the eager engine (SUM or
    AVERAGE)."""
    if not isinstance(tensor, torch.Tensor):
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(f"the eager engine reduces by SUM or AVERAGE, "
                             f"not {op.name}")
        return _eager("allreduce", tensor, group, name=name,
                      average=op == ReduceOp.AVERAGE)
    return allreduce_(tensor.clone(), op, group, name)


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


@_backend_errors
def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              group: Group = None, name: Optional[str] = None) -> torch.Tensor:
    """Overwrite ``tensor`` with the value of ``root_rank`` (a rank within
    ``group``), in place. A host value: root's value, through the eager
    engine."""
    if not isinstance(tensor, torch.Tensor):
        return _eager("broadcast", tensor, group, name=name,
                      root_rank=root_rank)
    _run("broadcast", tensor, name, lambda: dist.broadcast(
        tensor, src=_global(group, root_rank), group=group, async_op=True))
    return tensor


@_backend_errors
def allgather(tensor: torch.Tensor, group: Group = None,
              name: Optional[str] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 (shapes must match; a
    host value's dim 0 may differ, through the eager engine)."""
    if not isinstance(tensor, torch.Tensor):
        return _eager("allgather", tensor, group, name=name)
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    src = tensor.contiguous()
    _run("allgather", src, name, lambda: dist.all_gather(
        parts, src, group=group, async_op=True))
    return torch.cat(parts, dim=0)


@_backend_errors
def reducescatter(x: torch.Tensor, group: Group = None,
                  average: bool = False, name: Optional[str] = None
                  ) -> torch.Tensor:
    """Sum ``x`` over ``group`` and hand group rank j the j-th of n equal
    dim-0 shards (dim 0 must divide by n; a host value's shards are
    ``np.array_split``'s, through the eager engine)."""
    if not isinstance(x, torch.Tensor):
        return _eager("reducescatter", x, group, name=name, average=average)
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} not divisible by {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    src = x.contiguous()
    _run("reducescatter", src, name, lambda: dist.reduce_scatter_tensor(
        out, src, group=group, async_op=True))
    return out.div_(n) if average else out


@_backend_errors
def alltoall(x: torch.Tensor, group: Group = None, split_dim: int = 0,
             concat_dim: int = 0, name: Optional[str] = None) -> torch.Tensor:
    """Cut ``x`` into n pieces along ``split_dim``, send piece j to group
    rank j, and concatenate the pieces received along ``concat_dim`` in
    rank order (``lax.all_to_all(..., tiled=True)``). A host value: dim-0
    pieces through the eager engine (``split_dim``/``concat_dim`` 0)."""
    if not isinstance(x, torch.Tensor):
        if split_dim or concat_dim:
            raise ValueError("the eager engine's alltoall splits and "
                             "concatenates dim 0")
        return _eager("alltoall", x, group, name=name)
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} not divisible "
                         f"by {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim))    # piece j at [j]
    recv = torch.empty_like(send)
    _run("alltoall", send, name, lambda: dist.all_to_all_single(
        recv, send, group=group, async_op=True))
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


@_backend_errors
def all_gather_into(x: torch.Tensor, group: Group = None,
                    name: Optional[str] = None) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0 in one buffer (one
    ``all_gather_into_tensor``: ``lax.all_gather(..., tiled=True)``)."""
    out = x.new_empty((x.shape[0] * dist.get_world_size(group), *x.shape[1:]))
    src = x.contiguous()
    _run("allgather", src, name, lambda: dist.all_gather_into_tensor(
        out, src, group=group, async_op=True))
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


@_backend_errors
def hierarchical_allreduce(x: torch.Tensor, groups, average: bool = True,
                           dcn_wire_dtype: Optional[torch.dtype] = None,
                           name: Optional[str] = None) -> torch.Tensor:
    """The ladder: reduce-scatter over ICI, allreduce over DCN (at
    ``dcn_wire_dtype`` when given: the shard is cast for that one call and
    cast back), all-gather over ICI; the average is divided last, by the
    world's size, as the reference divides it. Three collectives, each
    issued also in a group of one, counted and traced as one allreduce
    with a ``wire`` span per tier. dim 0 must divide by the ICI size: the
    fusion plan pads each bucket to it. ``groups``: a
    ``parallel.mesh.Hierarchy``."""
    n = groups.ici_size
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} not divisible by {n} ranks")
    src = x.contiguous()
    f = telemetry.begin("allreduce", src, _nbytes(src), name)
    shard = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(shard, src, group=groups.ici_group)
    telemetry.segment(f, "local")
    wire = shard
    if dcn_wire_dtype is not None and dcn_wire_dtype != shard.dtype:
        wire = shard.to(dcn_wire_dtype)
    dist.all_reduce(wire, group=groups.dcn_group)
    telemetry.segment(f, "cross")
    back = wire.to(shard.dtype)
    out = back.new_empty((back.shape[0] * n, *back.shape[1:]))
    dist.all_gather_into_tensor(out, back, group=groups.ici_group)
    telemetry.finish(f, "local")
    telemetry.count_wire(_nbytes(src) + _nbytes(out), src, "local")
    telemetry.count_wire(_nbytes(wire), src, "cross")
    if average:
        out.div_(groups.ici_size * groups.dcn_size)
    return out


@_backend_errors
def ppermute(tensors: Sequence[torch.Tensor], perm: Sequence[tuple[int, int]],
             group: Optional[dist.ProcessGroup] = None,
             name: Optional[str] = None) -> list:
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
        f = telemetry.begin("ppermute", tensors[0],
                            sum(_nbytes(t) for t in tensors), name)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        telemetry.finish(f)
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


@_backend_errors
def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    """Every rank returns ``root_rank``'s ``obj``, a picklable Python object
    (non-root ranks' ``obj`` is ignored), through
    ``torch.distributed.broadcast_object_list`` over the world. In a world
    of one it returns ``obj`` at once. ``name`` is accepted as the JAX
    package's is; calls pair up by their order on each rank. Host-side
    only, and it unpickles root's bytes: use it within one job. It stays
    on ``torch.distributed`` (the JAX package's rides its eager engine)."""
    if basics.size() == 1:
        return obj
    box = [obj if basics.rank() == root_rank else None]
    f = telemetry.begin("broadcast", None, 0, name)
    dist.broadcast_object_list(box, src=root_rank)
    telemetry.finish(f)
    return box[0]


@_backend_errors
def allgather_object(obj, name: Optional[str] = None) -> list:
    """``[obj of rank 0, obj of rank 1, ...]`` on every rank, through
    ``torch.distributed.all_gather_object``; the objects may differ in size.
    In a world of one ``[obj]`` at once. ``name`` as in
    :func:`broadcast_object`; on ``torch.distributed``, as there."""
    if basics.size() == 1:
        return [obj]
    out = [None] * basics.size()
    f = telemetry.begin("allgather", None, 0, name)
    dist.all_gather_object(out, obj)
    telemetry.finish(f)
    return out
