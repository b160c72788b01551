"""Fully-sharded data parallelism (ZeRO-3), one leaf at a time.

The counterpart of ``horovod_tpu.parallel.fsdp``: parameters, gradients and
optimizer state are sharded 1/N per rank over an ``fsdp`` process group,
and the gradient exchange is a reduce-scatter instead of an allreduce.
Each leaf is flattened, zero-padded to a multiple of N and viewed as
``(N, chunk)``; rank ``r`` keeps row ``r`` as an ``nn.Parameter`` that a
``torch.optim`` optimizer steps. A step is

    full = fsdp_gather_params(rows, shapes, group)     # all-gather
    loss = loss_fn(torch.func.functional_call(model, full, args))
    loss.backward()                                    # reduce-scatter-sum
    fsdp_average_gradients_(rows, layout)              # / N (psum over dp first)
    optimizer.step(); fsdp_mask_(rows, shapes, rank)

``fsdp_gather_params`` is an autograd Function whose backward is the
all-gather's transpose, the reduce-scatter-sum into the owning row, as
JAX's autodiff of ``lax.all_gather`` gives it; the division by N (or by dp
x fsdp after a sum over dp) comes after, as the JAX steps take it. The
parameters are dicts of name -> tensor, the form ``functional_call``
takes, where the JAX package takes pytrees.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
from torch import nn

from . import collectives
from .collectives import ReduceOp


def _size(shape) -> int:
    return math.prod(shape)


def fsdp_shard_params(params: Mapping[str, torch.Tensor], axis_size: int,
                      rank: int) -> tuple[dict, dict]:
    """``(rows, shapes)``: rank ``rank``'s row of each leaf, flattened and
    zero-padded to ``(axis_size, chunk)``, as a new parameter; and each
    leaf's shape, to rebuild it after the gather."""
    if not 0 <= rank < axis_size:
        raise ValueError(f"rank {rank} outside [0, {axis_size})")
    rows, shapes = {}, {}
    with torch.no_grad():
        for name, x in params.items():
            flat = x.detach().reshape(-1)
            chunk = -(-flat.numel() // axis_size)
            padded = torch.cat([flat, flat.new_zeros(chunk * axis_size - flat.numel())])
            rows[name] = nn.Parameter(padded.view(axis_size, chunk)[rank].clone())
            shapes[name] = tuple(x.shape)
    return rows, shapes


class _Gather(torch.autograd.Function):
    """All-gather one leaf's rows into the full leaf; the backward is the
    reduce-scatter-sum of its gradient into this rank's row."""

    @staticmethod
    def forward(ctx, row, shape, group):
        ctx.group = group
        flat = collectives.all_gather_into(row, group)
        return flat[:_size(shape)].view(shape)

    @staticmethod
    def backward(ctx, grad):
        g = grad.reshape(-1)
        n = torch.distributed.get_world_size(ctx.group)
        pad = -g.numel() % n
        if pad:
            g = torch.cat([g, g.new_zeros(pad)])
        return collectives.reducescatter(g, ctx.group), None, None


def fsdp_gather_params(rows: Mapping[str, torch.Tensor],
                       shapes: Mapping[str, tuple], group=None) -> dict:
    """The full leaves from every rank's rows over ``group``: one tiled
    all-gather per leaf. Differentiable: the gradient of each row is the
    reduce-scatter-sum of the full leaf's gradient over ``group``."""
    return {name: _Gather.apply(row, shapes[name], group)
            for name, row in rows.items()}


def fsdp_average_gradients_(rows: Mapping[str, torch.Tensor], layout) -> None:
    """Turn each row's reduce-scatter-sum into the average over the data
    parallelism, in place: with ``layout.dp_size > 1`` a sum over the dp
    group first, then a division by dp x fsdp. ``layout``: a
    ``parallel.mesh.DpFsdp``."""
    n = layout.dp_size * layout.fsdp_size
    for row in rows.values():
        if layout.dp_size > 1:
            collectives.allreduce_(row.grad, ReduceOp.SUM, layout.dp_group)
        row.grad.div_(n)


def fsdp_mask_(rows: Mapping[str, torch.Tensor], shapes: Mapping[str, tuple],
               rank: int) -> None:
    """Write 0.0 to each row's pad-tail entries, in place, after the
    optimizer's step (the JAX package masks the update; the tail is 0.0
    before the step, so both agree). Leaves that tile the axis are not
    touched."""
    with torch.no_grad():
        for name, row in rows.items():
            chunk = row.numel()
            valid = min(max(_size(shapes[name]) - rank * chunk, 0), chunk)
            if valid < chunk:
                row[valid:].zero_()


def fsdp_unshard_params(rows_of_every_rank, shapes: Mapping[str, tuple]) -> dict:
    """Host-side inverse of :func:`fsdp_shard_params`: the full leaves from
    every rank's rows (in rank order), the pad tail dropped."""
    return {name: torch.cat([rows[name].detach() for rows in rows_of_every_rank])
            [:_size(shape)].view(shape) for name, shape in shapes.items()}
