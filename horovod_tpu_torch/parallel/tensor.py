"""Tensor parallelism over a model process group: Megatron's column and
row-parallel pairs, the counterpart of ``horovod_tpu.parallel.tensor``.

A **column-parallel** layer holds a 1/model_size slice of its weight's
output dimension, ``y_r = act(x @ w_col[:, r])``, with no collective; the
paired **row-parallel** layer holds the matching slice of its weight's
input dimension and ends in one allreduce: ``y = sum_r(h_r @ w_row[r, :])
+ b_row``. The mesh axis ``'model'`` becomes a process group (the
``model_group`` of ``parallel.mesh.sharded_groups``); ``group=None``, or a
group of one rank, issues no collective at all, so that tensor parallelism
at model size 1 is the flat step bit for bit.

The backward needs Megatron's conjugate pair. Each rank differentiates the
same replicated loss, so an allreduce whose backward is also an allreduce
(``torch.distributed.nn.functional.all_reduce``, like JAX's default psum
transpose) scales every slice gradient by the model size. Instead
:func:`copy_to_model` (identity forward, allreduce backward) wraps the
column half's input, completing the partial input-cotangents of the
ranks' slices, and :func:`reduce_from_model` (allreduce forward, identity
backward) ends the row half. With the two, slice gradients equal the
dense gradient's slices, replicated parameters get the same gradient on
every model rank, and a pair costs one allreduce per direction.

The pairs' weights keep the JAX layout, ``w_col (d_in, h)`` and ``w_row
(h, d_out)``, so ``x @ w`` reads as in the reference. The forward
reassociates the hidden contraction (local partial products, then the
sum), so it equals the dense oracle bit for bit on integer-valued
payloads and within dtype tolerance on generic floats.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .collectives import Group

__all__ = [
    "copy_to_model", "reduce_from_model", "model_size",
    "column_parallel", "row_parallel", "tp_pair_apply", "tp_apply",
    "dense_pair_apply", "dense_apply", "tp_pair_slices", "tp_local_pairs",
    "tp_rank_pairs", "tp_wire_bytes_per_pair",
]


def model_size(group: Group) -> int:
    """Ranks in the model group; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Identity forward, allreduce (sum) over ``group`` backward
    (Megatron's *f*): wraps the column half's replicated input, whose
    cotangent each rank holds only in part. No collective in a group of
    one."""
    return x if model_size(group) == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Allreduce (sum) over ``group`` forward, identity backward
    (Megatron's *g*): completes the row half's hidden contraction and
    hands every rank the replicated cotangent unchanged. No collective in
    a group of one."""
    return x if model_size(group) == 1 else _ReduceFromModel.apply(x, group)


# ------------------------------------------------------------- layer halves


def column_parallel(x, w, b=None, group: Group = None):
    """``x @ w (+ b)`` with ``w``/``b`` this rank's output-dimension
    slices; the input rides :func:`copy_to_model`."""
    y = copy_to_model(x, group) @ w
    return y if b is None else y + b


def row_parallel(x, w, b=None, group: Group = None):
    """This rank's input-dimension slice of the contraction, then one
    :func:`reduce_from_model`; the replicated bias is added after the sum,
    once, as the dense oracle adds it."""
    y = reduce_from_model(x @ w, group)
    return y if b is None else y + b


def tp_pair_apply(pair: dict, x, group: Group = None,
                  activation: Optional[Callable] = torch.tanh):
    """One column/row pair, ``row(act(col(x)))``, one allreduce. ``pair``
    holds this rank's slices: ``w_col (d_in, h/s)``, ``b_col (h/s,)``,
    ``w_row (h/s, d_out)``, ``b_row (d_out,)`` (biases optional)."""
    h = column_parallel(x, pair["w_col"], pair.get("b_col"), group)
    if activation is not None:
        h = activation(h)
    return row_parallel(h, pair["w_row"], pair.get("b_row"), group)


def tp_apply(pairs: Sequence[dict], x, group: Group = None,
             activation: Optional[Callable] = torch.tanh,
             final_activation: Optional[Callable] = None):
    """A stack of pairs: one allreduce per pair on the model group, each
    pair's output replicated over it."""
    for i, pair in enumerate(pairs):
        x = tp_pair_apply(pair, x, group, activation)
        if final_activation is not None and i == len(pairs) - 1:
            x = final_activation(x)
    return x


# ------------------------------------------------------- single-card oracle


def dense_pair_apply(pair: dict, x, activation: Optional[Callable] = torch.tanh):
    """The dense oracle of :func:`tp_pair_apply` on the full weights."""
    h = x @ pair["w_col"]
    if pair.get("b_col") is not None:
        h = h + pair["b_col"]
    if activation is not None:
        h = activation(h)
    y = h @ pair["w_row"]
    if pair.get("b_row") is not None:
        y = y + pair["b_row"]
    return y


def dense_apply(pairs: Sequence[dict], x,
                activation: Optional[Callable] = torch.tanh,
                final_activation: Optional[Callable] = None):
    """The dense oracle of :func:`tp_apply`."""
    for i, pair in enumerate(pairs):
        x = dense_pair_apply(pair, x, activation)
        if final_activation is not None and i == len(pairs) - 1:
            x = final_activation(x)
    return x


# ------------------------------------------------------------ param slicing


def tp_pair_slices(pair: dict, model_size: int) -> list:
    """Cut one full pair into ``model_size`` local pairs: ``w_col``/
    ``b_col`` on the hidden (output) dimension, ``w_row`` on its input
    dimension, ``b_row`` replicated. The hidden dimension must divide
    evenly."""
    if model_size < 1:
        raise ValueError(f"model_size must be >= 1, got {model_size}")
    hidden = int(pair["w_col"].shape[-1])
    if hidden % model_size:
        raise ValueError(
            f"hidden dim {hidden} not divisible by model_size "
            f"{model_size}: tensor-parallel slices must be uniform")
    if int(pair["w_row"].shape[0]) != hidden:
        raise ValueError(
            f"w_col out dim {hidden} != w_row in dim "
            f"{int(pair['w_row'].shape[0])}: not a column/row pair")
    per = hidden // model_size
    out = []
    for r in range(model_size):
        sl = slice(r * per, (r + 1) * per)
        local = {"w_col": pair["w_col"][:, sl], "w_row": pair["w_row"][sl]}
        if pair.get("b_col") is not None:
            local["b_col"] = pair["b_col"][sl]
        if pair.get("b_row") is not None:
            local["b_row"] = pair["b_row"]
        out.append(local)
    return out


def tp_local_pairs(pairs: Sequence[dict], model_size: int) -> list:
    """Element ``r``: model rank r's list of local pairs (the leaves that
    ``sharded.build_shard_plan`` plans and ``shard_params_model`` cuts)."""
    sliced = [tp_pair_slices(p, model_size) for p in pairs]
    return [[s[r] for s in sliced] for r in range(model_size)]


def tp_rank_pairs(pairs: Sequence[dict], model_size: int, rank: int) -> list:
    """One model rank's local pair stack."""
    return tp_local_pairs(pairs, model_size)[rank]


# ------------------------------------------------------------- wire math


def tp_wire_bytes_per_pair(batch: int, d_out: int,
                           dtype: torch.dtype = torch.float32) -> int:
    """Bytes one pair's allreduce moves per rank and step: the ``(batch,
    d_out)`` activation at its storage dtype."""
    return int(batch) * int(d_out) * dtype.itemsize
