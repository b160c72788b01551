"""``DistributedOptimizer`` and the broadcasts that keep ranks in step.

The counterpart of ``horovod_tpu.jax.DistributedOptimizer``: ``step()``
fuses the gradients into the buckets of a fusion plan, casts each bucket
to its wire dtype, allreduces it (one collective per bucket), unfuses the
result back into each parameter's ``.grad`` and then runs the wrapped
optimizer. The plan is built once, from the parameters in the order the
caller gives them; to line up with the JAX package's buckets, give them in
the order its parameter tree flattens (``convert.jax_ordered`` does so for
the transformer).

``hierarchical=True`` (or HOROVOD_HIERARCHICAL_ALLREDUCE) sends each bucket
down the ``('dcn', 'ici')`` ladder of ``parallel.mesh.hierarchical_groups``:
the plan pads each bucket to the ICI size and caps it by the DCN tier's
threshold, and the DCN tier may ship at its own wire dtype.

``sharded=True`` (or HOROVOD_SHARD_PARAMS) is ZeRO over the ``('batch',
'shard')`` groups of ``parallel.mesh.sharded_groups``
(``parallel/sharded.py``): the wrapped optimizer is built on this rank's
``ShardedBuckets`` rows, ``step()`` reduce-scatters the model's full
gradients into the rows' ``.grad``, steps them and zeroes their pad tail;
the caller refreshes the model's parameters with ``gather_params`` at the
start of each step. ``broadcast_sharded_state`` gives every batch replica
root's rows and optimizer state.
"""

from __future__ import annotations

import sys
from typing import Iterable, Mapping, Optional

import torch

from .common import basics
from .compression import Compression
from .parallel import collectives, fusion, sharded as sh
from .parallel.collectives import ReduceOp
from .parallel.mesh import hierarchical_groups, sharded_groups


def _resolved_threshold(fusion_threshold: Optional[int]) -> int:
    """None -> HOROVOD_FUSION_THRESHOLD (default 64 MiB)."""
    if fusion_threshold is not None:
        return fusion_threshold
    return basics.config().fusion_threshold


def _resolved_num_buckets(num_buckets: Optional[int]) -> int:
    """None -> HOROVOD_NUM_BUCKETS (default 1)."""
    if num_buckets is not None:
        return max(1, int(num_buckets))
    return basics.config().num_buckets


def _resolved_compression(compression):
    """None -> HOROVOD_COMPRESSION; an explicit argument wins."""
    if compression is not None:
        return compression
    return Compression.by_name(basics.config().compression)


def _resolved_hierarchical(hierarchical: Optional[bool], op: ReduceOp) -> bool:
    """None -> HOROVOD_HIERARCHICAL_ALLREDUCE. The ladder sums: an
    env-resolved True with another op warns and runs flat, while an
    explicit True with one raises."""
    sums = op in (ReduceOp.SUM, ReduceOp.AVERAGE)
    if hierarchical is not None:
        if hierarchical and not sums:
            raise ValueError(
                f"hierarchical allreduce supports SUM/AVERAGE only (got "
                f"{op}); use hierarchical=False for {op.name}")
        return bool(hierarchical)
    if not basics.config().hierarchical_allreduce:
        return False
    if not sums:
        print(f"[horovod_tpu_torch/warning] hierarchical allreduce supports "
              f"SUM/AVERAGE only; running {op.name} on the flat allreduce",
              file=sys.stderr)
        return False
    return True


def _resolved_sharded(sharded: Optional[bool]) -> bool:
    """None -> HOROVOD_SHARD_PARAMS; an explicit argument wins."""
    if sharded is not None:
        return bool(sharded)
    return basics.config().shard_params


class DistributedOptimizer:
    """Wrap ``optimizer`` so that each ``step()`` first averages the
    gradients over all ranks.

    ``backward_passes_per_step = k > 1`` lets gradients of k backward
    passes accumulate in ``.grad``; every k-th ``step()`` divides them by k
    (the mean, as ``optax.MultiSteps`` takes it), allreduces and steps, and
    the calls between are no-ops, as is ``zero_grad()`` after them.

    ``hierarchical`` (None: HOROVOD_HIERARCHICAL_ALLREDUCE) takes the
    ladder over ``groups`` (None: ``hierarchical_groups()``, built here,
    once: a step captured in a CUDA graph must create no group);
    ``dcn_compression`` (None: HOROVOD_DCN_COMPRESSION, and where that is
    empty the policy table for adaptive, else ``compression``) and
    ``dcn_threshold`` (None: HOROVOD_DCN_FUSION_THRESHOLD; 0 is no cap) set
    the DCN tier's wire dtype and bucket cap; ``wires`` holds each bucket's
    (ICI, DCN) wire dtypes. ``op`` is the reduction, AVERAGE as in
    Horovod.

    ``sharded`` (None: HOROVOD_SHARD_PARAMS) puts the optimizer on the
    ZeRO exchange over ``layout`` (None: ``sharded_groups()``, built here,
    once). ``optimizer`` is then built on this rank's rows
    (``sharded.shard_params``), in bucket order, and ``named_parameters``
    names the model's full parameters, the source of the gradients and the
    target of ``sharded.gather_params``. ``shard_plan`` (None: planned
    here from those parameters and the layout's shard size) and each
    bucket's wire dtype (``.wires``) are fixed here. SUM and AVERAGE only,
    and one backward pass per step."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Iterable[tuple[str, torch.Tensor]],
                 compression=None, fusion_threshold: Optional[int] = None,
                 num_buckets: Optional[int] = None,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 hierarchical: Optional[bool] = None, dcn_compression=None,
                 dcn_threshold: Optional[int] = None, groups=None,
                 sharded: Optional[bool] = None, shard_plan=None, layout=None,
                 group: collectives.Group = None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        named = list(named_parameters)
        names = [n for n, _ in named]
        if len(set(names)) != len(names):
            raise ValueError("named_parameters has duplicate names")
        self.optimizer = optimizer
        self.params = [p for _, p in named]
        self.compression = _resolved_compression(compression)
        self.threshold = _resolved_threshold(fusion_threshold)
        self.num_buckets = _resolved_num_buckets(num_buckets)
        self.compression_min_bytes = basics.config().compression_min_bytes
        self.backward_passes_per_step = backward_passes_per_step
        self.op = op
        self.group = group
        self._passes = 0
        self.sharded = _resolved_sharded(sharded)
        owned = [p for g in optimizer.param_groups for p in g["params"]]
        if self.sharded:
            self._init_sharded(owned, shard_plan, layout)
            return
        if {id(p) for p in self.params} != {id(p) for p in owned}:
            raise ValueError(
                "named_parameters must list exactly the optimizer's parameters")
        self.hierarchical = _resolved_hierarchical(hierarchical, op)
        self.groups, pad_to = None, 1
        threshold = self.threshold
        if self.hierarchical:
            self.groups = groups if groups is not None else hierarchical_groups()
            if dcn_threshold is None:
                dcn_threshold = basics.config().dcn_fusion_threshold
            pad_to = self.groups.ici_size
            threshold = fusion.dcn_capped_threshold(threshold, dcn_threshold,
                                                    pad_to)
        self.plan = fusion.build_plan(self.params, threshold, self.num_buckets,
                                      pad_to)
        # (ICI, DCN) wire dtype per bucket, chosen once: the plan and the
        # knobs are fixed from here on.
        self.wires = fusion.tier_wires(self.plan, op, self.compression,
                                       self.compression_min_bytes,
                                       self.hierarchical, dcn_compression)

    def _init_sharded(self, owned, shard_plan, layout) -> None:
        if self.backward_passes_per_step > 1:
            raise ValueError(
                "DistributedOptimizer(sharded=True) does not compose with "
                "backward_passes_per_step > 1; accumulate microbatch gradients "
                "in the training loop and call update() once per exchange")
        if self.op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(
                f"sharded gradient exchange supports SUM/AVERAGE only (got "
                f"{self.op}); reduce-scatter is a sum machine")
        self.hierarchical, self.groups = False, None
        self.layout = layout if layout is not None else sharded_groups()
        if shard_plan is None:
            shard_plan = sh.build_shard_plan(self.params, self.layout.shard_size,
                                             self.threshold, self.num_buckets)
        if shard_plan.shard_size != self.layout.shard_size:
            raise ValueError(f"shard_plan shards over {shard_plan.shard_size} "
                             f"ranks, the layout's shard group has "
                             f"{self.layout.shard_size}")
        self.shard_plan, self.plan = shard_plan, shard_plan.base
        self.rows = sh.ShardedBuckets(owned)
        if [tuple(p.shape) for p in owned] != [(c,) for c in shard_plan.chunk_sizes]:
            raise ValueError(
                "a sharded optimizer must be built on this rank's rows of the "
                f"plan, in bucket order: shapes {[tuple(p.shape) for p in owned]}, "
                f"the plan's chunks {list(shard_plan.chunk_sizes)}")
        # Each bucket's wire dtype, chosen once: the plan is fixed from here.
        self.wires = sh.shard_wires(shard_plan, self.op, self.compression,
                                    self.compression_min_bytes)

    def synchronize(self) -> None:
        """Allreduce every parameter's gradient (a missing one counts as 0);
        sharded, reduce-scatter them into the rows' ``.grad``."""
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.sharded:
            reduced = sh.reduce_scatter_gradients(grads, self.shard_plan,
                                                  self.layout, self.op, self.wires)
            for row, g in zip(self.rows, reduced):
                row.grad = g
            return
        if self.backward_passes_per_step > 1:
            for g in grads:
                g.div_(self.backward_passes_per_step)
        fusion.fused_allreduce_(grads, self.plan, self.op,
                                hierarchical=self.hierarchical,
                                groups=self.groups, wires=self.wires,
                                group=self.group)

    def step(self) -> bool:
        """Allreduce and step; returns whether this call stepped."""
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return False
        self._passes = 0
        self.synchronize()
        self.optimizer.step()
        if self.sharded:
            sh.mask_pad_(self.rows, self.shard_plan, self.layout.shard_rank)
        return True

    def zero_grad(self) -> None:
        if self._passes == 0:
            self.optimizer.zero_grad()
            if self.sharded:            # the model's full gradients
                for p in self.params:
                    p.grad = None


def _named_tensors(params) -> list[tuple[str, torch.Tensor]]:
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().items())
    if isinstance(params, Mapping):
        return list(params.items())
    return list(params)


def broadcast_parameters(params, root_rank: int = 0,
                         group: collectives.Group = None) -> None:
    """Overwrite every tensor of ``params`` (a module, a state dict, or
    ``(name, tensor)`` pairs) with root's value, in place, over ``group``
    (None: the world; ``root_rank`` is a rank of ``group``)."""
    with torch.no_grad():
        for _, t in _named_tensors(params):
            collectives.broadcast(t.data, root_rank, group)


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              group: collectives.Group = None) -> None:
    """Give every rank of ``group`` (None: the world) root's optimizer
    state and numeric hyperparameters; ``root_rank`` is a rank of
    ``group``.

    State that does not exist yet (a fresh ``Adam``, before its first step)
    is the same on every rank by construction and is left alone, so no
    optimizer step is taken to create it."""
    if isinstance(optimizer, DistributedOptimizer):
        optimizer = optimizer.optimizer
    dev = basics.device()
    with torch.no_grad():
        for pg in optimizer.param_groups:
            keys = sorted(k for k, v in pg.items()
                          if isinstance(v, (int, float)) and not isinstance(v, bool))
            if keys:
                vals = torch.tensor([float(pg[k]) for k in keys],
                                    dtype=torch.float64, device=dev)
                collectives.broadcast(vals, root_rank, group)
                for k, v in zip(keys, vals.tolist()):
                    pg[k] = type(pg[k])(v)
            for p in pg["params"]:
                for key in sorted(optimizer.state.get(p, {})):
                    t = optimizer.state[p][key]
                    if torch.is_tensor(t):
                        on_dev = t.to(dev)
                        collectives.broadcast(on_dev, root_rank, group)
                        t.copy_(on_dev)


def broadcast_sharded_state(rows_or_optimizer, root_rank: int = 0,
                            layout=None) -> None:
    """Initial-state consistency for the sharded layout: each shard rank
    owns other rows, so a broadcast from one global root would overwrite
    every rank's rows with root's. This broadcasts over the batch group
    only: batch rank ``root_rank`` of each shard index gives its rows to
    the other replicas of that index. Takes a sharded
    ``DistributedOptimizer`` (its rows and its wrapped optimizer's state
    and hyperparameters; ``layout`` defaults to its own) or a
    ``ShardedBuckets`` (with ``layout``)."""
    opt = rows_or_optimizer if isinstance(rows_or_optimizer,
                                          DistributedOptimizer) else None
    rows = opt.rows if opt is not None else rows_or_optimizer
    if layout is None:
        if opt is None:
            raise ValueError("broadcast_sharded_state of rows needs layout=")
        layout = opt.layout
    with torch.no_grad():
        for row in rows:
            collectives.broadcast(row.data, root_rank, layout.batch_group)
    if opt is not None:
        broadcast_optimizer_state(opt.optimizer, root_rank, layout.batch_group)


def metric_average(value) -> float:
    """Average a scalar metric over all ranks."""
    t = torch.tensor([float(value)], dtype=torch.float64, device=basics.device())
    return float(collectives.allreduce_(t, ReduceOp.AVERAGE).item())
