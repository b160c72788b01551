"""Sharded data parallelism (ZeRO) through the bucketed planner.

The counterpart of ``horovod_tpu.parallel.sharded``. The per-bucket
allreduce of data parallelism becomes

    reduce-scatter(bucket gradients -> the owning shard rank)
    ... the optimizer steps this rank's rows only ...
    all-gather(bucket parameters)          # the refresh, at the step's start

over the ``('batch', 'shard')`` process groups of
``parallel.mesh.sharded_groups``: gradients still sum over 'batch' (plain
data-parallel replicas), and 'shard' carries the partition, so parameters
in the optimizer, its state and the reduced gradients take 1/shard of the
memory per rank. The bucket layout is the shard layout:
``fusion.build_plan(pad_to=shard_size)`` packs the leaves into buckets
zero-padded to a multiple of the shard size, and shard rank ``s`` owns row
``s`` of each bucket's ``(shard_size, chunk)`` view. At ``shard_size = 1``
the plan is the DP plan and the exchange is the DP path's own call
(``collectives.bucketed_allreduce`` over 'batch'), so a sharded step
equals the DP step bit for bit.

Where the port differs from the JAX API, and why:

- A torch rank holds only its own rows. :class:`ShardedBuckets` is one
  ``nn.Parameter`` of shape ``(chunk,)`` per bucket, so a ``torch.optim``
  optimizer is built on it directly (the JAX package's
  ``optimizer.init(sharded_params)`` on ``(shard_size, chunk)`` buffers
  that shard_map splits). The host-side functions that need every rank's
  rows (``unshard_params``, ``unshard_tree``, ``shard_params_model``) take
  or give them as a list with one entry per rank.
- There is no ``shard_specs``: there are no shard_map specs to build, since
  each rank already holds only its row.
- ``mask_pad_`` writes 0.0 to the pad positions of this rank's rows after
  the optimizer has stepped them in place, where the JAX package masks the
  update before it is applied. The tail is 0.0 before the step, so both
  leave it 0.0 and the real elements alike.
- Leaves are sequences of tensors in a fixed order (for a model,
  ``convert.jax_ordered``'s), not pytrees; the containers that
  ``unshard_tree``/``reshard_tree``/``state_bytes`` walk are nested dicts,
  lists and tuples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from . import collectives, fusion
from .collectives import ReduceOp
from ..common.config import Config


class ShardedBuckets:
    """This rank's rows: one ``nn.Parameter`` of shape ``(chunk,)`` per
    bucket of a :class:`ShardPlan`, in bucket order."""

    def __init__(self, rows: Sequence[torch.Tensor]):
        self.rows = list(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def __getitem__(self, i):
        return self.rows[i]

    def __repr__(self) -> str:
        return "ShardedBuckets([" + ",".join(
            str(tuple(r.shape)) for r in self.rows) + "])"


@dataclass(frozen=True)
class ShardPlan:
    """A fusion plan bound to a shard size: the bucket layout is the
    partition. Every rank derives the same plan from the same leaves and
    knobs. ``model_size`` records the third mesh axis; the planned leaves
    are one model rank's, so it changes no bucket."""

    base: fusion.FusionPlan
    shard_size: int
    threshold: int
    raw_sizes: tuple          # per bucket, elements before padding
    padded_sizes: tuple       # per bucket, elements after padding
    chunk_sizes: tuple        # per bucket, elements per rank
    bucket_dtypes: tuple      # torch dtypes
    model_size: int = 1

    @property
    def num_buckets(self) -> int:
        return self.base.num_buckets

    def state_bytes_per_rank(self) -> int:
        """Bytes of one sharded copy of the planned leaves per rank
        (parameters; multiply by the optimizer's state factor for its
        moments)."""
        return sum(c * d.itemsize
                   for c, d in zip(self.chunk_sizes, self.bucket_dtypes))


def build_shard_plan(leaves: Sequence, shard_size: int,
                     threshold: Optional[int] = None,
                     num_buckets: Optional[int] = None,
                     dcn_threshold: Optional[int] = None,
                     model_size: int = 1) -> ShardPlan:
    """Plan the sharded buckets of ``leaves`` (anything with ``shape`` and
    ``dtype``). ``threshold`` None reads HOROVOD_FUSION_THRESHOLD,
    ``num_buckets`` None HOROVOD_NUM_BUCKETS; with ``shard_size > 1`` the
    threshold is capped by ``fusion.dcn_capped_threshold`` (a bucket's
    scatter ships 1/shard of its bytes; ``dcn_threshold`` None reads
    HOROVOD_DCN_FUSION_THRESHOLD). ``shard_size = 1`` gives the DP plan."""
    if shard_size < 1:
        raise ValueError(f"shard_size must be >= 1, got {shard_size}")
    if model_size < 1:
        raise ValueError(f"model_size must be >= 1, got {model_size}")
    cfg = Config.from_env()
    if threshold is None:
        threshold = cfg.fusion_threshold
    if num_buckets is None:
        num_buckets = cfg.num_buckets
    if shard_size > 1:
        if dcn_threshold is None:
            dcn_threshold = cfg.dcn_fusion_threshold
        threshold = fusion.dcn_capped_threshold(threshold, dcn_threshold,
                                                shard_size)
    plan = fusion.build_plan(leaves, threshold, num_buckets, pad_to=shard_size)
    raw = [sum(d.size for d in bucket) for bucket in plan.buckets]
    padded = [n + (-n % shard_size) for n in raw]
    return ShardPlan(plan, int(shard_size), int(threshold), tuple(raw),
                     tuple(padded), tuple(p // shard_size for p in padded),
                     tuple(getattr(torch, b[0].dtype) for b in plan.buckets),
                     int(model_size))


def shard_params(params: Sequence[torch.Tensor], plan: ShardPlan,
                 shard_rank: int) -> ShardedBuckets:
    """Cut shard rank ``shard_rank``'s rows from the full ``params``: each
    bucket fused and zero-padded, row ``shard_rank`` of its
    ``(shard_size, chunk)`` view, copied into a new parameter."""
    if not 0 <= shard_rank < plan.shard_size:
        raise ValueError(f"shard rank {shard_rank} outside [0, {plan.shard_size})")
    with torch.no_grad():
        buffers = fusion.fuse([p.detach() for p in params], plan.base)
        return ShardedBuckets(
            nn.Parameter(b.view(plan.shard_size, -1)[shard_rank].clone())
            for b in buffers)


def _leaves(plan: ShardPlan) -> list:
    return sorted((d for bucket in plan.base.buckets for d in bucket),
                  key=lambda d: d.index)


def unshard_params(rows_of_every_rank: Sequence, plan: ShardPlan) -> list:
    """The full leaves from every shard rank's rows (in shard-rank order),
    the pad tail dropped: the host-side inverse of :func:`shard_params`."""
    if len(rows_of_every_rank) != plan.shard_size:
        raise ValueError(f"need the rows of {plan.shard_size} shard ranks, "
                         f"got {len(rows_of_every_rank)}")
    flat = [torch.cat([rows[b].detach().reshape(-1) for rows in rows_of_every_rank])
            for b in range(plan.num_buckets)]
    out = [torch.empty(d.shape, dtype=getattr(torch, d.dtype),
                       device=flat[0].device) for d in _leaves(plan)]
    fusion.unfuse_(flat, plan.base, out)
    return out


def gather_params(rows: ShardedBuckets, plan: ShardPlan, layout,
                  out: Sequence[torch.Tensor]) -> None:
    """The parameter refresh: one all-gather per bucket over the shard
    group rebuilds each fused bucket from every rank's row, and its slices
    are copied into ``out`` (the model's parameters, in the plan's leaf
    order) in place. At ``shard_size = 1`` the row is the bucket and no
    collective is issued. ``layout``: a ``parallel.mesh.ShardedLayout``."""
    with torch.no_grad():
        flat = [row.detach() if plan.shard_size == 1
                else collectives.all_gather_into(row.detach(), layout.shard_group,
                                                 name=f"param.{b}")
                for b, row in enumerate(rows)]
        fusion.unfuse_(flat, plan.base, out)


def shard_wires(plan: ShardPlan, op: ReduceOp = ReduceOp.AVERAGE,
                compression=None,
                compression_min_bytes: Optional[int] = None) -> list:
    """Per bucket, the dtype its exchange ships at, or None: the DP
    planner's verdict on the padded bucket (``compression`` None is no
    compression; ``compression_min_bytes`` None reads
    HOROVOD_COMPRESSION_MIN_BYTES)."""
    if compression_min_bytes is None:
        compression_min_bytes = Config.from_env().compression_min_bytes
    return [fusion.wire_dtype_for_bucket(compression, dt, n * dt.itemsize, op,
                                         compression_min_bytes)
            for n, dt in zip(plan.padded_sizes, plan.bucket_dtypes)]


def reduce_scatter_gradients(grads: Sequence[torch.Tensor], plan: ShardPlan,
                             layout, op: ReduceOp = ReduceOp.AVERAGE,
                             wires: Optional[Sequence] = None) -> list:
    """The sharded gradient exchange of the full ``grads`` (in the plan's
    leaf order): per bucket, fuse, cast to its wire dtype (``wires``, one
    per bucket; None: ``shard_wires(plan, op)``), reduce-scatter (sum)
    over the shard group, sum over the batch group, cast back, and for
    AVERAGE divide by batch x shard. Returns this rank's ``(chunk,)``
    gradient of each bucket. At ``shard_size = 1`` it is the DP path's
    call, ``collectives.bucketed_allreduce`` over the batch group, which
    divides at the wire dtype."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"sharded gradient exchange supports SUM/AVERAGE only (got "
            f"{op}); reduce-scatter is a sum machine")
    if layout.shard_size != plan.shard_size:
        raise ValueError(f"plan shards over {plan.shard_size} ranks, the "
                         f"layout's shard group has {layout.shard_size}")
    if wires is None:
        wires = shard_wires(plan, op)
    buffers = fusion.fuse(grads, plan.base)
    shipped = [b.to(w) if w is not None else b for b, w in zip(buffers, wires)]
    if plan.shard_size == 1:
        reduced = collectives.bucketed_allreduce(shipped, op, layout.batch_group)
        return [r.to(b.dtype) for r, b in zip(reduced, buffers)]
    return [scatter_bucket(s, b.dtype, layout, op)
            for s, b in zip(shipped, buffers)]


def scatter_bucket(shipped: torch.Tensor, dtype: torch.dtype, layout,
                   op: ReduceOp = ReduceOp.AVERAGE,
                   name: Optional[str] = None) -> torch.Tensor:
    """One bucket's exchange at ``shard_size > 1``: reduce-scatter (sum)
    the buffer ``shipped`` (at its wire dtype) over the shard group, sum
    the chunk over the batch group, cast it back to ``dtype`` and for
    AVERAGE divide by batch x shard. Each step reads the one before.
    ``name`` traces the scatter (the batch sum as ``<name>.batch``)."""
    chunk = collectives.reducescatter(shipped, layout.shard_group, name=name)
    if layout.batch_size > 1:
        collectives.allreduce_(chunk, ReduceOp.SUM, layout.batch_group,
                               name=f"{name}.batch" if name else None)
    chunk = chunk.to(dtype)
    if op == ReduceOp.AVERAGE:
        chunk.div_(layout.shard_size * layout.batch_size)
    return chunk


def mask_pad_(rows: ShardedBuckets, plan: ShardPlan, shard_rank: int) -> None:
    """Write 0.0 to the pad positions of this rank's rows, in place: the
    elements at ``shard_rank * chunk + i >= raw``, which only the last
    ranks of a padded bucket hold. Unpadded buckets are not touched."""
    with torch.no_grad():
        for b, row in enumerate(rows):
            raw, chunk = plan.raw_sizes[b], plan.chunk_sizes[b]
            if raw == plan.padded_sizes[b]:
                continue
            valid = min(max(raw - shard_rank * chunk, 0), chunk)
            if valid < chunk:
                row[valid:].zero_()


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (a
    :class:`ShardedBuckets` is a leaf), with the same positions of
    ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unshard_tree(trees: Sequence, plan: ShardPlan):
    """Consolidate a training state: ``trees`` holds the same structure
    from every shard rank (in shard-rank order); each
    :class:`ShardedBuckets` position becomes the full leaves
    (:func:`unshard_params`), the pad tail dropped, and every other leaf is
    shard rank 0's."""
    def one(first, *others):
        if isinstance(first, ShardedBuckets):
            return unshard_params([first, *others], plan)
        return first

    return _map(one, trees[0], *trees[1:])


def reshard_tree(full, template, plan: ShardPlan, shard_rank: int):
    """Inverse of :func:`unshard_tree` for one rank: where ``template`` (a
    live sharded state) holds a :class:`ShardedBuckets`, cut
    ``shard_rank``'s rows of ``full``'s leaves there (fresh zero pad);
    elsewhere take ``full``'s value. ``plan`` may shard over another size
    than the state that was consolidated."""
    return _map(lambda t, f: shard_params(f, plan, shard_rank)
                if isinstance(t, ShardedBuckets) else f, template, full)


def shard_params_model(local_trees: Sequence, plan: ShardPlan) -> list:
    """The rows of every (model, shard) rank, model-major: entry ``m *
    shard_size + s`` is shard rank ``s``'s rows of model rank ``m``'s local
    leaves (the JAX package's stacked ``(model * shard, chunk)`` buffers,
    row for row)."""
    if len(local_trees) != plan.model_size:
        raise ValueError(
            f"need one local tree per model rank: got {len(local_trees)} "
            f"trees for model_size={plan.model_size}")
    return [shard_params(t, plan, s) for t in local_trees
            for s in range(plan.shard_size)]


def unshard_params_model(rows: Sequence, plan: ShardPlan) -> list:
    """Host-side inverse of :func:`shard_params_model`: each model rank's
    local leaves, in model-rank order."""
    n = plan.shard_size
    return [unshard_params(rows[m * n:(m + 1) * n], plan)
            for m in range(plan.model_size)]


def state_bytes(tree) -> int:
    """Total bytes of the tensors in nested dicts, lists and tuples (a
    :class:`ShardedBuckets` counts this rank's rows)."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, ShardedBuckets):
        tree = tree.rows
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(t) for t in tree)
    return 0
