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

Each exchange runs bucket by bucket: fuse the bucket's gradients, cast
to its wire dtype, start its collective (a flat, ``group=`` or shard-1
ZeRO bucket is one ``all_reduce(async_op=True)``; the ladder and ZeRO's
reduce-scatter then batch allreduce run as a chain), then ``synchronize()``
waits for each, divides for AVERAGE at the wire dtype, casts back and
unfuses. HOROVOD_LATENCY_HIDING (the reference's switch for XLA's
latency-hiding scheduler, read at ``init``) starts the buckets during the
backward pass: each parameter gets a post-accumulate-grad hook, and a
bucket starts as soon as its last gradient has landed and every bucket
before it in the launch order has started. The launch order is plan order
on the first exchange; from the second on it is the order in which the
buckets completed on the first rank's first backward pass (agreed over the
exchange's groups at the first ``synchronize``), so every rank issues the
same collectives in the same order and each bucket can start while later
gradients are still being computed. On the card the chains run on a
communication stream that waits for the backward's stream at launch.
Without the hooks, ``synchronize()`` starts every bucket in plan order:
the same buffers, calls and divisions, so the result is the same bit for
bit. A gradient must be final when it lands: code that changes ``.grad``
after the backward pass does so in a tensor hook instead
(``models/pipeline_lm.py`` sums its outer leaves over the pipeline that
way).
"""

from __future__ import annotations

import sys
import weakref
from typing import Iterable, Mapping, Optional

import torch
import torch.distributed as dist

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
    and one backward pass per step.

    With HOROVOD_LATENCY_HIDING on (``basics.config().latency_hiding`` when
    this is built) the exchange starts from the gradient hooks (see the
    module docstring). ``launch_order`` is the order the buckets start in;
    ``last_launches`` holds the last exchange's buckets in that order, each
    as ``(bucket, leaves landed)``: how many parameters' gradients had
    landed when a hook started it, or None where ``synchronize`` did."""

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
        else:
            self._init_flat(owned, hierarchical, groups, dcn_compression,
                            dcn_threshold)
        self.latency_hiding = basics.config().latency_hiding
        self.last_launches: list[tuple[int, Optional[int]]] = []
        self.launch_order = list(range(self.plan.num_buckets))
        # Only the hooks see the landing order worth agreeing on.
        self._agreed = not self.latency_hiding or self.plan.num_buckets < 2
        self._comm = None
        self._bucket_of = [0] * len(self.params)
        for b, bucket in enumerate(self.plan.buckets):
            for d in bucket:
                self._bucket_of[d.index] = b
        self._reset()
        if self.latency_hiding:
            self._init_hooks()

    def _init_flat(self, owned, hierarchical, groups, dcn_compression,
                   dcn_threshold) -> None:
        if {id(p) for p in self.params} != {id(p) for p in owned}:
            raise ValueError(
                "named_parameters must list exactly the optimizer's parameters")
        self.hierarchical = _resolved_hierarchical(hierarchical, self.op)
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
        self.wires = fusion.tier_wires(self.plan, self.op, self.compression,
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

    # ------------------------------------------------------- the exchange

    def _init_hooks(self) -> None:
        # The ladder and ZeRO's pair are chains of dependent collectives:
        # on the card they run on their own stream, so that neither the
        # backward's stream nor the host waits for them before synchronize.
        chained = self.hierarchical or (self.sharded
                                        and self.shard_plan.shard_size > 1)
        dev = self.params[0].device if self.params else None
        self._comm = torch.cuda.Stream(dev) \
            if chained and dev is not None and dev.type == "cuda" else None
        me = weakref.ref(self)      # the hooks outlive no optimizer

        def landed(i):
            def hook(_):
                opt = me()
                if opt is not None:
                    opt._landed(i)
            return hook

        for i, p in enumerate(self.params):
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(landed(i))

    def _reset(self) -> None:
        self._seen = [0] * len(self.params)         # passes landed, per leaf
        self._landed_leaves = 0                     # leaves on their k-th pass
        self._missing = [len(b) for b in self.plan.buckets]
        self._ready = []                            # buckets, as they completed
        self._next = 0                              # position in launch_order
        self._inflight = []
        self._launches = []

    def _landed(self, i: int) -> None:
        """Leaf ``i``'s gradient has accumulated: on its k-th pass it
        counts towards its bucket, and every complete bucket from the next
        one to launch on starts, in launch order."""
        k = self.backward_passes_per_step
        if self._seen[i] == k:
            raise RuntimeError(
                "Gradient ready before optimizer.step(); call synchronize()")
        self._seen[i] += 1
        if self._seen[i] < k:
            return
        self._landed_leaves += 1
        b = self._bucket_of[i]
        self._missing[b] -= 1
        if not self._missing[b]:
            self._ready.append(b)
        order = self.launch_order
        while self._next < len(order) and not self._missing[order[self._next]]:
            self._launch(order[self._next], True)

    def _launch(self, b: int, in_hook: bool) -> None:
        """Start bucket ``b``'s exchange: fuse its gradients (divided by k
        first), cast to its wire dtype, issue its collective or chain."""
        grads = [p.grad for p in self.params]
        if self.backward_passes_per_step > 1:
            for d in self.plan.buckets[b]:
                grads[d.index].div_(self.backward_passes_per_step)
        buf = fusion.fuse_bucket(grads, self.plan, b)
        wire = self.wires[b] if self.sharded else self.wires[0][b]
        shipped = buf.to(wire) if wire is not None else buf
        if self.hierarchical:
            out = self._chain(lambda: collectives.hierarchical_allreduce(
                shipped, self.groups, average=self.op == ReduceOp.AVERAGE,
                dcn_wire_dtype=self.wires[1][b]))
        elif self.sharded and self.shard_plan.shard_size > 1:
            out = self._chain(lambda: sh.scatter_bucket(
                shipped, buf.dtype, self.layout, self.op))
        else:
            group = self.layout.batch_group if self.sharded else self.group
            out = collectives.allreduce_async_(shipped, self.op, group)
        # ``shipped`` stays referenced until synchronize: the collective
        # reads it on another stream than the one it was made on.
        self._inflight.append((b, buf.dtype, shipped, out))
        self._launches.append((b, self._landed_leaves if in_hook else None))
        self._next += 1

    def _chain(self, run):
        if self._comm is None:
            return run()
        self._comm.wait_stream(torch.cuda.current_stream(self._comm.device))
        with torch.cuda.stream(self._comm):
            return run()

    def _agree(self) -> None:
        """Launch from now on in the order the buckets completed here (those
        that never did last, in plan order), as the first rank of the
        exchange's groups saw it."""
        done = set(self._ready)
        order = torch.tensor(
            self._ready + [b for b in range(self.plan.num_buckets) if b not in done],
            dtype=torch.int64, device=self.params[0].device)
        if self.hierarchical:
            groups = (self.groups.ici_group, self.groups.dcn_group)
        elif self.sharded:
            groups = (self.layout.batch_group, self.layout.shard_group)
        else:
            groups = (self.group,)
        # Root's order along one group, then along the other: the groups
        # tile the world, so every rank ends with the first rank's.
        for g in groups:
            if dist.get_world_size(g) > 1:
                collectives.broadcast(order, 0, g)
        self.launch_order = order.tolist()
        self._agreed = True

    def synchronize(self) -> None:
        """Allreduce every parameter's gradient (a missing one counts as 0);
        sharded, reduce-scatter them into the rows' ``.grad``: start the
        buckets no hook has started, in launch order, then wait for each
        and unfuse it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        order = self.launch_order
        while self._next < len(order):
            self._launch(order[self._next], False)
        if self._comm is not None:
            torch.cuda.current_stream(self._comm.device).wait_stream(self._comm)
        grads = [p.grad for p in self.params]
        for b, dtype, _, out in self._inflight:
            if isinstance(out, collectives.Pending):
                out = out.wait()
            reduced = out.to(dtype)
            if self.sharded:
                self.rows[b].grad = reduced
            else:
                fusion.unfuse_bucket_(reduced, self.plan, b, grads)
        self.last_launches = self._launches
        if not self._agreed:
            self._agree()
        self._reset()

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
            if any(self._seen):
                raise RuntimeError(
                    "zero_grad() called after gradients landed and before "
                    "step(); call step() or synchronize() first")
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
