"""The port's trainer: data-parallel, and optionally sequence-parallel,
TransformerLM training through ``DistributedOptimizer``.

``train(config, steps)`` runs Horovod's contract end to end: ``init`` ->
build the model -> ``broadcast_parameters`` -> ``broadcast_optimizer_state``
-> ``steps`` steps, each forward, next-token cross entropy, backward, and
``DistributedOptimizer.step`` (fused bucket allreduce, then Adam).
It runs on the card unless ``device="cpu"``, on as many cards as the
launcher (torchrun or the horovod launcher) starts processes.

``config.sp = k`` lays the world out as dp × sp (``parallel.mesh``): rings
of k consecutive ranks, each ring one data-parallel replica that shares
one global batch, each rank a ``seq // k`` shard of it, with attention
around the ring. The loss averages over the world and the gradients over
the whole world, as the JAX dp×sp step's ``axis_name=("dp", "sp")``.
``sp = None`` is plain data parallelism with no ring.

The long-context options are the JAX example's: ``remat`` recomputes each
block in the backward pass, ``loss_chunk > 0`` computes the loss from the
normed hidden states over sequence chunks (``chunked_lm_loss``), and
``logits_dtype = "bfloat16"`` runs the LM head in bf16 (the loss upcasts
before the cross entropy). ``steps_per_dispatch = K`` trains from a
``data.DeviceCache`` of ``CACHE_ROWS`` sequences through
``loop.make_scan_train_loop``: on the card one CUDA graph of the whole
step, replayed K times per dispatch, with Adam built ``capturable``;
``metric_average`` then runs once per dispatch, on the mean loss.

``config.sharded = True`` (None: HOROVOD_SHARD_PARAMS) trains with ZeRO on
the ``('batch', 'shard')`` groups that ``HOROVOD_MESH`` lays out
(``parallel.mesh.sharded_groups``): the parameters are broadcast whole,
each rank cuts its rows of the fusion buckets, Adam steps the rows, and
each step starts with ``gather_params``, which refreshes the model's
parameters from every shard's rows. ``setup_fsdp`` builds the per-leaf
FSDP step instead (``parallel/fsdp.py``): the model runs on the gathered
leaves through ``torch.func.functional_call``. Adam runs its ``foreach``
implementation on every path, so that it steps a flat row and a parameter
with the same arithmetic per element: at ``shard = 1`` a sharded step is
the data-parallel step bit for bit, graphed (both Adams ``capturable``) or
eager.

The model axis of ``HOROVOD_MESH`` (``"<batch>x<shard>x<model>"``) or of
``setup(layout=sharded_groups(b, s, m))`` puts tensor parallelism into
``setup``: the model is cut over the model group (``build_model(tp_group=)``),
the exchange runs over the batch group (flat) or the ``('batch', 'shard')``
groups of the model index (ZeRO), and the ranks of one model group draw
one batch, the JAX package's ``('batch', 'shard', 'model')`` cube.

``setup_pipeline(config, pp, n_micro)`` builds the GPipe step of
``models/pipeline_lm.py`` on the ``('dp', 'pp')`` groups of
``training_groups``: each rank draws the whole model from the config's
seed and keeps its stage (``build_pipeline_stage``), Adam steps the
stage's parameters through ``DistributedOptimizer(group=<dp group>)``,
and a step feeds the replica's batch of ``config.batch`` sequences as
``n_micro`` microbatches. The ranks of one pipeline share their batch,
drawn from (seed, dp index).

Every step takes ``config.steps_per_dispatch``: the ZeRO step of
``setup(TrainConfig(sharded=True, steps_per_dispatch=K))``, the FSDP step
and the pipelined step are captured and replayed by the loop as the flat
one is, where the JAX package jits each one under ``shard_map`` and scans
it (``make_scan_train_loop``). Every loop draws from ``make_cache(config,
sp, device, index)``: a pipeline replica passes its dp index. The loop's
warm-up restores the optimizer's parameters (ZeRO's and FSDP's rows), and
a ZeRO step refreshes the model's parameters from them at its start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from dataclasses import dataclass, field
from typing import Callable, ContextManager, Optional

import torch
import torch.distributed as dist

from . import optimizer as hvd_opt
from .common import basics
from .compression import Compression, normalize
from .convert import jax_ordered
from .data import DeviceCache
from .loop import make_scan_train_loop
from .models.moe import ep_state_dict
from .models.pipeline_lm import (PipelineStage, pipeline_lm_loss_and_grads,
                                 stage_state_dict)
from .models.transformer import (TransformerLM, chunked_lm_loss, init_weights,
                                 next_tokens, token_loss, tp_state_dict)
from .parallel import fsdp
from .parallel import sharded as sh
from .parallel.mesh import (DpFsdp, DpSp, ShardedLayout, dp_sp_groups,
                            hierarchical_groups, mesh_model_axis,
                            parse_mesh_spec, sharded_groups, training_groups)
from .parallel.pipeline import stage_of
from .parallel.tensor import model_size

# Sequences per rank in the DeviceCache of a graphed run (8 x 4096 int64
# tokens and as many targets: 0.5 MB).
CACHE_ROWS = 8


@dataclass
class TrainConfig:
    """The flash TransformerLM of the repo's transformer benchmark at its
    published width: vocab 32000, dim 1024, 8 heads of 128, 12 layers."""

    vocab: int = 32000
    dim: int = 1024
    heads: int = 8
    kv_heads: Optional[int] = None
    layers: int = 12
    mlp_ratio: int = 4
    seq: int = 4096
    batch: int = 1                      # per rank (with sp: per ring)
    lr: float = 1e-3
    attention: str = "flash"
    dtype: str = "bfloat16"             # activations; params stay float32
    seed: int = 0
    sp: Optional[int] = None            # ring size; None: no ring
    remat: bool = False                 # recompute each block in backward
    loss_chunk: int = 0                 # > 0: chunked_lm_loss over chunks
    logits_dtype: str = "float32"       # the LM head's
    steps_per_dispatch: Optional[int] = None   # K steps per CUDA graph dispatch
    sharded: Optional[bool] = None      # ZeRO; None: HOROVOD_SHARD_PARAMS
    block_q: Optional[int] = None       # flash tile ceilings (TransformerLM's);
    block_k: Optional[int] = None       # None: each kernel's default

    def __post_init__(self):
        if self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be >= 0, got {self.loss_chunk}")
        if self.loss_chunk and self.logits_dtype != "float32":
            raise ValueError(
                f"logits_dtype {self.logits_dtype} does not reach the "
                "loss_chunk path (chunked_lm_loss does its own float32 head "
                "product); drop one of the two")
        if self.steps_per_dispatch is not None and self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{self.steps_per_dispatch}")


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)       # per step, rank-averaged
    step_s: list = field(default_factory=list)       # host clock per step
    tokens_per_step: int = 0                          # over the data ranks
    num_buckets: int = 0
    params: int = 0
    # With steps_per_dispatch: per dispatch of K steps instead of per step.
    dispatch_losses: list = field(default_factory=list)   # mean, rank-averaged
    dispatch_s: list = field(default_factory=list)        # host clock
    capture_s: Optional[float] = None                     # warm-up + capture


def model_kwargs(config: TrainConfig, **extra) -> dict:
    """The ``TransformerLM`` arguments of the config's model (``extra``
    adds or overrides some): ``build_model``'s, which a caller may give
    ``tp_size`` to see one model rank's shapes (on the meta device, say)."""
    return dict(vocab=config.vocab, dim=config.dim, heads=config.heads,
                layers=config.layers, mlp_ratio=config.mlp_ratio,
                dtype=getattr(torch, config.dtype), attention=config.attention,
                kv_heads=config.kv_heads,
                logits_dtype=getattr(torch, config.logits_dtype),
                remat=config.remat, block_q=config.block_q,
                block_k=config.block_k, **extra)


def build_model(config: TrainConfig, device, sp_group=None, tp_group=None,
                ep_group=None, moe_experts: int = 0,
                moe_every: int = 2) -> TransformerLM:
    """The config's model with random weights drawn from its seed.
    ``tp_group``/``ep_group`` of more than one rank: the whole model's
    weights are drawn and this rank's slices cut from them
    (``tp_state_dict``, ``ep_state_dict``), so the ranks of a group hold
    one model; ``moe_experts``/``moe_every`` as ``TransformerLM`` takes
    them."""
    kw = model_kwargs(config, sp_group=sp_group, moe_experts=moe_experts,
                      moe_every=moe_every)
    model = TransformerLM(**kw, tp_group=tp_group, ep_group=ep_group).to(device)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    tp, ep = model_size(tp_group), model_size(ep_group)
    if tp == 1 and ep == 1:
        init_weights(model, gen)
        return model
    full = TransformerLM(**kw).to(device)
    init_weights(full, gen)
    state = full.state_dict()
    del full
    if tp > 1:
        state = tp_state_dict(state, tp, dist.get_rank(tp_group), config.kv_heads)
    if ep > 1:
        state = ep_state_dict(state, ep, dist.get_rank(ep_group))
    model.load_state_dict(state)
    return model


def build_pipeline_stage(config: TrainConfig, pp_group, device,
                         sp_group=None) -> PipelineStage:
    """This rank's ``PipelineStage`` of the config's model (see
    ``pipeline_stages``), its stage and the stage count from ``pp_group``,
    so the ranks of a pp group hold one model."""
    stage, pp = stage_of(pp_group)
    return pipeline_stages(config, device, pp, [stage], sp_group)[0]


def pipeline_stages(config: TrainConfig, device, pp: int, stages,
                    sp_group=None) -> list:
    """Stages ``stages`` of the config's model cut into ``pp``: the whole
    model's weights drawn from the config's seed, as ``build_model`` draws
    them, and each stage's blocks cut out (``stage_state_dict``). The head
    is float32."""
    kw = dict(vocab=config.vocab, dim=config.dim, heads=config.heads,
              mlp_ratio=config.mlp_ratio, dtype=getattr(torch, config.dtype),
              attention=config.attention, kv_heads=config.kv_heads)
    full = TransformerLM(**kw, layers=config.layers).to(device)
    init_weights(full, torch.Generator(device=device).manual_seed(config.seed))
    state = full.state_dict()
    out = []
    for stage in stages:
        model = PipelineStage(**kw, layers=config.layers // pp,
                              sp_group=sp_group).to(device)
        model.load_state_dict(stage_state_dict(state, pp, stage))
        out.append(model)
    return out


def make_batch(config: TrainConfig, rank: int, device,
               rows: Optional[int] = None) -> torch.Tensor:
    """This rank's token batch (``rows`` sequences, default the batch),
    drawn from (seed, rank)."""
    gen = torch.Generator(device="cpu").manual_seed(
        config.seed * 1_000_003 + 7919 * (rank + 1))
    tokens = torch.randint(0, config.vocab, (rows or config.batch, config.seq),
                           generator=gen)
    return tokens.to(device)


def make_shard(config: TrainConfig, sp: DpSp, device,
               rows: Optional[int] = None):
    """(tokens, positions) of this rank's sequence shard: the global batch
    of its ring (``rows`` sequences, drawn from (seed, dp index), so every
    rank of a ring shares it) cut into ``sp_size`` pieces, and the piece's
    global positions ``sp_rank * T_local + arange(T_local)``."""
    if config.seq % sp.sp_size:
        raise ValueError(f"seq {config.seq} not divisible by sp {sp.sp_size}")
    t_local = config.seq // sp.sp_size
    start = sp.sp_rank * t_local
    tokens = make_batch(config, sp.dp_index, device, rows)[:, start:start + t_local]
    positions = torch.arange(start, start + t_local, device=device)[None, :]
    return tokens.contiguous(), positions


def make_cache(config: TrainConfig, sp: Optional[DpSp], device,
               index: Optional[int] = None) -> DeviceCache:
    """This rank's ``DeviceCache`` of ``CACHE_ROWS`` sequences (at least a
    batch) drawn from (seed, rank), or with ``sp`` from (seed, dp index) and
    cut to this rank's shard, so the ranks of a ring hold the same rows and,
    with the same seed, draw them in the same order. ``index`` draws from
    (seed, index) in place of the rank: the ranks of one pipeline pass their
    dp index, so that they share their batch. The targets are each row
    rolled left by one (within the shard), as ``lm_loss`` takes them."""
    rows = max(CACHE_ROWS, config.batch)
    if sp is None:
        tokens = make_batch(config, basics.rank() if index is None else index,
                            "cpu", rows)
    else:
        tokens, _ = make_shard(config, sp, "cpu", rows)
    return DeviceCache(tokens, next_tokens(tokens), batch_size=config.batch,
                       seed=config.seed, device=device)


def setup_cache(config: TrainConfig, s: "Setup", device) -> DeviceCache:
    """``make_cache`` for a ``setup``'s rank: its ring's shard with sp,
    else the rows of its data index, so the ranks of one model group draw
    the same batches."""
    return make_cache(config, s.sp, device, None if s.sp else s.data_index)


def make_train_step(model: TransformerLM, opt: hvd_opt.DistributedOptimizer,
                    positions: Optional[torch.Tensor] = None,
                    loss_chunk: int = 0):
    """``step(tokens, targets=None) -> loss`` (a 0-d tensor on the device,
    this rank's): zero_grad, forward, loss, backward, ``opt.step()``; a
    sharded ``opt`` first refreshes the parameters (``gather_params``).
    ``targets`` default to the tokens rolled left by one; on a sequence
    shard within the shard, as the JAX dp×sp step takes them
    (``jnp.roll(tokens, -1, axis=1)`` on the local shard). ``loss_chunk >
    0`` takes the loss from the hidden states with ``chunked_lm_loss``."""

    def step(tokens: torch.Tensor, targets: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        if targets is None:
            targets = next_tokens(tokens)
        opt.zero_grad()
        if opt.sharded:
            sh.gather_params(opt.rows, opt.shard_plan, opt.layout, opt.params)
        if loss_chunk:
            hidden = model(tokens, positions, return_hidden=True)
            loss = chunked_lm_loss(hidden, model.lm_head.weight, targets,
                                   loss_chunk, model.tp_group)
        else:
            loss = token_loss(model(tokens, positions), targets)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


@dataclass
class Setup:
    """What ``setup`` builds for one rank."""

    model: TransformerLM
    opt: hvd_opt.DistributedOptimizer
    step: Callable
    sp: Optional[DpSp]
    tokens_per_step: int                # over the data ranks
    layout: Optional[ShardedLayout] = None  # ZeRO's or the model axis's
    data_index: int = 0                 # the batch this rank draws


def adam(params, config: TrainConfig, capturable: bool = False):
    """The trainers' Adam, pinned to its ``foreach`` implementation."""
    return torch.optim.Adam(params, lr=config.lr, capturable=capturable,
                            foreach=True)


def graphed_on_card(config: TrainConfig, device) -> bool:
    """Whether the trainers' Adam is built ``capturable``: when a CUDA graph
    of the step is asked for (``config.steps_per_dispatch``) on the card."""
    return config.steps_per_dispatch is not None and \
        torch.device(device).type == "cuda"


def data_index(sp: Optional[DpSp], layout: Optional[ShardedLayout]) -> int:
    """The batch a rank draws: its ring's dp index with ``sp``, its data
    rank ``batch_rank x shard_size + shard_rank`` on a layout (the ranks of
    one model group share it), else its rank."""
    if sp is not None:
        return sp.dp_index
    if layout is not None:
        return layout.batch_rank * layout.shard_size + layout.shard_rank
    return basics.rank()


def setup(config: TrainConfig, device=None, *,
          fusion_threshold: Optional[int] = None,
          num_buckets: Optional[int] = None,
          compression: Optional[str] = None,
          hierarchical: Optional[bool] = None, groups=None,
          layout=None) -> Setup:
    """init -> model -> broadcasts -> the train step. Adam is built
    ``capturable`` when ``config.steps_per_dispatch`` is set and the device
    is the card, so that its step can be captured in a CUDA graph.
    Sharded: init -> model -> ``broadcast_parameters`` of the full
    parameters -> this rank's rows -> Adam on the rows (``capturable`` as
    the flat one) -> ``DistributedOptimizer(sharded=True)`` ->
    ``broadcast_sharded_state``. Sharded training with ``sp`` raises.

    The exchange's knobs default to the environment's
    (HOROVOD_FUSION_THRESHOLD, HOROVOD_NUM_BUCKETS, HOROVOD_COMPRESSION,
    HOROVOD_HIERARCHICAL_ALLREDUCE); ``compression`` is a
    HOROVOD_COMPRESSION name or spec, ``groups`` the ladder's
    ``Hierarchy``, and ``layout`` a ``ShardedLayout`` that puts the step
    on ZeRO over it.

    The model axis: a layout whose model axis is named (``layout=
    sharded_groups(b, s, m)``, or HOROVOD_MESH ``"<b>x<s>x<m>"``) cuts the
    model over its model group (``build_model(tp_group=)``; the blocks'
    and the head's allreduces run there) and trains on ZeRO when
    ``config.sharded`` (None: HOROVOD_SHARD_PARAMS) says so: over the
    ``('batch', 'shard')`` groups of this rank's model index, the shard
    plan built from this rank's slices with ``model_size``. Otherwise the
    exchange is the flat ``DistributedOptimizer(group=<batch group>)``,
    and a shard size above 1 raises. The model axis issues no collective
    in the exchange: the conjugate pairs have completed the gradients. The
    ranks of one model group draw one batch (``data_index``), and
    ``tokens_per_step`` counts the data ranks. No ``sp`` with a model
    axis."""
    basics.init(device)
    dev = basics.device()
    if layout is not None and layout.model_group is None:
        sharded = True
    else:
        sharded = basics.config().shard_params if config.sharded is None \
            else config.sharded
    if sharded and config.sp is not None:
        raise ValueError("sharded training does not combine with sp yet")
    if layout is None and (sharded or mesh_model_axis()):
        layout = sharded_groups()
    tp_group = None if layout is None else layout.model_group
    if tp_group is not None:
        if config.sp is not None:
            raise ValueError("tensor parallelism (a model axis) does not "
                             "combine with sp yet")
        if not sharded and layout.shard_size > 1:
            raise ValueError(
                f"a mesh of shard size {layout.shard_size} under a model axis "
                "trains with ZeRO: set sharded=True (TrainConfig(sharded=True) "
                "or HOROVOD_SHARD_PARAMS=1), or lay the mesh out as "
                "'<batch>x1x<model>'")
    sp = dp_sp_groups(config.sp) if config.sp is not None else None
    model = build_model(config, dev, sp.group if sp else None, tp_group=tp_group)
    named = jax_ordered(model.named_parameters())
    if tp_group is None:
        hvd_opt.broadcast_parameters(named, root_rank=0)
    else:       # each model index holds its own slices
        hvd_opt.broadcast_parameters(named, 0, layout.batch_group)
        hvd_opt.broadcast_parameters(named, 0, layout.shard_group)
    opt = build_optimizer(config, named, sharded, fusion_threshold=fusion_threshold,
                          num_buckets=num_buckets, compression=compression,
                          hierarchical=hierarchical, groups=groups,
                          layout=layout)
    positions = None
    if sp is not None:
        _, positions = make_shard(config, sp, dev)
    tokens_local = config.batch * config.seq // (sp.sp_size if sp else 1)
    model_ranks = layout.model_size if layout is not None else 1
    return Setup(model=model, opt=opt, sp=sp,
                 step=make_train_step(model, opt, positions, config.loss_chunk),
                 tokens_per_step=tokens_local * basics.size() // model_ranks,
                 layout=layout, data_index=data_index(sp, layout))


def build_optimizer(config: TrainConfig, named, sharded: bool, adam_opt=None, *,
                    fusion_threshold=None, num_buckets=None, compression=None,
                    hierarchical=None, groups=None,
                    layout=None) -> hvd_opt.DistributedOptimizer:
    """The ``DistributedOptimizer`` of ``setup`` over the model's
    ``named`` parameters, with the knobs ``setup`` takes, and its state
    broadcast from rank 0. ``adam_opt``, flat only: the running job's Adam
    over the parameters, kept with its state (which every rank already
    shares) in place of a new one. Flat with a ``layout`` (a model axis):
    the exchange and the broadcast run over its batch group."""
    wire = None if compression is None \
        else Compression.by_name(normalize(compression))
    graphed = graphed_on_card(config, named[0][1].device)
    if sharded:
        params = [p for _, p in named]
        layout = layout if layout is not None else sharded_groups()
        plan = sh.build_shard_plan(params, layout.shard_size,
                                   hvd_opt._resolved_threshold(fusion_threshold),
                                   hvd_opt._resolved_num_buckets(num_buckets),
                                   model_size=layout.model_size)
        rows = sh.shard_params(params, plan, layout.shard_rank)
        opt = hvd_opt.DistributedOptimizer(
            adam(rows, config, graphed), named, compression=wire,
            fusion_threshold=fusion_threshold, num_buckets=num_buckets,
            hierarchical=hierarchical, groups=groups, sharded=True,
            shard_plan=plan, layout=layout)
        hvd_opt.broadcast_sharded_state(opt)
        return opt
    group = None if layout is None else layout.batch_group
    fresh = adam_opt is None
    if fresh:
        adam_opt = adam([p for _, p in named], config, graphed)
    opt = hvd_opt.DistributedOptimizer(
        adam_opt, named, compression=wire, fusion_threshold=fusion_threshold,
        num_buckets=num_buckets, hierarchical=hierarchical, groups=groups,
        sharded=False, group=group)
    if fresh:
        hvd_opt.broadcast_optimizer_state(opt, 0, group)
    return opt


def make_fsdp_train_step(model: TransformerLM, rows: dict, shapes: dict,
                         layout: DpFsdp, optimizer: torch.optim.Optimizer):
    """``step(tokens, targets=None) -> loss``, FSDP: zero_grad, the leaves
    gathered from every fsdp rank's rows, forward through
    ``functional_call``, loss, backward (each row's gradient the
    reduce-scatter-sum), the average over dp x fsdp, the step, and the pad
    tails zeroed."""

    def step(tokens: torch.Tensor, targets: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        if targets is None:
            targets = next_tokens(tokens)
        optimizer.zero_grad()
        full = fsdp.fsdp_gather_params(rows, shapes, layout.fsdp_group)
        loss = token_loss(torch.func.functional_call(model, full, (tokens,)),
                          targets)
        loss.backward()
        fsdp.fsdp_average_gradients_(rows, layout)
        optimizer.step()
        fsdp.fsdp_mask_(rows, shapes, layout.fsdp_rank)
        return loss.detach()

    return step


@dataclass
class FsdpSetup:
    """What ``setup_fsdp`` builds for one rank."""

    model: TransformerLM        # its own parameters released: the rows hold them
    rows: dict                  # name -> this rank's row, an nn.Parameter
    shapes: dict                # name -> the full leaf's shape
    layout: DpFsdp
    optimizer: torch.optim.Optimizer
    step: Callable
    tokens_per_step: int        # over all ranks


def setup_fsdp(config: TrainConfig, layout: Optional[DpFsdp] = None,
               device=None) -> FsdpSetup:
    """init -> model -> ``broadcast_parameters`` -> each parameter cut into
    this rank's FSDP row (the model's own parameters are then released) ->
    Adam on the rows (``capturable`` when a graph is asked for on the card)
    -> the FSDP step. ``layout`` None is ``training_groups(1, world)``. The
    plain forward only: no ring, remat or chunked loss. With
    ``config.steps_per_dispatch``, ``make_scan_train_loop(s.step,
    make_cache(config, None, dev), K, optimizer=s.optimizer)`` is the
    graphed FSDP loop."""
    if (config.sp, config.remat, config.loss_chunk) != (None, False, 0):
        raise ValueError("FSDP training takes the plain step only: no sp, "
                         "remat or loss_chunk")
    basics.init(device)
    dev = basics.device()
    if layout is None:
        layout = training_groups(1, basics.size())
    model = build_model(config, dev)
    named = jax_ordered(model.named_parameters())
    hvd_opt.broadcast_parameters(named, root_rank=0)
    rows, shapes = fsdp.fsdp_shard_params(dict(named), layout.fsdp_size,
                                          layout.fsdp_rank)
    for _, p in named:
        p.data = p.data.new_empty(0)
    optimizer = adam(list(rows.values()), config, graphed_on_card(config, dev))
    return FsdpSetup(model=model, rows=rows, shapes=shapes, layout=layout,
                     optimizer=optimizer,
                     step=make_fsdp_train_step(model, rows, shapes, layout,
                                               optimizer),
                     tokens_per_step=config.batch * config.seq * basics.size())


def make_pipeline_train_step(stage: PipelineStage,
                             opt: hvd_opt.DistributedOptimizer, pp_group,
                             n_micro: int):
    """``step(tokens, targets=None) -> loss``, GPipe: zero_grad, the
    replica's ``(batch, T)`` tokens (and ``targets``, by default the tokens
    rolled left by one) cut into ``n_micro`` microbatches through
    ``pipeline_lm_loss_and_grads`` (the outer leaves' gradients summed over
    the pp group), then ``opt.step()`` (the average over the dp group and
    Adam). The loss is the last stage's, on every stage. ``step(x, y)`` is
    the loop's ``train_step`` form."""

    def step(tokens: torch.Tensor, targets: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        if tokens.shape[0] % n_micro:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"{n_micro} microbatches")
        opt.zero_grad()

        def micro(t):
            return None if t is None else t.reshape(n_micro, -1, t.shape[1])

        loss, _ = pipeline_lm_loss_and_grads(stage, micro(tokens), pp_group,
                                             micro(targets))
        opt.step()
        return loss

    return step


@dataclass
class PipelineSetup:
    """What ``setup_pipeline`` builds for one rank."""

    stage: PipelineStage
    opt: hvd_opt.DistributedOptimizer
    step: Callable
    layout: DpFsdp
    tokens_per_step: int        # over all ranks' pipelines


def setup_pipeline(config: TrainConfig, pp: int, n_micro: int,
                   device=None) -> PipelineSetup:
    """init -> ``training_groups(world / pp, 1, pp)`` -> this rank's stage
    -> ``broadcast_parameters`` over the dp group, and of the outer leaves
    over the pp group -> Adam on the stage's parameters (``capturable``
    when a graph is asked for on the card) ->
    ``DistributedOptimizer(group=<dp group>)`` -> the pipelined step. The
    plain step only: no ring, remat, chunked loss or ZeRO. With
    ``config.steps_per_dispatch``, ``make_scan_train_loop(s.step,
    make_cache(config, None, dev, s.layout.dp_rank), K, optimizer=s.opt)``
    is the graphed pipeline loop: the replica's cache, drawn from (seed, dp
    index) as its eager batch is."""
    if (config.sp, config.remat, config.loss_chunk) != (None, False, 0) \
            or config.sharded:
        raise ValueError("pipeline training takes the plain step only: no sp, "
                         "remat, loss_chunk or sharded")
    basics.init(device)
    dev = basics.device()
    if basics.size() % pp:
        raise ValueError(f"world size {basics.size()} not divisible by pp {pp}")
    layout = training_groups(basics.size() // pp, 1, pp)
    stage = build_pipeline_stage(config, layout.pp_group, dev)
    named = jax_ordered(stage.named_parameters())
    hvd_opt.broadcast_parameters(named, 0, layout.dp_group)
    hvd_opt.broadcast_parameters(
        [(n, p) for n, p in named if not n.startswith("blocks.")], 0,
        layout.pp_group)
    opt = hvd_opt.DistributedOptimizer(
        adam([p for _, p in named], config, graphed_on_card(config, dev)), named,
        sharded=False, group=layout.dp_group)
    hvd_opt.broadcast_optimizer_state(opt, 0, layout.dp_group)
    return PipelineSetup(
        stage=stage, opt=opt, layout=layout,
        step=make_pipeline_train_step(stage, opt, layout.pp_group, n_micro),
        tokens_per_step=config.batch * config.seq * layout.dp_size)


def train(config: TrainConfig, steps: int, device=None,
          around_step: Optional[Callable[[int], ContextManager]] = None,
          layout: Optional[ShardedLayout] = None) -> TrainResult:
    """init -> model -> broadcasts -> ``steps`` steps: on one repeated
    batch, or with ``config.steps_per_dispatch = K`` in ``steps / K``
    dispatches of the graphed loop over a ``DeviceCache``.

    ``around_step(i)``, if given, returns a context manager that step ``i``
    (dispatch ``i`` of a graphed run) runs inside (a profiler around it,
    for example). ``layout`` is ``setup``'s (a model axis, or ZeRO).
    """
    s = setup(config, device, layout=layout)
    dev = basics.device()
    result = TrainResult(tokens_per_step=s.tokens_per_step,
                         num_buckets=s.opt.plan.num_buckets,
                         params=sum(p.numel() for p in s.model.parameters()))
    k = config.steps_per_dispatch
    if k is None:
        tokens = make_batch(config, s.data_index, dev) if s.sp is None \
            else make_shard(config, s.sp, dev)[0]
    else:
        if steps % k:
            raise ValueError(f"steps {steps} not a multiple of "
                             f"steps_per_dispatch {k}")
        loop = make_scan_train_loop(s.step, setup_cache(config, s, dev), k,
                                    optimizer=s.opt)
        if dev.type == "cuda":
            loop.capture()
            result.capture_s = loop.capture_s
    losses, times = ((result.losses, result.step_s) if k is None
                     else (result.dispatch_losses, result.dispatch_s))
    for i in range(steps if k is None else steps // k):
        with around_step(i) if around_step else contextlib.nullcontext():
            t0 = time.perf_counter()
            loss = s.step(tokens) if k is None else loop()
            losses.append(hvd_opt.metric_average(loss.item()))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
    return result


# The exchange's knobs that a candidate or a running job may change.
KNOB_NAMES = ("fusion_threshold", "num_buckets", "compression", "hierarchical")


def _release(dev) -> None:
    """Free what the dropped objects held, CUDA graph pools included."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


class TuneStepFactory:
    """``autotune.tune``'s step factory for the config's TransformerLM: the
    counterpart of ``bench.py:541-551``'s ``step_factory``.

    ``factory(fusion_threshold, num_buckets=, compression=, hierarchical=,
    mesh_shape=) -> (run, sync)`` frees the previous candidate (its model,
    optimizer, fusion buffers, cache and CUDA graph with its memory pool),
    then builds this one from the config's seed, so every candidate starts
    from the same weights and draws the same batches. ``mesh_shape`` None is
    the flat ``DistributedOptimizer``; a HOROVOD_MESH spec puts the step on
    ZeRO over that layout's ``sharded_groups`` (the ladder has no ZeRO
    form, in either package, so ``hierarchical`` is ignored there), and a
    three-axis spec (``"1x2x2"``) also cuts the model over its model group,
    the JAX package's sixth tuning dimension; ``"BxSx1"`` trains as
    ``"BxS"`` bit for bit. With ``config.steps_per_dispatch = K`` every candidate,
    flat or ZeRO, captures its step in a CUDA graph on a ``capturable``
    Adam, where the JAX package re-jits its compiled step, and ``run``
    replays it K times; a capture that fails raises. ``graphed=False``
    tunes the eager step instead, the one a job runs where the loop takes
    no graph (under HOROVOD_ELASTIC=1): every candidate's K steps run
    eagerly on a plain Adam, whose update rounds otherwise than the
    capturable one's. ``sync`` fences at a window's end.

    ``records`` holds one dict per candidate: its knobs, its layout's
    ``model_size``, ``graphed``, the plan's ``num_buckets``, each bucket's wire dtype (None: as it is), ``build_s`` (setup, warm-up and capture), the
    per-step ``losses`` of its first ``run`` and, on the card, its
    ``peak_bytes`` (``max_memory_allocated``, reset before the build).
    Those of the last candidate are filled in by ``close()``, which frees
    it. ``ici_size`` sizes the ladder's groups as ``hierarchical_groups``
    takes it.
    """

    def __init__(self, config: TrainConfig, device=None,
                 ici_size: Optional[int] = None, graphed: bool = True) -> None:
        basics.init(device)
        self.config = config
        self.ici_size = ici_size
        self.graphed = graphed
        self.records: list[dict] = []
        self._live = None       # the candidate's Setup, until close()
        self._first = None      # the losses of its first run, on the device
        self._layouts: dict = {}
        self._hierarchy = None

    def _layout(self, spec: str):
        """The ``ShardedLayout`` of a mesh spec, built once: groups are
        created on every rank and a captured step must create none. The
        candidates reach every rank in one order, so the ranks create the
        groups in one order. ``"BxSxM"`` names the model axis (its model
        group, of one rank at M = 1); ``"BxS"`` does not."""
        if spec not in self._layouts:
            batch, shard, model = parse_mesh_spec(spec, basics.size())
            self._layouts[spec] = sharded_groups(
                batch, shard, model if mesh_model_axis(spec) else None)
        return self._layouts[spec]

    def build(self, fusion_threshold: int, num_buckets: Optional[int] = None,
              compression: Optional[str] = None,
              hierarchical: Optional[bool] = None,
              mesh_shape: Optional[str] = None) -> Setup:
        """Free the previous candidate and set up this one's step."""
        self.close()
        dev = basics.device()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        config, layout, groups = self.config, None, None
        if not self.graphed:                   # eager: a plain Adam
            config = dataclasses.replace(config, steps_per_dispatch=None)
        if mesh_shape:
            layout = self._layout(mesh_shape)
            config = dataclasses.replace(config, sharded=True)
        elif hierarchical:
            if self._hierarchy is None:
                self._hierarchy = hierarchical_groups(self.ici_size)
            groups = self._hierarchy
        s = setup(config, None, fusion_threshold=fusion_threshold,
                  num_buckets=num_buckets, compression=compression,
                  hierarchical=hierarchical, groups=groups, layout=layout)
        self.records.append({
            "fusion_threshold": fusion_threshold, "num_buckets": num_buckets,
            "compression": compression, "hierarchical": hierarchical,
            "mesh_shape": mesh_shape, "model_size": 1 if layout is None
            else layout.model_size, "planned_buckets": s.opt.plan.num_buckets,
            "wires": [None if w is None else str(w).removeprefix("torch.")
                      for w in (s.opt.wires if s.opt.sharded else s.opt.wires[0])],
            "graphed": config.steps_per_dispatch is not None,
            "build_s": None, "losses": None, "peak_bytes": None})
        self._live, self._t0 = s, t0
        return s

    def __call__(self, fusion_threshold: int, **knobs):
        s = self.build(fusion_threshold, **knobs)
        record, dev = self.records[-1], basics.device()
        cache = setup_cache(self.config, s, dev)
        k = self.config.steps_per_dispatch or 1
        if record["graphed"]:
            loop = make_scan_train_loop(s.step, cache, k, optimizer=s.opt)
            if dev.type == "cuda":
                loop.capture()
            losses = loop.losses

            def dispatch():
                loop()
        else:
            ctr = [cache.counter()]
            losses = torch.zeros(k, device=dev)

            def dispatch():
                for i in range(k):
                    x, y, ctr[0] = cache.sample(ctr[0])
                    losses[i] = s.step(x, y)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record["build_s"] = time.perf_counter() - self._t0

        def run():
            dispatch()
            if self._first is None:
                self._first = losses.detach().clone()

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        return run, sync

    def close(self) -> None:
        """Fill in the live candidate's record and free it."""
        if self._live is None:
            return
        dev = basics.device()
        record = self.records[-1]
        if self._first is not None:
            record["losses"] = self._first.tolist()
        if dev.type == "cuda":
            record["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        self._live.opt.remove_hooks()
        self._live = self._first = None
        _release(dev)


class TrainRecapture:
    """A graphed training job whose exchange knobs change while it runs:
    the ``rejit`` hook of ``control.TrainingController``.

    ``job()`` runs one dispatch of ``config.steps_per_dispatch`` steps and
    returns its mean loss, as ``loop.ScanTrainLoop`` does. ``rejit({knob:
    value})`` (``KNOB_NAMES``; a compression name or spec) rebuilds the
    ``DistributedOptimizer`` over the same model and the same Adam, so the
    parameters and every moment and step count stay, drops the old graph
    and its pool, and captures the step again from the ``DeviceCache``
    counter where it stood: the warm-up restores parameters, Adam state and
    counter, so the job then runs exactly the steps it would have run
    without the change. The mesh has no such path (moving the Adam state
    between layouts is not ported), and the engine-only knobs have no
    actuator here: ``rejit`` raises on them, which vetoes the proposal.
    ``recaptures`` holds ``(change, seconds)`` per call. On the CPU the
    loop runs eagerly and a rejit only rebuilds the optimizer.
    """

    def __init__(self, config: TrainConfig, device=None, **knobs) -> None:
        if not config.steps_per_dispatch:
            raise ValueError("TrainRecapture drives the graphed loop: set "
                             "config.steps_per_dispatch")
        unknown = set(knobs) - set(KNOB_NAMES)
        if unknown:
            raise ValueError(f"unknown knobs {sorted(unknown)}")
        self.config = config
        self.s = setup(config, device, **knobs)
        self.dev = basics.device()
        self.knobs = {"fusion_threshold": self.s.opt.threshold,
                      "num_buckets": self.s.opt.num_buckets,
                      "compression": knobs.get("compression") or
                      basics.config().compression,
                      "hierarchical": self.s.opt.hierarchical}
        self.cache = setup_cache(config, self.s, self.dev)
        self.recaptures: list[tuple[dict, float]] = []
        self.loop = self._capture(self.cache.counter())

    def _capture(self, counter: torch.Tensor):
        loop = make_scan_train_loop(self.s.step, self.cache,
                                    self.config.steps_per_dispatch,
                                    optimizer=self.s.opt)
        loop.counter.copy_(counter)
        if self.dev.type == "cuda":
            loop.capture()
        return loop

    def __call__(self) -> torch.Tensor:
        return self.loop()

    def rejit(self, change: dict) -> None:
        unknown = set(change) - set(KNOB_NAMES)
        if unknown:
            raise ValueError(f"a running job cannot change {sorted(unknown)} "
                             f"(it takes {', '.join(KNOB_NAMES)})")
        t0 = time.perf_counter()
        knobs = {**self.knobs, **change}
        counter = self.loop.counter.clone()
        old = self.s.opt
        named = jax_ordered(self.s.model.named_parameters())
        groups = old.groups if knobs["hierarchical"] else None
        # A change the optimizer refuses leaves the job as it was.
        opt = build_optimizer(self.config, named, False, old.optimizer,
                              groups=groups, layout=self.s.layout, **knobs)
        old.remove_hooks()
        positions = None if self.s.sp is None \
            else make_shard(self.config, self.s.sp, self.dev)[1]
        self.s = dataclasses.replace(self.s, opt=opt, step=make_train_step(
            self.s.model, opt, positions, self.config.loss_chunk))
        self.loop = None
        del old
        _release(self.dev)
        self.loop = self._capture(counter)
        self.knobs = knobs
        self.recaptures.append((dict(change), time.perf_counter() - t0))
