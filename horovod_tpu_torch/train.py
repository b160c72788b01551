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
the data-parallel step bit for bit.

``setup_pipeline(config, pp, n_micro)`` builds the GPipe step of
``models/pipeline_lm.py`` on the ``('dp', 'pp')`` groups of
``training_groups``: each rank draws the whole model from the config's
seed and keeps its stage (``build_pipeline_stage``), Adam steps the
stage's parameters through ``DistributedOptimizer(group=<dp group>)``,
and a step feeds the replica's batch of ``config.batch`` sequences as
``n_micro`` microbatches. The ranks of one pipeline share their batch,
drawn from (seed, dp index).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, ContextManager, Optional

import torch
import torch.distributed as dist

from . import optimizer as hvd_opt
from .common import basics
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
from .parallel.mesh import (DpFsdp, DpSp, dp_sp_groups, sharded_groups,
                            training_groups)
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
    tokens_per_step: int = 0                          # over all ranks
    num_buckets: int = 0
    params: int = 0
    # With steps_per_dispatch: per dispatch of K steps instead of per step.
    dispatch_losses: list = field(default_factory=list)   # mean, rank-averaged
    dispatch_s: list = field(default_factory=list)        # host clock
    capture_s: Optional[float] = None                     # warm-up + capture


def build_model(config: TrainConfig, device, sp_group=None, tp_group=None,
                ep_group=None, moe_experts: int = 0,
                moe_every: int = 2) -> TransformerLM:
    """The config's model with random weights drawn from its seed.
    ``tp_group``/``ep_group`` of more than one rank: the whole model's
    weights are drawn and this rank's slices cut from them
    (``tp_state_dict``, ``ep_state_dict``), so the ranks of a group hold
    one model; ``moe_experts``/``moe_every`` as ``TransformerLM`` takes
    them."""
    kw = dict(vocab=config.vocab, dim=config.dim, heads=config.heads,
              layers=config.layers, mlp_ratio=config.mlp_ratio,
              dtype=getattr(torch, config.dtype), attention=config.attention,
              kv_heads=config.kv_heads,
              logits_dtype=getattr(torch, config.logits_dtype),
              sp_group=sp_group, remat=config.remat, moe_experts=moe_experts,
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
        state = tp_state_dict(state, tp, dist.get_rank(tp_group))
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


def make_cache(config: TrainConfig, sp: Optional[DpSp], device) -> DeviceCache:
    """This rank's ``DeviceCache`` of ``CACHE_ROWS`` sequences (at least a
    batch) drawn from (seed, rank), or with ``sp`` from (seed, dp index) and
    cut to this rank's shard, so the ranks of a ring hold the same rows and,
    with the same seed, draw them in the same order. The targets are each
    row rolled left by one (within the shard), as ``lm_loss`` takes them."""
    rows = max(CACHE_ROWS, config.batch)
    if sp is None:
        tokens = make_batch(config, basics.rank(), "cpu", rows)
    else:
        tokens, _ = make_shard(config, sp, "cpu", rows)
    return DeviceCache(tokens, next_tokens(tokens), batch_size=config.batch,
                       seed=config.seed, device=device)


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
                                   loss_chunk)
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
    tokens_per_step: int                # over all ranks


def adam(params, config: TrainConfig, capturable: bool = False):
    """The trainers' Adam, pinned to its ``foreach`` implementation."""
    return torch.optim.Adam(params, lr=config.lr, capturable=capturable,
                            foreach=True)


def setup(config: TrainConfig, device=None) -> Setup:
    """init -> model -> broadcasts -> the train step. Adam is built
    ``capturable`` when ``config.steps_per_dispatch`` is set and the device
    is the card, so that its step can be captured in a CUDA graph.
    Sharded: init -> model -> ``broadcast_parameters`` of the full
    parameters -> this rank's rows -> Adam on the rows ->
    ``DistributedOptimizer(sharded=True)`` -> ``broadcast_sharded_state``."""
    basics.init(device)
    dev = basics.device()
    sharded = basics.config().shard_params if config.sharded is None \
        else config.sharded
    if sharded and (config.sp is not None or config.steps_per_dispatch is not None):
        raise ValueError("sharded training does not combine with sp or "
                         "steps_per_dispatch yet")
    sp = dp_sp_groups(config.sp) if config.sp is not None else None
    model = build_model(config, dev, sp.group if sp else None)
    named = jax_ordered(model.named_parameters())
    params = [p for _, p in named]
    hvd_opt.broadcast_parameters(named, root_rank=0)
    if sharded:
        layout = sharded_groups()
        plan = sh.build_shard_plan(params, layout.shard_size,
                                   basics.config().fusion_threshold,
                                   basics.config().num_buckets)
        rows = sh.shard_params(params, plan, layout.shard_rank)
        opt = hvd_opt.DistributedOptimizer(adam(rows, config), named,
                                           sharded=True, shard_plan=plan,
                                           layout=layout)
        hvd_opt.broadcast_sharded_state(opt)
    else:
        capturable = config.steps_per_dispatch is not None and dev.type == "cuda"
        opt = hvd_opt.DistributedOptimizer(adam(params, config, capturable),
                                           named, sharded=False)
        hvd_opt.broadcast_optimizer_state(opt, root_rank=0)
    positions = None
    if sp is not None:
        _, positions = make_shard(config, sp, dev)
    tokens_local = config.batch * config.seq // (sp.sp_size if sp else 1)
    return Setup(model=model, opt=opt, sp=sp,
                 step=make_train_step(model, opt, positions, config.loss_chunk),
                 tokens_per_step=tokens_local * basics.size())


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
    Adam on the rows -> the FSDP step. ``layout`` None is
    ``training_groups(1, world)``. The plain forward only: no ring, graph,
    remat or chunked loss."""
    if (config.sp, config.steps_per_dispatch, config.remat, config.loss_chunk) \
            != (None, None, False, 0):
        raise ValueError("FSDP training takes the plain step only: no sp, "
                         "steps_per_dispatch, remat or loss_chunk")
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
    optimizer = adam(list(rows.values()), config)
    return FsdpSetup(model=model, rows=rows, shapes=shapes, layout=layout,
                     optimizer=optimizer,
                     step=make_fsdp_train_step(model, rows, shapes, layout,
                                               optimizer),
                     tokens_per_step=config.batch * config.seq * basics.size())


def make_pipeline_train_step(stage: PipelineStage,
                             opt: hvd_opt.DistributedOptimizer, pp_group,
                             n_micro: int):
    """``step(tokens) -> loss``, GPipe: zero_grad, the replica's ``(batch,
    T)`` tokens cut into ``n_micro`` microbatches through
    ``pipeline_lm_loss_and_grads`` (the outer leaves' gradients summed over
    the pp group), then ``opt.step()`` (the average over the dp group and
    Adam). The loss is the last stage's, on every stage."""

    def step(tokens: torch.Tensor) -> torch.Tensor:
        if tokens.shape[0] % n_micro:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"{n_micro} microbatches")
        opt.zero_grad()
        loss, _ = pipeline_lm_loss_and_grads(
            stage, tokens.reshape(n_micro, -1, tokens.shape[1]), pp_group)
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
    over the pp group -> Adam on the stage's parameters ->
    ``DistributedOptimizer(group=<dp group>)`` -> the pipelined step. The
    plain step only: no ring, graph, remat, chunked loss or ZeRO."""
    if (config.sp, config.steps_per_dispatch, config.remat, config.loss_chunk) \
            != (None, None, False, 0) or config.sharded:
        raise ValueError("pipeline training takes the plain step only: no sp, "
                         "steps_per_dispatch, remat, loss_chunk or sharded")
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
    opt = hvd_opt.DistributedOptimizer(adam([p for _, p in named], config),
                                       named, sharded=False,
                                       group=layout.dp_group)
    hvd_opt.broadcast_optimizer_state(opt, 0, layout.dp_group)
    return PipelineSetup(
        stage=stage, opt=opt, layout=layout,
        step=make_pipeline_train_step(stage, opt, layout.pp_group, n_micro),
        tokens_per_step=config.batch * config.seq * layout.dp_size)


def train(config: TrainConfig, steps: int, device=None,
          around_step: Optional[Callable[[int], ContextManager]] = None,
          ) -> TrainResult:
    """init -> model -> broadcasts -> ``steps`` steps: on one repeated
    batch, or with ``config.steps_per_dispatch = K`` in ``steps / K``
    dispatches of the graphed loop over a ``DeviceCache``.

    ``around_step(i)``, if given, returns a context manager that step ``i``
    (dispatch ``i`` of a graphed run) runs inside (a profiler around it,
    for example).
    """
    s = setup(config, device)
    dev = basics.device()
    result = TrainResult(tokens_per_step=s.tokens_per_step,
                         num_buckets=s.opt.plan.num_buckets,
                         params=sum(p.numel() for p in s.model.parameters()))
    k = config.steps_per_dispatch
    if k is None:
        tokens = make_batch(config, basics.rank(), dev) if s.sp is None \
            else make_shard(config, s.sp, dev)[0]
    else:
        if steps % k:
            raise ValueError(f"steps {steps} not a multiple of "
                             f"steps_per_dispatch {k}")
        loop = make_scan_train_loop(s.step, make_cache(config, s.sp, dev), k,
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
