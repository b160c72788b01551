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
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, ContextManager, Optional

import torch

from . import optimizer as hvd_opt
from .common import basics
from .convert import jax_ordered
from .models.transformer import TransformerLM, init_weights, lm_loss
from .parallel.mesh import DpSp, dp_sp_groups


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


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)       # per step, rank-averaged
    step_s: list = field(default_factory=list)       # host clock per step
    tokens_per_step: int = 0                          # over all ranks
    num_buckets: int = 0
    params: int = 0


def build_model(config: TrainConfig, device, sp_group=None) -> TransformerLM:
    """The config's model with random weights drawn from its seed."""
    model = TransformerLM(
        vocab=config.vocab, dim=config.dim, heads=config.heads,
        layers=config.layers, mlp_ratio=config.mlp_ratio,
        dtype=getattr(torch, config.dtype), attention=config.attention,
        kv_heads=config.kv_heads, sp_group=sp_group,
    ).to(device)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    init_weights(model, gen)
    return model


def make_batch(config: TrainConfig, rank: int, device) -> torch.Tensor:
    """This rank's token batch, drawn from (seed, rank)."""
    gen = torch.Generator(device="cpu").manual_seed(
        config.seed * 1_000_003 + 7919 * (rank + 1))
    tokens = torch.randint(0, config.vocab, (config.batch, config.seq),
                           generator=gen)
    return tokens.to(device)


def make_shard(config: TrainConfig, sp: DpSp, device):
    """(tokens, positions) of this rank's sequence shard: the global batch
    of its ring (drawn from (seed, dp index), so every rank of a ring
    shares it) cut into ``sp_size`` pieces, and the piece's global
    positions ``sp_rank * T_local + arange(T_local)``."""
    if config.seq % sp.sp_size:
        raise ValueError(f"seq {config.seq} not divisible by sp {sp.sp_size}")
    t_local = config.seq // sp.sp_size
    start = sp.sp_rank * t_local
    tokens = make_batch(config, sp.dp_index, device)[:, start:start + t_local]
    positions = torch.arange(start, start + t_local, device=device)[None, :]
    return tokens.contiguous(), positions


def make_train_step(model: TransformerLM, opt: hvd_opt.DistributedOptimizer,
                    positions: Optional[torch.Tensor] = None):
    """``step(tokens) -> loss`` (a 0-d tensor on the device, this rank's).
    On a sequence shard the targets are the shard's tokens rolled left by
    one within the shard, as the JAX dp×sp step takes them
    (``jnp.roll(tokens, -1, axis=1)`` on the local shard)."""

    def step(tokens: torch.Tensor) -> torch.Tensor:
        opt.zero_grad()
        loss = lm_loss(model(tokens, positions), tokens)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def train(config: TrainConfig, steps: int, device=None,
          around_step: Optional[Callable[[int], ContextManager]] = None,
          ) -> TrainResult:
    """init -> model -> broadcasts -> ``steps`` steps on one repeated batch.

    ``around_step(i)``, if given, returns a context manager that step ``i``
    runs inside (a profiler around one step, for example).
    """
    basics.init(device)
    dev = basics.device()
    sp = dp_sp_groups(config.sp) if config.sp is not None else None
    model = build_model(config, dev, sp.group if sp else None)
    named = jax_ordered(model.named_parameters())
    hvd_opt.broadcast_parameters(named, root_rank=0)
    opt = hvd_opt.DistributedOptimizer(
        torch.optim.Adam([p for _, p in named], lr=config.lr), named)
    hvd_opt.broadcast_optimizer_state(opt, root_rank=0)
    if sp is None:
        tokens, positions = make_batch(config, basics.rank(), dev), None
    else:
        tokens, positions = make_shard(config, sp, dev)
    step = make_train_step(model, opt, positions)
    result = TrainResult(tokens_per_step=tokens.numel() * basics.size(),
                         num_buckets=opt.plan.num_buckets,
                         params=sum(p.numel() for _, p in named))
    for i in range(steps):
        with around_step(i) if around_step else contextlib.nullcontext():
            t0 = time.perf_counter()
            loss = step(tokens)
            result.losses.append(hvd_opt.metric_average(loss.item()))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            result.step_s.append(time.perf_counter() - t0)
    return result
