"""The pipeline-parallel TransformerLM, the counterpart of
``horovod_tpu.models.pipeline_lm``: the TransformerLM's blocks on the GPipe
schedule of ``parallel/pipeline.py``.

Each rank of the ``pp`` group holds a ``PipelineStage``: the embedding,
its own contiguous run of ``layers / pp`` blocks, the final norm and the
LM head (float32, whatever the activations' dtype, as the reference makes
it). Every stage embeds the microbatches; only stage 0's embedding enters
the pipeline. The norm and the head run on the pipeline's output, which
is valid on the last stage, and the loss is masked to the last stage
(``masked_last_stage_loss``). The embedding's gradient so lands on stage
0 and the norm's and head's on the last stage, zeros elsewhere:
:func:`pipeline_lm_loss_and_grads` sums them over the pp group, as the
reference's ``psum``, so every stage holds the whole gradient of the
outer leaves, and data parallelism over the stage's replicas works as
for any model.

State dicts keep the flat model's names: ``stage_state_dict(full, pp,
stage)`` holds the outer leaves (``embed.weight``, ``norm.scale``,
``lm_head.weight``) and blocks ``stage * L/pp ... (stage+1) * L/pp - 1``
renumbered from 0, so it loads into the stage; ``split_lm_params`` and
``merge_lm_params`` are the reference's stacked layout, the blocks' leaves
with a leading layer dim.

With ``sp_group`` the blocks' attention rings over the sequence-parallel
group (``ring_flash_attention`` for "flash", ``ring_attention`` for
"dense"); the microbatches hold this rank's sequence shard and rope takes
its global positions ``sp_rank * t_local + arange(t_local)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..parallel.collectives import ReduceOp, allreduce_
from ..parallel.pipeline import (last_stage_value, masked_last_stage_loss,
                                 pipeline_apply, stack_stage_params,
                                 unstack_stage_params)
from .transformer import Block, Dense, RMSNorm, next_tokens, token_loss

_BLOCKS = "blocks."


def _block_index(name: str) -> Optional[int]:
    return int(name.split(".")[1]) if name.startswith(_BLOCKS) else None


def _block_leaf(name: str) -> str:
    return name.split(".", 2)[2]


def split_lm_params(state: dict, layers: int) -> tuple[dict, dict]:
    """A TransformerLM state dict as ``(outer, stacked_blocks)``: ``outer``
    the embedding, final norm and head; ``stacked_blocks`` each block leaf
    (``qkv.weight``, ...) stacked over ``block 0 ... layers - 1``."""
    outer = {k: v for k, v in state.items() if _block_index(k) is None}
    per_layer = [{_block_leaf(k): v for k, v in state.items()
                  if _block_index(k) == i} for i in range(layers)]
    return outer, stack_stage_params(per_layer)


def merge_lm_params(outer: dict, stacked_blocks: dict, layers: int) -> dict:
    """The inverse of :func:`split_lm_params`."""
    state = dict(outer)
    for i, block in enumerate(unstack_stage_params(stacked_blocks)[:layers]):
        state.update({f"{_BLOCKS}{i}.{k}": v for k, v in block.items()})
    return state


def _stage_range(layers: int, pp: int, stage: int) -> range:
    if pp < 1 or layers % pp:
        raise ValueError(f"{layers} layers do not cut into {pp} equal stages")
    if not 0 <= stage < pp:
        raise ValueError(f"stage {stage} outside [0, {pp})")
    per = layers // pp
    return range(stage * per, (stage + 1) * per)


def stage_state_dict(full: dict, pp: int, stage: int) -> dict:
    """Stage ``stage``'s state dict of a ``pp``-stage pipeline, cut from a
    full TransformerLM state dict: the outer leaves and this stage's blocks,
    renumbered from 0."""
    layers = 1 + max(i for i in map(_block_index, full) if i is not None)
    mine = _stage_range(layers, pp, stage)
    out = {}
    for name, t in full.items():
        i = _block_index(name)
        if i is None:
            out[name] = t.clone()
        elif i in mine:
            out[f"{_BLOCKS}{i - mine.start}.{_block_leaf(name)}"] = t.clone()
    return out


def merge_stage_state_dicts(stages: list) -> dict:
    """The full state dict (or gradients by name) from every stage's, in
    stage order; the outer leaves from stage 0."""
    per = 1 + max(i for i in map(_block_index, stages[0]) if i is not None)
    out = {k: v for k, v in stages[0].items() if _block_index(k) is None}
    for s, sd in enumerate(stages):
        for name, t in sd.items():
            i = _block_index(name)
            if i is not None:
                out[f"{_BLOCKS}{s * per + i}.{_block_leaf(name)}"] = t
    return out


class PipelineStage(nn.Module):
    """One stage of the pipelined TransformerLM: the embedding, ``layers``
    blocks (this stage's share), the final norm and the float32 head. The
    arguments are the TransformerLM's; ``moe_experts > 0`` raises, as the
    reference does."""

    def __init__(self, vocab: int = 32000, dim: int = 512, heads: int = 8,
                 layers: int = 6, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16, attention: str = "dense",
                 kv_heads: Optional[int] = None, sp_group=None,
                 moe_experts: int = 0):
        super().__init__()
        if moe_experts > 0:
            # MoE models alternate dense and MoE blocks: one stacked layout
            # does not cover both.
            raise NotImplementedError(
                "pipeline_lm does not support moe_experts > 0: MoE blocks "
                "alternate with dense blocks, so the stacked-layer layout does "
                "not apply; pipeline MoE needs per-stage param trees")
        self.vocab, self.dim, self.dtype = vocab, dim, dtype
        self.sp_group = sp_group
        self.embed = nn.Embedding(vocab, dim)
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, dtype, attention, kv_heads, sp_group)
            for _ in range(layers))
        self.norm = RMSNorm(dim, dtype)
        self.lm_head = Dense(dim, vocab, torch.float32)

    def positions(self, t_local: int, device) -> torch.Tensor:
        """The rope positions of a microbatch's rows: this rank's sequence
        shard's global ones under sequence parallelism."""
        start = 0 if self.sp_group is None else dist.get_rank(self.sp_group) * t_local
        return torch.arange(start, start + t_local, device=device)[None, :]


def pipeline_lm_logits(stage: PipelineStage, tokens_micro: torch.Tensor,
                       group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``(n_micro, mb, T, vocab)`` float32 logits of ``tokens_micro``
    ``(n_micro, mb, T)`` through the pipeline over ``group``; valid on the
    last stage."""
    n_micro, mb, t = tokens_micro.shape
    positions = stage.positions(t, tokens_micro.device)
    x_micro = stage.embed(tokens_micro).to(stage.dtype)
    out = pipeline_apply(lambda block, h: block(h, positions), stage.blocks,
                         x_micro, group)
    h = stage.norm(out.reshape(n_micro * mb, t, stage.dim))
    return stage.lm_head(h).reshape(n_micro, mb, t, stage.vocab)


def pipeline_lm_loss_and_grads(stage: PipelineStage, tokens_micro: torch.Tensor,
                               group: Optional[dist.ProcessGroup] = None
                               ) -> tuple[torch.Tensor, dict]:
    """Loss and gradients of the pipelined LM. Runs the backward pass into
    the stage's ``.grad`` (adding to what is there) and sums the outer
    leaves' gradients over ``group``; the blocks' stay on their stage.
    Returns ``(loss, {name: grad})``: the loss is the last stage's value,
    the same on every stage. The sum runs in a tensor hook on each outer
    leaf, before its gradient accumulates, so that a gradient hook that
    fires after accumulation (the latency-hiding ``DistributedOptimizer``'s)
    sees the summed gradient. Every stage reaches every outer leaf in the
    same place of the same graph, so the ranks issue these allreduces and
    the ticks' P2P calls in one order.

    The loss is the mean next-token cross entropy over all ``n_micro * mb
    * T`` rows in one call (targets rolled within each row; on a sequence
    shard within the shard), masked to the last stage."""
    n_micro, mb, t = tokens_micro.shape
    rows = tokens_micro.reshape(n_micro * mb, t)
    logits = pipeline_lm_logits(stage, tokens_micro, group).reshape(n_micro * mb, t, -1)
    loss = masked_last_stage_loss(token_loss(logits, next_tokens(rows)), group)
    # The cross entropy keeps what its backward needs: holding the float32
    # logits through the backward too would add their size to the peak.
    del logits
    named = list(stage.named_parameters())
    outer = [p for name, p in named if _block_index(name) is None]
    summed = set()

    def sum_over_pp(p):
        def hook(grad):
            summed.add(id(p))
            return allreduce_(grad.clone(), ReduceOp.SUM, group)
        return hook

    handles = [p.register_hook(sum_over_pp(p)) for p in outer]
    try:
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    for p in outer:
        if id(p) not in summed:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            allreduce_(p.grad, ReduceOp.SUM, group)
    return last_stage_value(loss, group), {n: p.grad for n, p in named}
