"""Decoder-only transformer LM, the counterpart of
``horovod_tpu.models.transformer.TransformerLM``.

Numerics follow the flax model step for step: float32 parameters; Dense
layers cast input and weight to the activation dtype (bf16 by default)
before the product; RMSNorm reduces in float32 with epsilon 1e-6; GELU is
the tanh approximation; rotary embedding rotates the two halves of each
head; the LM head runs at ``logits_dtype`` (float32 by default).
``attention="flash"`` runs the flash kernels of ``ops/flash_attention.py``,
``attention="dense"`` the plain causal attention below.

``remat=True`` recomputes each block's forward in the backward pass
(``torch.utils.checkpoint``, the counterpart of flax's ``nn.remat(Block)``):
one more forward of work for activations kept only at block boundaries.
It composes with both flash paths: the recompute runs the block's
attention Function again, so the forward kernel launches twice per layer
and step and the backward kernels once. ``forward(...,
return_hidden=True)`` returns the normed hidden states and skips the head,
for ``chunked_lm_loss``, which never holds the whole ``(B, T, vocab)``
logits.

``sp_group`` (flax's ``sp_axis``) makes the model sequence-parallel: each
rank of the group holds a shard of the sequence, the caller passes the
shard's global positions (for the rotary embedding), and attention runs
around the ring, ``ring_flash_attention`` for "flash" and
``ring_attention`` for "dense". GQA k/v are not replicated before the ring,
so it rotates the small blocks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import ring_attention
from ..ops.ring_flash import ring_flash_attention


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding on the last dim, halves rotated."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[..., None].float() * freqs          # [..., T, half]
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def causal_attention(q, k, v):
    """Dense causal attention on [B, T, H, D]: the (T, T) logits in float32,
    probabilities cast back to the activation dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    logits = logits.masked_fill(~(pos[:, None] >= pos[None, :]), -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Dense(nn.Module):
    """Bias-free linear layer: ``weight`` (out, in) in float32; input and
    weight are cast to ``dtype`` before the product (flax ``nn.Dense``)."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mul = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps) * self.scale
        return (xf * mul).to(self.dtype)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16, attention: str = "dense",
                 kv_heads: Optional[int] = None, sp_group=None):
        super().__init__()
        if attention not in ("dense", "flash"):
            raise ValueError(
                f"unknown attention={attention!r}; use 'dense' or 'flash'")
        kvh = heads if kv_heads is None else kv_heads
        if kvh < 1 or heads % kvh:
            raise ValueError(f"kv_heads {kvh} must be >= 1 and divide heads {heads}")
        self.dim, self.heads, self.kv_heads = dim, heads, kvh
        self.head_dim = dim // heads
        self.attention = attention
        self.sp_group = sp_group
        self.norm1 = RMSNorm(dim, dtype)
        if kvh == heads:
            self.qkv = Dense(dim, 3 * dim, dtype)
        else:
            self.q_proj = Dense(dim, dim, dtype)
            self.kv_proj = Dense(dim, 2 * kvh * self.head_dim, dtype)
        self.o_proj = Dense(dim, dim, dtype)
        self.norm2 = RMSNorm(dim, dtype)
        self.mlp_in = Dense(dim, mlp_ratio * dim, dtype)
        self.mlp_out = Dense(mlp_ratio * dim, dim, dtype)

    def forward(self, x, positions):
        b, t = x.shape[0], x.shape[1]
        hd, kvh = self.head_dim, self.kv_heads
        h = self.norm1(x)
        if kvh == self.heads:
            q, k, v = self.qkv(h).chunk(3, dim=-1)
        else:
            q = self.q_proj(h)
            k, v = self.kv_proj(h).chunk(2, dim=-1)
        q = _rope(q.reshape(b, t, self.heads, hd), positions)
        k = _rope(k.reshape(b, t, kvh, hd), positions)
        v = v.reshape(b, t, kvh, hd)
        if self.sp_group is not None:
            ring = ring_flash_attention if self.attention == "flash" else ring_attention
            attn = ring(q, k, v, self.sp_group)
        elif self.attention == "flash":
            attn = flash_attention(q, k, v, causal=True)
        else:
            if kvh != self.heads:
                k = k.repeat_interleave(self.heads // kvh, dim=2)
                v = v.repeat_interleave(self.heads // kvh, dim=2)
            attn = causal_attention(q, k, v)
        x = x + self.o_proj(attn.reshape(b, t, self.dim))
        h = F.gelu(self.mlp_in(self.norm2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    def __init__(self, vocab: int = 32000, dim: int = 512, heads: int = 8,
                 layers: int = 6, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16, attention: str = "dense",
                 kv_heads: Optional[int] = None,
                 logits_dtype: torch.dtype = torch.float32, sp_group=None,
                 remat: bool = False):
        super().__init__()
        self.vocab, self.dim, self.dtype = vocab, dim, dtype
        self.remat = remat
        self.embed = nn.Embedding(vocab, dim)
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, dtype, attention, kv_heads, sp_group)
            for _ in range(layers))
        self.norm = RMSNorm(dim, dtype)
        self.lm_head = Dense(dim, vocab, logits_dtype)

    def forward(self, tokens, positions=None, return_hidden: bool = False):
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = self.embed(tokens).to(self.dtype)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                # No RNG state to keep (the model draws none), and reading
                # it is not allowed while a CUDA graph captures the step.
                x = checkpoint(block, x, positions, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, positions)
        x = self.norm(x)
        return x if return_hidden else self.lm_head(x)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at flax's default scales: Dense kernels truncated
    normal with variance 1/fan_in (lecun_normal), embeddings normal with
    variance 1/dim, norm scales 1. Draws on the generator's device."""
    for name, p in model.named_parameters():
        if name.endswith("scale"):
            p.fill_(1.0)
        elif name == "embed.weight":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        else:
            # flax's truncated normal at +-2 std, rescaled to unit variance
            std = 1.0 / math.sqrt(p.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)


def next_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """The targets of next-token prediction: tokens rolled left by one (on
    a sequence shard: within the shard, as the JAX dp×sp step does)."""
    return torch.roll(tokens, -1, dims=1)


def token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of ``(B, T, vocab)`` logits against ``(B, T)``
    targets, upcast to float32 first (a bf16 head's logits too)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy of the logits of ``tokens``."""
    return token_loss(logits, next_tokens(tokens))


def _chunk_loss(hidden, weight, targets):
    return token_loss(hidden.float() @ weight.t(), targets)


def chunked_lm_loss(hidden: torch.Tensor, head_weight: torch.Tensor,
                    targets: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Next-token cross entropy without the whole ``(B, T, vocab)`` logits,
    the counterpart of ``horovod_tpu.models.transformer.chunked_lm_loss``:
    the head and the cross entropy run over sequence chunks, each chunk
    checkpointed so that the backward pass recomputes its logits instead of
    keeping them. The result is the mean of the chunk means.

    ``hidden`` is ``model(tokens, return_hidden=True)``; ``head_weight`` is
    ``model.lm_head.weight`` in the port's layout, ``(vocab, dim)`` (the
    flax kernel is its transpose, ``(dim, vocab)``). The head's product
    runs in float32, the hidden states upcast, as the JAX function does.
    Peak extra memory is one chunk's float32 logits, ``B * chunk * vocab``.
    """
    b, t, _ = hidden.shape
    if chunk <= 0:
        raise ValueError(f"loss chunk must be positive, got {chunk}")
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence {t} not divisible by loss chunk {chunk}")
    weight = head_weight.float()
    losses = [checkpoint(_chunk_loss, hidden[:, i:i + chunk], weight,
                         targets[:, i:i + chunk], use_reentrant=False,
                         preserve_rng_state=False)
              for i in range(0, t, chunk)]
    return torch.stack(losses).mean()
