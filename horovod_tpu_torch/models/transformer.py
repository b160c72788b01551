"""Decoder-only transformer LM, the counterpart of
``horovod_tpu.models.transformer.TransformerLM``.

Numerics follow the flax model step for step: float32 parameters; Dense
layers cast input and weight to the activation dtype (bf16 by default)
before the product; RMSNorm reduces in float32 with epsilon 1e-6; GELU is
the tanh approximation; rotary embedding rotates the two halves of each
head; the LM head runs at ``logits_dtype`` (float32 by default).
``attention="flash"`` runs the flash kernels of ``ops/flash_attention.py``,
``attention="dense"`` the plain causal attention below. ``block_q`` and
``block_k`` (flax's fields of the same names) are the flash kernels' tile
ceilings, passed to both flash paths (``flash_attention`` and
``ring_flash_attention``; ``effective_blocks`` resolves them); None is
each kernel's default. They are not weights: ``tp_state_dict`` and
``convert.py`` do not see them.

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

``tp_group`` makes the model tensor-parallel over a model process group
of size tp, the explicit form of ``tp_param_specs``' layout (GSPMD inserts
the collectives there; here the module does). ``qkv`` (or ``q_proj`` and
``kv_proj``) and ``mlp_in`` are column-parallel, their input riding
``parallel.tensor.copy_to_model``; ``o_proj``, ``mlp_out`` and ``lm_head``
are row-parallel, each ending in one ``reduce_from_model``; the embedding
and the norms are replicated. Rank r holds heads ``r H/tp ... (r+1) H/tp -
1`` of q, of k and of v (and of the kv heads under GQA), and the matching
rows of ``o_proj``, and runs attention on them; so a block is ``x +
reduce(attn_partial(x))`` then ``x + reduce(mlp_partial(x))``. A fused
``qkv`` is cut by heads within each of q, k and v, not into contiguous
columns: ``tp_state_dict`` cuts a full state dict into rank r's, and
``tp_merge_state_dicts`` puts the ranks' back together. ``tp_size``
without a group builds rank-local shapes whose partials the caller sums
(``tp_rank`` names the virtual rank). With fewer kv heads than ranks
(``kv_heads < tp``, ``tp`` a multiple of ``kv_heads``) ``kv_proj`` stays
whole on every rank, computed from the normed input outside
``copy_to_model`` and its output passed through ``copy_to_model``, and
each rank keeps the one kv head its q heads read: the flash kernels take
the group ratio ``(heads / tp) : 1``, the backward sums the K/V cotangents
over the group, and every replica of ``kv_proj`` gets the whole gradient.
``return_hidden`` returns the normed hidden states, replicated over the
model group; ``chunked_lm_loss(..., tp_group=)`` takes its head from them.

``moe_experts > 0`` turns block ``i``'s MLP into a switch-MoE
(``models/moe.py``) where ``i % moe_every == moe_every - 1``; ``ep_group``
shards its experts. Each forward keeps the MoE layers' load-balancing
losses, read with ``moe_lb_loss()``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import ring_attention
from ..ops.ring_flash import ring_flash_attention
from ..common import basics
from ..parallel.tensor import copy_to_model, model_size, reduce_from_model
from .moe import MoEMLP


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
                 kv_heads: Optional[int] = None, sp_group=None,
                 moe_experts: int = 0, tp_group=None,
                 tp_size: Optional[int] = None, ep_group=None,
                 block_q: Optional[int] = None, block_k: Optional[int] = None,
                 tp_rank: Optional[int] = None):
        super().__init__()
        if attention not in ("dense", "flash"):
            raise ValueError(
                f"unknown attention={attention!r}; use 'dense' or 'flash'")
        kvh = heads if kv_heads is None else kv_heads
        if kvh < 1 or heads % kvh:
            raise ValueError(f"kv_heads {kvh} must be >= 1 and divide heads {heads}")
        tp = _tp_size(tp_group, tp_size)
        kv_whole = _kv_whole(kvh, tp)
        if heads % tp:
            raise ValueError(f"heads {heads} must divide by the tensor-parallel "
                             f"size {tp}")
        if kv_whole and (tp % kvh or sp_group is not None):
            raise ValueError(
                f"kv_heads {kvh} under the tensor-parallel size {tp}: either "
                f"must divide the other, so that each rank reads one whole kv "
                f"head, and the ring does not take a replicated kv_proj")
        self.dim, self.heads, self.kv_heads = dim, heads, kvh
        self.head_dim = dim // heads
        self.attention = attention
        self.block_q, self.block_k = block_q, block_k
        self.sp_group = sp_group
        self.tp_group, self.tp_size = tp_group, tp
        self.kv_whole, self.virtual_rank = kv_whole, tp_rank
        self.norm1 = RMSNorm(dim, dtype)
        if kvh == heads:
            self.qkv = Dense(dim, 3 * dim // tp, dtype)
        else:
            self.q_proj = Dense(dim, dim // tp, dtype)
            self.kv_proj = Dense(dim, 2 * kvh * self.head_dim //
                                 (1 if kv_whole else tp), dtype)
        self.o_proj = Dense(dim // tp, dim, dtype)
        self.norm2 = RMSNorm(dim, dtype)
        self.moe = None
        if moe_experts:
            self.moe = MoEMLP(dim, mlp_ratio * dim, moe_experts, dtype=dtype,
                              ep_group=ep_group)
        else:
            self.mlp_in = Dense(dim, mlp_ratio * dim // tp, dtype)
            self.mlp_out = Dense(mlp_ratio * dim // tp, dim, dtype)

    def attn_partial(self, x, positions):
        """This rank's heads' share of the attention sublayer's output:
        ``o_proj``'s partial product, which the model group sums."""
        b, t = x.shape[0], x.shape[1]
        hd, tp = self.head_dim, self.tp_size
        h_local = self.heads // tp
        kv_local = 1 if self.kv_whole else self.kv_heads // tp
        normed = self.norm1(x)
        h = copy_to_model(normed, self.tp_group)
        if self.kv_heads == self.heads:
            q, k, v = self.qkv(h).chunk(3, dim=-1)
        elif self.kv_whole:
            # Every rank computes all kv heads from the replicated input and
            # keeps the one its q heads read; copy_to_model sums the ranks'
            # kv cotangents, so each replica of kv_proj gets the whole
            # gradient and the input its whole kv share.
            q = self.q_proj(h)
            kv = copy_to_model(self.kv_proj(normed), self.tp_group)
            j = self._kv_head()
            k, v = (u.reshape(b, t, self.kv_heads, hd)[:, :, j:j + 1]
                    for u in kv.chunk(2, dim=-1))
        else:
            q = self.q_proj(h)
            k, v = self.kv_proj(h).chunk(2, dim=-1)
        q = _rope(q.reshape(b, t, h_local, hd), positions)
        k = _rope(k.reshape(b, t, kv_local, hd), positions)
        v = v.reshape(b, t, kv_local, hd)
        if self.sp_group is not None and self.attention == "flash":
            attn = ring_flash_attention(q, k, v, self.sp_group,
                                        block_q=self.block_q, block_k=self.block_k)
        elif self.sp_group is not None:
            attn = ring_attention(q, k, v, self.sp_group)
        elif self.attention == "flash":
            attn = flash_attention(q, k, v, causal=True, block_q=self.block_q,
                                   block_k=self.block_k)
        else:
            if kv_local != h_local:
                k = k.repeat_interleave(h_local // kv_local, dim=2)
                v = v.repeat_interleave(h_local // kv_local, dim=2)
            attn = causal_attention(q, k, v)
        return self.o_proj(attn.reshape(b, t, h_local * hd))

    def _kv_head(self) -> int:
        """The kv head this rank's q heads read when kv_proj is whole: q
        head ``i`` reads kv head ``i // (heads / kv_heads)``. A rank of a
        virtual world (``tp_size`` without a group) reads
        ``virtual_rank``'s."""
        r = self.virtual_rank if self.tp_group is None else \
            dist.get_rank(self.tp_group)
        if r is None:
            raise ValueError("a rank block of a virtual model group with a "
                             "whole kv_proj needs its tp_rank")
        return r * (self.heads // self.tp_size) // (self.heads // self.kv_heads)

    def mlp_partial(self, x):
        """This rank's share of the MLP sublayer's output (``mlp_out``'s
        partial product)."""
        h = copy_to_model(self.norm2(x), self.tp_group)
        return self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))

    def forward(self, x, positions):
        if self.tp_size > 1 and self.tp_group is None:
            raise ValueError(f"a Block cut for tp={self.tp_size} runs forward "
                             f"only with its tp_group; sum attn_partial and "
                             f"mlp_partial over the ranks instead")
        x = x + reduce_from_model(self.attn_partial(x, positions), self.tp_group)
        if self.moe is not None:
            return x + self.moe(self.norm2(x))
        return x + reduce_from_model(self.mlp_partial(x), self.tp_group)


def _kv_whole(kv_heads: int, tp: int) -> bool:
    """Whether tensor parallelism keeps ``kv_proj`` whole on every model
    rank: when the kv heads do not cut into ``tp`` equal sets of heads
    (``kv_heads < tp``)."""
    return kv_heads % tp != 0


def _tp_size(tp_group, tp_size: Optional[int]) -> int:
    tp = model_size(tp_group) if tp_size is None else tp_size
    if tp_group is not None and tp != model_size(tp_group):
        raise ValueError(f"tp_size {tp} but the tp group has "
                         f"{model_size(tp_group)} ranks")
    if tp < 1:
        raise ValueError(f"tp_size must be >= 1, got {tp}")
    return tp


class TransformerLM(nn.Module):
    def __init__(self, vocab: int = 32000, dim: int = 512, heads: int = 8,
                 layers: int = 6, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16, attention: str = "dense",
                 kv_heads: Optional[int] = None,
                 logits_dtype: torch.dtype = torch.float32, sp_group=None,
                 remat: bool = False, moe_experts: int = 0, moe_every: int = 2,
                 tp_group=None, tp_size: Optional[int] = None, ep_group=None,
                 block_q: Optional[int] = None, block_k: Optional[int] = None,
                 tp_rank: Optional[int] = None):
        super().__init__()
        self.vocab, self.dim, self.dtype = vocab, dim, dtype
        self.remat = remat
        self.tp_group, self.tp_size = tp_group, _tp_size(tp_group, tp_size)
        self.embed = nn.Embedding(vocab, dim)
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, dtype, attention, kv_heads, sp_group,
                  moe_experts if moe_experts > 0 and i % moe_every == moe_every - 1
                  else 0, tp_group, tp_size, ep_group, block_q, block_k, tp_rank)
            for i in range(layers))
        self.norm = RMSNorm(dim, dtype)
        self.lm_head = Dense(dim // self.tp_size, vocab, logits_dtype)
        self.moe_lb_losses: list = []
        if tp_group is not None and self.tp_size > 1:
            basics.note_model_cut()

    def head(self, x):
        """The LM head, row-parallel under tensor parallelism: this rank's
        slice of the hidden dim against its rows of the head, summed over
        the model group."""
        if self.tp_size == 1:
            return self.lm_head(x)
        per = self.dim // self.tp_size
        r = dist.get_rank(self.tp_group)
        x = copy_to_model(x, self.tp_group)[..., r * per:(r + 1) * per]
        return reduce_from_model(self.lm_head(x), self.tp_group)

    def forward(self, tokens, positions=None, return_hidden: bool = False):
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = self.embed(tokens).to(self.dtype)
        self.moe_lb_losses = []
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                # No RNG state to keep (the model draws none), and reading
                # it is not allowed while a CUDA graph captures the step.
                x = checkpoint(block, x, positions, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, positions)
            if block.moe is not None:
                # Read here, from this forward: a remat recompute in the
                # backward sets the layer's attribute again.
                self.moe_lb_losses.append(block.moe.lb_loss)
        x = self.norm(x)
        return x if return_hidden else self.head(x)

    def moe_lb_loss(self) -> torch.Tensor:
        """The sum of the MoE layers' load-balancing losses of the last
        forward (0 without MoE layers); the caller adds it times its
        weight to the task loss."""
        if not self.moe_lb_losses:
            return torch.zeros((), device=self.embed.weight.device)
        return torch.stack(self.moe_lb_losses).sum()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at flax's default scales: Dense kernels truncated
    normal with variance 1/fan_in (lecun_normal), embeddings normal with
    variance 1/dim, norm scales 1. The MoE leaves keep flax's layout, so
    their fan-in is the product of all dims but the last, as flax computes
    it. Draws on the generator's device."""
    for name, p in model.named_parameters():
        if name.endswith("scale"):
            p.fill_(1.0)
        elif name == "embed.weight":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        else:
            moe = name.rsplit(".", 1)[-1] in ("gate", "w_in", "w_out")
            fan_in = math.prod(p.shape[:-1]) if moe else p.shape[1]
            # flax's truncated normal at +-2 std, rescaled to unit variance
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)


_COLUMN = ("qkv", "q_proj", "kv_proj", "mlp_in")
_ROW = ("o_proj", "mlp_out", "lm_head")


def _tp_dim(name: str, ndim: int) -> Optional[int]:
    """The dim of the port's ``(out, in)`` weight that tensor parallelism
    cuts: 0 (output) for a column-parallel one, 1 (input) for a
    row-parallel one, None for a replicated leaf; the substring rules of
    ``horovod_tpu.models.transformer.tp_param_specs`` on 2-D leaves."""
    if ndim == 2:
        if any(k in name for k in _COLUMN):
            return 0
        if any(k in name for k in _ROW):
            return 1
    return None


def _fused(name: str) -> int:
    """How many tensors a fused weight stacks on its output dim: q, k and v
    in ``qkv``; k and v in ``kv_proj``. Each is cut by heads on its own."""
    parts = name.split(".")
    return 3 if "qkv" in parts else 2 if "kv_proj" in parts else 1


def _whole_kv(name: str, kv_heads: Optional[int], tp: int) -> bool:
    return "kv_proj" in name.split(".") and kv_heads is not None and \
        _kv_whole(kv_heads, tp)


def tp_param_specs(model: nn.Module) -> dict:
    """Parameter name -> the dim tensor parallelism cuts (see ``_tp_dim``),
    the port's form of ``tp_param_specs``: flax's ``P(None, tp)`` on an
    ``(in, out)`` kernel is dim 0 of the port's ``(out, in)`` weight,
    ``P(tp, None)`` dim 1. A ``kv_proj`` that the model's tensor-parallel
    size keeps whole (``kv_heads < tp``) is replicated, None."""
    whole = {f"{n}.kv_proj.weight".lstrip(".") for n, m in model.named_modules()
             if getattr(m, "kv_whole", False)}
    return {name: None if name in whole else _tp_dim(name, p.dim())
            for name, p in model.named_parameters()}


def tp_state_dict(full: dict, tp: int, rank: int,
                  kv_heads: Optional[int] = None) -> dict:
    """Model rank ``rank``'s state dict of a TransformerLM built with a
    model group of size ``tp``, cut from a full one: each of q, k and v
    (and k, v of ``kv_proj``) by heads, ``mlp_in`` by rows, the
    row-parallel weights by columns, the rest copied. ``kv_heads`` (the
    model's; None: a multiple of ``tp``) below ``tp`` keeps ``kv_proj``
    whole, as the model does."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside [0, {tp})")
    out = {}
    for name, t in full.items():
        dim = None if _whole_kv(name, kv_heads, tp) else _tp_dim(name, t.dim())
        if dim is not None:
            parts = t.chunk(_fused(name), dim=dim)
            if any(p.shape[dim] % tp for p in parts):
                raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does "
                                 f"not cut into {tp} equal slices")
            t = torch.cat([p.chunk(tp, dim=dim)[rank] for p in parts], dim=dim)
        out[name] = t.clone()
    return out


def tp_merge_state_dicts(locals_: list, kv_heads: Optional[int] = None) -> dict:
    """The inverse of :func:`tp_state_dict` over every model rank's dict
    (or gradients by name), in rank order: the full tensors, replicated
    leaves (a whole ``kv_proj`` too, ``kv_heads`` as there) taken from
    rank 0."""
    out = {}
    for name, t in locals_[0].items():
        dim = None if _whole_kv(name, kv_heads, len(locals_)) \
            else _tp_dim(name, t.dim())
        if dim is None:
            out[name] = t
            continue
        n = _fused(name)
        pieces = [sd[name].chunk(n, dim=dim) for sd in locals_]
        out[name] = torch.cat([torch.cat([p[i] for p in pieces], dim=dim)
                               for i in range(n)], dim=dim)
    return out


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


def tp_partial_logits(hidden: torch.Tensor, weight: torch.Tensor,
                      rank: int = 0) -> torch.Tensor:
    """Model rank ``rank``'s partial logits of the row-parallel head, in
    float32: its ``weight.shape[1]`` columns of the replicated ``hidden``
    against its slice ``weight`` (``(vocab, dim / tp)``) of the head. The
    ranks' partials sum to the logits; a whole head (``weight`` as wide as
    ``hidden``) gives them."""
    per = weight.shape[1]
    if per != hidden.shape[-1]:
        hidden = hidden[..., rank * per:(rank + 1) * per]
    return hidden.float() @ weight.t()


def _chunk_loss(hidden, weight, targets, tp_group=None, rank=0):
    return token_loss(reduce_from_model(tp_partial_logits(hidden, weight, rank),
                                        tp_group), targets)


def chunked_lm_loss(hidden: torch.Tensor, head_weight: torch.Tensor,
                    targets: torch.Tensor, chunk: int = 2048,
                    tp_group=None) -> torch.Tensor:
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

    ``tp_group``: the model group of a tensor-parallel model, whose
    ``lm_head`` holds this rank's ``dim / tp`` columns and whose hidden
    states are replicated. Each chunk takes this rank's partial logits
    (``tp_partial_logits``, from the hidden states passed through
    ``copy_to_model``, whose backward completes their cotangent) and sums
    them over the group in float32 (``reduce_from_model``) before the
    cross entropy, as the row-parallel head of ``tp_param_specs``
    (``P(tp, None)`` on the flax kernel) computes them.
    """
    b, t, _ = hidden.shape
    if chunk <= 0:
        raise ValueError(f"loss chunk must be positive, got {chunk}")
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence {t} not divisible by loss chunk {chunk}")
    weight = head_weight.float()
    rank = 0
    if model_size(tp_group) > 1:
        rank = dist.get_rank(tp_group)
        hidden = copy_to_model(hidden, tp_group)
    losses = [checkpoint(_chunk_loss, hidden[:, i:i + chunk], weight,
                         targets[:, i:i + chunk], tp_group, rank,
                         use_reentrant=False, preserve_rng_state=False)
              for i in range(0, t, chunk)]
    return torch.stack(losses).mean()
