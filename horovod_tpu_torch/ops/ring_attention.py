"""Sequence-parallel attention, the counterpart of
``horovod_tpu.ops.ring_attention``: its zigzag layout helpers, the dense
oracle, the einsum ring, and Ulysses.

``ring_attention(q, k, v, group, zigzag)`` takes this rank's sequence shard
q ``(B, T_local, H, D)`` and k/v ``(B, T_local, Hkv, D)`` and returns its
shard of causal attention over the whole sequence. K/V blocks rotate around
the ring (``ring_shift``) while each step's block product runs as einsums
with the online-softmax state carried across steps; masking uses explicit
global positions, so the contiguous and the zigzag layouts are both right.
Gradients flow back around the ring (``_RingBlocks``). The fused variant,
with the block product in CUDA kernels, is
``ring_flash.ring_flash_attention``.

``group`` is the ring's process group; None is a ring of one rank (no
communication). Which steps are fully masked is decided on the host from
the positions, which are a pure function of (rank, T_local, n, zigzag), so
no step reads a device value.

``ulysses_attention(q, k, v, group, impl)`` trades the sequence shard for a
head shard with one all-to-all per tensor, ``(B, T/n, H, D) -> (B, T,
H/n, D)``, runs causal attention on the whole sequence for its heads
(einsums, or ``flash_attention``'s kernels with ``impl="flash"``), and
trades back. The all-to-alls are differentiable: the backward of each is
the inverse all-to-all.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.collectives import AllToAll, ring_shift


def zigzag_positions(rank_idx: int, t_local: int, n: int,
                     device=None) -> torch.Tensor:
    """Global positions of rank ``rank_idx``'s tokens under zigzag sharding:
    the sequence is cut into 2n stripes and rank r holds stripes r and
    2n-1-r, so every rank sees the same causal workload."""
    if t_local % 2:
        raise ValueError(
            f"zigzag needs an even per-rank sequence (two stripes); got "
            f"t_local={t_local}")
    half = t_local // 2
    i = torch.arange(t_local, device=device)
    low = rank_idx * half + i
    high = (2 * n - 1 - rank_idx) * half + (i - half)
    return torch.where(i < half, low, high)


def _zigzag_order(t: int, n: int) -> list:
    """The permutation both shard and unshard derive from: stripe r then
    stripe 2n-1-r for each rank r."""
    if t % (2 * n):
        raise ValueError(f"sequence {t} must divide into 2*{n} stripes")
    half = t // (2 * n)
    order = []
    for r in range(n):
        order.extend(range(r * half, (r + 1) * half))
        order.extend(range((2 * n - 1 - r) * half, (2 * n - r) * half))
    return order


def zigzag_shard(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Reorder the full sequence so that a plain contiguous split over
    ``n`` ranks hands each rank its two zigzag stripes."""
    order = torch.tensor(_zigzag_order(x.shape[axis], n), device=x.device)
    return torch.index_select(x, axis, order)


def zigzag_unshard(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Inverse permutation of :func:`zigzag_shard`."""
    order = _zigzag_order(x.shape[axis], n)
    inv = [0] * len(order)
    for i, o in enumerate(order):
        inv[o] = i
    return torch.index_select(x, axis, torch.tensor(inv, device=x.device))


def positions(rank_idx: int, t_local: int, n: int, zigzag: bool,
              device=None) -> torch.Tensor:
    """Global positions (int64) of a rank's rows, contiguous or zigzag."""
    if zigzag:
        return zigzag_positions(rank_idx, t_local, n, device)
    return rank_idx * t_local + torch.arange(t_local, device=device)


def position_range(rank_idx: int, t_local: int, n: int,
                   zigzag: bool) -> tuple[int, int]:
    """(min, max) of :func:`positions`, computed on the host."""
    if zigzag:
        half = t_local // 2
        return rank_idx * half, (2 * n - rank_idx) * half - 1
    return rank_idx * t_local, (rank_idx + 1) * t_local - 1


def fully_masked(my: int, src: int, t_local: int, n: int, zigzag: bool) -> bool:
    """Whether every key of rank ``src``'s block lies after every query of
    rank ``my``: the ring step that skips its block product."""
    return (position_range(my, t_local, n, zigzag)[1]
            < position_range(src, t_local, n, zigzag)[0])


def ring_rank(group: Optional[dist.ProcessGroup]) -> tuple[int, int]:
    """(this rank, ring size) in ``group``; None is a ring of one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def ring_hop(tensors, group: Optional[dist.ProcessGroup], shift: int = 1) -> list:
    """One hop of the ring ``group`` (``ring_shift``); a ring of one
    (None) hands the tensors back."""
    return list(tensors) if group is None else ring_shift(tensors, group, shift)


def causal_reference(q, k, v):
    """Single-device dense causal attention on ``(B, T, H, D)``: the oracle
    the sequence-parallel schedules are held against."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    logits = logits.masked_fill(~(pos[:, None] >= pos[None, :]), float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block_update(q, k, v, o, m, l, q_pos, k_pos, scale):
    """One online-softmax accumulation step with global causal masking.
    o: (B, T, H, D) float32; m, l: (B, H, T) float32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.where(mask, torch.exp(logits - m_safe[..., None]),
                    torch.zeros_like(logits))
    corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                       torch.exp(m - m_safe))
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v).float()
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


class _RingBlocks(torch.autograd.Function):
    """The K/V blocks a rank holds at ring steps 0..n-1 (its own first),
    flattened as (k_0, v_0, k_1, v_1, ...): n - 1 hops of ``ring_shift``.
    The backward sends each block's gradient back the way the block came,
    adding the gradient of every step it passed. One node carries all the
    hops, so every rank reaches it in its backward (step 0 is never
    masked) and makes the same P2P calls, whichever steps it skipped. It
    holds all n blocks at once, as the dense path may."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group, (_, ctx.n) = group, ring_rank(group)
        blocks = [k, v]
        for _ in range(ctx.n - 1):
            blocks += ring_hop(blocks[-2:], group)
        return tuple(blocks)

    @staticmethod
    def backward(ctx, *grads):
        gk, gv = grads[-2], grads[-1]
        for step in range(ctx.n - 2, -1, -1):
            gk, gv = ring_hop([gk, gv], ctx.group, -1)
            gk, gv = gk + grads[2 * step], gv + grads[2 * step + 1]
        return None, gk, gv


def ring_attention(q, k, v, group: Optional[dist.ProcessGroup] = None,
                   zigzag: bool = False):
    """Causal ring attention over ``group`` (sequence-sharded); see the
    module docstring. GQA: k/v may have fewer heads than q; the ring
    rotates the small k/v blocks and each step replicates their heads."""
    my, n = ring_rank(group)
    b, t, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh != 0 or v.shape[2] != kvh:
        raise ValueError(
            f"q heads {h} must be a multiple of kv heads {kvh} "
            f"(v has {v.shape[2]})")
    rep = h // kvh
    scale = d ** -0.5
    o = torch.zeros(b, t, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), float("-inf"), device=q.device)
    l = torch.zeros(b, h, t, device=q.device)
    q_pos = positions(my, t, n, zigzag, q.device)
    blocks = _RingBlocks.apply(group, k, v)
    for step in range(n):
        src = (my - step) % n
        if not fully_masked(my, src, t, n, zigzag):
            k_blk, v_blk = blocks[2 * step], blocks[2 * step + 1]
            o, m, l = _block_update(
                q, k_blk.repeat_interleave(rep, dim=2) if rep > 1 else k_blk,
                v_blk.repeat_interleave(rep, dim=2) if rep > 1 else v_blk,
                o, m, l, q_pos, positions(src, t, n, zigzag, q.device), scale)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def to_heads(x, group: Optional[dist.ProcessGroup]):
    """(B, T/n, H, D) sequence shard -> (B, T, H/n, D) head shard; a group
    of one (None) hands ``x`` back."""
    return x if group is None else AllToAll.apply(x, group, 2, 1)


def to_seq(x, group: Optional[dist.ProcessGroup]):
    """The inverse of :func:`to_heads`."""
    return x if group is None else AllToAll.apply(x, group, 1, 2)


def head_shard_attention(qh, kh, vh, impl: str = "dense"):
    """Causal attention of Ulysses's head shard, q ``(B, T, h, D)`` and k/v
    ``(B, T, hkv, D)`` with h a multiple of hkv: dense einsums (kv heads
    repeated, masked logits at -1e30) or ``flash_attention``'s kernels,
    whose own head grouping serves GQA."""
    if impl == "flash":
        from .flash_attention import flash_attention

        return flash_attention(qh, kh, vh)
    rep = qh.shape[2] // kh.shape[2]
    if rep > 1:
        kh = kh.repeat_interleave(rep, dim=2)
        vh = vh.repeat_interleave(rep, dim=2)
    scale = qh.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float() * scale
    pos = torch.arange(qh.shape[1], device=qh.device)
    logits = logits.masked_fill(~(pos[:, None] >= pos[None, :]), -1e30)
    probs = torch.softmax(logits, dim=-1).to(qh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh)


def ulysses_attention(q, k, v, group: Optional[dist.ProcessGroup] = None,
                      impl: str = "dense"):
    """All-to-all sequence parallelism over ``group`` (None: a group of
    one, no call); see the module docstring. The heads must divide by the
    group's size n, and in GQA the kv heads too, with the q heads a
    multiple of them, so that every rank gets whole kv heads."""
    _, n = ring_rank(group)
    h, kvh = q.shape[2], k.shape[2]
    if h % n != 0:
        raise ValueError(f"heads {h} not divisible by axis size {n}")
    if v.shape[2] != kvh:
        raise ValueError(f"k has {kvh} heads but v has {v.shape[2]}")
    if kvh != h and (kvh % n != 0 or h % kvh != 0):
        raise ValueError(
            f"GQA kv heads {kvh} must be a multiple of the axis size {n} "
            f"(and q heads {h} a multiple of {kvh}) so the all-to-all can "
            f"hand every device whole kv heads; use "
            f"ring_attention/ring_flash_attention otherwise")
    if impl not in ("dense", "flash"):
        raise ValueError(f"unknown impl={impl!r}; use 'dense' or 'flash'")
    out = head_shard_attention(to_heads(q, group), to_heads(k, group),
                               to_heads(v, group), impl)
    return to_seq(out, group)
