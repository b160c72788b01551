"""Ring flash attention, trainable: the ring schedule of sequence
parallelism with each step's local block product in CUDA kernels.

``ring_flash_attention(q, k, v, group=None, zigzag=False)`` takes this
rank's sequence shard, q ``(B, T_local, H, D)`` and k/v
``(B, T_local, Hkv, D)`` with ``H % Hkv == 0``, and returns its shard of
causal attention over the whole sequence: the counterpart of
``horovod_tpu.ops.ring_flash.ring_flash_attention``. ``group`` is the
ring's process group (``parallel.mesh.dp_sp_groups``); None is a ring of
one rank. Inside, tensors are in the rows layout ``(B*H, T_local, D)`` and
each ring step calls one kernel per pass:

- ``rf_fwd``: updates the float32 carries (acc, m, l), unnormalized, by one
  K/V block, with causal masking from the global positions qpos >= kpos;
- ``rf_bwd_dq``: adds one K/V block's share to the float32 dQ carry;
- ``rf_bwd_dkv``: adds one K/V block's dK, dV to the float32 carries that
  travel the ring with the block.

Carries are updated in place, by the kernel on a CUDA tensor
(``csrc/ring_flash.cu``, counted in ``launches``) and by its plain version,
the same arithmetic densely in float32, on a CPU tensor. In bfloat16 the
three kernels run on the tensor cores (``csrc/flash_tc.cuh``: TMA loads,
wgmma) and need 16-byte aligned inputs, the positions they load by TMA
included (k positions for the forward and dQ, q positions for dK/dV).
There is no other fallback: a CUDA tensor the kernel does not take raises.

The schedule is the JAX package's step for step: carries start as zeros,
-1e30 and zeros; at step s a rank holds the block of rank (my - s) % n and
skips the block product when every key of it lies after every query (the
positions are a pure function of rank, T_local, n and the layout, so the
skip is decided on the host and never reads the device); K/V rotate on
every step but the last, skipped or not, so the ranks' P2P calls always
match. Then O = acc / l and lse = m + log l (with l = 0 read as 1). The
backward takes delta = rowsum(dO * O) from O rounded to q's dtype; dQ stays
on its rank, and (dK, dV) rotate with their (K, V) block on every step,
the last included, so that after n hops each lands on the rank that owns
the block.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.distributed as dist

from . import flash_attention as fa
from .ring_attention import fully_masked, positions, ring_hop, ring_rank

NEG_INF = fa.NEG_INF
_SOURCE = "ring_flash.cu"

# Kernel launches per wrapper, counted where the kernel launches.
launches = {"ring_flash_fwd": 0, "ring_flash_bwd_dq": 0, "ring_flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------ plain versions

def _live(qpos, kpos):
    return qpos[:, None] >= kpos[None, :]


def rf_fwd_plain(qr, kr, vr, acc, m, l, qpos, kpos, h: int, hkv: int):
    """Plain version of ``rf_fwd``: updates (acc, m, l) in place and
    returns them."""
    scale = qr.shape[-1] ** -0.5
    kq, vq = fa._expand_kv(kr, h, hkv).float(), fa._expand_kv(vr, h, hkv).float()
    live = _live(qpos, kpos)
    s = torch.matmul(qr.float() * scale, kq.transpose(1, 2)).masked_fill(~live, NEG_INF)
    m_new = torch.maximum(m, s.max(dim=-1).values)
    # Rows with no live key yet pivot on 0, so exp() underflows to 0.
    m_safe = torch.where(m_new <= NEG_INF * 0.5, torch.zeros_like(m_new), m_new)
    alpha = torch.exp(m - m_safe)
    p = torch.exp(s - m_safe[..., None]).masked_fill(~live, 0.0)
    l.copy_(l * alpha + p.sum(dim=-1))
    acc.copy_(acc * alpha[..., None] + torch.matmul(p, vq))
    m.copy_(m_new)
    return acc, m, l


def _probs(qr, kq, lse, qpos, kpos):
    """p = exp(q.k^T * scale - L), exactly 0 where masked."""
    scale = qr.shape[-1] ** -0.5
    s = torch.matmul(qr.float(), kq.transpose(1, 2)) * scale
    return torch.exp(s - lse[..., None]).masked_fill(~_live(qpos, kpos), 0.0)


def rf_dq_plain(qr, kr, vr, dor, lse, delta, qpos, kpos, dq, h: int, hkv: int):
    """Plain version of ``rf_bwd_dq``: dq += this block's dQ, in place."""
    scale = qr.shape[-1] ** -0.5
    kq, vq = fa._expand_kv(kr, h, hkv).float(), fa._expand_kv(vr, h, hkv).float()
    p = _probs(qr, kq, lse, qpos, kpos)
    ds = p * (torch.matmul(dor.float(), vq.transpose(1, 2)) - delta[..., None])
    return dq.add_(torch.matmul(ds, kq) * scale)


def rf_dkv_plain(qr, kr, vr, dor, lse, delta, qpos, kpos, dk, dv, h: int,
                 hkv: int):
    """Plain version of ``rf_bwd_dkv``: (dk, dv) += this block's dK, dV,
    each summed over the q rows of its group, in place."""
    scale = qr.shape[-1] ** -0.5
    kq, vq = fa._expand_kv(kr, h, hkv).float(), fa._expand_kv(vr, h, hkv).float()
    p = _probs(qr, kq, lse, qpos, kpos)
    dvq = torch.matmul(p.transpose(1, 2), dor.float())
    ds = p * (torch.matmul(dor.float(), vq.transpose(1, 2)) - delta[..., None])
    dkq = torch.matmul(ds.transpose(1, 2), qr.float()) * scale
    rkv, t, d = kr.shape

    def fold(x):   # (B*H, T, D) -> (B*Hkv, T, D), summing each group
        return x.view(rkv // hkv, hkv, h // hkv, t, d).sum(dim=2).reshape(rkv, t, d)

    dk.add_(fold(dkq))
    dv.add_(fold(dvq))
    return dk, dv


# ------------------------------------------------------------------ kernels

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load

        lib = load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hvd_ring_flash_fwd.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.hvd_ring_flash_dq.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.hvd_ring_flash_dkv.argtypes = [p] * 10 + [i] * 6 + [p]
        for fn in (lib.hvd_ring_flash_fwd, lib.hvd_ring_flash_dq,
                   lib.hvd_ring_flash_dkv):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(h, hkv, inputs, rows_f32, carries, qpos, kpos) -> int:
    """Validate what the kernels take; return the dtype code."""
    code = fa._check_cuda(h, hkv, inputs, rows_f32)
    dev, t = inputs[0].device, inputs[0].shape[1]
    for c in carries:
        if c.device != dev or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError("ring carries must be contiguous float32 on the "
                             "inputs' device")
    for pos in (qpos, kpos):
        if pos.device != dev or pos.dtype != torch.int32 or pos.shape != (t,) \
                or not pos.is_contiguous():
            raise ValueError(f"positions must be contiguous int32 ({t},) on "
                             "the inputs' device")
    return code


def rf_fwd(qr, kr, vr, acc, m, l, qpos, kpos, h: int, hkv: int):
    """One ring step's forward on (acc, m, l), in place: the kernel on CUDA,
    plain on CPU."""
    if not qr.is_cuda:
        return rf_fwd_plain(qr, kr, vr, acc, m, l, qpos, kpos, h, hkv)
    code = _check_cuda(h, hkv, (qr, kr, vr), (), (acc, m, l), qpos, kpos)
    fa._check_tma(qr, kr, vr, kpos)
    rows, t, d = qr.shape
    ptrs = [fa._ptr(x) for x in (qr, kr, vr, acc, m, l, qpos, kpos)]
    fa._launch(_library().hvd_ring_flash_fwd, "ring_flash_fwd", qr.device,
               *ptrs, rows, h, hkv, t, d, code, counts=launches)
    return acc, m, l


def rf_bwd_dq(qr, kr, vr, dor, lse, delta, qpos, kpos, dq, h: int, hkv: int):
    """dq += one ring step's dQ, in place: the kernel on CUDA, plain on CPU."""
    if not qr.is_cuda:
        return rf_dq_plain(qr, kr, vr, dor, lse, delta, qpos, kpos, dq, h, hkv)
    code = _check_cuda(h, hkv, (qr, kr, vr, dor), (lse, delta), (dq,), qpos, kpos)
    fa._check_tma(qr, kr, vr, dor, kpos)
    rows, t, d = qr.shape
    ptrs = [fa._ptr(x) for x in (qr, kr, vr, dor, lse, delta, qpos, kpos, dq)]
    fa._launch(_library().hvd_ring_flash_dq, "ring_flash_bwd_dq", qr.device,
               *ptrs, rows, h, hkv, t, d, code, counts=launches)
    return dq


def rf_bwd_dkv(qr, kr, vr, dor, lse, delta, qpos, kpos, dk, dv, h: int,
               hkv: int):
    """(dk, dv) += one ring step's dK, dV, in place: the kernel on CUDA,
    plain on CPU."""
    if not qr.is_cuda:
        return rf_dkv_plain(qr, kr, vr, dor, lse, delta, qpos, kpos, dk, dv,
                            h, hkv)
    code = _check_cuda(h, hkv, (qr, kr, vr, dor), (lse, delta), (dk, dv),
                       qpos, kpos)
    fa._check_tma(qr, kr, vr, dor, lse, delta, qpos)
    rows_kv, t, d = kr.shape
    if qr.dtype == torch.bfloat16:
        lse, delta = fa._tma_rows(t, lse, delta)
    ptrs = [fa._ptr(x) for x in (qr, kr, vr, dor, lse, delta, qpos, kpos, dk, dv)]
    fa._launch(_library().hvd_ring_flash_dkv, "ring_flash_bwd_dkv", qr.device,
               *ptrs, rows_kv, h, hkv, t, d, code, counts=launches)
    return dk, dv


# ------------------------------------------------------------ ring schedule

def ring_positions(rank_idx: int, t: int, n: int, zigzag: bool, device):
    """A rank's global positions as the kernels take them: int32 (t,)."""
    return positions(rank_idx, t, n, zigzag, device).to(torch.int32)


def init_carries(rows: int, t: int, d: int, device):
    """The forward carries before the first step: acc 0, m -1e30, l 0."""
    return (torch.zeros(rows, t, d, device=device),
            torch.full((rows, t), NEG_INF, device=device),
            torch.zeros(rows, t, device=device))


def finalize(acc, m, l, dtype):
    """(O in ``dtype``, lse float32) from the carries after the ring; a row
    that never saw a live key (l = 0) reads l as 1."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(dtype), m + torch.log(l_safe)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, zigzag):
        my, n = ring_rank(group)
        b, t, h, d = q.shape
        hkv = k.shape[2]
        qr, kr, vr = fa._rows(q), fa._rows(k), fa._rows(v)
        acc, m, l = init_carries(b * h, t, d, q.device)
        qpos = ring_positions(my, t, n, zigzag, q.device)
        k_blk, v_blk = kr, vr
        for step in range(n):
            src = (my - step) % n
            if not fully_masked(my, src, t, n, zigzag):
                rf_fwd(qr, k_blk, v_blk, acc, m, l, qpos,
                       ring_positions(src, t, n, zigzag, q.device), h, hkv)
            if step + 1 < n:
                k_blk, v_blk = ring_hop([k_blk, v_blk], group)
        out, lse = finalize(acc, m, l, q.dtype)
        ctx.save_for_backward(qr, kr, vr, out, lse)
        ctx.geometry = (b, h, hkv, group, zigzag)
        return fa._unrows(out, b)

    @staticmethod
    def backward(ctx, dout):
        qr, kr, vr, out, lse = ctx.saved_tensors
        b, h, hkv, group, zigzag = ctx.geometry
        my, n = ring_rank(group)
        t, d = qr.shape[1], qr.shape[2]
        dor = fa._rows(dout.to(qr.dtype))
        delta = (dor.float() * out.float()).sum(dim=-1)
        qpos = ring_positions(my, t, n, zigzag, qr.device)
        dq = torch.zeros(qr.shape, device=qr.device)
        dk = torch.zeros(kr.shape, device=qr.device)
        dv = torch.zeros(kr.shape, device=qr.device)
        k_blk, v_blk = kr, vr
        for step in range(n):
            src = (my - step) % n
            if not fully_masked(my, src, t, n, zigzag):
                kpos = ring_positions(src, t, n, zigzag, qr.device)
                rf_bwd_dq(qr, k_blk, v_blk, dor, lse, delta, qpos, kpos, dq, h, hkv)
                rf_bwd_dkv(qr, k_blk, v_blk, dor, lse, delta, qpos, kpos, dk,
                           dv, h, hkv)
            # (dK, dV) travel with their (K, V) block, the last step included.
            if step + 1 < n:
                dk, dv, k_blk, v_blk = ring_hop([dk, dv, k_blk, v_blk], group)
            else:
                dk, dv = ring_hop([dk, dv], group)
        return (fa._unrows(dq.to(qr.dtype), b), fa._unrows(dk.to(kr.dtype), b),
                fa._unrows(dv.to(vr.dtype), b), None, None)


def ring_flash_attention(q, k, v, group: Optional[dist.ProcessGroup] = None,
                         zigzag: bool = False):
    """Causal ring attention over ``group`` with the fused kernels,
    trainable; see the module docstring."""
    fa._gqa_group(q, k, v)
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    return _RingFlash.apply(q, k, v, group, zigzag)
