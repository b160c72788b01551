"""Flash attention, trainable: three CUDA kernels behind one autograd
Function, each with its plain PyTorch version beside it.

``flash_attention(q, k, v, causal=True)`` takes q ``(B, T, H, D)`` and k/v
``(B, T, Hkv, D)`` with ``H % Hkv == 0`` (grouped-query attention: each kv
head serves a contiguous group of H/Hkv q heads), the layout of
``horovod_tpu.ops.flash_attention.flash_attention``. Inside, tensors are in
the rows layout ``(B*H, T, D)``:

- ``flash_fwd``: O and the per-row logsumexp L = m + log l;
- ``flash_bwd_dq``: dQ = scale * sum_k [p * (dO.V^T - delta)].K, p = exp(s - L);
- ``flash_bwd_dkv``: dV = sum p^T.dO and dK = scale * sum [p * (dO.V^T -
  delta)]^T.Q over every q row of the kv row's group;

with delta = rowsum(dO * O) computed here, outside the kernels. On a CUDA
tensor each wrapper launches its kernel (``csrc/flash_attention.cu``) and
counts the launch in ``launches``; on a CPU tensor it runs its plain
version, which does the same arithmetic densely in float32: the contract
every kernel is held to. In bfloat16 the three kernels run on the tensor
cores (``csrc/flash_tc.cuh``: TMA loads, wgmma) and need 16-byte aligned
inputs. There is no other fallback: a CUDA tensor the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention.cu"

# Kernel launches per wrapper, counted where the kernel launches.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _gqa_group(q, k, v):
    """(h, hkv, group); raises on head counts that do not group."""
    h, hkv = q.shape[2], k.shape[2]
    if v.shape[2] != hkv:
        raise ValueError(f"k has {hkv} heads but v has {v.shape[2]}")
    if h % hkv:
        raise ValueError(f"q heads {h} not divisible by kv heads {hkv}")
    return h, hkv, h // hkv


def _rows(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _unrows(x: torch.Tensor, b: int) -> torch.Tensor:
    r, t, d = x.shape
    return x.reshape(b, r // b, t, d).transpose(1, 2)


# ------------------------------------------------------------ plain versions

def _expand_kv(xr: torch.Tensor, h: int, hkv: int) -> torch.Tensor:
    """kv rows (B*Hkv, T, D) -> one per q row (B*H, T, D), as _kv_row maps."""
    rkv, t, d = xr.shape
    b = rkv // hkv
    return (xr.view(b, hkv, 1, t, d).expand(b, hkv, h // hkv, t, d)
            .reshape(b * h, t, d))


def _mask(t: int, causal: bool, device) -> torch.Tensor | None:
    if not causal:
        return None
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _probs(qr, kr, lse, causal):
    """p = exp(q.k^T * scale - L), exactly 0 where masked."""
    scale = qr.shape[-1] ** -0.5
    s = torch.matmul(qr.float(), kr.float().transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    mask = _mask(qr.shape[1], causal, qr.device)
    return p if mask is None else p.masked_fill(~mask, 0.0)


def fwd_plain(qr, kr, vr, h: int, hkv: int, causal: bool):
    """Plain version of ``flash_fwd``: (O in q's dtype, L float32)."""
    scale = qr.shape[-1] ** -0.5
    kq, vq = _expand_kv(kr, h, hkv).float(), _expand_kv(vr, h, hkv).float()
    s = torch.matmul(qr.float() * scale, kq.transpose(1, 2))
    mask = _mask(qr.shape[1], causal, qr.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.max(dim=-1).values
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    out = torch.matmul(p, vq) / l[..., None]
    return out.to(qr.dtype), m + torch.log(l)


def dq_plain(qr, kr, vr, dor, lse, delta, h: int, hkv: int, causal: bool):
    """Plain version of ``flash_bwd_dq``: dQ in q's dtype."""
    scale = qr.shape[-1] ** -0.5
    kq, vq = _expand_kv(kr, h, hkv).float(), _expand_kv(vr, h, hkv).float()
    p = _probs(qr, kq, lse, causal)
    ds = p * (torch.matmul(dor.float(), vq.transpose(1, 2)) - delta[..., None])
    return (torch.matmul(ds, kq) * scale).to(qr.dtype)


def dkv_plain(qr, kr, vr, dor, lse, delta, h: int, hkv: int, causal: bool):
    """Plain version of ``flash_bwd_dkv``: (dK, dV) in k's and v's dtype,
    each the sum over the q rows of its group."""
    scale = qr.shape[-1] ** -0.5
    kq, vq = _expand_kv(kr, h, hkv).float(), _expand_kv(vr, h, hkv).float()
    p = _probs(qr, kq, lse, causal)
    dv = torch.matmul(p.transpose(1, 2), dor.float())
    ds = p * (torch.matmul(dor.float(), vq.transpose(1, 2)) - delta[..., None])
    dk = torch.matmul(ds.transpose(1, 2), qr.float()) * scale
    rkv, t, d = kr.shape

    def fold(x):   # (B*H, T, D) -> (B*Hkv, T, D), summing each group
        return x.view(rkv // hkv, hkv, h // hkv, t, d).sum(dim=2).reshape(rkv, t, d)

    return fold(dk).to(kr.dtype), fold(dv).to(vr.dtype)


def flash_attention_reference(q, k, v, causal: bool = True):
    """Dense attention on ``(B, T, H, D)``/``(B, T, Hkv, D)``, computed in
    float32 and returned in q's dtype; autograd gives its gradients."""
    h, hkv, group = _gqa_group(q, k, v)
    scale = q.shape[-1] ** -0.5
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = _mask(q.shape[1], causal, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


# ------------------------------------------------------------------ kernels

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load

        lib = load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hvd_flash_fwd.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.hvd_flash_bwd_dq.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.hvd_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + [p]
        for fn in (lib.hvd_flash_fwd, lib.hvd_flash_bwd_dq, lib.hvd_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(h: int, hkv: int, inputs, rows_f32=()) -> int:
    """Validate what the kernels take; return the dtype code."""
    x = inputs[0]
    dev = x.device
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take float32 or bfloat16, not {x.dtype}")
    if x.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head dims {HEAD_DIMS}, not {x.shape[-1]}")
    for y in inputs:
        if y.device != dev or y.dtype != x.dtype or not y.is_contiguous():
            raise ValueError("flash kernel inputs must be contiguous, of one "
                             "dtype and on one device")
    for y in rows_f32:
        if y.device != dev or y.dtype != torch.float32 or not y.is_contiguous():
            raise ValueError("L and delta must be contiguous float32 on the "
                             "inputs' device")
    if h % hkv:
        raise ValueError(f"q heads {h} not divisible by kv heads {hkv}")
    return _DTYPE_CODES[x.dtype]


def _check_tma(*inputs) -> None:
    """The tensor-core kernels load bf16 inputs by TMA, which needs
    16-byte aligned base addresses."""
    if inputs[0].dtype != torch.bfloat16:
        return
    for x in inputs:
        if x.data_ptr() % 16:
            raise ValueError("bf16 flash kernel inputs must start on a 16-byte "
                             f"boundary (storage offset {x.storage_offset()})")


def _tma_rows(t: int, *rows_f32):
    """L and delta as the bf16 dK/dV kernels read them by TMA: rows that
    start on 16 bytes, so t rounded up to 4 values, padded with zeros."""
    if t % 4 == 0:
        return rows_f32
    return tuple(torch.nn.functional.pad(x, (0, 4 - t % 4)) for x in rows_f32)


_ERRORS = {1000: "arguments no kernel takes",
           1001: "a TMA tensor map did not encode"}


def _launch(fn, name: str, dev, *args, counts: dict = launches) -> None:
    """Launch on ``dev``'s current stream, with ``dev`` made the current
    device only for the call, and count it in ``counts[name]``."""
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = fn(*args, stream)
    if err != 0:
        why = _ERRORS.get(err, "CUDA error")
        raise RuntimeError(f"{name} kernel launch failed: {why} ({err})")
    counts[name] += 1


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def flash_fwd(qr, kr, vr, h: int, hkv: int, causal: bool):
    """(O, L) of rows-layout q, k, v: the kernel on CUDA, plain on CPU."""
    if not qr.is_cuda:
        return fwd_plain(qr, kr, vr, h, hkv, causal)
    code = _check_cuda(h, hkv, (qr, kr, vr))
    _check_tma(qr, kr, vr)
    rows, t, d = qr.shape
    out = torch.empty_like(qr)
    lse = torch.empty(rows, t, device=qr.device, dtype=torch.float32)
    _launch(_library().hvd_flash_fwd, "flash_fwd", qr.device,
            _ptr(qr), _ptr(kr), _ptr(vr), _ptr(out), _ptr(lse), rows, h, hkv,
            t, d, int(causal), code)
    return out, lse


def flash_bwd_dq(qr, kr, vr, dor, lse, delta, h: int, hkv: int, causal: bool):
    """dQ: the kernel on CUDA, plain on CPU."""
    if not qr.is_cuda:
        return dq_plain(qr, kr, vr, dor, lse, delta, h, hkv, causal)
    code = _check_cuda(h, hkv, (qr, kr, vr, dor), (lse, delta))
    _check_tma(qr, kr, vr, dor)
    rows, t, d = qr.shape
    dq = torch.empty_like(qr)
    _launch(_library().hvd_flash_bwd_dq, "flash_bwd_dq", qr.device,
            _ptr(qr), _ptr(kr), _ptr(vr), _ptr(dor), _ptr(lse), _ptr(delta),
            _ptr(dq), rows, h, hkv, t, d, int(causal), code)
    return dq


def flash_bwd_dkv(qr, kr, vr, dor, lse, delta, h: int, hkv: int, causal: bool):
    """(dK, dV): the kernel on CUDA, plain on CPU."""
    if not qr.is_cuda:
        return dkv_plain(qr, kr, vr, dor, lse, delta, h, hkv, causal)
    code = _check_cuda(h, hkv, (qr, kr, vr, dor), (lse, delta))
    _check_tma(qr, kr, vr, dor, lse, delta)
    rows_kv, t, d = kr.shape
    if qr.dtype == torch.bfloat16:
        lse, delta = _tma_rows(t, lse, delta)
    dk, dv = torch.empty_like(kr), torch.empty_like(vr)
    _launch(_library().hvd_flash_bwd_dkv, "flash_bwd_dkv", qr.device,
            _ptr(qr), _ptr(kr), _ptr(vr), _ptr(dor), _ptr(lse), _ptr(delta),
            _ptr(dk), _ptr(dv), rows_kv, h, hkv, t, d, int(causal), code)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, h, hkv = q.shape[0], q.shape[2], k.shape[2]
        qr, kr, vr = _rows(q), _rows(k), _rows(v)
        out, lse = flash_fwd(qr, kr, vr, h, hkv, causal)
        ctx.save_for_backward(qr, kr, vr, out, lse)
        ctx.geometry = (b, h, hkv, causal)
        return _unrows(out, b)

    @staticmethod
    def backward(ctx, dout):
        qr, kr, vr, out, lse = ctx.saved_tensors
        b, h, hkv, causal = ctx.geometry
        dor = _rows(dout.to(qr.dtype))
        delta = (dor.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(qr, kr, vr, dor, lse, delta, h, hkv, causal)
        dk, dv = flash_bwd_dkv(qr, kr, vr, dor, lse, delta, h, hkv, causal)
        return _unrows(dq, b), _unrows(dk, b), _unrows(dv, b), None


def flash_attention(q, k, v, causal: bool = True):
    """Fused attention, trainable; see the module docstring."""
    _gqa_group(q, k, v)
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    return _FlashAttention.apply(q, k, v, causal)
