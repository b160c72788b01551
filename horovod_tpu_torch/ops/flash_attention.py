"""Flash attention, trainable: three CUDA kernels behind one autograd
Function, each with its plain PyTorch version beside it.

``flash_attention(q, k, v, causal=True, block_q=None, block_k=None)`` takes
q ``(B, T, H, D)`` and k/v
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

``block_q`` and ``block_k`` are tile ceilings, as in the JAX package: each
kernel runs the largest (q extent, k extent) pair it was built for within
them (``effective_blocks``; ``TILE_PAIRS`` lists the pairs). A ceiling
below the smallest built extent takes the smallest, and None takes the
kernel's default extent. At head dim 128 the bf16 kernels are built for
4 (forward), 3 (dQ) and 2 (dK/dV) pairs of 64- and 128-row extents, at 32
and 64 for their default pair alone; the float32 kernels for their one
64 x 64 tile. A tile need not divide T: the kernels
mask a ragged tail. On the CPU the tiles are validated and resolved the
same way, and the plain versions run.
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

# The tile pairs (q extent, k extent) the bf16 kernels are built for at
# TILE_HEAD_DIM, per kernel, default first; csrc/flash_tc.cuh's
# HVD_*_PAIRS list the same. For dK/dV the k extent is a block's rows and
# the q extent a tile's; for the others the reverse. The ring kernels
# (ops/ring_flash.py) are the same templates and take the same pairs.
# Other bf16 head dims take the default pair alone, float32 F32_TILE.
TILE_HEAD_DIM = 128
TILE_PAIRS = {
    "flash_fwd": ((128, 128), (128, 64), (64, 128), (64, 64)),
    "flash_bwd_dq": ((128, 64), (64, 64), (64, 128)),
    "flash_bwd_dkv": ((64, 128), (64, 64)),
}
F32_TILE = (64, 64)
RING_OF = {"ring_flash_fwd": "flash_fwd", "ring_flash_bwd_dq": "flash_bwd_dq",
           "ring_flash_bwd_dkv": "flash_bwd_dkv"}


def built_pairs(name: str, d: int, dtype) -> tuple:
    """The tile pairs kernel ``name`` (a flash or a ring kernel) is built
    for at head dim ``d`` in ``dtype``, default first."""
    pairs = TILE_PAIRS[RING_OF.get(name, name)]
    if dtype == torch.float32:
        return (F32_TILE,)
    return pairs if d == TILE_HEAD_DIM else pairs[:1]


def _ceiling(value, name: str):
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(f"{name} must be a positive int or None, not {value!r}")
    return value


def effective_blocks(t: int, d: int, dtype, block_q=None,
                     block_k=None) -> dict:
    """{kernel: (q extent, k extent)} that the six kernels (B1-B6) run for
    the ceilings ``block_q`` and ``block_k`` at sequence length ``t``, head
    dim ``d`` and ``dtype``: the port's counterpart of the JAX package's
    ``_check_blocks``. Each kernel takes the built pair of the largest
    area (then q extent) with both extents within the ceilings; a ceiling
    below the smallest built extent is raised to it, and None is the
    kernel's default extent. ``t`` takes no part: the kernels mask a
    ragged tail, so no tile has to divide it."""
    bq, bk = _ceiling(block_q, "block_q"), _ceiling(block_k, "block_k")
    if t < 1:
        raise ValueError(f"sequence length {t} < 1")
    out = {}
    for name in (*TILE_PAIRS, *RING_OF):
        pairs = built_pairs(name, d, dtype)
        cq = max(pairs[0][0] if bq is None else bq, min(p[0] for p in pairs))
        ck = max(pairs[0][1] if bk is None else bk, min(p[1] for p in pairs))
        out[name] = max((p for p in pairs if p[0] <= cq and p[1] <= ck),
                        key=lambda p: (p[0] * p[1], p[0]))
    return out


# While a list: each launch of a kernel here or in ``ring_flash`` appends
# (name, q rows, kv rows, T, D, itemsize, causal or (q positions, k
# positions)), from which ``utils/roofline.py`` counts the work it did.
launch_log: list | None = None


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
        lib.hvd_flash_fwd.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.hvd_flash_bwd_dq.argtypes = [p] * 7 + [i] * 9 + [p]
        lib.hvd_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 9 + [p]
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


_ERRORS = {1000: "arguments no kernel takes (or a tile pair not built)",
           1001: "a TMA tensor map did not encode"}


def _launch(fn, name: str, dev, *args, counts: dict = launches,
            geometry: tuple = ()) -> None:
    """Launch on ``dev``'s current stream, with ``dev`` made the current
    device only for the call, and count it in ``counts[name]`` (and its
    ``geometry`` in ``launch_log`` while that is a list)."""
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = fn(*args, stream)
    if err != 0:
        why = _ERRORS.get(err, "CUDA error")
        raise RuntimeError(f"{name} kernel launch failed: {why} ({err})")
    counts[name] += 1
    if launch_log is not None:
        launch_log.append((name, *geometry))


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def tiles_of(name: str, x: torch.Tensor, block_q=None, block_k=None) -> tuple:
    """The (q extent, k extent) kernel ``name`` runs on rows-layout ``x``
    (rows, T, D) for the ceilings ``block_q`` and ``block_k``."""
    _, t, d = x.shape
    return effective_blocks(t, d, x.dtype, block_q, block_k)[name]


def flash_fwd(qr, kr, vr, h: int, hkv: int, causal: bool, block_q=None,
              block_k=None):
    """(O, L) of rows-layout q, k, v: the kernel on CUDA, plain on CPU."""
    bq, bk = tiles_of("flash_fwd", qr, block_q, block_k)
    if not qr.is_cuda:
        return fwd_plain(qr, kr, vr, h, hkv, causal)
    code = _check_cuda(h, hkv, (qr, kr, vr))
    _check_tma(qr, kr, vr)
    rows, t, d = qr.shape
    out = torch.empty_like(qr)
    lse = torch.empty(rows, t, device=qr.device, dtype=torch.float32)
    _launch(_library().hvd_flash_fwd, "flash_fwd", qr.device,
            _ptr(qr), _ptr(kr), _ptr(vr), _ptr(out), _ptr(lse), rows, h, hkv,
            t, d, int(causal), code, bq, bk,
            geometry=(rows, kr.shape[0], t, d, qr.element_size(), causal))
    return out, lse


def flash_bwd_dq(qr, kr, vr, dor, lse, delta, h: int, hkv: int, causal: bool,
                 block_q=None, block_k=None):
    """dQ: the kernel on CUDA, plain on CPU."""
    bq, bk = tiles_of("flash_bwd_dq", qr, block_q, block_k)
    if not qr.is_cuda:
        return dq_plain(qr, kr, vr, dor, lse, delta, h, hkv, causal)
    code = _check_cuda(h, hkv, (qr, kr, vr, dor), (lse, delta))
    _check_tma(qr, kr, vr, dor)
    rows, t, d = qr.shape
    dq = torch.empty_like(qr)
    _launch(_library().hvd_flash_bwd_dq, "flash_bwd_dq", qr.device,
            _ptr(qr), _ptr(kr), _ptr(vr), _ptr(dor), _ptr(lse), _ptr(delta),
            _ptr(dq), rows, h, hkv, t, d, int(causal), code, bq, bk,
            geometry=(rows, kr.shape[0], t, d, qr.element_size(), causal))
    return dq


def flash_bwd_dkv(qr, kr, vr, dor, lse, delta, h: int, hkv: int, causal: bool,
                  block_q=None, block_k=None):
    """(dK, dV): the kernel on CUDA, plain on CPU."""
    bq, bk = tiles_of("flash_bwd_dkv", qr, block_q, block_k)
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
            _ptr(dk), _ptr(dv), rows_kv, h, hkv, t, d, int(causal), code,
            bq, bk,
            geometry=(qr.shape[0], rows_kv, t, d, qr.element_size(), causal))
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        b, h, hkv = q.shape[0], q.shape[2], k.shape[2]
        qr, kr, vr = _rows(q), _rows(k), _rows(v)
        out, lse = flash_fwd(qr, kr, vr, h, hkv, causal, block_q, block_k)
        ctx.save_for_backward(qr, kr, vr, out, lse)
        ctx.geometry = (b, h, hkv, causal, block_q, block_k)
        return _unrows(out, b)

    @staticmethod
    def backward(ctx, dout):
        qr, kr, vr, out, lse = ctx.saved_tensors
        b, h, hkv, causal, block_q, block_k = ctx.geometry
        dor = _rows(dout.to(qr.dtype))
        delta = (dor.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(qr, kr, vr, dor, lse, delta, h, hkv, causal,
                          block_q, block_k)
        dk, dv = flash_bwd_dkv(qr, kr, vr, dor, lse, delta, h, hkv, causal,
                               block_q, block_k)
        return _unrows(dq, b), _unrows(dk, b), _unrows(dv, b), None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q=None, block_k=None):
    """Fused attention, trainable; see the module docstring."""
    _gqa_group(q, k, v)
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    effective_blocks(q.shape[1], q.shape[3], q.dtype, block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)
