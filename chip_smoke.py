#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and
prints no result):

1. device: the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``horovod_tpu_torch/csrc``; log each
   tensor-core kernel's registers and spill bytes (ptxas) and its count of
   HGMMA (wgmma) and UTMALDG (TMA load) instructions (``cuobjdump``),
   raising if either count is zero or a kernel spills; hold each kernel
   against its plain PyTorch version on the card: the slice's shape
   (1, 4096, 8, 128) bf16 causal, the slice's head dim in float32 at
   T 1024, a GQA shape (8 q heads over 2 kv heads, D 64, T 1024) in
   float32 and bf16, and a ragged non-causal T = 96 in float32 and bf16;
   each kernel alone, and the autograd Function against the dense
   reference;
3. time each kernel at the slice's shape beside its plain version, its
   bound (with the TFLOP/s reached and the share of the bound), and
   PyTorch's own ``scaled_dot_product_attention`` forward and backward as
   a yardstick: CUDA events around runs of 10 calls back to back (``ms``)
   and around single calls (``single_ms``, which adds the host's cost of
   a launch to a kernel of tens of microseconds), medians of 30 runs
   after warm-up;
4. train the full-width flash TransformerLM (vocab 32000, dim 1024, 8
   heads of 128, 12 layers, seq 4096, batch 1, Adam 1e-3 through
   DistributedOptimizer) for 5 steps on a world of one over NCCL, with the
   launch counts zeroed just before and read just after;
5. one step of the flash model against the same step with plain dense
   attention, same weights and batch;
6. the ring-flash kernels against their plain versions over a virtual ring
   of 4 ranks on the card, in lockstep, rotation being list indexing, at
   every step (with the carries the ring has built): the layer of the sp
   path, (1, 4096, 8, 128) bf16 per rank, a GQA shape (8 q heads over 2,
   D 64, T 1024) in float32 and a ragged T = 96 in float32, each contiguous
   and zigzag; then the whole virtual ring (4 x 1024, bf16) against the
   dense reference on the full sequence, forward and gradients;
7. time each ring kernel at the layer's shape for a diagonal ring step
   (causal half of the pairs live) and a past step (all pairs live);
8. train the same model through the sequence-parallel path,
   ``TrainConfig(sp=1)`` (a ring of one: every layer runs the ring-flash
   kernels once per pass), 5 steps, counts zeroed just before;
9. one ring-flash step against one slice-1 flash step, same weights and
   batch;
10. the ``{"kernels": [...]}`` line (all six kernels), then
    ``{"ok": true, ...}`` last.

Both CUDA sources build at once, one nvcc each, at the start.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STEPS = 5
SLICE_SHAPE = (1, 4096, 8, 8, 128)       # (B, T, H, Hkv, D)
CHECK_SHAPES = [
    # (B, T, H, Hkv, D, causal, dtype name)
    (*SLICE_SHAPE, True, "bfloat16"),
    (1, 1024, 8, 8, 128, True, "float32"),
    (1, 1024, 8, 2, 64, True, "float32"),
    (2, 96, 4, 2, 32, False, "float32"),
    # bf16 B1 and B3 run on the tensor cores (csrc/flash_tc.cuh): GQA, and
    # a ragged T against their 128-row TMA tiles, non-causal.
    (1, 1024, 8, 2, 64, True, "bfloat16"),
    (2, 96, 4, 2, 32, False, "bfloat16"),
]
# Tolerances, by the dtype of the output compared (in float32):
# - float32 outputs, kernel vs plain or autograd vs dense: the same sums in
#   another order, |err| <= 1e-4 * max(1, max|ref|);
# - bf16 outputs, kernel vs its plain version fed the same inputs (the
#   plain version is the float32 contract; the tensor-core kernels split
#   P, P^T and dS^T into bf16 hi and lo terms and err by ~2^-16 of each
#   term): both round to bf16 and may differ by one unit in the last
#   place, at most 2^-7 of the value, so |err| <= 2^-7 |ref| + 1e-2 * rms
#   of the ref's row (its last dim, for values near 0), and the relative
#   norm error ||got - ref|| / ||ref|| <= 1e-2 (the rounding alone gives
#   < 1e-4);
# - bf16 outputs, the autograd Function vs the dense reference: relative
#   norm error <= 1e-2. Not element-wise: the Function, as in the JAX
#   package, takes delta = rowsum(dO * O) from O rounded to bf16, while the
#   dense reference differentiates the float32 softmax (~1.3e-3 for dQ/dK).
F32_TOL = 1e-4
BF16_RTOL, BF16_ROW_ATOL, BF16_RELNORM = 2.0 ** -7, 1e-2, 1e-2
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
KERNELS = {
    # name: (TPU kernel it replaces, products per live (q, k) pair)
    "flash_fwd": ("horovod_tpu/ops/flash_attention.py:53", 2),
    "flash_bwd_dq": ("horovod_tpu/ops/flash_attention.py:96", 3),
    "flash_bwd_dkv": ("horovod_tpu/ops/flash_attention.py:131", 4),
}
RING_KERNELS = {
    "ring_flash_fwd": ("horovod_tpu/ops/ring_flash.py:65", 2),
    "ring_flash_bwd_dq": ("horovod_tpu/ops/ring_flash.py:106", 3),
    "ring_flash_bwd_dkv": ("horovod_tpu/ops/ring_flash.py:137", 4),
}
SOURCES = {"flash_attention.cu": list(KERNELS), "ring_flash.cu": list(RING_KERNELS)}
RING_N = 4
RING_SHAPES = [
    # (B, T per rank, H, Hkv, D, dtype name)
    (1, 4096, 8, 8, 128, "bfloat16"),
    (1, 1024, 8, 2, 64, "float32"),
    (2, 96, 4, 2, 32, "float32"),
]
WHOLE_RING = (1, 1024, 8, 8, 128, "bfloat16")


def log(msg: str) -> None:
    print(msg, flush=True)


# The tensor-core kernels of csrc/flash_tc.cuh, by their template name.
TC_KERNELS = {"fwd_tc_kernel": "flash_fwd", "dkv_tc_kernel": "flash_bwd_dkv"}


def compiled_report(lib_path: str) -> dict:
    """Per tensor-core kernel and head dim: registers and spill bytes
    from the ptxas report beside the library, and the count of HGMMA
    (wgmma), UTMALDG (TMA load) and USETMAXREG instructions in its SASS.
    Raises if a kernel spills or either count is zero."""
    from horovod_tpu_torch.ops import _build

    name = re.compile(r"(" + "|".join(TC_KERNELS) + r")ILi(\d+)EE")
    report, cur = {}, None
    with open(lib_path + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = name.search(m.group(1))
                cur = f"{k.group(1)}<{k.group(2)}>" if k else None
                if cur:
                    report[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                report[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[cur]["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for chunk in sass.split("Function : ")[1:]:
        k = name.search(chunk.split("\n", 1)[0])
        if k:
            entry = report.setdefault(f"{k.group(1)}<{k.group(2)}>", {})
            for op in ("HGMMA", "UTMALDG", "USETMAXREG"):
                entry[op] = len(re.findall(r"\b" + op + r"\b", chunk))
    want = [f"{k}<{d}>" for k in TC_KERNELS for d in (32, 64, 128)]
    for k in want:
        e = report.get(k, {})
        log(f"  {k:20s} registers {e.get('registers')} spill bytes "
            f"{e.get('spill_bytes')} HGMMA {e.get('HGMMA')} UTMALDG "
            f"{e.get('UTMALDG')} USETMAXREG {e.get('USETMAXREG')}")
        if not e.get("HGMMA") or not e.get("UTMALDG"):
            raise AssertionError(f"{k}: no wgmma or no TMA load in its SASS: {e}")
        if e.get("spill_bytes") != 0:
            raise AssertionError(f"{k}: spills {e.get('spill_bytes')} bytes")
    return report


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 30, warmup: int = 3, inner: int = 10) -> float:
    """Time of one call of ``fn``: the median over ``reps`` runs of
    ``inner`` calls back to back, CUDA events around each run, after
    warm-up. Back to back, as a training step queues them, the host's cost
    of a launch overlaps the kernel before it; ``inner=1`` times single
    calls, host cost included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def flops(name, b, t, h, d, causal):
    """2 flops per multiply-add over the live (q, k) pairs of each product."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 2 * d * pairs * KERNELS[name][1] * b * h


def bound(name, b, t, h, hkv, d, causal, dtype_name, itemsize):
    """(ms, 'bytes' | 'operations'): the least time the card could take.
    Operations: the flops of ``flops``; bytes: each input read once, each
    output written once."""
    q_bytes, kv_bytes, row_bytes = (b * h * t * d * itemsize,
                                    b * hkv * t * d * itemsize, b * h * t * 4)
    moved = {
        "flash_fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,
        "flash_bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
        "flash_bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
    }[name]
    t_ops = flops(name, b, t, h, d, causal) / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(torch, label, got, want, autograd=False, quiet=False) -> float:
    """Hold ``got`` to ``want`` (both in their own dtype) by the tolerances
    above; log (unless ``quiet``) and return the max abs error, raise past a
    limit."""
    bf16 = want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    err = (g - w).abs()
    max_abs = err.max().item()
    relnorm = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
    if not bf16:
        limit = F32_TOL * max(1.0, w.abs().max().item())
        worst = max_abs / limit
        rule = f"max_abs <= {limit:.3e}"
    elif autograd:
        worst = relnorm / BF16_RELNORM
        rule = f"relnorm <= {BF16_RELNORM:g}"
    else:
        row_rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
        limit = BF16_RTOL * w.abs() + BF16_ROW_ATOL * row_rms
        worst = max((err / limit.clamp_min(1e-30)).max().item(),
                    relnorm / BF16_RELNORM)
        rule = (f"|err| <= 2^-7 |ref| + {BF16_ROW_ATOL:g} row rms, relnorm "
                f"<= {BF16_RELNORM:g}")
    if not quiet:
        log(f"  {label:20s} max_abs_err {max_abs:.3e} relnorm {relnorm:.3e} "
            f"worst/limit {worst:.3f} ({rule})")
    if not worst <= 1.0:
        raise AssertionError(f"{label}: {worst:.3f} of its limit ({rule})")
    return max_abs


def check_shape(torch, fa, dev, shape):
    """Each kernel against its plain version on the same inputs, and the
    autograd Function against the dense reference. Returns per-kernel max
    abs errors and the inputs for timing."""
    b, t, h, hkv, d, causal, dtype_name = shape
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand(*s):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)

    q, k, v, g = rand(b, t, h, d), rand(b, t, hkv, d), rand(b, t, hkv, d), rand(b, t, h, d)
    qr, kr, vr, dor = fa._rows(q), fa._rows(k), fa._rows(v), fa._rows(g)
    o_p, lse_p = fa.fwd_plain(qr, kr, vr, h, hkv, causal)
    delta = (dor.float() * o_p.float()).sum(-1)
    dq_p = fa.dq_plain(qr, kr, vr, dor, lse_p, delta, h, hkv, causal)
    dk_p, dv_p = fa.dkv_plain(qr, kr, vr, dor, lse_p, delta, h, hkv, causal)
    o_k, lse_k = fa.flash_fwd(qr, kr, vr, h, hkv, causal)
    dq_k = fa.flash_bwd_dq(qr, kr, vr, dor, lse_p, delta, h, hkv, causal)
    dk_k, dv_k = fa.flash_bwd_dkv(qr, kr, vr, dor, lse_p, delta, h, hkv, causal)
    torch.cuda.synchronize()
    pairs = {"flash_fwd": [("O", o_k, o_p), ("L", lse_k, lse_p)],
             "flash_bwd_dq": [("dQ", dq_k, dq_p)],
             "flash_bwd_dkv": [("dK", dk_k, dk_p), ("dV", dv_k, dv_p)]}
    errs = {}
    for name, outs in pairs.items():
        errs[name] = 0.0
        for label, got, want in outs:
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {label}: {got.shape}/{got.dtype} "
                                     f"!= {want.shape}/{want.dtype}")
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name} {label}: non-finite output")
            errs[name] = max(errs[name], check(torch, f"{name} {label}", got, want))
    # The autograd Function end to end against the dense reference.
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    ref = fa.flash_attention_reference(*ref_leaves, causal=causal)
    (out.float() * g.float()).sum().backward()
    (ref.float() * g.float()).sum().backward()
    check(torch, "autograd out", out, ref)
    for n, a, r in zip("qkv", leaves, ref_leaves):
        check(torch, f"autograd d{n}", a.grad, r.grad, autograd=True)
    return errs, (qr, kr, vr, dor, lse_p, delta, q, k, v)


def time_kernels(torch, fa, inputs, shape):
    import torch.nn.functional as F

    b, t, h, hkv, d, causal, dtype_name = shape
    qr, kr, vr, dor, lse, delta, q, k, v = inputs
    itemsize = qr.element_size()
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(qr, kr, vr, h, hkv, causal),
                      lambda: fa.fwd_plain(qr, kr, vr, h, hkv, causal)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(qr, kr, vr, dor, lse, delta, h, hkv, causal),
            lambda: fa.dq_plain(qr, kr, vr, dor, lse, delta, h, hkv, causal)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(qr, kr, vr, dor, lse, delta, h, hkv, causal),
            lambda: fa.dkv_plain(qr, kr, vr, dor, lse, delta, h, hkv, causal)),
    }
    # Yardstick only: PyTorch's own fused attention, (B, H, T, D) layout.
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    def fwd_call():
        F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qs, ks, vs))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    go = dor.view(b, h, t, d)

    def bwd_call():   # its backward alone: dQ, dK and dV in one call
        torch.autograd.grad(sdpa_out, (qg, kg, vg), go, retain_graph=True)

    sdpa_fwd, sdpa_bwd = time_ms(torch, fwd_call), time_ms(torch, bwd_call)
    single_fwd = time_ms(torch, fwd_call, inner=1)
    single_bwd = time_ms(torch, bwd_call, inner=1)
    sdpa_both = time_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal),
        (qg, kg, vg), go))
    library = {
        "flash_fwd": (sdpa_fwd, "scaled_dot_product_attention forward", single_fwd),
        "flash_bwd_dq": (None, "none alone: the backward that computes dQ "
                               "also computes dK and dV; see flash_bwd_dkv", None),
        "flash_bwd_dkv": (sdpa_bwd, "scaled_dot_product_attention backward, "
                                    "dQ, dK and dV together", single_bwd),
    }
    rows = {}
    for name, (kernel, plain) in calls.items():
        ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
        single_ms = time_ms(torch, kernel, inner=1)
        bound_ms, bound_by = bound(name, b, t, h, hkv, d, causal, dtype_name, itemsize)
        tflops = flops(name, b, t, h, d, causal) / ms / 1e9
        rows[name] = {"ms": ms, "single_ms": single_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library[name][0],
                      "library_single_ms": library[name][2],
                      "library": library[name][1], "tflops": tflops,
                      "bound_share": bound_ms / ms}
        log(f"  {name:14s} {ms:9.4f} ms (single {single_ms:.4f})  plain "
            f"{plain_ms:9.3f} ms  bound {bound_ms:7.4f} ms ({bound_by}), "
            f"{tflops:6.1f} TFLOP/s, {100 * bound_ms / ms:5.2f}% of the bound")
    kernel_bwd = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    log(f"  yardstick scaled_dot_product_attention: fwd {sdpa_fwd:.3f} ms "
        f"(single {single_fwd:.3f}), bwd {sdpa_bwd:.3f} ms (single "
        f"{single_bwd:.3f}; dQ, dK, dV), fwd+bwd {sdpa_both:.3f} ms; "
        f"the kernels: fwd {rows['flash_fwd']['ms']:.3f} ms, bwd "
        f"{kernel_bwd:.3f} ms, fwd+bwd {rows['flash_fwd']['ms'] + kernel_bwd:.3f} ms")
    return rows


def one_step(torch, model, tokens, positions=None):
    """Loss and gradients of one forward/backward, no optimizer step."""
    from horovod_tpu_torch.models.transformer import lm_loss

    loss = lm_loss(model(tokens, positions), tokens)
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in model.named_parameters()}


def hold_step(label, a, b, loss_limit, grad_limit=3e-2):
    """Hold step ``a`` (loss, grads) to step ``b``."""
    (la, ga), (lb, gb) = a, b
    rel = abs(la - lb) / abs(lb)
    log(f"  loss {label} {la:.6f} vs {lb:.6f} rel {rel:.3e} (limit {loss_limit:g})")
    if not (math.isfinite(la) and rel <= loss_limit):
        raise AssertionError(f"{label}: loss {la} vs {lb}")
    worst = ("", 0.0)
    for name, g in gb.items():
        err = (ga[name] - g).norm().item() / max(g.norm().item(), 1e-30)
        if not math.isfinite(err) or err > grad_limit:
            raise AssertionError(f"grad {name}: relative norm error {err}")
        worst = max(worst, (name, err), key=lambda x: x[1])
    log(f"  every gradient within {grad_limit:g} relative norm error; worst "
        f"{worst[0]} {worst[1]:.3e}")


def step_against_plain(torch, train_mod, config, dev):
    """One step's loss and gradients, flash kernels vs dense plain attention."""
    tokens = train_mod.make_batch(config, 0, dev)
    results = {}
    for attention in ("flash", "dense"):
        model = train_mod.build_model(
            dataclasses.replace(config, attention=attention), dev)
        results[attention] = one_step(torch, model, tokens)
        del model
        torch.cuda.empty_cache()
    hold_step("flash vs dense", results["flash"], results["dense"], 1e-2)


def ring_rows(torch, dev, shape, seed):
    """Per virtual rank: q, k, v, dO in the rows layout, random in the
    shape's dtype."""
    b, t, h, hkv, d, dtype_name = shape
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*s):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)

    return [[rand(b * h, t, d), rand(b * hkv, t, d), rand(b * hkv, t, d),
             rand(b * h, t, d)] for _ in range(RING_N)]


def ring_steps(ra, t, zigzag):
    """(rank, source rank) of every ring step that runs a block product, in
    lockstep order: step by step, rank by rank."""
    return [(r, (r - s) % RING_N) for s in range(RING_N) for r in range(RING_N)
            if not ra.fully_masked(r, (r - s) % RING_N, t, RING_N, zigzag)]


def check_ring_shape(torch, rf, ra, dev, shape, zigzag):
    """Each ring kernel against its plain version at every step of a
    virtual ring, on the same inputs and the same carries (the ones the ring
    has built so far, carried on from the plain version). Returns the max
    abs error per kernel."""
    b, t, h, hkv, d, dtype_name = shape
    ranks = ring_rows(torch, dev, shape, seed=99)
    pos = [rf.ring_positions(r, t, RING_N, zigzag, dev) for r in range(RING_N)]
    steps = ring_steps(ra, t, zigzag)
    errs = dict.fromkeys(RING_KERNELS, 0.0)

    def hold(name, label, got, want):
        errs[name] = max(errs[name], check(torch, f"{name} {label}", got, want,
                                           quiet=True))

    carries = [list(rf.init_carries(b * h, t, d, dev)) for _ in range(RING_N)]
    for r, src in steps:
        (qr, *_), (_, kr, vr, _) = ranks[r], ranks[src]
        want = [c.clone() for c in carries[r]]
        got = [c.clone() for c in carries[r]]
        rf.rf_fwd_plain(qr, kr, vr, *want, pos[r], pos[src], h, hkv)
        rf.rf_fwd(qr, kr, vr, *got, pos[r], pos[src], h, hkv)
        for label, g, w in zip(("acc", "m", "l"), got, want):
            hold("ring_flash_fwd", label, g, w)
        carries[r] = want
    fin = [rf.finalize(*c, getattr(torch, dtype_name)) for c in carries]
    delta = [(ranks[r][3].float() * fin[r][0].float()).sum(-1) for r in range(RING_N)]
    dq = [torch.zeros(b * h, t, d, device=dev) for _ in range(RING_N)]
    dkv = [[torch.zeros(b * hkv, t, d, device=dev) for _ in range(2)]
           for _ in range(RING_N)]
    for r, src in steps:
        (qr, _, _, dor), (_, kr, vr, _) = ranks[r], ranks[src]
        args = (qr, kr, vr, dor, fin[r][1], delta[r], pos[r], pos[src])
        want, got = dq[r].clone(), dq[r].clone()
        rf.rf_dq_plain(*args, want, h, hkv)
        rf.rf_bwd_dq(*args, got, h, hkv)
        hold("ring_flash_bwd_dq", "dQ", got, want)
        dq[r] = want
        want = [c.clone() for c in dkv[src]]
        got = [c.clone() for c in dkv[src]]
        rf.rf_dkv_plain(*args, *want, h, hkv)
        rf.rf_bwd_dkv(*args, *got, h, hkv)
        for label, g, w in zip(("dK", "dV"), got, want):
            hold("ring_flash_bwd_dkv", label, g, w)
        dkv[src] = want
    torch.cuda.synchronize()
    log(f"  {len(steps)} ring steps, every kernel within its limit; max abs "
        f"err {errs}")
    return errs


def virtual_ring(torch, fa, rf, ra, q, k, v, g, zigzag):
    """The schedule of ring_flash_attention over RING_N virtual ranks on one
    card, in lockstep, with the kernels: (out, dq, dk, dv) of the full
    sequence. Rotation is list indexing: the (dK, dV) carry of block j
    gathers the share of every rank that holds block j."""
    b, tt, h, d = q.shape
    hkv, t = k.shape[2], tt // RING_N

    def shards(x):
        x = ra.zigzag_shard(x, RING_N) if zigzag else x
        return [fa._rows(c) for c in x.chunk(RING_N, dim=1)]

    def whole(parts, dtype):
        x = torch.cat([fa._unrows(p.to(dtype), b) for p in parts], dim=1)
        return ra.zigzag_unshard(x, RING_N) if zigzag else x

    qr, kr, vr, gr = (shards(x) for x in (q, k, v, g))
    pos = [rf.ring_positions(r, t, RING_N, zigzag, q.device) for r in range(RING_N)]
    steps = ring_steps(ra, t, zigzag)
    carries = [rf.init_carries(b * h, t, d, q.device) for _ in range(RING_N)]
    for r, src in steps:
        rf.rf_fwd(qr[r], kr[src], vr[src], *carries[r], pos[r], pos[src], h, hkv)
    fin = [rf.finalize(*c, q.dtype) for c in carries]
    dq = [torch.zeros(b * h, t, d, device=q.device) for _ in range(RING_N)]
    dk = [torch.zeros(b * hkv, t, d, device=q.device) for _ in range(RING_N)]
    dv = [torch.zeros(b * hkv, t, d, device=q.device) for _ in range(RING_N)]
    for r, src in steps:
        delta = (gr[r].float() * fin[r][0].float()).sum(-1)
        args = (qr[r], kr[src], vr[src], gr[r], fin[r][1], delta, pos[r], pos[src])
        rf.rf_bwd_dq(*args, dq[r], h, hkv)
        rf.rf_bwd_dkv(*args, dk[src], dv[src], h, hkv)
    return (whole([f[0] for f in fin], q.dtype), whole(dq, q.dtype),
            whole(dk, k.dtype), whole(dv, v.dtype))


def check_whole_ring(torch, fa, rf, ra, dev, zigzag):
    """The virtual ring's output and gradients against autograd through the
    dense reference on the full sequence."""
    b, t, h, hkv, d, dtype_name = WHOLE_RING
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(4321)
    full = (b, t * RING_N)
    q, k, v, g = (torch.randn(*full, hh, d, generator=gen, device=dev).to(dtype)
                  for hh in (h, hkv, hkv, h))
    out, dq, dk, dv = virtual_ring(torch, fa, rf, ra, q, k, v, g, zigzag)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = fa.flash_attention_reference(*leaves, causal=True)
    (ref.float() * g.float()).sum().backward()
    check(torch, "ring out", out, ref)
    for n, got, leaf in zip("qkv", (dq, dk, dv), leaves):
        check(torch, f"ring d{n}", got, leaf.grad, autograd=True)


def ring_flops(name, b, h, d, live_pairs):
    return 2 * d * live_pairs * RING_KERNELS[name][1] * b * h


def ring_bound(name, b, t, h, hkv, d, live_pairs, dtype_name, itemsize):
    """(ms, 'bytes' | 'operations') of one ring step: operations over the
    live pairs actually computed; bytes of q, k, v (and dO, L, delta), the
    positions, and the float32 carries read and written back."""
    flops = ring_flops(name, b, h, d, live_pairs)
    q_bytes, kv_bytes = b * h * t * d * itemsize, b * hkv * t * d * itemsize
    row, pos = b * h * t * 4, 2 * t * 4
    moved = pos + {
        "ring_flash_fwd": q_bytes + 2 * kv_bytes + 2 * b * h * t * d * 4 + 4 * row,
        "ring_flash_bwd_dq": 2 * q_bytes + 2 * kv_bytes + 2 * row + 2 * b * h * t * d * 4,
        "ring_flash_bwd_dkv": 2 * q_bytes + 2 * kv_bytes + 2 * row + 4 * b * hkv * t * d * 4,
    }[name]
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ring_kernels(torch, rf, dev):
    """B4-B6 at the layer's shape for a diagonal and a past ring step."""
    import torch.nn.functional as F

    b, t, h, hkv, d, dtype_name = RING_SHAPES[0]
    (qr, kr, vr, dor), = ring_rows(torch, dev, RING_SHAPES[0], seed=7)[:1]
    lse = torch.rand(b * h, t, device=dev) + 5.0
    delta = torch.randn(b * h, t, device=dev)
    itemsize = qr.element_size()
    rows = {}
    for step, (my, src) in (("diagonal", (1, 1)), ("past", (1, 0))):
        qpos = rf.ring_positions(my, t, RING_N, False, dev)
        kpos = rf.ring_positions(src, t, RING_N, False, dev)
        live = int((qpos[:, None] >= kpos[None, :]).sum().item())
        acc, m, l = rf.init_carries(b * h, t, d, dev)
        dq = torch.zeros(b * h, t, d, device=dev)
        dk, dv = (torch.zeros(b * hkv, t, d, device=dev) for _ in range(2))
        fwd = (qr, kr, vr, acc, m, l, qpos, kpos, h, hkv)
        bwd = (qr, kr, vr, dor, lse, delta, qpos, kpos)
        calls = {
            "ring_flash_fwd": (lambda: rf.rf_fwd(*fwd), lambda: rf.rf_fwd_plain(*fwd)),
            "ring_flash_bwd_dq": (lambda: rf.rf_bwd_dq(*bwd, dq, h, hkv),
                                  lambda: rf.rf_dq_plain(*bwd, dq, h, hkv)),
            "ring_flash_bwd_dkv": (lambda: rf.rf_bwd_dkv(*bwd, dk, dv, h, hkv),
                                   lambda: rf.rf_dkv_plain(*bwd, dk, dv, h, hkv)),
        }
        for name, (kernel, plain) in calls.items():
            ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
            single_ms = time_ms(torch, kernel, inner=1)
            bound_ms, bound_by = ring_bound(name, b, t, h, hkv, d, live,
                                            dtype_name, itemsize)
            tflops = ring_flops(name, b, h, d, live) / ms / 1e9
            rows.setdefault(name, {})[step] = {
                "ms": ms, "single_ms": single_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by, "live_pairs": live, "tflops": tflops,
                "bound_share": bound_ms / ms}
            log(f"  {step:8s} {name:18s} {ms:9.3f} ms  plain {plain_ms:9.3f} ms"
                f"  bound {bound_ms:7.4f} ms ({bound_by}), {live} live pairs, "
                f"{tflops:6.1f} TFLOP/s, {100 * bound_ms / ms:5.2f}% of the bound")
    # Yardstick only: no PyTorch call takes an (acc, m, l) carry. SDPA
    # computes a past step's block product alone, non-causal.
    qs = qr.view(b, h, t, d)
    ks, vs = kr.view(b, hkv, t, d), vr.view(b, hkv, t, d)
    sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qs, ks, vs))
    out = F.scaled_dot_product_attention(qg, kg, vg)
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dor.view(b, h, t, d), retain_graph=True))
    log(f"  yardstick scaled_dot_product_attention on one {t}-token block, "
        f"non-causal: fwd {sdpa_fwd:.3f} ms, bwd {sdpa_bwd:.3f} ms")
    reason = "none: no PyTorch call takes an (acc, m, l) or gradient carry"
    out_rows = {}
    for name, by_step in rows.items():
        # The main path (sp=1) runs the diagonal step: its numbers lead.
        out_rows[name] = {**by_step["diagonal"], "library_ms": None,
                          "library": reason, "past_step": by_step["past"],
                          "sdpa_block_fwd_ms": sdpa_fwd,
                          "sdpa_block_bwd_ms": sdpa_bwd}
    return out_rows


def ring_step_against_flash(torch, train_mod, config, dev):
    """One step of the sp=1 ring-flash model against one step of slice 1's
    flash model: same weights (same seed), same batch."""
    from horovod_tpu_torch.parallel.mesh import dp_sp_groups

    ring = dp_sp_groups(config.sp)
    tokens, positions = train_mod.make_shard(config, ring, dev)
    model = train_mod.build_model(config, dev, ring.group)
    ring_res = one_step(torch, model, tokens, positions)
    del model
    model = train_mod.build_model(dataclasses.replace(config, sp=None), dev)
    flash_res = one_step(torch, model, train_mod.make_batch(config, 0, dev))
    del model
    torch.cuda.empty_cache()
    hold_step("ring-flash vs flash", ring_res, flash_res, 1e-3)


def report_training(torch, dev, result) -> None:
    """Log a training run; raise unless its loss is finite and falls."""
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steady = result.step_s[1:] or result.step_s
    step_s = statistics.median(steady)
    log(f"  params {result.params}, buckets {result.num_buckets}, peak memory "
        f"{peak_gb:.2f} GB")
    log(f"  loss per step {result.losses}")
    log(f"  step time per step (s) {result.step_s}; median after the first "
        f"{step_s:.4f} s, {result.tokens_per_step / step_s:.1f} tokens/s")
    if not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"non-finite loss {result.losses}")
    if not result.losses[-1] < result.losses[0]:
        raise AssertionError(f"loss did not fall: {result.losses}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import ring_attention as ra
    from horovod_tpu_torch.ops import ring_flash as rf
    from horovod_tpu_torch import train as train_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"[1] device: {card}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(SOURCES)}, one nvcc each, at once)")
    compiled = compiled_report(_build.build("flash_attention.cu"))
    errs = None
    timing_inputs = None
    for shape in CHECK_SHAPES:
        log(f"  shape (B, T, H, Hkv, D, causal, dtype) = {shape}")
        shape_errs, inputs = check_shape(torch, fa, dev, shape)
        if errs is None:
            errs, timing_inputs = shape_errs, inputs

    log(f"[3] timing at {CHECK_SHAPES[0]}")
    timing = time_kernels(torch, fa, timing_inputs, CHECK_SHAPES[0])
    del timing_inputs
    torch.cuda.empty_cache()

    config = train_mod.TrainConfig()
    log(f"[4] training {STEPS} steps: {config}")
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    rf.reset_launches()
    result = train_mod.train(config, STEPS, device="cuda")
    counts = {**fa.launches, **rf.launches}
    report_training(torch, dev, result)
    log(f"  launches on the main path {counts}")
    want = config.layers * STEPS
    if any(counts[k] != want for k in KERNELS) or any(counts[k] for k in RING_KERNELS):
        raise AssertionError(f"launch counts {counts}, expected {want} of each "
                             f"flash kernel and no ring kernel")

    log("[5] one step, flash kernels against plain dense attention")
    step_against_plain(torch, train_mod, config, dev)
    basics.shutdown()

    log(f"[6] ring kernels against their plain versions over a virtual ring "
        f"of {RING_N}")
    for shape in RING_SHAPES:
        for zigzag in (False, True):
            log(f"  shape (B, T per rank, H, Hkv, D, dtype) = {shape}, "
                f"{'zigzag' if zigzag else 'contiguous'}")
            shape_errs = check_ring_shape(torch, rf, ra, dev, shape, zigzag)
            if shape == RING_SHAPES[0]:
                for k, e in shape_errs.items():
                    errs[k] = max(errs.get(k, 0.0), e)
            torch.cuda.empty_cache()
    for zigzag in (False, True):
        log(f"  the whole virtual ring, {RING_N} x {WHOLE_RING}, "
            f"{'zigzag' if zigzag else 'contiguous'}, against the dense "
            f"reference on the full sequence")
        check_whole_ring(torch, fa, rf, ra, dev, zigzag)
        torch.cuda.empty_cache()

    log(f"[7] ring kernel timing at {RING_SHAPES[0]}")
    timing.update(time_ring_kernels(torch, rf, dev))
    torch.cuda.empty_cache()

    sp_config = train_mod.TrainConfig(sp=1)
    log(f"[8] training {STEPS} steps through the ring path: {sp_config}")
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    rf.reset_launches()
    sp_result = train_mod.train(sp_config, STEPS, device="cuda")
    sp_counts = {**fa.launches, **rf.launches}
    report_training(torch, dev, sp_result)
    log(f"  launches on the ring path {sp_counts}")
    want = sp_config.layers * STEPS
    if any(sp_counts[k] != want for k in RING_KERNELS) or \
            any(sp_counts[k] for k in KERNELS):
        raise AssertionError(f"launch counts {sp_counts}, expected {want} of "
                             f"each ring kernel and no flash kernel")
    for k in RING_KERNELS:
        counts[k] = sp_counts[k]

    log("[9] one ring-flash step against one slice-1 flash step")
    ring_step_against_flash(torch, train_mod, sp_config, dev)
    basics.shutdown()

    kernels = []
    for source, names in SOURCES.items():
        for kname in names:
            replaces = {**KERNELS, **RING_KERNELS}[kname][0]
            row = {"name": kname, "route": "cuda",
                   "source": f"horovod_tpu_torch/csrc/{source}",
                   "replaces": replaces, "launches": counts[kname],
                   "max_abs_err": errs[kname], **timing[kname]}
            tc = {k: v for k, v in compiled.items()
                  if TC_KERNELS[k.split("<")[0]] == kname}
            if tc:   # bf16 runs on flash_tc.cuh's tensor-core kernel
                row["bf16_kernel"] = {"header": "horovod_tpu_torch/csrc/flash_tc.cuh",
                                      "compiled": tc}
            kernels.append(row)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
