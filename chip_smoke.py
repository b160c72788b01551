#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and
prints no result):

1. device: the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``horovod_tpu_torch/csrc`` and hold each
   kernel against its plain PyTorch version on the card: the slice's shape
   (1, 4096, 8, 128) bf16 causal, the slice's head dim in float32 at
   T 1024, a GQA shape (8 q heads over 2 kv heads, D 64, T 1024) in
   float32, and a ragged non-causal T = 96 in float32; each kernel alone,
   and the autograd Function against the dense reference;
3. time each kernel at the slice's shape (CUDA events, median of 30 after
   warm-up) beside its plain version, its bound, and PyTorch's own
   ``scaled_dot_product_attention`` forward and backward as a yardstick;
4. train the full-width flash TransformerLM (vocab 32000, dim 1024, 8
   heads of 128, 12 layers, seq 4096, batch 1, Adam 1e-3 through
   DistributedOptimizer) for 5 steps on a world of one over NCCL, with the
   launch counts zeroed just before and read just after;
5. one step of the flash model against the same step with plain dense
   attention, same weights and batch;
6. the ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

STEPS = 5
SLICE_SHAPE = (1, 4096, 8, 8, 128)       # (B, T, H, Hkv, D)
CHECK_SHAPES = [
    # (B, T, H, Hkv, D, causal, dtype name)
    (*SLICE_SHAPE, True, "bfloat16"),
    (1, 1024, 8, 8, 128, True, "float32"),
    (1, 1024, 8, 2, 64, True, "float32"),
    (2, 96, 4, 2, 32, False, "float32"),
]
# Tolerances, by the dtype of the output compared (in float32):
# - float32 outputs, kernel vs plain or autograd vs dense: the same sums in
#   another order, |err| <= 1e-4 * max(1, max|ref|);
# - bf16 outputs, kernel vs its plain version fed the same inputs: both
#   round to bf16 and may differ by one unit in the last place, at most
#   2^-7 of the value, so |err| <= 2^-7 |ref| + 1e-2 * rms of the ref's
#   row (its last dim, for values near 0), and the relative norm error
#   ||got - ref|| / ||ref|| <= 1e-2 (the rounding alone gives < 1e-4);
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
SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(name, b, t, h, hkv, d, causal, dtype_name, itemsize):
    """(ms, 'bytes' | 'operations'): the least time the card could take.
    Operations: 2 flops per multiply-add over the live (q, k) pairs of each
    product; bytes: each input read once, each output written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2 * d * pairs * KERNELS[name][1] * b * h
    q_bytes, kv_bytes, row_bytes = (b * h * t * d * itemsize,
                                    b * hkv * t * d * itemsize, b * h * t * 4)
    moved = {
        "flash_fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,
        "flash_bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
        "flash_bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
    }[name]
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(torch, label, got, want, autograd=False) -> float:
    """Hold ``got`` to ``want`` (both in their own dtype) by the tolerances
    above; log and return the max abs error, raise past a limit."""
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
    sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qs, ks, vs))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    go = dor.view(b, h, t, d)
    # Its backward alone: one call that computes dQ, dK and dV together.
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), go, retain_graph=True))
    sdpa_both = time_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal),
        (qg, kg, vg), go))
    library = {
        "flash_fwd": (sdpa_fwd, "scaled_dot_product_attention forward"),
        "flash_bwd_dq": (None, "none alone: the backward that computes dQ "
                               "also computes dK and dV; see flash_bwd_dkv"),
        "flash_bwd_dkv": (sdpa_bwd, "scaled_dot_product_attention backward, "
                                    "dQ, dK and dV together"),
    }
    rows = {}
    for name, (kernel, plain) in calls.items():
        ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
        bound_ms, bound_by = bound(name, b, t, h, hkv, d, causal, dtype_name, itemsize)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library[name][0],
                      "library": library[name][1]}
        log(f"  {name:14s} {ms:9.3f} ms  plain {plain_ms:9.3f} ms  bound "
            f"{bound_ms:7.4f} ms ({bound_by})")
    kernel_bwd = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    log(f"  yardstick scaled_dot_product_attention: fwd {sdpa_fwd:.3f} ms, "
        f"bwd {sdpa_bwd:.3f} ms (dQ, dK, dV), fwd+bwd {sdpa_both:.3f} ms; "
        f"the kernels: fwd {rows['flash_fwd']['ms']:.3f} ms, bwd "
        f"{kernel_bwd:.3f} ms, fwd+bwd {rows['flash_fwd']['ms'] + kernel_bwd:.3f} ms")
    return rows


def step_against_plain(torch, train_mod, config, dev):
    """One step's loss and gradients, flash kernels vs dense plain attention."""
    from horovod_tpu_torch.models.transformer import lm_loss

    tokens = train_mod.make_batch(config, 0, dev)
    results = {}
    for attention in ("flash", "dense"):
        model = train_mod.build_model(
            dataclasses.replace(config, attention=attention), dev)
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        results[attention] = (loss.item(), {n: p.grad.float() for n, p in
                                            model.named_parameters()})
        del model, loss
        torch.cuda.empty_cache()
    (lf, gf), (ld, gd) = results["flash"], results["dense"]
    rel = abs(lf - ld) / abs(ld)
    log(f"  loss flash {lf:.6f} dense {ld:.6f} rel {rel:.3e} (limit 1e-2)")
    if not (math.isfinite(lf) and rel <= 1e-2):
        raise AssertionError(f"flash loss {lf} vs dense {ld}")
    worst = ("", 0.0)
    for name, g in gd.items():
        norm = g.norm().item()
        err = (gf[name] - g).norm().item() / max(norm, 1e-30)
        if not math.isfinite(err) or err > 3e-2:
            raise AssertionError(f"grad {name}: relative norm error {err}")
        worst = max(worst, (name, err), key=lambda x: x[1])
    log(f"  every gradient within 3e-2 relative norm error; worst "
        f"{worst[0]} {worst[1]:.3e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch import train as train_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"[1] device: {card}")

    t0 = time.perf_counter()
    _build.build("flash_attention.cu")
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
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
    result = train_mod.train(config, STEPS, device="cuda")
    counts = dict(fa.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steady = result.step_s[1:] or result.step_s
    step_s = statistics.median(steady)
    log(f"  params {result.params}, buckets {result.num_buckets}, peak memory "
        f"{peak_gb:.2f} GB")
    log(f"  loss per step {result.losses}")
    log(f"  step time per step (s) {result.step_s}; median after the first "
        f"{step_s:.4f} s, {result.tokens_per_step / step_s:.1f} tokens/s")
    log(f"  launches on the main path {counts}")
    if not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"non-finite loss {result.losses}")
    if not result.losses[-1] < result.losses[0]:
        raise AssertionError(f"loss did not fall: {result.losses}")
    want = config.layers * STEPS
    if any(counts[k] != want for k in KERNELS):
        raise AssertionError(f"launch counts {counts}, expected {want} each")

    log("[5] one step, flash kernels against plain dense attention")
    step_against_plain(torch, train_mod, config, dev)
    basics.shutdown()

    kernels = []
    for kname, (replaces, _) in KERNELS.items():
        kernels.append({"name": kname, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": counts[kname],
                        "max_abs_err": errs[kname], **timing[kname]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
