#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and
prints no result):

1. device: the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``horovod_tpu_torch/csrc``; log each
   tensor-core kernel's registers and spill bytes (ptxas) and its count of
   HGMMA (wgmma) and UTMALDG (TMA load) instructions (``cuobjdump``), from
   both libraries (the kFlash variants, B1-B3, in ``flash_attention.cu``'s;
   the kRing variants, B4-B6, in ``ring_flash.cu``'s: every bf16 kernel
   runs on the tensor cores), raising if either count is zero or a kernel
   spills; hold each kernel
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
   D 64, T 1024) and a ragged T = 96 (D 32), each in float32 (the FMA
   kernels) and in bf16 (the tensor-core kernels), each contiguous and
   zigzag; then, in bf16 at D 32, 64 and 128, a zigzag step from the
   initial carries in which some q rows see no key of the block: B4 must
   leave those rows' carries bit for bit (m -1e30, l 0, acc 0) and B5
   their dQ carry; then the whole virtual ring (4 x 1024, bf16) against
   the dense reference on the full sequence, forward and gradients;
7. time each ring kernel at the layer's shape for a diagonal ring step
   (causal half of the pairs live) and a past step (all pairs live);
8. train the same model through the sequence-parallel path,
   ``TrainConfig(sp=1)`` (a ring of one: every layer runs the ring-flash
   kernels once per pass), 5 steps, counts zeroed just before;
9. one ring-flash step against one slice-1 flash step, same weights and
   batch;
10. ResNet-50 data parallelism (``train_cnn``): one float32 step on the
    card (TF32 off, batch 4 at 224) against the same step on the CPU,
    same weights (BatchNorm scales, biases and statistics drawn from a
    seed) and images; one bf16 channels-last step against the float32 step
    on the card; which BatchNorm kernel bf16 channels-last input takes;
    then ``train_cnn(CNNConfig(), 5)`` at full width (batch 128, bf16,
    channels-last, SGD with momentum through DistributedOptimizer): img/s,
    step times, buckets per step (2), peak memory, the losses (finite and
    falling) and the share of the bf16 dense peak that the FLOPs of the
    model's own conv and Dense shapes reach;
11. long context at full width, seq 32768, batch 1: one step of
    ``TrainConfig(seq=32768, remat=True, loss_chunk=4096)`` against one
    step of ``TrainConfig(seq=32768)``, same weights and tokens (loss 1e-5
    relative, every gradient 1e-4 relative norm); then 3 steps of each,
    with the median step time and the peak memory, which remat + chunked
    loss must lower, and the launches (B1 twice per layer and step under
    remat, B2 and B3 once);
12. the bf16 LM head: one step of ``TrainConfig(logits_dtype="bfloat16")``
    against the float32 head's, same weights and batch (phase 5's limits),
    then 5 steps with tokens/s;
13. the graphed loop, ``TrainConfig(steps_per_dispatch=4)`` and
    ``TrainConfig(sp=1, steps_per_dispatch=4)``: warm-up, then the capture
    of one step in a CUDA graph (launches counted at capture: one step's,
    since a replay runs no Python), 2 dispatches of 4 steps against 8
    eager steps of the same step on the same cache draws (every loss and
    parameter within 1e-6 relative; the largest difference printed), the
    capture time, the peak memory and the tokens/s eager and graphed by
    the benchmark's median-window method;
14. hierarchical data parallelism, ResNet-50 at full width through
    ``DistributedOptimizer(hierarchical=True)`` on the ``('dcn', 'ici')``
    groups of a world of one (both groups of one rank; every collective
    of the ladder is still issued): flat against hierarchical at the
    graft demo's 1 MiB bucket cap, and flat with the bf16 wire against
    hierarchical with ``HOROVOD_DCN_COMPRESSION=bf16``, each pair bit for
    bit in the loss of every step and in every parameter after the last;
    img/s of flat and hierarchical at 1 MiB and of hierarchical at 64 MiB
    beside phase 10's flat 64 MiB; buckets and the ladder's collectives
    per step (one reduce-scatter, allreduce and all-gather per bucket);
15. Ulysses on the flash kernels: a virtual world of 4 on the card, in
    lockstep, the all-to-all as list re-indexing, the head shard's
    attention through ``ring_attention.head_shard_attention`` (B1-B3),
    at the slice's layer (1, 4096, 8, 128) bf16 and a GQA layer (8 q
    heads over 4, D 128), output and gradients against one
    whole-sequence ``flash_attention``, 4 launches of each kernel per
    virtual pass; B1-B3 checked and timed at the head shard (1, 4096, 2,
    128) as phases 2 and 3 do; ``ulysses_attention(group=None,
    impl="flash")`` against ``flash_attention``, bit for bit;
16. sharded data parallelism at full width, on a world of one over NCCL
    with every group of one rank: 3 steps of ``TrainConfig(sharded=True)``
    with ``HOROVOD_MESH=1x1`` (ZeRO through
    ``DistributedOptimizer(sharded=True)``) and 3 steps of FSDP
    (``train.setup_fsdp`` on ``training_groups(1, 1)``:
    ``fsdp_gather_params`` and ``functional_call``), each against 3 steps
    of ``TrainConfig()`` from the same weights on the same tokens, bit for
    bit in every step's loss and every parameter after the last step; the
    median step ms and peak memory of flat, ZeRO and FSDP, the collectives
    of a step (at shard 1 ZeRO issues the DP call, one all-reduce per
    bucket, and no gather, as the JAX package does; FSDP one all-gather
    and one reduce-scatter per leaf), B1-B3's launches (12 of each per
    step on both paths), the parameter count, and the plan's
    ``state_bytes_per_rank()`` at shard 1, 2, 4 and 8 (planned, not
    measured);
17. tensor parallelism at full width: 3 steps with a model group of one
    (``sharded_groups(1, 1, 1)``, a world of one over NCCL;
    ``TransformerLM(tp_group=...)``, ``DistributedOptimizer(group=<batch
    group>)``) against 3 flat steps, bit for bit in every loss and
    parameter, with no collective on the model group and 12 launches of
    each of B1-B3 per step; step ms and peak memory of both; then a
    virtual model group of 4 on the card: one full-width block cut by
    ``tp_state_dict`` into 4 rank blocks, each rank's ``attn_partial`` and
    ``mlp_partial`` (B1-B3 at the head shard (1, 4096, 2, 128)) summed in
    float32 in place of the reduce, against the whole block (output 1e-2,
    every gradient, reassembled, 3e-2 relative norm); the allreduce bytes
    a step at tp = 4 would move (planned);
18. the full-width MoE TransformerLM (8 experts in every 2nd block,
    capacity factor 1.25): 5 steps with loss = task + 0.01 x the
    load-balancing losses (finite and falling), tokens dropped per MoE
    layer, step ms, tokens/s, peak memory, 12 launches of B1-B3 per step;
    one step against the same step with dense attention, in float32 held
    whole to phase 5's limits, in bf16 with the routing flips counted and
    every parameter but the experts' held (the experts' gradients move
    with the tokens each expert keeps, and are printed);
    ``MoEMLP(ep_group=<group of one>)`` against ``MoEMLP()``, bit for
    bit; ``moe_apply`` with a capacity that drops nothing against the
    dense per-token oracle (bf16 relative norm 1e-2);
19. pipeline parallelism at full width (``train.setup_pipeline``,
    ``models/pipeline_lm.py``): 3 steps with a pp group of one
    (``training_groups(1, 1, 1)``, a world of one over NCCL) at
    ``n_micro = 1`` against 3 flat steps, bit for bit in every loss and
    parameter, with no P2P call and 12 launches of each of B1-B3 per step;
    at ``n_micro = 4`` on a batch of 4 against the flat step on the same
    batch (step 0's loss and gradients, phase 5's limits), 48 launches
    each per step (the ``(n_micro + pp - 1) x L / pp`` of the schedule);
    step ms and peak memory of each; then a virtual pp of 4 on the card:
    4 ``PipelineStage``s of 3 blocks cut by ``stage_state_dict``, run in
    lockstep on the tick schedule with a local hand-off, loss and
    gradients against the flat step (phase 5's limits), and bubble
    isolation (microbatch 1 changed, the others' logits bit for bit); the
    bytes a real pp = 4 step would hand on per rank (planned);
20. the gradient exchange from the gradient hooks at full width
    (``HOROVOD_LATENCY_HIDING=1``, ``HOROVOD_NUM_BUCKETS=4``, a world of one
    over NCCL): (a) 3 steps of ``TrainConfig()`` with the hooks on against
    3 with them off, bit for bit in every loss and parameter, the buckets'
    launch order (plan order) and those started before ``backward()``
    returned, B1-B3's launches, step ms and peak memory of both; (b)
    ``TrainConfig(steps_per_dispatch=4)`` with the hooks on against eager
    steps with the hooks on, as phase 13; (c) ``metrics.overlap``'s
    ``record_plan`` and a ``measure_overlap`` report of 2 hooked steps
    (``ok: false`` where NCCL launches no kernel in a world of one);
21. the ``{"kernels": [...]}`` line (all six kernels, each with its
    launches on every path above; phases 10 and 14 run none of them),
    then ``{"ok": true, ...}`` last.

Both CUDA sources build at once, one nvcc each, at the start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
    # bf16 B1-B3 run on the tensor cores (csrc/flash_tc.cuh): GQA, and a
    # ragged T against their 64- and 128-row TMA tiles, non-causal.
    (1, 1024, 8, 2, 64, True, "bfloat16"),
    (2, 96, 4, 2, 32, False, "bfloat16"),
]
# Tolerances, by the dtype of the output compared (in float32):
# - float32 outputs, kernel vs plain or autograd vs dense: the same sums in
#   another order, |err| <= 1e-4 * max(1, max|ref|);
# - bf16 outputs, kernel vs its plain version fed the same inputs (the
#   plain version is the float32 contract; the tensor-core kernels split
#   P, dS, P^T and dS^T into bf16 hi and lo terms and err by ~2^-16 of
#   each term): both round to bf16 and may differ by one unit in the last
#   place, at most 2^-7 of the value, so |err| <= 2^-7 |ref| + 1e-2 * rms
#   of the ref's row (its last dim, for values near 0), and the relative
#   norm error ||got - ref|| / ||ref|| <= 1e-2 (the rounding alone gives
#   < 1e-4);
# - an output row that is 0 in exact arithmetic (causal dQ's first row:
#   one key, so dS = dP - delta = 0) is float32 noise on both sides, which
#   no relative rule can compare: |x| <= NOISE there, the rules above
#   everywhere else;
# - bf16 outputs, the autograd Function vs the dense reference: relative
#   norm error <= 1e-2. Not element-wise: the Function, as in the JAX
#   package, takes delta = rowsum(dO * O) from O rounded to bf16, while the
#   dense reference differentiates the float32 softmax (~1.3e-3 for dQ/dK).
F32_TOL = 1e-4
NOISE = 1e-4
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
    # bf16 B4-B6 run on the tensor cores: GQA, and a ragged T whose
    # 128-row q block (B4, B5) and 64-row q tile (B6) straddle the zigzag
    # stripes (48 rows each).
    (1, 1024, 8, 2, 64, "bfloat16"),
    (2, 96, 4, 2, 32, "bfloat16"),
]
WHOLE_RING = (1, 1024, 8, 8, 128, "bfloat16")
# Rank 0 of a zigzag ring of 4 against rank 1's block, T 96 per rank in
# stripes of 48: rank 0's low stripe (positions 0-47) sees none of rank 1's
# keys (48-95 and 288-335). (B, T per rank, H, Hkv, my rank, source rank)
NO_LIVE_KEY = (2, 96, 4, 2, 0, 1)


def log(msg: str) -> None:
    print(msg, flush=True)


# The tensor-core kernels of csrc/flash_tc.cuh: (template, variant, the
# kernel of the kernels line it runs for, the source whose library holds
# it). Each template takes the variant of csrc/flash_kernels.cuh: 0 kFlash
# (B1-B3), 3 kRing (B4-B6).
TC_KERNELS = [
    ("fwd_tc_kernel", 0, "flash_fwd", "flash_attention.cu"),
    ("dq_tc_kernel", 0, "flash_bwd_dq", "flash_attention.cu"),
    ("dkv_tc_kernel", 0, "flash_bwd_dkv", "flash_attention.cu"),
    ("fwd_tc_kernel", 3, "ring_flash_fwd", "ring_flash.cu"),
    ("dq_tc_kernel", 3, "ring_flash_bwd_dq", "ring_flash.cu"),
    ("dkv_tc_kernel", 3, "ring_flash_bwd_dkv", "ring_flash.cu"),
]
# A mangled instance: the head dim, then the variant.
TC_NAME = re.compile(r"(" + "|".join(sorted({k[0] for k in TC_KERNELS}))
                     + r")ILi(\d+)ELi(\d+)EE")


def tc_label(template, d, variant) -> str:
    """An instance's name, from TC_KERNELS or from TC_NAME's groups."""
    return f"{template}<{d}, {variant}>"


def compiled_report(lib_path: str) -> dict:
    """Per tensor-core kernel instance in one library: registers and spill
    bytes from the ptxas report beside it, and the count of HGMMA (wgmma),
    UTMALDG (TMA load) and USETMAXREG instructions in its SASS."""
    from horovod_tpu_torch.ops import _build

    report, cur = {}, None
    with open(lib_path + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = TC_NAME.search(m.group(1))
                cur = tc_label(*k.groups()) if k else None
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
        k = TC_NAME.search(chunk.split("\n", 1)[0])
        if k:
            entry = report.setdefault(tc_label(*k.groups()), {})
            for op in ("HGMMA", "UTMALDG", "USETMAXREG"):
                entry[op] = len(re.findall(r"\b" + op + r"\b", chunk))
    return report


def check_compiled(build) -> dict:
    """The compiled report of every tensor-core kernel at every head dim,
    each read from its own library's; {kernel of the kernels line:
    {instance: entry}}. Raises if an instance is missing, spills, or has
    no HGMMA or no UTMALDG."""
    reports = {src: compiled_report(build(src)) for src in {k[3] for k in TC_KERNELS}}
    by_kernel = {}
    for template, variant, kname, src in TC_KERNELS:
        for d in (32, 64, 128):
            label = tc_label(template, d, variant)
            e = reports[src].get(label, {})
            log(f"  {label:24s} {src:18s} registers {e.get('registers')} spill "
                f"bytes {e.get('spill_bytes')} HGMMA {e.get('HGMMA')} UTMALDG "
                f"{e.get('UTMALDG')} USETMAXREG {e.get('USETMAXREG')}")
            if not e.get("HGMMA") or not e.get("UTMALDG"):
                raise AssertionError(f"{label}: no wgmma or no TMA load in its SASS: {e}")
            if e.get("spill_bytes") != 0:
                raise AssertionError(f"{label}: spills {e.get('spill_bytes')} bytes")
            by_kernel.setdefault(kname, {})[label] = e
    return by_kernel


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


def check(torch, label, got, want, autograd=False, quiet=False,
          noise_rows=()) -> float:
    """Hold ``got`` to ``want`` (both in their own dtype) by the tolerances
    above; log (unless ``quiet``) and return the max abs error, raise past a
    limit. ``noise_rows``: rows (dim 1 of the rows layout) that are 0 in
    exact arithmetic."""
    bf16 = want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    if noise_rows:
        noise = max(g[:, noise_rows].abs().max().item(),
                    w[:, noise_rows].abs().max().item())
        if not noise <= NOISE:
            raise AssertionError(f"{label}: rows {list(noise_rows)}, 0 in exact "
                                 f"arithmetic, read {noise:.3e} > {NOISE:g}")
        keep = torch.ones(g.shape[1], dtype=torch.bool, device=g.device)
        keep[list(noise_rows)] = False
        g, w = g[:, keep], w[:, keep]
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
            noise_rows = [0] if causal and label == "dQ" else ()
            errs[name] = max(errs[name], check(torch, f"{name} {label}", got, want,
                                               noise_rows=noise_rows))
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


def one_step(torch, model, tokens, positions=None, loss_chunk=0):
    """Loss and gradients of one forward/backward, no optimizer step; with
    ``loss_chunk``, the loss of ``chunked_lm_loss`` on the hidden states."""
    from horovod_tpu_torch.models.transformer import (chunked_lm_loss, lm_loss,
                                                      next_tokens)

    if loss_chunk:
        hidden = model(tokens, positions, return_hidden=True)
        loss = chunked_lm_loss(hidden, model.lm_head.weight, next_tokens(tokens),
                               loss_chunk)
    else:
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
    errs = sorted(((ga[name] - g).norm().item() / max(g.norm().item(), 1e-30), name)
                  for name, g in gb.items())
    log(f"  gradient relative norm errors: median {errs[len(errs) // 2][0]:.3e}, "
        f"largest " + ", ".join(f"{n} {e:.3e}" for e, n in errs[:-4:-1]))
    bad = [(n, e) for e, n in errs if not (math.isfinite(e) and e <= grad_limit)]
    if bad:
        raise AssertionError(f"gradients past {grad_limit:g} relative norm "
                             f"error: {bad}")
    log(f"  every gradient within {grad_limit:g} relative norm error")


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


def check_no_live_key(torch, rf, dev, d):
    """B4 from the initial carries, then B5, at a step in which some q rows
    see no key of the block (NO_LIVE_KEY), bf16 at head dim ``d``: those
    rows' carries must come back bit for bit (m -1e30, l 0, acc 0; the dQ
    carry as it was), the rest within the rules against the plain
    versions."""
    b, t, h, hkv, my, src = NO_LIVE_KEY
    (qr, _, _, dor), (_, kr, vr, _) = ring_rows(
        torch, dev, (b, t, h, hkv, d, "bfloat16"), seed=d)[:2]
    qpos = rf.ring_positions(my, t, RING_N, True, dev)
    kpos = rf.ring_positions(src, t, RING_N, True, dev)
    dead = ~(qpos[:, None] >= kpos[None, :]).any(dim=1)
    if not 0 < int(dead.sum()) < t:
        raise AssertionError(f"expected some rows with no live key, got {int(dead.sum())}")
    want = list(rf.init_carries(b * h, t, d, dev))
    got = [c.clone() for c in want]
    rf.rf_fwd_plain(qr, kr, vr, *want, qpos, kpos, h, hkv)
    rf.rf_fwd(qr, kr, vr, *got, qpos, kpos, h, hkv)
    torch.cuda.synchronize()
    for label, g, w, init in zip(("acc", "m", "l"), got, want, (0.0, rf.NEG_INF, 0.0)):
        if not bool((g[:, dead] == init).all()):
            raise AssertionError(f"ring_flash_fwd {label}: rows with no live key moved")
        # The other rows alone: m's -1e30 would set the limit to 1e26.
        check(torch, f"ring_flash_fwd {label}", g[:, ~dead], w[:, ~dead], quiet=True)
    out, lse = rf.finalize(*want, torch.bfloat16)
    delta = (dor.float() * out.float()).sum(-1)
    before = torch.randn(b * h, t, d, device=dev)
    dq_want, dq_got = before.clone(), before.clone()
    args = (qr, kr, vr, dor, lse, delta, qpos, kpos)
    rf.rf_dq_plain(*args, dq_want, h, hkv)
    rf.rf_bwd_dq(*args, dq_got, h, hkv)
    torch.cuda.synchronize()
    if not torch.equal(dq_got[:, dead], before[:, dead]):
        raise AssertionError("ring_flash_bwd_dq: rows with no live key moved")
    check(torch, "ring_flash_bwd_dq dQ", dq_got, dq_want, quiet=True)
    log(f"  D {d}: {int(dead.sum())} of {t} rows with no live key kept bit for bit "
        f"by B4 and B5; the rest within the rules")


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


# Phase 10. The card's float32 step against the CPU's is held to the CPU
# tests' limits (tests/test_torch_port_cnn.py): logits and loss
# |err| <= 1e-4 * max(1, max|ref|), each BatchNorm statistic
# |err| <= 1e-5 * max|ref|; the gradients by relative norm <= 1e-4, but in
# float64 on both sides: in float32 an activation within rounding of 0
# passes a ReLU on one side and not on the other, and the gradient below
# moves by that pixel's share (at batch 4, ~2e-2 relative norm between
# the CPU's own float32 and float64 steps on an x86 CPU), so the float32
# gradients are printed, not held.
CNN_CHECK_BATCH = 4
CNN_F32_TOL, CNN_STATS_TOL, CNN_GRAD_TOL = 1e-4, 1e-5, 1e-4
# The bf16 step against the float32 step, from the same weights (the
# trainer's init: the last BatchNorm scale of each residual branch at 0)
# and images, batch 32, by relative norm. bf16 keeps 8 significant bits
# (2^-9 relative per rounding) and the step rounds every activation of 53
# convolutions and their gradients: on the CPU at batch 16 the port's bf16
# step read logits 4.6e-3, loss 2.3e-5, statistics 9.2e-5 and all
# gradients 5.3e-2 from its float32 step on an x86 CPU. The limits are
# about three times those; a cast in the wrong place (statistics or the
# head in bf16) moves them by far more.
CNN_BF16_BATCH = 32
CNN_BF16_LIMITS = {"logits": 2e-2, "loss": 1e-2, "statistics": 1e-2,
                   "gradients": 0.15}


def randomize_batch_norms(torch, model, seed: int) -> None:
    """BatchNorm scales from [0.5, 1.5], biases and running means from
    N(0, 0.1^2), running variances from [0.5, 1.5]: with the trainer's
    zero scales the residual branches' gradients are exactly 0 on both
    sides of a comparison."""
    from horovod_tpu_torch.models.cnn_layers import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.shape
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)


def cnn_step(torch, model, images, labels) -> dict:
    """One training-mode forward and backward, no optimizer step: logits,
    loss, gradients and BatchNorm statistics after it, float64 on the CPU."""
    import torch.nn.functional as F

    logits = model(images)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    return {"logits": logits.detach().double().cpu(), "loss": loss.item(),
            "grads": {n: p.grad.double().cpu() for n, p in model.named_parameters()},
            "stats": {n: t.double().cpu() for n, t in model.state_dict().items()
                      if n.endswith(("running_mean", "running_var"))}}


def relnorm(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def hold_cnn_step(label, got, want, hold_grads) -> None:
    """Hold ``got`` to ``want`` (cnn_step results) at the CPU tests'
    limits; the gradients too where ``hold_grads``."""
    limit = CNN_F32_TOL * max(1.0, want["logits"].abs().max().item())
    err = (got["logits"] - want["logits"]).abs().max().item()
    loss_err = abs(got["loss"] - want["loss"])
    stats = max(((got["stats"][n] - w).abs().max() / w.abs().max()).item()
                for n, w in want["stats"].items())
    grads = {n: relnorm(got["grads"][n], w) for n, w in want["grads"].items()}
    worst = max(grads, key=grads.get)
    log(f"  {label}: logits max_abs_err {err:.3e} (limit {limit:.3e}), loss "
        f"{got['loss']:.6f} vs {want['loss']:.6f}, statistics worst "
        f"{stats:.3e} of max|ref| (limit {CNN_STATS_TOL:g}), gradients worst "
        f"relative norm {grads[worst]:.3e} ({worst})"
        + (f" (limit {CNN_GRAD_TOL:g})" if hold_grads else
           " (not held: ReLU flips)"))
    loss_limit = CNN_F32_TOL * max(1.0, abs(want["loss"]))
    if not (err <= limit and loss_err <= loss_limit and stats <= CNN_STATS_TOL):
        raise AssertionError(f"{label}: logits {err}, loss {loss_err}, "
                             f"statistics {stats}")
    if hold_grads and not grads[worst] <= CNN_GRAD_TOL:
        raise AssertionError(f"{label}: gradient {worst} {grads[worst]}")


def cnn_card_against_cpu(torch, tc, dev) -> None:
    """One step of ResNet-50 at 224, batch 4, on the card and on the CPU
    from the same weights and images, in float32 and in float64."""
    config = tc.CNNConfig(batch=CNN_CHECK_BATCH, dtype="float32")
    base = tc.build_cnn(config, "cpu")
    randomize_batch_norms(torch, base, seed=1)
    images, labels = tc.make_images(config, 0, "cpu")
    for dtype in ("float32", "float64"):
        res = {}
        for where in ("cpu", dev):
            model = tc.build_cnn(dataclasses.replace(config, dtype=dtype), where)
            model.load_state_dict(base.state_dict())
            if dtype == "float64":
                model = model.double()
            res[where] = cnn_step(torch, model, images.to(where), labels.to(where))
            del model
        hold_cnn_step(f"card vs CPU, {dtype}", res[dev], res["cpu"],
                      hold_grads=dtype == "float64")
    torch.cuda.empty_cache()


def cnn_bf16_against_f32(torch, tc, dev) -> None:
    config = tc.CNNConfig(batch=CNN_BF16_BATCH)
    images, labels = tc.make_images(config, 0, dev)
    res = {}
    for dtype in ("bfloat16", "float32"):
        model = tc.build_cnn(dataclasses.replace(config, dtype=dtype), dev)
        res[dtype] = cnn_step(torch, model, images, labels)
        del model
    torch.cuda.empty_cache()
    got, want = res["bfloat16"], res["float32"]
    names = list(want["grads"])
    errs = {
        "logits": relnorm(got["logits"], want["logits"]),
        "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        "statistics": relnorm(torch.cat([got["stats"][n] for n in want["stats"]]),
                              torch.cat(list(want["stats"].values()))),
        "gradients": relnorm(torch.cat([got["grads"][n].reshape(-1) for n in names]),
                             torch.cat([want["grads"][n].reshape(-1) for n in names])),
    }
    log("  bf16 channels-last vs float32, batch "
        f"{CNN_BF16_BATCH}, relative norm: " + ", ".join(
            f"{k} {v:.3e} (limit {CNN_BF16_LIMITS[k]:g})" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= CNN_BF16_LIMITS[k]}
    if bad:
        raise AssertionError(f"bf16 vs float32: {bad}")


def batch_norm_kernel(torch, dev) -> str:
    """Which implementation PyTorch picks for bf16 channels-last input with
    float32 weight at the stem's shape (128, 64, 112, 112), in training
    mode: the index ``torch._batch_norm_impl_index`` returns."""
    x = torch.randn(128, 64, 112, 112, device=dev, dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.ones(64, device=dev)
    out = torch._batch_norm_impl_index(x, w, torch.zeros_like(w), None, None,
                                       True, 0.0, 1e-5, True)
    torch.cuda.synchronize(dev)
    name = {0: "native (PyTorch's CUDA kernels)", 1: "cuDNN", 2: "MIOpen"}[out[4]]
    fmt = out[0].is_contiguous(memory_format=torch.channels_last)
    return f"{name}, output channels-last: {fmt}"


def report_cnn_training(torch, tc, dev, config, result) -> None:
    """Log the ResNet-50 run; raise unless its loss is finite and falls and
    it ran 2 buckets per step."""
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steady = result.step_s[1:]
    step_s = statistics.median(steady)
    img_s = result.images_per_step / step_s
    model = tc.build_cnn(config, dev).eval()
    one, _ = tc.make_images(dataclasses.replace(config, batch=1), 0, dev)
    macs = tc.forward_macs(model, one)
    del model
    flops_per_image = 3 * 2 * macs      # forward, and twice it backward
    share = flops_per_image * img_s / PEAK_FLOPS["bfloat16"]
    log(f"  params {result.params}, buckets per step {result.num_buckets}, "
        f"peak memory {peak_gb:.2f} GB")
    log(f"  loss per step {result.losses}")
    log(f"  step time per step (s) {result.step_s}; median of steps 1-4 "
        f"{step_s:.4f} s, {img_s:.1f} img/s")
    log(f"  {macs} conv and Dense multiply-adds per image forward, "
        f"{flops_per_image:.4e} FLOPs per image per step (3 x 2 x MACs): "
        f"{flops_per_image * img_s / 1e12:.1f} TFLOP/s, "
        f"{100 * share:.1f}% of the bf16 dense peak (989 TFLOP/s)")
    if result.num_buckets != 2:
        raise AssertionError(f"{result.num_buckets} buckets, expected 2")
    if not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"non-finite loss {result.losses}")
    if not result.losses[-1] < result.losses[0]:
        raise AssertionError(f"loss did not fall: {result.losses}")


# Phase 11. At seq 32768, from the same weights and tokens, three one-step
# runs: remat + chunked loss, the chunked loss alone, and the plain step.
# - Remat alone must be exact: the recompute repeats the forward with the
#   same kernels, so remat + chunked loss is held to the chunked loss
#   without remat at 1e-5 (loss, relative) and 1e-4 (every gradient,
#   relative norm error).
# - The chunked loss against the full loss: the same float32 sums per row,
#   so the loss is held to 1e-5. The head's backward sums d(hidden) in
#   float32 in another order (products of 4096 rows against one of 32768);
#   the cast of d(hidden) to bf16 then rounds some elements the other way,
#   and 12 layers of bf16 backward carry that into every gradient (the
#   first run on the card read 6.2e-3 relative norm on embed.weight). So
#   these gradients are held to phase 5's limit for two bf16 paths that
#   round in different places, 3e-2; the float32 CPU tests hold the
#   chunked loss to the full one at 1e-5.
# Then LONG_STEPS steps of remat + chunked loss and of the plain step: step
# time and peak memory, which remat + chunked loss must lower.
LONG_SEQ, LONG_CHUNK, LONG_STEPS = 32768, 4096, 3
# Phase 13. Two dispatches of GRAPH_K steps from one CUDA graph against
# 2 * GRAPH_K eager steps of the same step on the same cache draws, from the
# same weights, with the same capturable Adam: the same kernels in the same
# order, so bit-equality is expected; every loss and parameter is held to
# 1e-6 relative.
GRAPH_K, GRAPH_DISPATCHES, GRAPH_LIMIT = 4, 2, 1e-6


def read_counts(fa, rf) -> dict:
    counts = {**fa.launches, **rf.launches}
    fa.reset_launches()
    rf.reset_launches()
    return counts


def hold_counts(label, counts, want: dict) -> None:
    """Raise unless each kernel launched as ``want`` says (0 if absent)."""
    expected = {k: want.get(k, 0) for k in counts}
    log(f"  launches {label}: {counts}")
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected}")


def long_context(torch, fa, rf, basics, train_mod, dev, paths) -> None:
    plain = train_mod.TrainConfig(seq=LONG_SEQ)
    chunked = dataclasses.replace(plain, loss_chunk=LONG_CHUNK)
    lean = dataclasses.replace(chunked, remat=True)
    tokens = train_mod.make_batch(plain, 0, dev)
    res = {}
    for name, config in (("lean", lean), ("chunked", chunked), ("plain", plain)):
        model = train_mod.build_model(config, dev)
        res[name] = one_step(torch, model, tokens, loss_chunk=config.loss_chunk)
        del model
    hold_step("remat + chunked loss vs chunked loss", res["lean"],
              res["chunked"], 1e-5, grad_limit=1e-4)
    hold_step("chunked loss vs full loss", res["chunked"], res["plain"], 1e-5)
    hold_step("remat + chunked loss vs plain", res["lean"], res["plain"], 1e-5)
    del res, tokens
    peaks = {}
    for config in (lean, plain):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        read_counts(fa, rf)
        result = train_mod.train(config, LONG_STEPS, device="cuda")
        counts = read_counts(fa, rf)
        label = f"remat={config.remat}, loss_chunk={config.loss_chunk}"
        log(f"  {LONG_STEPS} steps at seq {LONG_SEQ}, {label}:")
        peaks[config.remat] = torch.cuda.max_memory_allocated(dev)
        report_training(torch, dev, result)
        basics.shutdown()
        per_step = config.layers * LONG_STEPS
        hold_counts(label, counts, {
            "flash_fwd": (2 if config.remat else 1) * per_step,
            "flash_bwd_dq": per_step, "flash_bwd_dkv": per_step})
        paths[f"11: {LONG_STEPS} steps, seq {LONG_SEQ}, {label}"] = counts
    log(f"  peak memory: remat + chunked loss {peaks[True] / 1e9:.2f} GB, "
        f"plain {peaks[False] / 1e9:.2f} GB")
    if not peaks[True] < peaks[False]:
        raise AssertionError("remat + chunked loss did not lower the peak memory")


def bf16_head(torch, fa, rf, basics, train_mod, dev, paths) -> None:
    config = train_mod.TrainConfig(logits_dtype="bfloat16")
    tokens = train_mod.make_batch(config, 0, dev)
    res = []
    for c in (config, train_mod.TrainConfig()):
        model = train_mod.build_model(c, dev)
        res.append(one_step(torch, model, tokens))
        del model
    hold_step("bf16 head vs float32 head", res[0], res[1], 1e-2)
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    read_counts(fa, rf)
    result = train_mod.train(config, STEPS, device="cuda")
    counts = read_counts(fa, rf)
    report_training(torch, dev, result)
    basics.shutdown()
    hold_counts("bf16 head", counts, {k: config.layers * STEPS for k in KERNELS})
    paths[f"12: {STEPS} steps, bf16 head"] = counts


def graphed_against_eager(torch, fa, rf, basics, train_mod, loop_mod, bench,
                          config, dev, paths, phase="13") -> list:
    """Returns the captured step's ``last_launches`` (the exchange's
    buckets, in launch order, with whether a hook started each) and the
    optimizer's ``launch_order``."""
    s = train_mod.setup(config, "cuda")
    cache = train_mod.make_cache(config, s.sp, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    loop = loop_mod.make_scan_train_loop(s.step, cache, GRAPH_K, optimizer=s.opt)
    loop.warm_up()
    warm_s = loop.capture_s
    read_counts(fa, rf)
    loop.capture()
    graph_losses = []
    for _ in range(GRAPH_DISPATCHES):
        loop()
        graph_losses += loop.losses.tolist()
    counts = read_counts(fa, rf)
    peak = torch.cuda.max_memory_allocated(dev)
    graph_params = {n: p.detach().clone() for n, p in s.model.named_parameters()}
    log(f"  warm-up ({loop_mod.WARMUP_STEPS} steps) {warm_s:.3f} s, capture "
        f"{loop.capture_s - warm_s:.3f} s, peak memory {peak / 1e9:.2f} GB")
    hold_counts("at capture (one step; replays run no Python)", counts,
                {k: config.layers for k in (RING_KERNELS if config.sp else KERNELS)})
    paths[f"{phase}: capture of one step, {config_label(config)}"] = counts
    captured = (s.opt.last_launches, s.opt.launch_order)

    e = train_mod.setup(config, "cuda")
    ctr, eager_losses = cache.counter(), []
    for _ in range(GRAPH_K * GRAPH_DISPATCHES):
        x, y, ctr = cache.sample(ctr)
        eager_losses.append(e.step(x, y).item())
    read_counts(fa, rf)
    log(f"  losses graphed {graph_losses}")
    log(f"  losses eager   {eager_losses}")
    worst_loss = max(abs(g - w) / abs(w) for g, w in zip(graph_losses, eager_losses))
    worst = ("", 0.0)
    for name, p in e.model.named_parameters():
        err = (graph_params[name] - p).abs().max().item() / \
            max(p.abs().max().item(), 1e-30)
        worst = max(worst, (name, err), key=lambda x: x[1])
    log(f"  largest difference: loss {worst_loss:.3e} relative, parameter "
        f"{worst[0]} {worst[1]:.3e} of its max (limit {GRAPH_LIMIT:g})")
    if not (all(math.isfinite(x) for x in graph_losses)
            and worst_loss <= GRAPH_LIMIT and worst[1] <= GRAPH_LIMIT):
        raise AssertionError(f"graphed steps differ from eager: loss "
                             f"{worst_loss}, {worst}")

    def sync():
        torch.cuda.synchronize(dev)

    box = [ctr]

    def eager_step():
        x, y, box[0] = cache.sample(box[0])
        e.step(x, y)

    eager_rate = bench.measure_steps_per_s(eager_step, warmup=2,
                                           iters=2 * GRAPH_K, reps=3, sync=sync)
    graph_rate = GRAPH_K * bench.measure_steps_per_s(loop, warmup=1, iters=2,
                                                     reps=3, sync=sync)
    log(f"  tokens/s (median of 3 windows of {2 * GRAPH_K} steps): eager "
        f"{eager_rate * s.tokens_per_step:.1f} ({1e3 / eager_rate:.2f} ms a "
        f"step), graphed {graph_rate * s.tokens_per_step:.1f} "
        f"({1e3 / graph_rate:.2f} ms a step)")
    read_counts(fa, rf)
    del loop, s, e
    basics.shutdown()
    torch.cuda.empty_cache()
    return captured


# Phase 14. A world of one: each group of the ladder has one rank, so the
# ladder moves the same bytes as the flat allreduce and both pairs are
# expected bit-equal. The bf16 pair rounds the same float32 bucket to bf16
# once: the flat path casts the bucket, the ladder casts its DCN shard,
# which is the whole bucket.
HIER_THRESHOLD = 1 << 20
HIER_COLLECTIVES = ("reduce_scatter_tensor", "all_reduce", "all_gather_into_tensor")


class CountCollectives:
    """Count the calls of ``torch.distributed``'s collectives ``names``
    made inside the ``with`` block (the port calls them as
    ``dist.<name>``), by name (``counts``) and by the process group each
    call names (``on``)."""

    def __init__(self, dist, names=HIER_COLLECTIVES):
        self.dist, self.names = dist, names
        self.counts, self.groups, self.saved = {}, [], {}

    def __enter__(self):
        for name in self.names:
            fn = self.saved[name] = getattr(self.dist, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                self.groups.append(kwargs.get("group"))
                return _fn(*args, **kwargs)

            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)

    def on(self, group) -> int:
        """Calls that named ``group``."""
        return sum(g is group for g in self.groups)


def hierarchical_variant(torch, tc, basics, config, dcn_env=None) -> dict:
    """STEPS steps of ``config`` through ``setup_cnn``/``run_cnn``; the
    collectives of step 1 counted. Returns the result, the parameters
    after the last step (on the card) and the counts."""
    import torch.distributed as dist

    if dcn_env is not None:
        os.environ["HOROVOD_DCN_COMPRESSION"] = dcn_env
    try:
        s = tc.setup_cnn(config, "cuda")
    finally:
        os.environ.pop("HOROVOD_DCN_COMPRESSION", None)
    counter = CountCollectives(dist)

    def around(i):
        return counter if i == 1 else contextlib.nullcontext()

    result = tc.run_cnn(s, STEPS, around)
    params = {n: p.detach().clone() for n, p in s.model.named_parameters()}
    wires = sorted({str(w).removeprefix("torch.") for w in s.opt.wires[1]})
    del s
    basics.shutdown()
    torch.cuda.empty_cache()
    return {"result": result, "params": params, "counts": counter.counts,
            "dcn_wires": wires}


def hold_bit_equal(label, a, b) -> None:
    la, lb = a["result"].losses, b["result"].losses
    differ = [n for n in b["params"] if not bool((a["params"][n] == b["params"][n]).all())]
    log(f"  {label}: losses {la} vs {lb}; parameters that differ after step "
        f"{STEPS}: {len(differ)} of {len(b['params'])}")
    if la != lb or differ:
        worst = max(((a["params"][n] - b["params"][n]).abs().max().item(), n)
                    for n in differ) if differ else None
        raise AssertionError(f"{label}: not bit-equal (losses {la} vs {lb}; "
                             f"largest parameter difference {worst})")


def hierarchical_resnet(torch, tc, basics, card, flat_64) -> dict:
    base = tc.CNNConfig(fusion_threshold=HIER_THRESHOLD)
    variants = {
        "flat, 1 MiB": (dataclasses.replace(base, hierarchical=False), None),
        "hierarchical, 1 MiB": (dataclasses.replace(base, hierarchical=True), None),
        "flat, 1 MiB, bf16 wire": (dataclasses.replace(
            base, hierarchical=False, compression="bf16"), None),
        "hierarchical, 1 MiB, DCN bf16": (dataclasses.replace(
            base, hierarchical=True), "bf16"),
        "hierarchical, 64 MiB": (tc.CNNConfig(hierarchical=True), None),
    }
    runs = {}
    for label, (config, dcn_env) in variants.items():
        run = runs[label] = hierarchical_variant(torch, tc, basics, config, dcn_env)
        res = run["result"]
        if not all(math.isfinite(x) for x in res.losses) or \
                not res.losses[-1] < res.losses[0]:
            raise AssertionError(f"{label}: losses {res.losses}")
        want = {"reduce_scatter_tensor": res.num_buckets,
                "all_reduce": res.num_buckets + 1,      # + metric_average
                "all_gather_into_tensor": res.num_buckets} if res.hierarchical \
            else {"all_reduce": res.num_buckets + 1}
        log(f"  {label}: hierarchical {res.hierarchical} (ici {res.ici_size}, "
            f"dcn {res.dcn_size}), DCN wires {run['dcn_wires']}, "
            f"{res.num_buckets} buckets, collectives in step 1 {run['counts']} "
            f"(one all_reduce is metric_average's)")
        if run["counts"] != want:
            raise AssertionError(f"{label}: collectives {run['counts']}, expected {want}")
    hold_bit_equal("flat vs hierarchical, 1 MiB", runs["flat, 1 MiB"],
                   runs["hierarchical, 1 MiB"])
    hold_bit_equal("flat bf16 wire vs hierarchical DCN bf16, 1 MiB",
                   runs["flat, 1 MiB, bf16 wire"],
                   runs["hierarchical, 1 MiB, DCN bf16"])
    rates = {"flat, 64 MiB (phase 10)": flat_64}
    for label, run in runs.items():
        res = run["result"]
        rates[label] = res.images_per_step / statistics.median(res.step_s[1:])
    log(f"  img/s, median of steps 1-4, on {card}: " + "; ".join(
        f"{k} {v:.1f}" for k, v in rates.items()))
    return rates


# Phase 15. The virtual world's head shards run the same kernels on the
# same rows as the whole-sequence call (a row's program does not depend on
# how many rows the grid holds), so bit-equality is expected.
ULYSSES_N = 4
ULYSSES_LAYERS = [
    # (B, T whole, H, Hkv, D)
    (1, 4096, 8, 8, 128),
    (1, 4096, 8, 4, 128),
]


def virtual_ulysses(torch, ra, q, k, v, g):
    """Ulysses over ULYSSES_N virtual ranks on one card: rank r's head
    shard is every rank's sequence shard of head chunk r, in rank order;
    its attention runs through ``head_shard_attention`` (flash), forward
    and backward with dO = the head shard of ``g``; the result and
    gradients are put back together along the heads."""
    n = ULYSSES_N

    def to_heads(x, r):
        return torch.cat([s.chunk(n, dim=2)[r] for s in x.chunk(n, dim=1)], dim=1)

    outs, grads = [], []
    for r in range(n):
        leaves = [to_heads(x, r).requires_grad_(True) for x in (q, k, v)]
        out = ra.head_shard_attention(*leaves, impl="flash")
        out.backward(to_heads(g, r))
        outs.append(out.detach())
        grads.append([x.grad for x in leaves])
    return (torch.cat(outs, dim=2),
            *(torch.cat([gr[i] for gr in grads], dim=2) for i in range(3)))


def flash_with_grads(fn, q, k, v, g):
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    out.backward(g)
    return (out.detach(), *(x.grad for x in leaves))


def hold_same(torch, label, got, want) -> bool:
    """Bit-equal, or else within phase 2's bf16 kernel limits; returns
    whether bit-equal."""
    same = []
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        same.append(torch.equal(a, b))
        if not same[-1]:
            check(torch, f"{label} {name}", a, b)
    log(f"  {label}: " + ", ".join(f"{n} {'bit-equal' if e else 'not bit-equal'}"
                                   for n, e in zip(("out", "dq", "dk", "dv"), same)))
    return all(same)


def ulysses_on_card(torch, fa, rf, ra, dev, timing, paths) -> dict:
    for layer in ULYSSES_LAYERS:
        b, t, h, hkv, d = layer
        gen = torch.Generator(device=dev).manual_seed(8080 + hkv)
        q, k, v, g = (torch.randn(b, t, hh, d, generator=gen, device=dev)
                      .to(torch.bfloat16) for hh in (h, hkv, hkv, h))
        read_counts(fa, rf)
        got = virtual_ulysses(torch, ra, q, k, v, g)
        torch.cuda.synchronize()
        counts = read_counts(fa, rf)
        hold_counts(f"virtual Ulysses {layer}", counts,
                    {k_: ULYSSES_N for k_ in KERNELS})
        paths[f"15: Ulysses, virtual world of {ULYSSES_N}, {layer}"] = counts
        want = flash_with_grads(fa.flash_attention, q, k, v, g)
        hold_same(torch, f"virtual Ulysses {layer} vs whole-sequence flash",
                  got, want)
        one = flash_with_grads(lambda a, b_, c: ra.ulysses_attention(
            a, b_, c, None, impl="flash"), q, k, v, g)
        if not hold_same(torch, f"ulysses_attention(group=None) {layer} vs "
                                "flash_attention", one, want):
            raise AssertionError("ulysses_attention in a world of one is not "
                                 "flash_attention bit for bit")
        read_counts(fa, rf)
        torch.cuda.empty_cache()
    # Every head shard the layers above ran (MHA and GQA), each kernel
    # against its plain version; the MHA shard is timed.
    shards = [(b, t, h // ULYSSES_N, hkv // ULYSSES_N, d, True, "bfloat16")
              for b, t, h, hkv, d in ULYSSES_LAYERS]
    inputs = {}
    for shard in shards:
        log(f"  the head shard {shard}: each kernel against its plain version")
        _, inputs[shard] = check_shape(torch, fa, dev, shard)
    shard = shards[0]
    log(f"  timing at the head shard {shard}")
    rows = time_kernels(torch, fa, inputs[shard], shard)
    del inputs
    read_counts(fa, rf)
    for name, row in rows.items():
        full = timing[name]["ms"]
        log(f"  {name:14s} head shard {row['ms']:.4f} ms, whole layer "
            f"{full:.4f} ms: {row['ms'] / full:.3f} of it (a quarter of the "
            f"heads: {ULYSSES_N} launches take {ULYSSES_N * row['ms'] / full:.3f})")
    torch.cuda.empty_cache()
    return rows


# Phase 16. A world of one: every group of the sharded layouts has one
# rank, the ZeRO exchange at shard 1 is the DP path's call, and Adam runs
# its foreach implementation on the rows and on the parameters alike, so
# ZeRO and FSDP are expected bit-equal to the flat step.
SHARD_STEPS = 3
PLANNED_SHARDS = (1, 2, 4, 8)


def sharded_run(torch, fa, rf, basics, train_mod, sh, fsdp_mod, label, config,
                dev) -> dict:
    """SHARD_STEPS steps of ``config`` (``label`` "FSDP": through
    ``setup_fsdp``) on one repeated batch: losses, step ms, peak memory,
    the collectives of step 1, B1-B6's launches (counts zeroed just
    before the steps), the parameters after the last step (on the host)
    and the planned per-rank bytes."""
    import torch.distributed as dist

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    if label == "ZeRO":
        os.environ["HOROVOD_MESH"] = "1x1"
    try:
        s = train_mod.setup_fsdp(config, device="cuda") if label == "FSDP" \
            else train_mod.setup(config, "cuda")
    finally:
        os.environ.pop("HOROVOD_MESH", None)
    tokens = train_mod.make_batch(config, 0, dev)
    counter = CountCollectives(dist)
    losses, times = [], []
    read_counts(fa, rf)
    for i in range(SHARD_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with counter if i == 1 else contextlib.nullcontext():
            loss = s.step(tokens)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = read_counts(fa, rf)
    run = {"losses": losses, "ms": [1e3 * t for t in times],
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "collectives": counter.counts, "launches": counts}
    if label == "FSDP":
        run["params"] = {n: t.cpu() for n, t in
                         fsdp_mod.fsdp_unshard_params([s.rows], s.shapes).items()}
        run["leaves"] = len(s.rows)
    else:
        if s.opt.sharded:
            sh.gather_params(s.opt.rows, s.opt.shard_plan, s.opt.layout, s.opt.params)
            run["planned"] = {n: sh.build_shard_plan(
                s.opt.params, n, s.opt.threshold, s.opt.num_buckets, 0
            ).state_bytes_per_rank() for n in PLANNED_SHARDS}
            run["param_count"] = sum(s.opt.shard_plan.raw_sizes)
        run["params"] = {n: p.detach().cpu() for n, p in s.model.named_parameters()}
        run["buckets"] = s.opt.plan.num_buckets
    del s
    basics.shutdown()
    torch.cuda.empty_cache()
    return run


def hold_runs_bit_equal(label, a, b) -> None:
    differ = [n for n in b["params"] if not torch_equal(a["params"][n], b["params"][n])]
    log(f"  {label}: losses {a['losses']} vs {b['losses']}; parameters that "
        f"differ after step {SHARD_STEPS}: {len(differ)} of {len(b['params'])}")
    if a["losses"] != b["losses"] or differ:
        raise AssertionError(f"{label}: not bit-equal (losses {a['losses']} vs "
                             f"{b['losses']}; differing parameters {differ[:5]})")


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def sharded_phase(torch, fa, rf, basics, train_mod, card, dev, paths) -> None:
    from horovod_tpu_torch.parallel import fsdp as fsdp_mod
    from horovod_tpu_torch.parallel import sharded as sh

    flat_config = train_mod.TrainConfig()
    configs = {"flat": flat_config,
               "ZeRO": dataclasses.replace(flat_config, sharded=True),
               "FSDP": flat_config}
    runs = {label: sharded_run(torch, fa, rf, basics, train_mod, sh, fsdp_mod,
                               label, config, dev)
            for label, config in configs.items()}
    hold_runs_bit_equal("ZeRO (HOROVOD_MESH=1x1) vs flat", runs["ZeRO"], runs["flat"])
    hold_runs_bit_equal("FSDP (training_groups(1, 1)) vs flat", runs["FSDP"],
                        runs["flat"])
    per_step = flat_config.layers * SHARD_STEPS
    for label, run in runs.items():
        hold_counts(f"{label}, {SHARD_STEPS} steps", run["launches"],
                    {k: per_step for k in KERNELS})
        paths[f"16: {SHARD_STEPS} steps, {label}"] = run["launches"]
        log(f"  {label}: median step {statistics.median(run['ms'][1:]):.2f} ms "
            f"(steps 1-{SHARD_STEPS - 1}; per step {[round(t, 2) for t in run['ms']]}), "
            f"peak memory {run['peak_gb']:.3f} GB, on {card}")
    b, leaves = runs["flat"]["buckets"], runs["FSDP"]["leaves"]
    want = {"flat": {"all_reduce": b}, "ZeRO": {"all_reduce": b},
            "FSDP": {"all_gather_into_tensor": leaves, "reduce_scatter_tensor": leaves}}
    for label, run in runs.items():
        log(f"  collectives of a {label} step: {run['collectives']} ({b} buckets, "
            f"{leaves} leaves)")
        if run["collectives"] != want[label]:
            raise AssertionError(f"{label}: collectives {run['collectives']}, "
                                 f"expected {want[label]}")
    log(f"  ZeRO at shard 1 sends each of its {b} buckets through the DP call "
        f"(an all-reduce over the batch group) and gathers nothing; at shard > 1 "
        f"each bucket takes one reduce-scatter and one all-gather")
    zero = runs["ZeRO"]
    log(f"  parameters: {zero['param_count']} (float32, "
        f"{4 * zero['param_count'] / 1e9:.3f} GB)")
    log("  planned per-rank bytes of the parameters (state_bytes_per_rank(); "
        "Adam's state is twice that), not measured: " + ", ".join(
            f"shard {n} {v} B" for n, v in zero["planned"].items()))


# Phase 17. Tensor parallelism. (a) A model group of one in a world of one
# over NCCL: copy_to_model and reduce_from_model issue nothing, the flat
# allreduce runs over the batch group of one, and the model draws the same
# weights, so TP_STEPS steps are expected bit-equal to the flat step in
# every loss and parameter, with no collective on the model group. (b) A
# virtual model group of TP_N on the card: one full-width block cut by
# tp_state_dict into TP_N rank blocks, each rank's attn_partial and
# mlp_partial summed in float32 in place of the reduce, against the whole
# block. Its output is held to phase 2's bf16 relative norm (1e-2) and its
# gradients (x and every parameter, reassembled: the sliced ones by
# tp_merge_state_dicts, each replicated norm scale as the sum of the
# ranks' partial gradients) to phase 5's 3e-2: the ranks' partial products
# are summed in another order than the whole block's contraction.
TP_STEPS, TP_N = 3, 4
# Phase 18. The full-width MoE TransformerLM (8 experts in every 2nd
# block, capacity factor 1.25), loss = task + MOE_AUX x the sum of the
# load-balancing losses, Adam through DistributedOptimizer.
MOE_EXPERTS, MOE_EVERY, MOE_AUX = 8, 2, 0.01


def lm_setup(torch, train_mod, config, dev, group=None, **model_kw):
    """model -> ``broadcast_parameters`` -> Adam ->
    ``DistributedOptimizer(group=)`` -> ``broadcast_optimizer_state``, the
    port's own functions, after ``init``; ``group`` is the batch group
    (None: the world)."""
    from horovod_tpu_torch import optimizer as hvd_opt
    from horovod_tpu_torch.convert import jax_ordered

    model = train_mod.build_model(config, dev, **model_kw)
    named = jax_ordered(model.named_parameters())
    hvd_opt.broadcast_parameters(named, 0, group)
    opt = hvd_opt.DistributedOptimizer(
        train_mod.adam([p for _, p in named], config), named, sharded=False,
        group=group)
    hvd_opt.broadcast_optimizer_state(opt, 0, group)
    return model, opt


def moe_loss(model, tokens):
    from horovod_tpu_torch.models.transformer import lm_loss

    return lm_loss(model(tokens), tokens) + MOE_AUX * model.moe_lb_loss()


def run_steps(torch, fa, rf, model, opt, tokens, steps, dev, loss_fn=None,
              counter=None) -> dict:
    """``steps`` steps (zero_grad, forward, loss, backward, ``opt.step()``)
    on one repeated batch, the counts zeroed just before: losses, ms per
    step, peak memory, launches, the parameters after the last step (on
    the host). ``counter`` wraps step 1."""
    from horovod_tpu_torch.models.transformer import lm_loss

    loss_fn = loss_fn or (lambda m, t: lm_loss(m(t), t))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    read_counts(fa, rf)
    for i in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with counter if (counter is not None and i == 1) else contextlib.nullcontext():
            opt.zero_grad()
            loss = loss_fn(model, tokens)
            loss.backward()
            opt.step()
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
    return {"losses": losses, "ms": times, "launches": read_counts(fa, rf),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}


def tp_of_one(torch, fa, rf, basics, train_mod, config, card, dev, paths) -> None:
    import torch.distributed as dist
    from horovod_tpu_torch.parallel.mesh import sharded_groups

    runs = {}
    for label in ("flat", "TP=1"):
        basics.init("cuda")
        layout = sharded_groups(1, 1, 1) if label == "TP=1" else None
        model, opt = lm_setup(
            torch, train_mod, config, dev,
            group=layout.batch_group if layout else None,
            tp_group=layout.model_group if layout else None)
        tokens = train_mod.make_batch(config, 0, dev)
        counter = CountCollectives(dist)
        runs[label] = run_steps(torch, fa, rf, model, opt, tokens, TP_STEPS, dev,
                                counter=counter)
        if layout is not None:
            on_model = counter.on(layout.model_group)
            log(f"  TP=1: collectives of step 1 on the model group: {on_model}; "
                f"on the batch group: {counter.on(layout.batch_group)} "
                f"({opt.plan.num_buckets} buckets)")
            if on_model:
                raise AssertionError(f"a model group of one issued {on_model} "
                                     f"collectives")
        del model, opt
        basics.shutdown()
        torch.cuda.empty_cache()
    hold_runs_bit_equal("TP=1 (sharded_groups(1, 1, 1)) vs flat", runs["TP=1"],
                        runs["flat"])
    for label, run in runs.items():
        hold_counts(f"{label}, {TP_STEPS} steps", run["launches"],
                    {k: config.layers * TP_STEPS for k in KERNELS})
        paths[f"17: {TP_STEPS} steps, {label}"] = run["launches"]
        log(f"  {label}: median step {statistics.median(run['ms'][1:]):.2f} ms "
            f"(steps 1-{TP_STEPS - 1}; per step {[round(t, 2) for t in run['ms']]}), "
            f"peak memory {run['peak_gb']:.3f} GB, on {card}")


def relnorm_t(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def virtual_tp(torch, fa, rf, config, dev, paths) -> None:
    from horovod_tpu_torch.models.transformer import (
        TransformerLM, init_weights, tp_merge_state_dicts, tp_param_specs,
        tp_state_dict)

    kw = dict(vocab=config.vocab, dim=config.dim, heads=config.heads, layers=1,
              mlp_ratio=config.mlp_ratio, dtype=getattr(torch, config.dtype),
              attention=config.attention)
    whole = TransformerLM(**kw).to(dev)
    init_weights(whole, torch.Generator(device=dev).manual_seed(config.seed))
    ranks = []
    for r in range(TP_N):
        m = TransformerLM(**kw, tp_size=TP_N).to(dev)
        m.load_state_dict(tp_state_dict(whole.state_dict(), TP_N, r))
        ranks.append(m.blocks[0])
    gen = torch.Generator(device=dev).manual_seed(1717)
    shape = (config.batch, config.seq, config.dim)
    x0 = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(config.seq, device=dev)[None]

    read_counts(fa, rf)
    x = x0.clone().requires_grad_(True)
    want = whole.blocks[0](x, pos)
    want.backward(g)
    want_grads = {"x": x.grad, **{n: p.grad for n, p in
                                  whole.blocks[0].named_parameters()}}
    hold_counts("the whole block, one pass", read_counts(fa, rf),
                {k: 1 for k in KERNELS})

    x = x0.clone().requires_grad_(True)
    x1 = x + torch.stack([b.attn_partial(x, pos).float() for b in ranks]).sum(0) \
        .to(x.dtype)
    got = x1 + torch.stack([b.mlp_partial(x1).float() for b in ranks]).sum(0) \
        .to(x.dtype)
    got.backward(g)
    torch.cuda.synchronize(dev)
    counts = read_counts(fa, rf)
    hold_counts(f"virtual TP world of {TP_N}, one pass", counts,
                {k: TP_N for k in KERNELS})
    paths[f"17: virtual TP world of {TP_N}, one block, one pass"] = counts
    out_err = relnorm_t(got, want)
    log(f"  virtual TP={TP_N} block vs the whole block: output relative norm "
        f"{out_err:.3e} (limit {BF16_RELNORM:g})")
    if not out_err <= BF16_RELNORM:
        raise AssertionError(f"virtual TP output {out_err:.3e} > {BF16_RELNORM:g}")
    specs = tp_param_specs(ranks[0])
    grads = {"x": x.grad}
    for n in specs:
        parts = [dict(b.named_parameters())[n].grad for b in ranks]
        grads[n] = torch.stack([p.float() for p in parts]).sum(0) \
            if specs[n] is None else tp_merge_state_dicts([{n: p} for p in parts])[n]
    errs = sorted(((relnorm_t(grads[n], w), n) for n, w in want_grads.items()),
                  reverse=True)
    log("  gradients vs the whole block, relative norm: " + ", ".join(
        f"{n} {e:.3e}" for e, n in errs) + " (limit 3e-2)")
    if not errs[0][0] <= 3e-2:
        raise AssertionError(f"virtual TP gradient {errs[0]} > 3e-2")
    del whole, ranks
    torch.cuda.empty_cache()


def tp_wire(torch, config) -> None:
    from horovod_tpu_torch.parallel.tensor import tp_wire_bytes_per_pair

    rows = config.batch * config.seq
    act = tp_wire_bytes_per_pair(rows, config.dim, getattr(torch, config.dtype))
    head = tp_wire_bytes_per_pair(rows, config.vocab,
                                  getattr(torch, config.logits_dtype))
    fwd = 2 * config.layers * act + head
    bwd = (2 * config.layers + 1) * act
    log(f"  TP={TP_N} model-group allreduce payload per step (planned, not "
        f"measured): forward {2 * config.layers} x {act} B (the o_proj and "
        f"mlp_out partials) + the head's float32 logits {head} B = {fwd} B; "
        f"backward {2 * config.layers + 1} x {act} B (copy_to_model: each "
        f"sublayer's and the head's input cotangent) = {bwd} B; {fwd + bwd} B "
        f"in all")


def tensor_parallel(torch, fa, rf, basics, train_mod, card, dev, paths) -> None:
    config = train_mod.TrainConfig()
    tp_of_one(torch, fa, rf, basics, train_mod, config, card, dev, paths)
    log(f"  a virtual model group of {TP_N}: one full-width block, the head "
        f"shard ({config.batch}, {config.seq}, {config.heads // TP_N}, "
        f"{config.dim // config.heads}) per rank")
    virtual_tp(torch, fa, rf, config, dev, paths)
    tp_wire(torch, config)


def moe_oracle(torch, params, x):
    """Every token through its argmax expert's MLP times its gate
    probability (the dense oracle of tests/test_tensor_parallel.py's MoE
    test): the gate's logits as ``moe_apply`` and the oracle take them,
    ``x @ gate`` in the inputs' dtype, so both route alike; the experts in
    float32 from the same inputs."""
    prob, expert = torch.softmax((x @ params.gate).float(), dim=-1).max(dim=-1)
    gate, w_in, w_out = (p.float() for p in params)
    x = x.float()
    h = torch.relu(torch.einsum("td,tdh->th", x, w_in[expert]))
    return torch.einsum("th,thd->td", h, w_out[expert]) * prob[:, None]


def moe_layer_checks(torch, basics, config, dev) -> None:
    from horovod_tpu_torch.models.moe import MoEMLP
    from horovod_tpu_torch.models.transformer import init_weights
    from horovod_tpu_torch.ops.moe import MoEParams, moe_apply
    from horovod_tpu_torch.parallel.mesh import sharded_groups

    d, hidden = config.dim, config.mlp_ratio * config.dim
    n_tok = config.batch * config.seq
    basics.init("cuda")
    group = sharded_groups(1, 1, 1).model_group
    gen = torch.Generator(device=dev).manual_seed(1818)
    x0 = torch.randn(config.batch, config.seq, d, generator=gen,
                     device=dev).to(torch.bfloat16)
    outs = []
    for ep_group in (None, group):
        mlp = MoEMLP(d, hidden, MOE_EXPERTS, ep_group=ep_group).to(dev)
        init_weights(mlp, torch.Generator(device=dev).manual_seed(18))
        x = x0.clone().requires_grad_(True)
        out = mlp(x)
        out.float().square().mean().backward()
        outs.append([out, x.grad, *(p.grad for p in mlp.parameters())])
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    log(f"  MoEMLP(ep_group=<group of one>) vs MoEMLP(), full width: output and "
        f"gradients {'bit-equal' if same else 'differ'}")
    if not same:
        raise AssertionError("MoEMLP with an ep group of one is not MoEMLP()")
    basics.shutdown()
    gate = torch.randn(d, MOE_EXPERTS, generator=gen, device=dev) / d ** 0.5
    w_in = torch.randn(MOE_EXPERTS, d, hidden, generator=gen, device=dev) / d ** 0.5
    w_out = torch.randn(MOE_EXPERTS, hidden, d, generator=gen, device=dev) / hidden ** 0.5
    params = MoEParams(*(p.to(torch.bfloat16) for p in (gate, w_in, w_out)))
    x = x0.reshape(n_tok, d)
    got = moe_apply(params, x, n_tok)
    want = moe_oracle(torch, params, x)
    check(torch, "moe_apply ep=1, no drop", got, want.to(torch.bfloat16),
          autograd=True)
    log(f"  (capacity {n_tok}: no token dropped; against the dense per-token "
        f"oracle, experts in float32 from the same bf16 inputs; bf16 relative "
        f"norm: moe_apply rounds h and each product to bf16)")
    del got, want
    torch.cuda.empty_cache()


def routes_of(torch, model) -> list:
    """Forward hooks that record each MoE layer's (expert, keep) per token,
    routed again from the layer's input as the layer routes it."""
    from horovod_tpu_torch.ops.moe import top1_route

    routes = []

    def hook(mod, args, _out):
        tokens = args[0].reshape(-1, mod.dim)
        expert, _, _, keep = top1_route(tokens.float() @ mod.gate,
                                        mod.capacity(tokens.shape[0]))
        routes.append((expert, keep))

    for b in model.blocks:
        if b.moe is not None:
            b.moe.register_forward_hook(hook)
    return routes


def moe_against_dense(torch, fa, rf, train_mod, config, dev, tokens) -> None:
    """One step of the MoE model, flash kernels against plain dense
    attention, same weights and batch. Routing is an argmax, and capacity
    keeps the first tokens of each expert in sequence order: a token whose
    two best gate logits lie within the two paths' rounding flips, and
    moves which later tokens of both experts are kept. In float32 the two
    attention paths agree to ~1e-6, routing is expected the same, and the
    step is held whole to phase 5's limits. In bf16 (the trained dtype)
    they differ at 2^-9: the flips are counted, the loss and every
    parameter but the experts' are held to phase 5's limits, and the
    experts' gradients are printed."""
    results, routes = {}, {}
    for attention in ("flash", "dense"):
        model = train_mod.build_model(
            dataclasses.replace(config, attention=attention), dev,
            moe_experts=MOE_EXPERTS, moe_every=MOE_EVERY)
        routes[attention] = routes_of(torch, model)
        loss = moe_loss(model, tokens)
        loss.backward()
        results[attention] = (loss.item(), {n: p.grad.float() for n, p in
                                            model.named_parameters()})
        del model, loss
        torch.cuda.empty_cache()
    read_counts(fa, rf)
    flips = [int(((ea != eb) | (ka != kb)).sum()) for (ea, ka), (eb, kb)
             in zip(routes["flash"], routes["dense"])]
    kept = [int(k.sum()) for _, k in routes["flash"]]
    log(f"  {config.dtype}: tokens routed otherwise (expert or keep) by dense "
        f"attention, per MoE layer: {flips}; tokens kept (flash) {kept} of "
        f"{tokens.numel()}")
    label = f"MoE flash vs dense, {config.dtype}"
    if config.dtype == "float32":
        hold_step(label, results["flash"], results["dense"], 1e-2)
        return
    experts = {n for n in results["dense"][1] if ".moe.w_" in n}
    hold_step(label + ", all but the experts",
              (results["flash"][0], {n: g for n, g in results["flash"][1].items()
                                     if n not in experts}),
              (results["dense"][0], {n: g for n, g in results["dense"][1].items()
                                     if n not in experts}), 1e-2)
    errs = sorted((relnorm_t(results["flash"][1][n], results["dense"][1][n]), n)
                  for n in experts)
    log("  experts' gradients, relative norm (printed, not held: the routing "
        "above differs): " + ", ".join(f"{n} {e:.3e}" for e, n in errs))


def mixture_of_experts(torch, fa, rf, basics, train_mod, card, dev, paths) -> None:
    config = train_mod.TrainConfig()
    moe_kw = dict(moe_experts=MOE_EXPERTS, moe_every=MOE_EVERY)
    basics.init("cuda")
    model, opt = lm_setup(torch, train_mod, config, dev, **moe_kw)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = train_mod.make_batch(config, 0, dev)
    run = run_steps(torch, fa, rf, model, opt, tokens, STEPS, dev, moe_loss)
    n_tok = config.batch * config.seq
    dropped = [int(b.moe.dropped) for b in model.blocks if b.moe is not None]
    losses = run["losses"]
    ms = statistics.median(run["ms"][1:])
    log(f"  {n_params} parameters ({4 * n_params / 1e9:.3f} GB float32), "
        f"{len(dropped)} MoE layers of {MOE_EXPERTS} experts, capacity "
        f"{model.blocks[MOE_EVERY - 1].moe.capacity(n_tok)} tokens per expert")
    log(f"  losses (task + {MOE_AUX} x load balancing) {losses}")
    log(f"  tokens dropped per MoE layer, last step: {dropped} of {n_tok}")
    log(f"  median step {ms:.2f} ms (steps 1-{STEPS - 1}; per step "
        f"{[round(t, 2) for t in run['ms']]}), {n_tok / ms * 1e3:.1f} tokens/s, "
        f"peak memory {run['peak_gb']:.3f} GB, on {card}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE losses not finite and falling: {losses}")
    hold_counts(f"MoE, {STEPS} steps", run["launches"],
                {k: config.layers * STEPS for k in KERNELS})
    paths[f"18: {STEPS} steps, MoE"] = run["launches"]
    del model, opt, run
    basics.shutdown()
    torch.cuda.empty_cache()

    for dtype in ("float32", "bfloat16"):
        moe_against_dense(torch, fa, rf, train_mod,
                          dataclasses.replace(config, dtype=dtype), dev, tokens)
    moe_layer_checks(torch, basics, config, dev)


# Phase 19. Pipeline parallelism at full width (models/pipeline_lm.py on the
# tick schedule of parallel/pipeline.py). (a) A pp group of one in a world of
# one over NCCL at n_micro = 1: the same operations on the same rows as the
# flat step, so PP_STEPS steps are expected bit-equal to it in every loss and
# parameter, with no P2P call. (b) The same group with PP_MICRO microbatches
# of one sequence against the flat step on the same batch of PP_MICRO: the
# gradients sum over the microbatches in another order, so step 0's loss and
# gradients are held to phase 5's limits. (c) A virtual pp of PP_N on the
# card: PP_N PipelineStages of 3 blocks cut by stage_state_dict, run in one
# process in lockstep on the tick schedule, list rotation in place of the
# PPermute; loss and gradients (the outer leaves summed over the stages, the
# blocks merged) against (b)'s flat step within phase 5's limits, and bubble
# isolation: microbatch 1 changed, the other microbatches' logits bit for bit.
PP_STEPS, PP_N, PP_MICRO = 3, 4, 4
P2P_CALLS = ("batch_isend_irecv", "isend", "irecv", "send", "recv")


def pipeline_run(torch, fa, rf, basics, train_mod, config, n_micro, dev,
                 keep_grads=False) -> dict:
    """PP_STEPS steps on one repeated batch of ``config.batch`` sequences,
    of ``setup_pipeline(config, 1, n_micro)``, or of ``setup(config)`` (the
    flat step) when ``n_micro`` is None: losses, step ms, peak memory,
    launches (zeroed just before the steps), P2P calls, the parameters after
    the last step (on the host) and with ``keep_grads`` step 0's gradients
    (on the card)."""
    import torch.distributed as dist

    gc.collect()    # the previous run's objects, so its memory leaves the peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    if n_micro is None:
        s = train_mod.setup(config, "cuda")
        model = s.model
    else:
        s = train_mod.setup_pipeline(config, 1, n_micro, "cuda")
        model = s.stage
    tokens = train_mod.make_batch(config, 0, dev)
    losses, times, grads = [], [], None
    read_counts(fa, rf)
    with CountCollectives(dist, P2P_CALLS) as p2p:
        for i in range(PP_STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss = s.step(tokens)
            torch.cuda.synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(loss.item())
            if i == 0 and keep_grads:
                grads = {n: p.grad.detach().float().clone()
                         for n, p in model.named_parameters()}
    run = {"losses": losses, "ms": times, "launches": read_counts(fa, rf),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "p2p": sum(p2p.counts.values()), "grads": grads,
           "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
    del s, model
    basics.shutdown()
    torch.cuda.empty_cache()
    return run


def virtual_pipeline(torch, stages, tokens_micro):
    """``(n_micro, mb, T, vocab)`` logits of a pipeline of ``stages`` run in
    one process in lockstep: each tick of ``pipeline_ticks`` every stage
    runs its blocks on what it holds (stage 0 on its ingested microbatch,
    the others on what the previous tick handed them, zeros at first), the
    last stage's output of a collecting tick is kept, and the outputs move
    one stage on by list rotation in place of the ``PPermute``."""
    from horovod_tpu_torch.parallel.pipeline import pipeline_ticks

    n_micro, mb, t = tokens_micro.shape
    first, last = stages[0], stages[-1]
    positions = first.positions(t, tokens_micro.device)
    x_micro = first.embed(tokens_micro).to(first.dtype)
    held = [torch.zeros_like(x_micro[0]) for _ in stages]
    outs = [None] * n_micro
    for ingest, collect in pipeline_ticks(n_micro, len(stages)):
        held[0] = x_micro[ingest]
        done = []
        for stage, h in zip(stages, held):
            for block in stage.blocks:
                h = block(h, positions)
            done.append(h)
        if collect is not None:
            outs[collect] = done[-1]
        held = done[-1:] + done[:-1]
    h = last.norm(torch.stack(outs).reshape(n_micro * mb, t, last.dim))
    return last.lm_head(h).reshape(n_micro, mb, t, last.vocab)


def virtual_pp(torch, fa, rf, train_mod, config, dev, want, paths) -> None:
    from horovod_tpu_torch.models.pipeline_lm import merge_stage_state_dicts
    from horovod_tpu_torch.models.transformer import next_tokens, token_loss

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    stages = train_mod.pipeline_stages(config, dev, PP_N, range(PP_N))
    tokens = train_mod.make_batch(config, 0, dev)
    micro = tokens.reshape(PP_MICRO, -1, config.seq)

    def one_pass():
        for stage in stages:
            stage.zero_grad(set_to_none=True)
        loss = token_loss(virtual_pipeline(torch, stages, micro).reshape(
            config.batch, config.seq, -1), next_tokens(tokens))
        loss.backward()
        return loss.item()

    read_counts(fa, rf)
    one_pass()
    counts = read_counts(fa, rf)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    loss = one_pass()
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    read_counts(fa, rf)
    n_ticks = PP_MICRO + PP_N - 1
    per = config.layers // PP_N
    # The virtual hand-off drops the junk of the bubble ticks from the graph,
    # so only the collected microbatches' passes run a backward.
    hold_counts(f"virtual pp={PP_N}, one pass", counts,
                {"flash_fwd": n_ticks * config.layers,
                 "flash_bwd_dq": PP_MICRO * config.layers,
                 "flash_bwd_dkv": PP_MICRO * config.layers})
    paths[f"19c: virtual pp={PP_N}, {PP_MICRO} microbatches, one pass"] = counts
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    named = [dict(s.named_parameters()) for s in stages]
    grads = merge_stage_state_dicts([{n: p.grad for n, p in d.items()} for d in named])
    for name in ("embed.weight", "norm.scale", "lm_head.weight"):
        # the psum over the pp group: each leaf's gradient lands on one stage
        grads[name] = sum(d[name].grad for d in named if d[name].grad is not None)
    log(f"  virtual pp={PP_N} ({per} blocks per stage, {PP_MICRO} microbatches of "
        f"{config.batch // PP_MICRO}, {n_ticks} ticks): forward + backward "
        f"{ms:.2f} ms (the second pass), peak {peak:.3f} GB")
    hold_step(f"virtual pp={PP_N} vs flat", (loss, {n: g.float() for n, g in
                                                   grads.items()}), want, 1e-2)
    del grads
    for s in stages:
        s.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    changed = micro.clone()
    changed[1] = (changed[1] + 1) % config.vocab
    with torch.no_grad():
        a = virtual_pipeline(torch, stages, micro)
        b = virtual_pipeline(torch, stages, changed)
    kept = [i for i in range(PP_MICRO) if i != 1 and torch.equal(a[i], b[i])]
    log(f"  bubble isolation: microbatch 1 changed; microbatches bit-equal: "
        f"{kept} (want {[i for i in range(PP_MICRO) if i != 1]}); microbatch 1 "
        f"differs: {not torch.equal(a[1], b[1])}")
    if kept != [i for i in range(PP_MICRO) if i != 1] or torch.equal(a[1], b[1]):
        raise AssertionError("virtual pipeline: a microbatch's change reached "
                             "another's logits, or none")
    read_counts(fa, rf)
    del a, b, stages
    torch.cuda.empty_cache()


def pipeline_parallel(torch, fa, rf, basics, train_mod, card, dev, paths) -> None:
    config = train_mod.TrainConfig()
    config4 = dataclasses.replace(config, batch=PP_MICRO)
    runs = {"flat": pipeline_run(torch, fa, rf, basics, train_mod, config, None, dev),
            "a": pipeline_run(torch, fa, rf, basics, train_mod, config, 1, dev),
            f"flat, batch {PP_MICRO}": pipeline_run(torch, fa, rf, basics, train_mod,
                                                   config4, None, dev, True),
            "b": pipeline_run(torch, fa, rf, basics, train_mod, config4, PP_MICRO, dev,
                              True)}
    hold_runs_bit_equal("(a) pp group of one, n_micro = 1, vs flat", runs["a"],
                        runs["flat"])
    for label, run in runs.items():
        if run["p2p"]:
            raise AssertionError(f"{label}: {run['p2p']} P2P calls in a world of one")
    flat4, b = runs[f"flat, batch {PP_MICRO}"], runs["b"]
    log(f"  (b) pp group of one, {PP_MICRO} microbatches of 1, vs flat on the "
        f"same batch of {PP_MICRO}, step 0:")
    hold_step("(b) vs flat", (b["losses"][0], b["grads"]),
              (flat4["losses"][0], flat4["grads"]), 1e-2)
    # One launch per layer and pass carries a whole batch (its B x H rows);
    # the pipeline launches once per microbatch and tick.
    want = {"flat": 1, "a": 1, f"flat, batch {PP_MICRO}": 1, "b": PP_MICRO}
    for label, run in runs.items():
        per_step = want[label] * config.layers
        hold_counts(f"{label}, {PP_STEPS} steps", run["launches"],
                    {k: per_step * PP_STEPS for k in KERNELS})
        paths[f"19: {PP_STEPS} steps, {label}"] = run["launches"]
        log(f"  {label}: median step {statistics.median(run['ms'][1:]):.2f} ms "
            f"(steps 1-{PP_STEPS - 1}; per step {[round(t, 2) for t in run['ms']]}), "
            f"peak memory {run['peak_gb']:.3f} GB, B1-B3 {per_step} launches each "
            f"per step, {run['p2p']} P2P calls, on {card}")
    want_b = (flat4["losses"][0], flat4["grads"])
    del runs
    log(f"  (c) a virtual pp of {PP_N} on the card")
    virtual_pp(torch, fa, rf, train_mod, config4, dev, want_b, paths)
    n_ticks = PP_MICRO + PP_N - 1
    act = config4.batch // PP_MICRO * config.seq * config.dim * 2
    log(f"  a real pp={PP_N} step moves 2 x {n_ticks - 1} hand-offs of {act} B "
        f"(one bf16 microbatch's activations) = {2 * (n_ticks - 1) * act} B per "
        f"rank, forward and backward (planned, not measured)")


# Phase 20. The gradient exchange from the gradient hooks
# (HOROVOD_LATENCY_HIDING=1) at HOROVOD_NUM_BUCKETS=OVERLAP_BUCKETS in a
# world of one over NCCL: the same fused buffers, the same all-reduces and
# the same divisions as the serial exchange, only started earlier (in plan
# order on the first step, then in the order the buckets completed on it),
# so the hooked steps are expected bit-equal to the serial ones in every
# loss and parameter; the graphed loop with the hooks on is held to eager steps with
# the hooks on as phase 13 holds it (1e-6 relative, bit-equal expected).
OVERLAP_STEPS, OVERLAP_BUCKETS = 3, 4


def overlap_run(torch, fa, rf, basics, train_mod, config, hooked, dev) -> dict:
    """OVERLAP_STEPS steps of ``config`` on one repeated batch, the hooks
    on or off: losses, step ms, peak memory, B1-B3's launches (counts zeroed
    just before the steps), each step's launches, the parameters; with the
    hooks on also ``record_plan`` and a ``measure_overlap`` report of 2 more
    steps."""
    from horovod_tpu_torch.metrics.overlap import measure_overlap, record_plan

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    os.environ["HOROVOD_NUM_BUCKETS"] = str(OVERLAP_BUCKETS)
    os.environ["HOROVOD_LATENCY_HIDING"] = "1" if hooked else "0"
    try:
        s = train_mod.setup(config, "cuda")
    finally:
        os.environ.pop("HOROVOD_NUM_BUCKETS")
        os.environ.pop("HOROVOD_LATENCY_HIDING")
    if s.opt.latency_hiding != hooked:
        raise AssertionError(f"HOROVOD_LATENCY_HIDING={int(hooked)} did not reach "
                             f"the optimizer ({s.opt.latency_hiding})")
    tokens = train_mod.make_batch(config, 0, dev)
    losses, times, launches = [], [], []
    read_counts(fa, rf)
    for _ in range(OVERLAP_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = s.step(tokens)
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        launches.append(s.opt.last_launches)
    run = {"losses": losses, "ms": times, "launches": launches,
           "counts": read_counts(fa, rf),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "buckets": s.opt.plan.num_buckets, "order": s.opt.launch_order,
           "params": {n: p.detach().cpu() for n, p in s.model.named_parameters()}}
    if hooked:
        run["plan"] = record_plan(s.opt.plan, s.opt.threshold)
        run["overlap"] = measure_overlap(lambda: s.step(tokens), steps=2,
                                         sync=lambda: torch.cuda.synchronize(dev))
        read_counts(fa, rf)
    del s
    basics.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return run


def overlap_phase(torch, fa, rf, basics, train_mod, loop_mod, bench, card, dev,
                  paths) -> None:
    config = train_mod.TrainConfig()
    runs = {hooked: overlap_run(torch, fa, rf, basics, train_mod, config, hooked, dev)
            for hooked in (False, True)}
    off, on = runs[False], runs[True]
    differ = [n for n in off["params"] if not torch_equal(on["params"][n], off["params"][n])]
    log(f"  (a) hooks on vs off, {OVERLAP_STEPS} steps: losses {on['losses']} vs "
        f"{off['losses']}; parameters that differ: {len(differ)} of {len(off['params'])}")
    if on["losses"] != off["losses"] or differ:
        raise AssertionError(f"hooked exchange not bit-equal to the serial one: "
                             f"losses {on['losses']} vs {off['losses']}, {differ[:5]}")
    nb, leaves = on["buckets"], len(on["params"])
    log(f"  agreed launch order (as the buckets completed on the first "
        f"backward pass): {on['order']}")
    if sorted(on["order"]) != list(range(nb)):
        raise AssertionError(f"launch order {on['order']} is no permutation of "
                             f"{nb} buckets")
    for i, step in enumerate(on["launches"]):
        order = [b for b, _ in step]
        early = [(b, at) for b, at in step if at is not None]
        want = list(range(nb)) if i == 0 else on["order"]
        log(f"  step {i}: buckets launched in order {order} "
            f"({'plan' if i == 0 else 'agreed'} order: {order == want}); "
            f"launched before backward() returned, as (bucket, leaves of "
            f"{leaves} landed when its hook started it): {early}")
        if order != want:
            raise AssertionError(f"step {i}: launch order {order}, expected {want}")
    for step in off["launches"]:
        if step != [(b, None) for b in range(nb)]:
            raise AssertionError(f"the serial exchange launched {step}, not every "
                                 f"bucket from synchronize in plan order")
    per_step = config.layers * OVERLAP_STEPS
    for label, run in (("hooks off", off), ("hooks on", on)):
        hold_counts(f"{label}, {OVERLAP_STEPS} steps", run["counts"],
                    {k: per_step for k in KERNELS})
        paths[f"20: {OVERLAP_STEPS} steps, {OVERLAP_BUCKETS} buckets, {label}"] = \
            run["counts"]
        log(f"  {label}: {run['buckets']} buckets, median step "
            f"{statistics.median(run['ms'][1:]):.2f} ms (steps 1-{OVERLAP_STEPS - 1}; "
            f"per step {[round(t, 2) for t in run['ms']]}), peak memory "
            f"{run['peak_gb']:.3f} GB, on {card}")
    log(f"  peak memory, hooks on minus off: {on['peak_gb'] - off['peak_gb']:+.3f} GB")
    plan = on["plan"]
    log(f"  (c) record_plan: bucket bytes in issue order "
        f"{[n for _, n in plan['buckets']]}, total {plan['total_bytes']} B, "
        f"occupancy {plan['occupancy']:.4f}, planned bound "
        f"{plan['planned_efficiency']:.4f}")
    rep = dict(on["overlap"])
    spans = rep.pop("spans", [])
    log(f"  measure_overlap, 2 hooked steps: {rep}; first spans {spans[:4]}")
    del runs, off, on
    graph_config = train_mod.TrainConfig(steps_per_dispatch=GRAPH_K)
    log(f"  (b) the graphed loop with the hooks on, K = {GRAPH_K}, against eager "
        f"steps with the hooks on")
    os.environ["HOROVOD_NUM_BUCKETS"] = str(OVERLAP_BUCKETS)
    os.environ["HOROVOD_LATENCY_HIDING"] = "1"
    try:
        captured = graphed_against_eager(torch, fa, rf, basics, train_mod, loop_mod,
                                         bench, graph_config, dev, paths, phase="20")
    finally:
        os.environ.pop("HOROVOD_NUM_BUCKETS")
        os.environ.pop("HOROVOD_LATENCY_HIDING")
    captured, order = captured
    log(f"  captured step's launches (bucket, leaves landed): {captured}")
    if [b for b, _ in captured] != order or sorted(order) != list(range(nb)) or \
            all(at is None for _, at in captured):
        raise AssertionError(f"the captured step did not run the hooked exchange "
                             f"in its agreed order {order}: {captured}")


def config_label(config) -> str:
    return "TrainConfig(sp=1)" if config.sp else "TrainConfig()"


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
    from horovod_tpu_torch import loop as loop_mod
    from horovod_tpu_torch import train as train_mod
    from horovod_tpu_torch import train_cnn as tc
    from horovod_tpu_torch import transformer_benchmark as bench

    t_start = time.perf_counter()
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
    compiled = check_compiled(_build.build)
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
    log(f"  rows with no live key, {NO_LIVE_KEY} (B, T per rank, H, Hkv, my "
        f"rank, source rank), zigzag, bf16, from the initial carries")
    for d in (32, 64, 128):
        check_no_live_key(torch, rf, dev, d)
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

    cnn_config = tc.CNNConfig()
    log(f"[10] ResNet-50 data parallel: {cnn_config}")
    cnn_card_against_cpu(torch, tc, dev)
    cnn_bf16_against_f32(torch, tc, dev)
    log(f"  BatchNorm, bf16 channels-last input, float32 weight: "
        f"{batch_norm_kernel(torch, dev)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    rf.reset_launches()
    cnn_result = tc.train_cnn(cnn_config, STEPS, device="cuda")
    report_cnn_training(torch, tc, dev, cnn_config, cnn_result)
    cnn_counts = {**fa.launches, **rf.launches}
    if any(cnn_counts.values()):
        raise AssertionError(f"the CNN path launched attention kernels: {cnn_counts}")
    basics.shutdown()
    paths = {"4: 5 steps, slice 1": {**{k: counts[k] for k in KERNELS},
                                      **{k: 0 for k in RING_KERNELS}},
             "8: 5 steps, sp=1": sp_counts}

    log(f"[11] long context at seq {LONG_SEQ}: remat + chunked loss "
        f"({LONG_CHUNK}) against the plain step")
    torch.cuda.empty_cache()
    long_context(torch, fa, rf, basics, train_mod, dev, paths)

    log("[12] the bf16 LM head against the float32 head")
    torch.cuda.empty_cache()
    bf16_head(torch, fa, rf, basics, train_mod, dev, paths)

    for config in (train_mod.TrainConfig(steps_per_dispatch=GRAPH_K),
                   train_mod.TrainConfig(sp=1, steps_per_dispatch=GRAPH_K)):
        log(f"[13] the graphed loop, {config_label(config)}, K = {GRAPH_K}: "
            f"{GRAPH_DISPATCHES} dispatches against "
            f"{GRAPH_K * GRAPH_DISPATCHES} eager steps")
        graphed_against_eager(torch, fa, rf, basics, train_mod, loop_mod,
                              bench, config, dev, paths)

    log(f"[14] hierarchical data parallelism: ResNet-50 on the ('dcn', 'ici') "
        f"groups of a world of one, {HIER_THRESHOLD} and 64 MiB bucket caps")
    flat_64 = cnn_result.images_per_step / statistics.median(cnn_result.step_s[1:])
    hierarchical_resnet(torch, tc, basics, card, flat_64)

    log(f"[15] Ulysses on the flash kernels: a virtual world of {ULYSSES_N}")
    shard_timing = ulysses_on_card(torch, fa, rf, ra, dev, timing, paths)

    log(f"[16] sharded data parallelism at full width: ZeRO (HOROVOD_MESH=1x1) "
        f"and FSDP against the flat step, {SHARD_STEPS} steps each")
    sharded_phase(torch, fa, rf, basics, train_mod, card, dev, paths)

    log(f"[17] tensor parallelism: a model group of one against the flat step, "
        f"{TP_STEPS} steps each; a virtual model group of {TP_N}")
    tensor_parallel(torch, fa, rf, basics, train_mod, card, dev, paths)

    log(f"[18] the full-width MoE TransformerLM, {MOE_EXPERTS} experts in every "
        f"{MOE_EVERY}nd block: {STEPS} steps; against dense attention; the layer")
    mixture_of_experts(torch, fa, rf, basics, train_mod, card, dev, paths)

    log(f"[19] pipeline parallelism at full width: a pp group of one against the "
        f"flat step ({PP_STEPS} steps; n_micro 1 and {PP_MICRO}); a virtual pp "
        f"of {PP_N}")
    pipeline_parallel(torch, fa, rf, basics, train_mod, card, dev, paths)

    log(f"[20] the gradient exchange from the gradient hooks "
        f"(HOROVOD_LATENCY_HIDING=1, {OVERLAP_BUCKETS} buckets) against the serial "
        f"exchange, {OVERLAP_STEPS} steps each; the graphed loop with the hooks on")
    overlap_phase(torch, fa, rf, basics, train_mod, loop_mod, bench, card, dev, paths)

    kernels = []
    for source, names in SOURCES.items():
        for kname in names:
            replaces = {**KERNELS, **RING_KERNELS}[kname][0]
            row = {"name": kname, "route": "cuda",
                   "source": f"horovod_tpu_torch/csrc/{source}",
                   "replaces": replaces, "launches": counts[kname],
                   "max_abs_err": errs[kname], **timing[kname],
                   "launches_by_path": {p: c[kname] for p, c in paths.items()}}
            if kname in shard_timing:
                row["ulysses_head_shard"] = shard_timing[kname]
            if kname in compiled:   # bf16 runs on flash_tc.cuh's tensor-core kernel
                row["bf16_kernel"] = {"header": "horovod_tpu_torch/csrc/flash_tc.cuh",
                                      "compiled": compiled[kname]}
            kernels.append(row)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
