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
21. checkpoint and resume of the full-width model (world of one over
    NCCL; checkpoints in a temporary directory, deleted after each part):
    (a) 3 steps, ``checkpoint.save``, a fresh run drawn from seed 1,
    ``restore`` in place into its live tensors, the broadcasts, 3 steps,
    against 6 steps that never stopped: every loss, parameter and Adam
    moment bit-equal, B1-B3 12 launches a step; (e) ``export_for_inference``
    of that state (Adam dropped), loaded by ``load_for_inference`` in a
    fresh ``python3 -c`` process that never calls ``init()``: its logits
    bit-equal to the trainer's forward; (d) the commit's costs: bytes on
    disk, ``save`` and ``restore`` seconds, the digest's seconds,
    ``AsyncCheckpointer.submit``'s
    stall against its background commit, 3 steps with the commit in flight
    against 3 without, and the async commit restored bit-equal to the
    synchronous one; (b) the graphed loop (``steps_per_dispatch=4``): 1
    dispatch, a checkpoint with the ``DeviceCache`` counter, a seed-1 run
    captured first and restored in place after the capture, 1 dispatch,
    against 2 dispatches, bit-equal; (c) ``TrainConfig(sharded=True)`` at
    ``HOROVOD_MESH=1x1``, 3 steps, ``save_sharded``, restored into the flat
    run, 3 steps, bit-equal to the flat run of (a);
22. tuning and measurement of the training path at full width (world of
    one over NCCL): (a) ``autotune.tune`` through ``train.TuneStepFactory``
    over fusion thresholds 4 and 64 MiB x 1 and 4 buckets x wires
    "none" and "bf16", one GP/EI round, each candidate's step captured in
    a CUDA graph (K = 4): the knob curve, the best config, each
    candidate's bucket count (held to the fusion plan), peak memory (held
    within 1 GB of the first's, and the memory allocated after the sweep
    within 0.1 GB of before it), B1-B3's launches at each capture, and the
    first dispatch's losses ("none" bit-equal, each bf16 candidate within
    1e-2 and not equal, its buckets at bf16); (b)
    ``control.TrainingController`` driving ``train.TrainRecapture`` for 12
    windows of one dispatch (canary 2, no cooldown): each decision with its
    recapture time, at least one held, and the 12 windows' losses
    bit-equal to the same loop with no controller; (c)
    ``utils/roofline.profile_device_ops`` of the eager step and of the
    graphed dispatch (``format_report``, the peaks read from the device
    with their inputs, B1-B3's FLOPs counted from their launches and held
    to their shapes', a trace that holds fewer of B1-B3's kernels than ran
    taken again, up to 3 times, the whole step's share of the device-read bf16
    peak), and ``utils/timeline.trace`` over one graphed dispatch, whose
    Chrome trace names B1-B3's kernels or is said not to; (d)
    ``tune(mesh_shapes=("1x1",))``, ZeRO through the factory, eager, 3
    steps a call, bit-equal to the flat candidate, eager on the same plain
    Adam;
23. the launcher and elastic training (world of one over NCCL): the run
    that never stopped, in this process (``train.setup``, 5 steps of phase
    4's model and batch, losses held to phase 4's bit for bit, parameters
    kept on the host); ``python -m horovod_tpu_torch.runner --check-build``
    printed; (a) ``python -m horovod_tpu_torch.runner -np 1 -- python
    chip_smoke.py --launched-worker ...`` (``run_command``, the CLI's
    path): the worker's ``init()`` from the launcher's env and 3 steps of
    the same model, its losses bit-equal to the first 3, its B1-B3
    launches, the seconds from the launch to its exit, run beside (b); (b)
    ``run_elastic(num_proc=1)`` of ``elastic_worker``: the model, its
    ``DistributedOptimizer`` and ``step`` in an
    ``ElasticState(checkpoint_dir=...)`` with a checkpoint every 3rd
    commit, the worker killed at step 2's commit, after its checkpoint
    (``HOROVOD_FAULT_INJECT_STEP``), respawned by the driver (blacklist
    threshold 2), cold-started by ``load_checkpoint()``: it must resume
    from step 2 (raising at 0), its remaining losses and final parameters
    bit-equal to the run that never stopped; the commits' seconds (the
    host snapshot of 216,556,544 parameters and Adam's moments), the
    driver's generations, the failure-to-resumed seconds, the phase's
    seconds;
24. observability of the training path (world of one over NCCL, full
    width): (a) 3 eager steps untraced, then 3 from the same weights and
    batch with ``HOROVOD_TRACE_DIR``, ``HOROVOD_FLIGHT_DIR`` and
    ``HOROVOD_METRICS_PORT`` set: losses and parameters bit-equal; the span
    file holds ``grad.<b>#<k>`` of every bucket and step with its
    ``enqueue``, ``wire`` and ``done`` spans, each ``wire`` span inside its
    step's host window; ``merge_trace`` writes strict JSON;
    ``/metrics``, fetched over HTTP before and after the steps, moves
    ``horovod_collective_bytes_total{op="allreduce"}`` by 3 x the plan's
    bucket bytes and ``horovod_collectives_total`` by 3 x its buckets,
    and its plan gauges are the optimizer's plan; ``read_ring`` decodes
    the ring; the traced and untraced step ms and the per-bucket device ms
    printed; (b) the graphed loop (K = 4, 2 dispatches) untraced and traced:
    losses bit-equal, one compiled-plan line for the capture, no span
    line and no counter moving while the graph replays;
25. the serving plane on the card (``horovod_tpu_torch.serving``): (a)
    TinyLM at the TransformerLM's widths (vocab 32000, dim 1024,
    max_context 4096, seed 0: 291,504,128 B of float32 weights), the
    port's ``lm_generate`` on the card against the CPU on 8 prompts of
    1-512 tokens, 32 new each (logits within 1e-4 x max|logit| up to the
    first position where the tokens part, which must be a near-tie: a
    top-2 gap under that tolerance), ``_gemm_rows_exact`` on the card, and
    ``IterationScheduler`` over a ``PagedKVCache`` of 36 blocks of 16 on
    the card (preemption forced), plain, ``draft_k=4`` and
    ``prefix_cache=1``, each sequence's tokens and K/V bitwise the card's
    oracle, with decode tok/s, TTFT and TPOT p50/p99 and the spec
    acceptance; (b) ``LLMServer`` over HTTP in a router process of its own
    (``--serving-router``): one prefill and one decode replica on the
    card, 16 concurrent ``/v1/generate`` requests, then 16 more with the
    decode replica killed at its 24th submit (``HOROVOD_FAULT_INJECT_STEP``),
    then the colocated plane with a streamed body; every token stream the
    card's oracle, handoff bytes equal to ``handoff_nbytes``, every
    replica's ``stats`` on ``cuda`` with TF32 off, and no CUDA context in
    the router; (c) ``InferenceServer``, two replicas on the card, an
    exported ``MLP`` on 64-wide inputs at ``decode_steps`` 1 ((256, 128,
    10)) and 4 ((256, 128, 64): each step feeds the next), 64 concurrent
    ``/v1/infer`` requests, each response bitwise the in-process eager
    forward (K times) at a padding bucket, with the captures per replica;
26. the pod-scale trees (``horovod_tpu_torch.ctrl``, ``.telemetry``,
    ``.ckpt_async.stream``), with fake hosts ``a`` and ``b`` (hvd-agent
    processes with ``HOROVOD_HOSTNAME`` set): (a) phase 4's model trained
    2 steps and committed with ``checkpoint.save``, then on to 5 (the run
    that never stopped); host a's control leader exports the commit; a
    fresh process given only ``HOROVOD_SECRET`` and
    ``HOROVOD_CKPT_STREAM_FROM`` times the leader's manifest, streams the
    checkpoint with ``fetch_from_peer`` into a directory of its own,
    restores it in place on the card into a seed-1 run and runs steps 3-5:
    every streamed file's SHA-256 the committed one's, its losses and the
    SHA-256 of every parameter and Adam moment the straight run's; fetch
    seconds, GB/s, chunks, manifest seconds; (b) 25c's MLP (decode_steps
    1) served by ``InferenceServer`` from a path the router does not have,
    streamed from host a's leader before the first replica: each response
    bitwise the in-process forward at a bucket, the bring-up seconds with
    the fetch inside; (c) phase 24's traced eager run (3 steps) pushing a
    snapshot each step through a ``RankTelemetryClient`` to a
    ``TelemetryAgent`` of host a whose root is a ``DriverService``: losses
    and parameters bit-equal to phase 24's untraced run, the root's pod
    view of the allreduce counters equal to the rank's registry (moved by
    3 x the plan's bytes) and bitwise the flat merge, the push bytes per
    tick (full, then deltas), the composed clock offset, and ``bundle
    --leader`` sweeping that run's flight ring and spans with no coverage
    gap; (d) ``run_command`` of 4 workers across hosts a and b (2 slots
    each) sharing cuda:0, each a world of one (``init(comm=[rank])``)
    running 23a's worker for 3 steps, with ``HOROVOD_CTRL_TREE`` unset
    (the tree on): every worker's losses phase 4's first 3, each dialing
    its host's leader; one request and one wait connection per host at
    the driver and each host's registrations in one ``host_register``;
    the driver's control bytes (the flat plane runs in every one-host
    launch: 23a, 27a, 28a, 30);
27. the eager engine (``common/engine.py``: negotiated host collectives;
    every world pins ``HOROVOD_ENGINE=python``), with the CPU model printed beside the card's line, since its times are
    host times: (a) ``examples/torch_mnist_eager.py`` under the launcher's
    CLI at ``-np 2``, both ranks on ``cuda:0`` (``HOROVOD_DEVICE_ORDINAL=0``;
    the example issues no ``torch.distributed`` collective), 2 epochs of
    8 steps: every rank's final parameters bitwise equal, step 1's
    averaged gradient leaves bitwise ``_ring_order_reduce`` of the two
    ranks' local leaves, a finite and falling loss, rank 0's host pane
    (``timeline.trace``) holding every ``grad.*`` name; (b) a launched
    world of 4 processes on this machine (``init(device="cpu")``,
    ``tests/torch_port_engine_world_worker.py``) allreducing a 64 MiB
    float32 tensor and 32 small ones, enqueued in a different order on each
    rank, on the ring and then on the star plane, under the none, fp16,
    bf16 and topk wires (a fresh engine each; on the star the big tensor
    under none only), cold and cached: every result's SHA-256 the
    canonical oracle's (the port's ``_ring_order_reduce`` over every
    rank's seeded payloads, computed here meanwhile), the ring's GB/s (3
    synchronous allreduces of the big tensor per wire), the control bytes
    per exchange cold and cached, the cache hits, and gloo's
    ``torch.distributed`` allreduce of the same tensors; (c) the same
    world across fake hosts a:2 and b:2 (hvd-agents, as in 26d) through
    the control tree, each host's ranks dialing their leader's
    ``CoordRelay``, run while (a) runs: on the flat ring (the big tensor
    under none only) every result bitwise (b)'s, on the two-level plane
    the two-level order's oracle (the grid reduces in another order, so
    its bits are not the flat ring's), and 2 control connections at the
    coordinator against (b)'s 4; each rank counts its attention-kernel
    launches, and no rank launches any;
28. the native eager engine (``horovod_tpu_torch/cc``: the C++ core,
    built from ``cc/src`` by g++ beside the two nvcc at the start, and
    ``NativeEngine``), every world under ``HOROVOD_ENGINE=native!`` (no
    fallback), with the CPU model, the card's line and ``/dev/shm``'s
    size: (a) 27a's eager MNIST and its checks on the native engine, each
    rank reporting ``NativeEngine``; (b) 27b's world on the ring
    (``HOROVOD_FUSION_THRESHOLD=0`` in b and c: a fused bucket folds in
    the bucket's chunk order, not each tensor's), with the
    same-host shm links on (2 per rank; the big tensor under none only,
    the small ones under every wire) and off (``HOROVOD_SHM=0``, none and
    bf16): every result's SHA-256 27b's oracle's, 3 synchronous 64 MiB
    allreduces under none and bf16, the cache hits, printed beside 27b's Python ring and gloo; (c)
    the same world across fake hosts a:2 and b:2 on the flat ring and the
    two-level plane (the grid oracle; the big tensor under none only on
    both, the small ones under every wire), and a ragged allgather flat and
    two-stage (``hierarchical_allgather``), bitwise equal, each two-level
    run's cross-host ring bytes (``hvd_ring_cross_bytes_sent``) below the
    flat run's; (d) ``examples/torch_engine_benchmark.py`` at ``-np 4``,
    float32 and bf16, 100 MB over 160 tensors, 3 steps: GB/s; each rank
    counts its attention-kernel launches, and no rank launches any;
29. the real-data input path at full width (``train_cnn`` fed from a
    ``DeviceCache``; ResNet-50, 224 x 224 x 3, 128 images, bf16
    channels-last): a 4,096-image uint8 dataset written by
    ``examples/torch_realdata_benchmark.py``'s ``ensure_dataset`` and its
    shard on the card (616,562,688 B); the input layer alone (the cache's
    draw on the card, CUDA events; the stream's host gather and its upload
    with the cast, host clock); (a) ``train_cnn.make_cnn_scan_loop``, K = 4:
    warm-up, capture, 2 dispatches against 8 eager cache steps from the
    same weights on the same draws, every loss, parameter, momentum buffer
    and BatchNorm statistic within 1e-6 relative (bit-equality expected and
    reported), no attention kernel launched; (b) the example's ``--json``
    in this process, all four modes (synthetic, stream, device-cache,
    device-cache-scan): img/s and the gaps, every loss finite (the example
    fails on one that is not), the JSON keys the JAX example's;
30. ``examples/torch_scaling_benchmark.py`` in a process of its own, every
    section: (a) native-engine worlds of 2/4/8 on this host (16 dropped
    above the host's 8 CPUs, and named), every rank's buffer of ones
    reduced to exactly the world; the two-level ring at 8 (4 + 4), its
    worst rank's cross-host bytes strictly below flat's; (b) the
    ``DistributedOptimizer`` step of a 2-layer TransformerLM over gloo in
    worlds of 1/2/4 processes and over NCCL in a world of 1 (2 and 4
    reported not run on one card), 1 against 2 processes through
    ``run_command``, ``num_buckets`` 1 against 2/4/8 on gloo world 4; (c)
    the H100 projection fed phase 10's measured step; every worker counts
    its own attention-kernel launches: none;
31. the ``{"kernels": [...]}`` line (all six kernels, each with its
    launches on every path above; phases 10, 14, 25, 27, 28, 29 and 30 run
    none of them), then ``{"ok": true, ...}`` last.

Both CUDA sources build at once, one nvcc each, at the start, beside the
native core's g++.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

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
    # name: the TPU kernel it replaces
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:53",
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:96",
    "flash_bwd_dkv": "horovod_tpu/ops/flash_attention.py:131",
}
RING_KERNELS = {
    "ring_flash_fwd": "horovod_tpu/ops/ring_flash.py:65",
    "ring_flash_bwd_dq": "horovod_tpu/ops/ring_flash.py:106",
    "ring_flash_bwd_dkv": "horovod_tpu/ops/ring_flash.py:137",
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
# Every built tile pair of the bf16 kernels (ops/flash_attention.py
# TILE_PAIRS, at head dim 128 alone) against the plain versions, phases 3
# (B1-B3) and 7 (B4-B6): the bf16 check shapes above at D = 128 (the
# layer; GQA; a ragged T, non-causal) and a ragged causal T, whose tiles
# of 64 and 128 rows straddle the diagonal and the tail apart.
PAIR_SHAPES = [
    (*SLICE_SHAPE, True, "bfloat16"),
    (1, 1024, 8, 2, 128, True, "bfloat16"),
    (2, 96, 4, 2, 128, False, "bfloat16"),
    (2, 200, 4, 2, 128, True, "bfloat16"),
]
PAIR_RING_SHAPES = [
    (1, 4096, 8, 8, 128, "bfloat16"),
    (1, 1024, 8, 2, 128, "bfloat16"),
    (2, 96, 4, 2, 128, "bfloat16"),
]
# Where every built pair is timed: the layer and its Ulysses head shard of
# 4 (phase 15's), (B, T, H, Hkv, D).
TILE_TIMING_SHAPES = [(1, 4096, 8, 8, 128), (1, 4096, 2, 2, 128)]
# Rank 0 of a zigzag ring of 4 against rank 1's block, T 96 per rank in
# stripes of 48: rank 0's low stripe (positions 0-47) sees none of rank 1's
# keys (48-95 and 288-335). (B, T per rank, H, Hkv, my rank, source rank)
NO_LIVE_KEY = (2, 96, 4, 2, 0, 1)


# A phase's or sub-phase's heading ("[4] ...", "  (22a) ...") is printed
# with the seconds since main() started, which sets this.
_STARTED = []


def log(msg: str) -> None:
    if _STARTED and re.match(r"\s*(\[\d+\]|\(\d+[a-z]\)) ", msg):
        msg = f"{msg} (at {time.perf_counter() - _STARTED[0]:.1f} s)"
    print(msg, flush=True)


# The tensor-core kernels of csrc/flash_tc.cuh: (template, variant, the
# kernel of the kernels line it runs for, the source whose library holds
# it). Each template takes the head dim, the variant of
# csrc/flash_kernels.cuh (0 kFlash, B1-B3; 3 kRing, B4-B6) and its tile
# pair (q extent, k extent): one instance per built pair.
TC_KERNELS = [
    ("fwd_tc_kernel", 0, "flash_fwd", "flash_attention.cu"),
    ("dq_tc_kernel", 0, "flash_bwd_dq", "flash_attention.cu"),
    ("dkv_tc_kernel", 0, "flash_bwd_dkv", "flash_attention.cu"),
    ("fwd_tc_kernel", 3, "ring_flash_fwd", "ring_flash.cu"),
    ("dq_tc_kernel", 3, "ring_flash_bwd_dq", "ring_flash.cu"),
    ("dkv_tc_kernel", 3, "ring_flash_bwd_dkv", "ring_flash.cu"),
]
# A mangled instance: the head dim, the variant, the q and k extents.
TC_NAME = re.compile(r"(" + "|".join(sorted({k[0] for k in TC_KERNELS}))
                     + r")ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EE")


def tc_label(template, d, variant, bq, bk) -> str:
    """An instance's name, from TC_KERNELS or from TC_NAME's groups."""
    return f"{template}<{d}, {variant}, {bq}, {bk}>"


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


def check_compiled(torch, fa, build) -> dict:
    """The compiled report of every tensor-core kernel at every head dim
    and built tile pair, each read from its own library's; {kernel of the
    kernels line: {instance: entry}}. Raises if an instance is missing,
    spills, or has no HGMMA or no UTMALDG, or if a library holds an
    instance that ``fa.TILE_PAIRS`` does not list."""
    reports = {src: compiled_report(build(src)) for src in {k[3] for k in TC_KERNELS}}
    by_kernel, want = {}, {src: set() for src in reports}
    for template, variant, kname, src in TC_KERNELS:
        for d in (32, 64, 128):
            for bq, bk in fa.built_pairs(kname, d, torch.bfloat16):
                label = tc_label(template, d, variant, bq, bk)
                want[src].add(label)
                e = reports[src].get(label, {})
                log(f"  {label:32s} {src:18s} registers {e.get('registers')} spill "
                    f"bytes {e.get('spill_bytes')} HGMMA {e.get('HGMMA')} UTMALDG "
                    f"{e.get('UTMALDG')} USETMAXREG {e.get('USETMAXREG')}")
                if not e.get("HGMMA") or not e.get("UTMALDG"):
                    raise AssertionError(f"{label}: no wgmma or no TMA load in its SASS: {e}")
                if e.get("spill_bytes") != 0:
                    raise AssertionError(f"{label}: spills {e.get('spill_bytes')} bytes")
                by_kernel.setdefault(kname, {})[label] = e
    for src, report in reports.items():
        if set(report) != want[src]:
            raise AssertionError(f"{src}: instances {sorted(set(report) ^ want[src])} "
                                 f"differ from ops/flash_attention.py's TILE_PAIRS")
    return by_kernel


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_plain(torch, fn) -> float:
    """``time_ms`` of a plain version, which takes milliseconds a call: the
    median of 10 single calls (a launch's host cost is lost in them)."""
    return time_ms(torch, fn, reps=10, warmup=1, inner=1)


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


def bound(entry, dtype_name):
    """(FLOPs, ms, 'bytes' | 'operations') of one launch: the least time
    the card could take for it. ``entry`` is a ``launch_log`` entry (the
    kernel, its q and kv rows, T, D, the itemsize, and causal or the ring
    step's (q, k) positions); ``roofline.launch_cost`` counts its operations,
    2 per multiply-add over the live (q, k) pairs of each product, and its
    bytes, each input read once and each output written once."""
    from horovod_tpu_torch.utils.roofline import launch_cost

    _, f, moved = launch_cost(entry)
    t_ops = f / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return (f, t_ops, "operations") if t_ops >= t_bytes else (f, t_bytes, "bytes")


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
        ms, plain_ms = time_ms(torch, kernel), time_plain(torch, plain)
        single_ms = time_ms(torch, kernel, inner=1)
        f, bound_ms, bound_by = bound((name, b * h, b * hkv, t, d, itemsize, causal),
                                      dtype_name)
        tflops = f / ms / 1e9
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


def tile_ceilings(fa) -> list:
    """Every built pair of every kernel as (block_q, block_k) ceilings,
    largest first: a kernel built for the pair runs it itself."""
    return sorted({p for pairs in fa.TILE_PAIRS.values() for p in pairs}, reverse=True)


def hold_covered(torch, label, fa, names, covered) -> None:
    """Raise unless ``covered`` holds every built pair at D = 128 of each
    kernel of ``names``."""
    want = {(n, p) for n in names
            for p in fa.built_pairs(n, fa.TILE_HEAD_DIM, torch.bfloat16)}
    if want - covered:
        raise AssertionError(f"{label}: pairs never run {sorted(want - covered)}")


def check_pairs(torch, fa, dev, shape) -> set:
    """B1-B3 at every built tile pair against their plain versions on the
    same inputs (phase 2's rules); returns the (kernel, pair) run."""
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
    covered = set()
    for bq, bk in tile_ceilings(fa):
        eff = fa.effective_blocks(t, d, dtype, bq, bk)
        o_k, lse_k = fa.flash_fwd(qr, kr, vr, h, hkv, causal, bq, bk)
        dq_k = fa.flash_bwd_dq(qr, kr, vr, dor, lse_p, delta, h, hkv, causal, bq, bk)
        dk_k, dv_k = fa.flash_bwd_dkv(qr, kr, vr, dor, lse_p, delta, h, hkv, causal, bq, bk)
        torch.cuda.synchronize()
        errs = {}
        for name, label, got, want in (
                ("flash_fwd", "O", o_k, o_p), ("flash_fwd", "L", lse_k, lse_p),
                ("flash_bwd_dq", "dQ", dq_k, dq_p), ("flash_bwd_dkv", "dK", dk_k, dk_p),
                ("flash_bwd_dkv", "dV", dv_k, dv_p)):
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name} {label} at {eff[name]}: non-finite output")
            noise_rows = [0] if causal and label == "dQ" else ()
            e = check(torch, f"{name} {label} {eff[name]}", got, want, quiet=True,
                      noise_rows=noise_rows)
            errs[name] = max(errs.get(name, 0.0), e)
            covered.add((name, eff[name]))
        log(f"  ceilings {bq}/{bk}: " + ", ".join(
            f"{n} {eff[n][0]}/{eff[n][1]} max_abs_err {e:.3e}" for n, e in errs.items()))
    return covered


def pair_row(torch, name, call, entry, dtype_name) -> dict:
    """``time_ms`` of one kernel at one pair (runs of 10 and single calls)
    beside its bound."""
    ms, single_ms = time_ms(torch, call), time_ms(torch, call, inner=1)
    f, bound_ms, bound_by = bound(entry, dtype_name)
    return {"ms": ms, "single_ms": single_ms, "tflops": f / ms / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms}


def log_pair(label, r) -> None:
    log(f"    {label:34s} {r['ms']:8.4f} ms (single {r['single_ms']:.4f})  "
        f"{r['tflops']:6.1f} TFLOP/s  {100 * r['bound_share']:5.2f}% of the "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def time_pairs(torch, fa, dev, shape, card) -> dict:
    """B1-B3 at every built pair, bf16, causal, at ``shape`` (B, T, H, Hkv,
    D; multi-head), with PyTorch's fused attention beside them as the
    yardstick: {kernel: {"q/k": row}, "sdpa": {...}}."""
    import torch.nn.functional as F

    b, t, h, hkv, d = shape
    gen = torch.Generator(device=dev).manual_seed(77)
    q, k, v, g = (torch.randn(b, t, hh, d, generator=gen, device=dev).to(torch.bfloat16)
                  for hh in (h, hkv, hkv, h))
    qr, kr, vr, dor = fa._rows(q), fa._rows(k), fa._rows(v), fa._rows(g)
    o, lse = fa.flash_fwd(qr, kr, vr, h, hkv, True)
    delta = (dor.float() * o.float()).sum(-1)
    log(f"  every built pair at {shape} (B, T, H, Hkv, D), bf16, causal; {card}")
    out = {}
    for name in KERNELS:
        for bq, bk in fa.built_pairs(name, d, torch.bfloat16):
            call = {
                "flash_fwd": lambda: fa.flash_fwd(qr, kr, vr, h, hkv, True, bq, bk),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq(qr, kr, vr, dor, lse, delta, h,
                                                        hkv, True, bq, bk),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(qr, kr, vr, dor, lse, delta, h,
                                                          hkv, True, bq, bk),
            }[name]
            r = pair_row(torch, name, call, (name, b * h, b * hkv, t, d, 2, True),
                         "bfloat16")
            out.setdefault(name, {})[f"{bq}/{bk}"] = r
            log_pair(f"{name} {bq}/{bk}", r)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (qs, ks, vs))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    out["sdpa"] = {
        "fwd_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)),
        "bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), dor.view(b, h, t, d), retain_graph=True))}
    log(f"    yardstick scaled_dot_product_attention: fwd "
        f"{out['sdpa']['fwd_ms']:.4f} ms, bwd {out['sdpa']['bwd_ms']:.4f} ms "
        f"(dQ, dK, dV together)")
    return out


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


def check_ring_shape(torch, rf, ra, dev, shape, zigzag, tiles=(None, None)):
    """Each ring kernel against its plain version at every step of a
    virtual ring, on the same inputs and the same carries (the ones the ring
    has built so far, carried on from the plain version), the kernels at
    the tile ceilings ``tiles``. Returns the max abs error per kernel."""
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
        rf.rf_fwd(qr, kr, vr, *got, pos[r], pos[src], h, hkv, *tiles)
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
        rf.rf_bwd_dq(*args, got, h, hkv, *tiles)
        hold("ring_flash_bwd_dq", "dQ", got, want)
        dq[r] = want
        want = [c.clone() for c in dkv[src]]
        got = [c.clone() for c in dkv[src]]
        rf.rf_dkv_plain(*args, *want, h, hkv)
        rf.rf_bwd_dkv(*args, *got, h, hkv, *tiles)
        for label, g, w in zip(("dK", "dV"), got, want):
            hold("ring_flash_bwd_dkv", label, g, w)
        dkv[src] = want
    torch.cuda.synchronize()
    note = "" if tiles == (None, None) else f"ceilings {tiles[0]}/{tiles[1]}: "
    log(f"  {note}{len(steps)} ring steps, every kernel within its limit; max abs "
        f"err {errs}")
    return errs


def check_ring_pairs(torch, fa, rf, ra, dev) -> None:
    """B4-B6 at every built tile pair against their plain versions at every
    step of the virtual ring, PAIR_RING_SHAPES, contiguous and zigzag."""
    covered = set()
    for shape in PAIR_RING_SHAPES:
        for zigzag in (False, True):
            log(f"  shape (B, T per rank, H, Hkv, D, dtype) = {shape}, "
                f"{'zigzag' if zigzag else 'contiguous'}")
            b, t, h, hkv, d, dtype_name = shape
            for tiles in tile_ceilings(fa):
                eff = fa.effective_blocks(t, d, getattr(torch, dtype_name), *tiles)
                check_ring_shape(torch, rf, ra, dev, shape, zigzag, tiles)
                covered |= {(n, eff[n]) for n in RING_KERNELS}
            torch.cuda.empty_cache()
    hold_covered(torch, "7: B4-B6", fa, RING_KERNELS, covered)


def time_ring_pairs(torch, fa, rf, dev, shape, card) -> dict:
    """B4-B6 at every built pair on a diagonal and a past ring step of a
    contiguous ring of RING_N at ``shape`` (B, T per rank, H, Hkv, D), bf16:
    {kernel: {"q/k": {"diagonal": row, "past": row}}}."""
    b, t, h, hkv, d = shape
    (qr, kr, vr, dor), = ring_rows(torch, dev, (*shape, "bfloat16"), seed=7)[:1]
    lse = torch.rand(b * h, t, device=dev) + 5.0
    delta = torch.randn(b * h, t, device=dev)
    log(f"  every built pair at {shape} (B, T per rank, H, Hkv, D), bf16; {card}")
    out = {}
    for step, (my, src) in (("diagonal", (1, 1)), ("past", (1, 0))):
        qpos = rf.ring_positions(my, t, RING_N, False, dev)
        kpos = rf.ring_positions(src, t, RING_N, False, dev)
        acc, m, l = rf.init_carries(b * h, t, d, dev)
        dq = torch.zeros(b * h, t, d, device=dev)
        dk, dv = (torch.zeros(b * hkv, t, d, device=dev) for _ in range(2))
        bwd = (qr, kr, vr, dor, lse, delta, qpos, kpos)
        for name in RING_KERNELS:
            for bq, bk in fa.built_pairs(name, d, torch.bfloat16):
                call = {
                    "ring_flash_fwd": lambda: rf.rf_fwd(qr, kr, vr, acc, m, l, qpos, kpos,
                                                        h, hkv, bq, bk),
                    "ring_flash_bwd_dq": lambda: rf.rf_bwd_dq(*bwd, dq, h, hkv, bq, bk),
                    "ring_flash_bwd_dkv": lambda: rf.rf_bwd_dkv(*bwd, dk, dv, h, hkv,
                                                                bq, bk),
                }[name]
                r = pair_row(torch, name, call,
                             (name, b * h, b * hkv, t, d, 2, (qpos, kpos)), "bfloat16")
                out.setdefault(name, {}).setdefault(f"{bq}/{bk}", {})[step] = r
                log_pair(f"{step} {name} {bq}/{bk}", r)
    return out


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
            ms, plain_ms = time_ms(torch, kernel), time_plain(torch, plain)
            single_ms = time_ms(torch, kernel, inner=1)
            f, bound_ms, bound_by = bound(
                (name, b * h, b * hkv, t, d, itemsize, (qpos, kpos)), dtype_name)
            tflops = f / ms / 1e9
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
# same weights (put back in place after the graphed run), with the same
# capturable Adam: the same kernels in the same order, so bit-equality is
# expected; every loss and parameter is held to 1e-6 relative
# (``graph_pair``, which phases 16, 19 and 20 share).
GRAPH_K, GRAPH_DISPATCHES, GRAPH_LIMIT = 4, 2, 1e-6
# Profiles of one window taken before a trace that keeps losing kernel
# records fails the phase.
PROFILE_TRIES = 3


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


def graphed_against_eager(torch, fa, rf, basics, train_mod, loop_mod, config,
                          dev, card, paths, phase="13", keep=None) -> list:
    """``graph_pair`` of ``setup(config)``: its graphed dispatches against
    as many eager steps, and the tokens/s of each. Returns the captured
    step's ``last_launches`` (the exchange's buckets, in launch order, with
    whether a hook started each) and the optimizer's ``launch_order``.
    ``keep``, a dict, receives the graphed run's ``losses`` and ``params``
    (on the host): phase 16 holds the graphed ZeRO step to them."""
    box = {}

    def build():
        s = train_mod.setup(config, "cuda")
        box["tokens"], snapped = s.tokens_per_step, []

        def snapshot():
            # First after the replays, which run no Python: the capture's
            # launches are still the optimizer's last.
            if not snapped:
                snapped.append((s.opt.last_launches, s.opt.launch_order))
            return {n: p.detach().cpu() for n, p in s.model.named_parameters()}

        box["captured"] = snapped
        return (s.step, train_mod.make_cache(config, s.sp, dev), s.opt, snapshot,
                {"all_reduce": s.opt.plan.num_buckets})

    g, e = graph_pair(torch, fa, rf, basics, loop_mod, config_label(config),
                      build, dev, card, paths, phase,
                      {k: config.layers for k in (RING_KERNELS if config.sp
                                                  else KERNELS)})
    if keep is not None:
        keep.update(losses=g["losses"], params=g["params"])
    tokens = box["tokens"]
    graph_ms, eager_ms = statistics.median(g["ms"]), statistics.median(e["ms"][1:])
    log(f"  tokens/s: eager {1e3 * tokens / eager_ms:.1f} ({eager_ms:.2f} ms a "
        f"step, median of steps 1-{len(e['ms']) - 1}, each synced), graphed "
        f"{1e3 * tokens / graph_ms:.1f} ({graph_ms:.2f} ms a step, median of "
        f"{GRAPH_DISPATCHES} dispatches over {GRAPH_K})")
    return box["captured"][0]


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
                dev, cube=None) -> dict:
    """SHARD_STEPS steps of ``config`` (``label`` "FSDP": through
    ``setup_fsdp``; ``cube``, a ``sharded_groups`` shape: through
    ``setup(layout=)``) on one repeated batch: losses, step ms, peak
    memory, the collectives of step 1 (and those on the model group),
    B1-B6's launches (counts zeroed just before the steps), the
    parameters after the last step (on the host) and the planned
    per-rank bytes."""
    import torch.distributed as dist
    from horovod_tpu_torch.parallel.mesh import sharded_groups

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    if label == "ZeRO":
        os.environ["HOROVOD_MESH"] = "1x1"
    try:
        if label == "FSDP":
            s = train_mod.setup_fsdp(config, device="cuda")
        elif cube is not None:
            basics.init("cuda")
            s = train_mod.setup(config, "cuda", layout=sharded_groups(*cube))
        else:
            s = train_mod.setup(config, "cuda")
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
    if cube is not None:
        run["on_model"] = counter.on(s.layout.model_group)
        run["tp"] = s.model.tp_size
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


def sharded_phase(torch, fa, rf, basics, train_mod, card, dev, paths) -> dict:
    """Phase 16's eager runs; returns the flat one, which phase 17 holds
    the cube of one to."""
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
    return runs["flat"]


# Phase 16, graphed, and phase 19, graphed. One CUDA graph of each sharded
# or pipelined step, replayed GRAPH_DISPATCHES x GRAPH_K times, against
# GRAPH_DISPATCHES x GRAPH_K eager steps of the same setup (the same
# capturable Adam) on the same cache draws: held to phase 13's rule (every
# loss and parameter within GRAPH_LIMIT relative, bit-equal expected and
# printed). The collectives of ``torch.distributed`` are counted while the
# step is captured and while it is replayed (a replay runs no Python, so
# none), as are B1-B3's launches.
SHARD_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                     "reduce_scatter_tensor", "batch_isend_irecv")


def graph_errors(graph_losses, graph_state, eager_losses, eager_state) -> tuple:
    """Phase 13's readings of a graphed run against its eager run: the
    largest relative loss error, ``(name, error)`` of the state tensor
    farthest off (``max|graphed - eager| / max|eager|``), and whether both
    are bit-equal."""
    loss_err = max(abs(g - w) / abs(w) for g, w in zip(graph_losses, eager_losses))
    worst = ("", 0.0)
    for name, w in eager_state.items():
        err = (graph_state[name].double() - w.double()).abs().max().item() / \
            max(w.double().abs().max().item(), 1e-30)
        worst = max(worst, (name, err), key=lambda x: x[1])
    equal = graph_losses == eager_losses and all(
        torch_equal(graph_state[n], w) for n, w in eager_state.items())
    return loss_err, worst, equal


def hold_graph_pair(label, graph, eager, bit_equal_required=False) -> None:
    """Phase 13's rule on two runs' losses and parameters (on the host)."""
    loss_err, (name, err), equal = graph_errors(graph["losses"], graph["params"],
                                                eager["losses"], eager["params"])
    log(f"  {label}: losses {graph['losses']} vs {eager['losses']}; largest "
        f"difference: loss {loss_err:.3e} relative, parameter {name} {err:.3e} "
        f"of its max (limit {GRAPH_LIMIT:g}); bit-equal: {equal}")
    if not (all(math.isfinite(x) for x in graph["losses"])
            and loss_err <= GRAPH_LIMIT and err <= GRAPH_LIMIT):
        raise AssertionError(f"{label}: loss {loss_err}, {name} {err}")
    if bit_equal_required and not equal:
        raise AssertionError(f"{label}: not bit-equal")


def graph_pair(torch, fa, rf, basics, loop_mod, label, build, dev, card, paths,
               key, launches) -> tuple:
    """The graphed run and the eager run of one ``build()``, which returns
    ``(step, cache, optimizer, snapshot, collectives)`` (``snapshot()``: the
    parameters on the host, called after each run; ``collectives``: those
    one step issues, by name): the graphed dispatches first, then the
    parameters and the optimizer's state put back as they were built
    (``loop.TrainingState``, as the loop's warm-up does) and the same steps
    eagerly. Returns both runs (losses, parameters, step ms, peak memory);
    holds the capture's collectives to ``collectives`` and the kernels'
    launches at the capture to ``launches`` (by kernel; 0 if absent), none
    on replay."""
    import torch.distributed as dist

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step, cache, opt, snapshot, want = build()
    built = loop_mod.TrainingState(getattr(opt, "optimizer", opt), cache.counter())
    held = sum(t.numel() * t.element_size() for t in built.saved) / 1e9
    loop = loop_mod.make_scan_train_loop(step, cache, GRAPH_K, optimizer=opt)
    loop.warm_up()
    read_counts(fa, rf)
    with CountCollectives(dist, SHARD_COLLECTIVES) as at_capture:
        loop.capture()
    captured = read_counts(fa, rf)
    losses, ms = [], []
    with CountCollectives(dist, SHARD_COLLECTIVES) as at_replay:
        for _ in range(GRAPH_DISPATCHES):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loop()
            losses += loop.losses.tolist()
            ms.append(1e3 * (time.perf_counter() - t0) / GRAPH_K)
    replayed = read_counts(fa, rf)
    runs = {"graphed": {"losses": losses, "ms": ms, "params": snapshot(),
                        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}}
    del loop
    built.restore()
    opt.zero_grad()         # the captured step's gradients, in the graph's pool
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ctr, losses, ms = cache.counter(), [], []
    for _ in range(GRAPH_K * GRAPH_DISPATCHES):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x, y, ctr = cache.sample(ctr)
        losses.append(step(x, y).item())
        ms.append(1e3 * (time.perf_counter() - t0))
    read_counts(fa, rf)
    runs["eager"] = {"losses": losses, "ms": ms, "params": snapshot(),
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del step, cache, opt, snapshot, built
    basics.shutdown()
    hold_counts(f"{label}, at capture (one step)", captured, launches)
    hold_counts(f"{label}, {GRAPH_DISPATCHES} dispatches of replays", replayed, {})
    paths[f"{key}: capture of one step, {label}"] = captured
    log(f"  {label}: collectives at the capture {at_capture.counts} (want "
        f"{want}), during the replays {at_replay.counts}")
    if at_capture.counts != want or at_replay.counts:
        raise AssertionError(f"{label}: collectives at capture {at_capture.counts}, "
                             f"on replay {at_replay.counts}")
    g, e = runs["graphed"], runs["eager"]
    log(f"  {label}: step ms graphed {[round(t, 2) for t in g['ms']]} (a "
        f"dispatch / {GRAPH_K}), eager median {statistics.median(e['ms'][1:]):.2f} "
        f"(steps 1-{len(e['ms']) - 1}); peak memory graphed {g['peak_gb']:.3f} GB, "
        f"eager {e['peak_gb']:.3f} GB (each with the {held:.3f} GB copy of the "
        f"optimizer's parameters the eager run starts from), on {card}")
    hold_graph_pair(f"{label} graphed vs eager", g, e)
    return g, e


def graphed_sharded(torch, fa, rf, basics, train_mod, loop_mod, card, dev,
                    paths, flat_graph) -> None:
    """ZeRO at HOROVOD_MESH=1x1 and FSDP on ``training_groups(1, 1)``, each
    graphed against eager; the graphed ZeRO step against phase 13's graphed
    flat step, bit for bit (at shard 1 the exchange is the DP call, and both
    Adams are capturable, foreach on rows and parameters alike)."""
    from horovod_tpu_torch.parallel import fsdp as fsdp_mod
    from horovod_tpu_torch.parallel import sharded as sh

    config = train_mod.TrainConfig(steps_per_dispatch=GRAPH_K)

    def zero():
        os.environ["HOROVOD_MESH"] = "1x1"
        try:
            s = train_mod.setup(dataclasses.replace(config, sharded=True), "cuda")
        finally:
            os.environ.pop("HOROVOD_MESH", None)
        opt = s.opt

        def snapshot():
            sh.gather_params(opt.rows, opt.shard_plan, opt.layout, opt.params)
            return {n: p.detach().cpu() for n, p in s.model.named_parameters()}

        # At shard 1 each bucket is the DP call: one all-reduce, no gather.
        return (s.step, train_mod.make_cache(config, None, dev), opt, snapshot,
                {"all_reduce": opt.plan.num_buckets})

    def fsdp():
        s = train_mod.setup_fsdp(config, device="cuda")

        def snapshot():
            return {n: t.cpu() for n, t in
                    fsdp_mod.fsdp_unshard_params([s.rows], s.shapes).items()}

        return (s.step, train_mod.make_cache(config, None, dev), s.optimizer, snapshot,
                {"all_gather_into_tensor": len(s.rows),
                 "reduce_scatter_tensor": len(s.rows)})

    per_step = {k: config.layers for k in KERNELS}
    g, _ = graph_pair(torch, fa, rf, basics, loop_mod, "ZeRO 1x1", zero, dev,
                      card, paths, "16", per_step)
    hold_graph_pair("ZeRO 1x1 graphed vs phase 13's graphed flat step", g,
                    flat_graph, bit_equal_required=True)
    del g
    graph_pair(torch, fa, rf, basics, loop_mod, "FSDP", fsdp, dev, card, paths,
               "16", per_step)


# Phase 17. Tensor parallelism through the trainer, in a world of one over
# NCCL. (17a) ``train.setup`` under a named model axis of one rank
# (``sharded_groups(1, 1, 1)``) against phase 16's flat setup, SHARD_STEPS
# eager steps: copy_to_model and reduce_from_model issue nothing, the flat
# exchange runs over the batch group of one and the model draws the same
# weights, so every loss and parameter is expected bit-equal, with no
# collective on the model group. (17b) The same setup graphed
# (``steps_per_dispatch = GRAPH_K``) against its eager steps (``graph_pair``)
# and against phase 13's graphed flat step, bit for bit (phase 13's rule).
# (17c) ZeRO on the cube of one (``sharded=True``, 1x1x1) against the flat
# setup, bit for bit (phase 16's shard-1 rule). (17d) A virtual model group
# of TP_N on the card: one full-width block cut by tp_state_dict into TP_N
# rank blocks, each rank's attn_partial and mlp_partial summed in float32
# in place of the reduce, against the whole block, at 8 kv heads and at
# TP_KV (each rank keeps the one kv head its q heads read: kv_proj whole);
# and the LM head cut into TP_N row-parallel slices, each chunk's partial
# logits summed in float32 before the cross entropy, as ``chunked_lm_loss(
# tp_group=)`` does (chunk TP_CHUNK, each rank's partial logits from
# ``tp_partial_logits``, the function the port's head calls), against the
# whole head. The block's output is held to phase 2's bf16 relative norm
# (1e-2) and its gradients (the input and every parameter, reassembled:
# the sliced ones by tp_merge_state_dicts, each replicated leaf as the sum
# of the ranks' partial gradients) to phase 5's 3e-2: the ranks' partial
# products are summed in another order than the whole contraction. The
# head computes in float32 from the same bf16 hidden states, so its loss
# is held to HEAD_LOSS relative and its gradients to HEAD_GRAD relative
# norm (a full-width run read a loss difference of 0, the hidden states'
# bf16 cotangent 1.1e-4 and the head's 6.1e-7; a wrong slice is off by
# order 1).
TP_N, TP_KV, TP_CHUNK = 4, 2, 4096
HEAD_LOSS, HEAD_GRAD = 1e-5, 1e-3
# Phase 18. The full-width MoE TransformerLM (8 experts in every 2nd
# block, capacity factor 1.25), loss = task + MOE_AUX x the sum of the
# load-balancing losses, Adam through DistributedOptimizer.
MOE_EXPERTS, MOE_EVERY, MOE_AUX = 8, 2, 0.01


def lm_setup(torch, train_mod, config, dev, group=None, **model_kw):
    """model -> ``broadcast_parameters`` -> Adam ->
    ``DistributedOptimizer(group=)`` -> ``broadcast_optimizer_state``, the
    port's own functions, after ``init``, for the MoE model (``setup`` does
    not build it yet); ``group`` is the batch group (None: the world)."""
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


def relnorm_t(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def virtual_tp(torch, fa, rf, config, dev, paths, kv_heads=None) -> None:
    from horovod_tpu_torch.models.transformer import (
        TransformerLM, init_weights, tp_merge_state_dicts, tp_param_specs,
        tp_state_dict)

    kw = dict(vocab=config.vocab, dim=config.dim, heads=config.heads, layers=1,
              mlp_ratio=config.mlp_ratio, dtype=getattr(torch, config.dtype),
              attention=config.attention, kv_heads=kv_heads)
    label = f"virtual TP={TP_N}, kv_heads {kv_heads or config.heads}"
    whole = TransformerLM(**kw).to(dev)
    init_weights(whole, torch.Generator(device=dev).manual_seed(config.seed))
    ranks = []
    for r in range(TP_N):
        m = TransformerLM(**kw, tp_size=TP_N, tp_rank=r).to(dev)
        m.load_state_dict(tp_state_dict(whole.state_dict(), TP_N, r, kv_heads))
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
    hold_counts(f"the whole block, kv_heads {kv_heads or config.heads}, one pass",
                read_counts(fa, rf), {k: 1 for k in KERNELS})

    x = x0.clone().requires_grad_(True)
    x1 = x + torch.stack([b.attn_partial(x, pos).float() for b in ranks]).sum(0) \
        .to(x.dtype)
    got = x1 + torch.stack([b.mlp_partial(x1).float() for b in ranks]).sum(0) \
        .to(x.dtype)
    got.backward(g)
    torch.cuda.synchronize(dev)
    counts = read_counts(fa, rf)
    hold_counts(f"{label}, one pass", counts, {k: TP_N for k in KERNELS})
    paths[f"17d: {label}, one block, one pass"] = counts
    specs = tp_param_specs(ranks[0])
    grads = {"x": x.grad}
    for n in specs:
        parts = [dict(b.named_parameters())[n].grad for b in ranks]
        grads[n] = torch.stack([p.float() for p in parts]).sum(0) \
            if specs[n] is None else tp_merge_state_dicts([{n: p} for p in parts])[n]
    hold_virtual(label, relnorm_t(got, want), grads, want_grads)
    del whole, ranks
    torch.cuda.empty_cache()


def hold_virtual(label, out_err, grads, want_grads, out_limit=BF16_RELNORM,
                 grad_limit=3e-2) -> None:
    """Phase 17d's limits, by relative norm: the block's output to
    BF16_RELNORM and every gradient to 3e-2 (the head: HEAD_LOSS and
    HEAD_GRAD)."""
    errs = sorted(((relnorm_t(grads[n], w), n) for n, w in want_grads.items()),
                  reverse=True)
    log(f"  {label} vs the whole: output relative norm {out_err:.3e} (limit "
        f"{out_limit:g}); gradients, relative norm: " + ", ".join(
            f"{n} {e:.3e}" for e, n in errs) + f" (limit {grad_limit:g})")
    if not out_err <= out_limit:
        raise AssertionError(f"{label}: output {out_err:.3e} > {out_limit:g}")
    if not errs[0][0] <= grad_limit:
        raise AssertionError(f"{label}: gradient {errs[0]} > {grad_limit:g}")


def virtual_tp_head(torch, config, dev) -> None:
    """The row-parallel head of ``chunked_lm_loss(tp_group=)`` in a virtual
    model group of TP_N: each rank's columns of the bf16 hidden states
    against its slice of the float32 head (``tp_state_dict``), the partial
    logits summed in float32, the cross entropy per chunk of TP_CHUNK
    (checkpointed), against the whole head's loss."""
    from torch.utils.checkpoint import checkpoint

    from horovod_tpu_torch.models.transformer import (
        token_loss, tp_merge_state_dicts, tp_partial_logits, tp_state_dict)

    gen = torch.Generator(device=dev).manual_seed(1719)
    b, t, d = config.batch, config.seq, config.dim
    h0 = torch.randn(b, t, d, generator=gen, device=dev).to(torch.bfloat16)
    w0 = torch.randn(config.vocab, d, generator=gen, device=dev) / d ** 0.5
    targets = torch.randint(0, config.vocab, (b, t), generator=gen, device=dev)

    h = h0.clone().requires_grad_(True)
    w = w0.clone().requires_grad_(True)
    want = token_loss(h.float() @ w.t(), targets)
    want.backward()
    want_grads = {"hidden": h.grad, "lm_head.weight": w.grad}

    def chunk_loss(hc, tc, *ws):
        return token_loss(sum(tp_partial_logits(hc, wr, r)
                              for r, wr in enumerate(ws)), tc)

    h = h0.clone().requires_grad_(True)
    ws = [tp_state_dict({"lm_head.weight": w0}, TP_N, r)["lm_head.weight"]
          .requires_grad_(True) for r in range(TP_N)]
    got = torch.stack([
        checkpoint(chunk_loss, h[:, i:i + TP_CHUNK], targets[:, i:i + TP_CHUNK],
                   *ws, use_reentrant=False, preserve_rng_state=False)
        for i in range(0, t, TP_CHUNK)]).mean()
    got.backward()
    grads = {"hidden": h.grad, "lm_head.weight": tp_merge_state_dicts(
        [{"lm_head.weight": wr.grad} for wr in ws])["lm_head.weight"]}
    log(f"  the TP={TP_N} chunked head: loss {got.item():.6f} vs the whole "
        f"head's {want.item():.6f}")
    hold_virtual(f"virtual TP={TP_N} chunked head (chunk {TP_CHUNK})",
                 abs(got.item() - want.item()) / abs(want.item()), grads,
                 want_grads, HEAD_LOSS, HEAD_GRAD)


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


def tensor_parallel(torch, fa, rf, basics, train_mod, loop_mod, card, dev,
                    paths, flat, flat_graph) -> None:
    """Phase 17; ``flat`` is phase 16's eager flat run, ``flat_graph``
    phase 13's graphed flat run."""
    from horovod_tpu_torch.parallel import fsdp as fsdp_mod
    from horovod_tpu_torch.parallel import sharded as sh
    from horovod_tpu_torch.parallel.mesh import sharded_groups

    config = train_mod.TrainConfig()
    per_step = {k: config.layers * SHARD_STEPS for k in KERNELS}
    for key, label, cfg in (("17a", "TP=1", config),
                            ("17c", "ZeRO x TP=1",
                             dataclasses.replace(config, sharded=True))):
        if key == "17c":
            graphed_cube(torch, fa, rf, basics, train_mod, loop_mod, config, card,
                         dev, paths, flat_graph)
        log(f"  ({key}) setup({'sharded=True, ' if cfg.sharded else ''}"
            f"layout=sharded_groups(1, 1, 1)) against phase 16's flat setup, "
            f"{SHARD_STEPS} steps")
        run = sharded_run(torch, fa, rf, basics, train_mod, sh, fsdp_mod, label,
                          cfg, dev, cube=(1, 1, 1))
        hold_runs_bit_equal(f"{label} (1x1x1) vs flat", run, flat)
        hold_counts(f"{label}, {SHARD_STEPS} steps", run["launches"], per_step)
        paths[f"{key}: {SHARD_STEPS} steps, {label}"] = run["launches"]
        log(f"  {label}: collectives of step 1 {run['collectives']}, on the model "
            f"group {run['on_model']}; model cut into {run['tp']}; median step "
            f"{statistics.median(run['ms'][1:]):.2f} ms (steps 1-{SHARD_STEPS - 1}; "
            f"per step {[round(t, 2) for t in run['ms']]}), peak memory "
            f"{run['peak_gb']:.3f} GB, on {card}")
        if run["on_model"] or run["tp"] != 1:
            raise AssertionError(f"{label}: {run['on_model']} collectives on the "
                                 f"model group, model cut into {run['tp']}")
    log(f"  (17d) a virtual model group of {TP_N}: one full-width block at the "
        f"head shard ({config.batch}, {config.seq}, {config.heads // TP_N}, "
        f"{config.dim // config.heads}) per rank, at kv_heads {config.heads} and "
        f"{TP_KV}; the chunked head")
    virtual_tp(torch, fa, rf, config, dev, paths)
    virtual_tp(torch, fa, rf, config, dev, paths, kv_heads=TP_KV)
    virtual_tp_head(torch, config, dev)
    torch.cuda.empty_cache()
    tp_wire(torch, config)


def graphed_cube(torch, fa, rf, basics, train_mod, loop_mod, config, card, dev,
                 paths, flat_graph) -> None:
    """17b: ``setup(layout=sharded_groups(1, 1, 1))`` graphed against its
    eager steps and against phase 13's graphed flat step, bit for bit."""
    from horovod_tpu_torch.parallel.mesh import sharded_groups

    cfg = dataclasses.replace(config, steps_per_dispatch=GRAPH_K)
    log(f"  (17b) the same, graphed (K = {GRAPH_K}, {GRAPH_DISPATCHES} "
        f"dispatches), against phase 13's graphed flat step")

    def build():
        basics.init("cuda")
        s = train_mod.setup(cfg, "cuda", layout=sharded_groups(1, 1, 1))

        def snapshot():
            return {n: p.detach().cpu() for n, p in s.model.named_parameters()}

        return (s.step, train_mod.setup_cache(cfg, s, dev), s.opt, snapshot,
                {"all_reduce": s.opt.plan.num_buckets})

    g, _ = graph_pair(torch, fa, rf, basics, loop_mod, "TP=1 (1x1x1)", build, dev,
                      card, paths, "17b", {k: config.layers for k in KERNELS})
    hold_graph_pair("TP=1 graphed vs phase 13's graphed flat step", g, flat_graph,
                    bit_equal_required=True)


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


def graphed_pipeline(torch, fa, rf, basics, train_mod, loop_mod, card, dev,
                     paths) -> None:
    """19a/19b graphed: the pipelined step of a pp group of one, n_micro 1
    on a batch of 1 and PP_MICRO on a batch of PP_MICRO, graphed against
    eager. Each microbatch launches B1-B3 once per layer and tick."""
    for n_micro, batch in ((1, 1), (PP_MICRO, PP_MICRO)):
        config = train_mod.TrainConfig(batch=batch, steps_per_dispatch=GRAPH_K)

        def build():
            s = train_mod.setup_pipeline(config, 1, n_micro, "cuda")

            def snapshot():
                return {n: p.detach().cpu() for n, p in s.stage.named_parameters()}

            # A bucket's all-reduce over the dp group, the three outer
            # leaves' sums and the loss's last-stage value over the pp
            # group: all-reduces in groups of one, and no P2P call.
            return (s.step, train_mod.make_cache(config, None, dev, s.layout.dp_rank),
                    s.opt, snapshot,
                    {"all_reduce": s.opt.plan.num_buckets + 3 + 1})

        sub = "19a" if n_micro == 1 else "19b"
        graph_pair(torch, fa, rf, basics, loop_mod,
                   f"({sub}) pp group of one, n_micro {n_micro}", build, dev,
                   card, paths, sub, {k: n_micro * config.layers for k in KERNELS})


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


def overlap_phase(torch, fa, rf, basics, train_mod, loop_mod, card, dev,
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
                                         graph_config, dev, card, paths, phase="20")
    finally:
        os.environ.pop("HOROVOD_NUM_BUCKETS")
        os.environ.pop("HOROVOD_LATENCY_HIDING")
    captured, order = captured
    log(f"  captured step's launches (bucket, leaves landed): {captured}")
    if [b for b, _ in captured] != order or sorted(order) != list(range(nb)) or \
            all(at is None for _, at in captured):
        raise AssertionError(f"the captured step did not run the hooked exchange "
                             f"in its agreed order {order}: {captured}")


# Phase 21. Checkpoint and resume at full width, in a world of one over
# NCCL. A resumed run repeats the operations of the run that never stopped
# on the same values (the restore writes every parameter, Adam moment and
# step counter back in place; the tokens and the cache draws are the same),
# so every resume is expected bit-equal to it: each loss, parameter and
# Adam moment, exactly.
CKPT_STEPS = 3


def ckpt_tree(s, **extra) -> dict:
    """The checkpointed state of a ``train.setup`` run: the model's state
    dict as live tensors, its optimizer (Adam's state and param groups),
    and ``extra``."""
    return {"model": s.model.state_dict(), "opt": s.opt, **extra}


def host_state(s) -> dict:
    """Every parameter and Adam state tensor of ``s``, copied to the host."""
    out = {f"param {n}": p.detach().cpu().clone() for n, p in s.model.named_parameters()}
    for i, st in s.opt.optimizer.state_dict()["state"].items():
        out.update({f"adam {i} {k}": v.detach().cpu().clone() for k, v in st.items()})
    return out


def hold_resumed(label, losses, want_losses, state, want_state) -> None:
    differ = [k for k in want_state if not torch_equal(state[k], want_state[k])]
    log(f"  {label}: losses {losses} vs {want_losses}; tensors that differ: "
        f"{len(differ)} of {len(want_state)} (parameters and Adam moments)")
    if losses != want_losses or differ or state.keys() != want_state.keys():
        raise AssertionError(f"{label}: not bit-equal (differing {differ[:5]})")


def restore_in_place(torch, ckpt, path, tree, step) -> dict:
    """``ckpt.restore`` into ``tree``, raising unless every tensor, an
    optimizer's state included, kept its storage."""
    def ptrs(t):
        out = []
        for x in ckpt._leaves(t):
            opt = ckpt._optimizer(x)
            for y in ckpt._leaves(opt.state_dict()["state"] if opt is not None else x):
                if torch.is_tensor(y):
                    out.append(y.data_ptr())
        return out

    before = ptrs(tree)
    got = ckpt.restore(path, template=tree, step=step)
    if ptrs(got) != before or ptrs(tree) != before:
        raise AssertionError("restore did not write into the live tensors")
    return got


def eager_resume(torch, fa, rf, basics, train_mod, ckpt, config, dev, tmp, paths):
    """21a. Returns the resumed run (its model and optimizer after
    2 x CKPT_STEPS steps), the tokens, and the straight run's losses and
    host state."""
    n = CKPT_STEPS
    tokens = train_mod.make_batch(config, 0, dev)
    s = train_mod.setup(config, dev.type)
    straight = [s.step(tokens).item() for _ in range(2 * n)]
    want = host_state(s)
    del s
    basics.shutdown()
    s = train_mod.setup(config, dev.type)
    first = [s.step(tokens).item() for _ in range(n)]
    ckpt.save(tmp, ckpt_tree(s, step=n), step=n)
    del s
    basics.shutdown()
    s = train_mod.setup(dataclasses.replace(config, seed=1), dev.type)
    if torch_equal(s.model.embed.weight.detach().cpu(), want["param embed.weight"]):
        raise AssertionError("the seed-1 run drew the seed-0 weights")
    ckpt.init_optimizer_state(s.opt)
    got = restore_in_place(torch, ckpt, tmp, ckpt_tree(s, step=0), ckpt.latest_step(tmp))
    if got["step"] != n:
        raise AssertionError(f"restored step {got['step']}, saved {n}")
    train_mod.hvd_opt.broadcast_parameters(s.model.state_dict(), root_rank=0)
    train_mod.hvd_opt.broadcast_optimizer_state(s.opt, root_rank=0)
    read_counts(fa, rf)
    resumed = first + [s.step(tokens).item() for _ in range(n)]
    counts = read_counts(fa, rf)
    hold_counts(f"{n} resumed steps", counts, {k: config.layers * n for k in KERNELS})
    paths[f"21a: {n} steps resumed from a checkpoint"] = counts
    hold_resumed(f"saved after {n} steps, restored into a seed-1 run, {n} more, "
                 f"vs {2 * n} straight", resumed, straight, host_state(s), want)
    return s, tokens, straight, want


SERVE = """
import json, os, sys
import torch
import torch.distributed as dist
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.train import TrainConfig, build_model
dev = torch.device(os.environ["CK_DEVICE"])
model = build_model(TrainConfig(**json.loads(os.environ["CK_CONFIG"])), dev)
checkpoint.load_for_inference(os.environ["CK_PATH"],
                              template={"model": model.state_dict()})
tokens = torch.load(os.environ["CK_TOKENS"], weights_only=True).to(dev)
with torch.no_grad():
    logits = model(tokens)
if basics.is_initialized() or dist.is_initialized():
    sys.exit("the serving process initialized a process group")
torch.save(logits.cpu(), os.environ["CK_OUT"])
"""


def export_check(torch, fa, rf, ckpt, s, tokens, config, dev, tmp, paths) -> None:
    """21e. The exported model's logits in a fresh process that never calls
    ``init()``, against the trainer's forward on the same tokens."""
    serving = ckpt.export_for_inference(os.path.join(tmp, "serve"),
                                        ckpt_tree(s, step=2 * CKPT_STEPS),
                                        drop=("opt", "step"))
    if list(serving) != ["model"]:
        raise AssertionError(f"export kept {list(serving)}")
    read_counts(fa, rf)
    with torch.no_grad():
        want = s.model(tokens).cpu()
    counts = read_counts(fa, rf)
    hold_counts("the trainer's forward", counts, {"flash_fwd": config.layers})
    paths["21e: the trainer's forward beside the exported model's"] = counts
    torch.save(tokens.cpu(), os.path.join(tmp, "tokens.pt"))
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    env = dict(os.environ, CK_PATH=os.path.join(tmp, "serve"),
               CK_TOKENS=os.path.join(tmp, "tokens.pt"),
               CK_OUT=os.path.join(tmp, "logits.pt"), CK_DEVICE=str(dev),
               CK_CONFIG=json.dumps(fields),
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "HOROVOD_COORD_ADDR", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SERVE], env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the serving process failed:\n{proc.stderr[-3000:]}")
    got = torch.load(os.path.join(tmp, "logits.pt"), weights_only=True)
    same = torch_equal(got, want)
    log(f"  exported ({', '.join(serving)}; Adam and the step dropped) and loaded "
        f"in a fresh process without init() ({time.perf_counter() - t0:.1f} s): "
        f"logits {tuple(got.shape)} bit-equal to the trainer's: {same}")
    if not same:
        raise AssertionError(f"exported logits differ: max |err| "
                             f"{(got - want).abs().max().item()}")


def tree_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def commit_costs(torch, ckpt, ckpt_async, s, tokens, dev, tmp, card) -> None:
    """21d. Bytes, save and restore seconds, the digest's seconds, the
    async submit's stall against its background commit, and the step time
    with a commit in flight against without; the async commit restores
    bit-equal to the synchronous one."""
    from horovod_tpu_torch.metrics import registry

    step = 2 * CKPT_STEPS
    tree = ckpt_tree(s, step=step)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ckpt.save(os.path.join(tmp, "sync"), tree, step=step)
    save_s = time.perf_counter() - t0
    nbytes = tree_bytes(os.path.join(tmp, "sync", f"step_{step}"))
    t0 = time.perf_counter()
    restore_in_place(torch, ckpt, os.path.join(tmp, "sync"), tree, step)
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    log(f"  checkpoint of {sum(p.numel() for p in s.model.parameters())} "
        f"parameters with Adam: {nbytes} B on disk; save {save_s:.3f} s "
        f"({nbytes / save_s / 1e9:.3f} GB/s, host copy + torch.save + fsync + "
        f"rename), restore in place {restore_s:.3f} s; on {card}")

    def timed_steps(k):
        out = []
        for _ in range(k):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            s.step(tokens)
            torch.cuda.synchronize(dev)
            out.append(1e3 * (time.perf_counter() - t))
        return out

    commit = registry().histogram("horovod_ckpt_commit_seconds")
    before = commit.sum
    writer = ckpt_async.AsyncCheckpointer(os.path.join(tmp, "async"))
    try:
        t0 = time.perf_counter()
        writer.submit(tree, step=step)
        submit_s = time.perf_counter() - t0
        during = timed_steps(CKPT_STEPS)
        in_flight = not writer.wait(0)
        if not writer.wait(600):
            raise AssertionError("the background commit did not finish in 600 s")
    finally:
        writer.close()
    commit_s = commit.sum - before
    after = timed_steps(CKPT_STEPS)
    log(f"  AsyncCheckpointer: submit {submit_s:.3f} s on the training thread "
        f"(the host snapshot), background commit {commit_s:.3f} s; "
        f"{CKPT_STEPS} steps with the commit in flight {[round(t, 2) for t in during]} "
        f"ms (still in flight after them: {in_flight}), {CKPT_STEPS} without "
        f"{[round(t, 2) for t in after]} ms; on {card}")
    a = ckpt.restore(os.path.join(tmp, "sync"), step=step, device="cpu")
    t0 = time.perf_counter()
    ckpt._digest(a)
    digest_s = time.perf_counter() - t0
    log(f"  the cross-rank digest's SHA-256 of the restored state (a world of one "
        f"skips it; every rank of a larger world pays it in restore): "
        f"{digest_s:.3f} s, {nbytes / digest_s / 1e9:.3f} GB/s; on {card}")
    b = ckpt.restore(os.path.join(tmp, "async"), step=step, device="cpu")
    leaves_a, leaves_b = ckpt._leaves(a), ckpt._leaves(b)
    same = len(leaves_a) == len(leaves_b) and all(
        torch_equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(leaves_a, leaves_b))
    log(f"  the async commit restores bit-equal to the synchronous one: {same} "
        f"({len(leaves_a)} leaves)")
    if not same:
        raise AssertionError("the async commit differs from the synchronous one")


def graphed_resume(torch, fa, rf, basics, train_mod, loop_mod, ckpt, config, dev,
                   tmp, paths) -> None:
    """21b. Two dispatches of K steps from one captured graph against one
    dispatch, a checkpoint with the cache's counter, a fresh run from seed
    1 captured first and restored in place after the capture, and one
    dispatch."""
    gconfig = dataclasses.replace(config, steps_per_dispatch=GRAPH_K)

    def run(cfg, cache_cfg):
        """The run's setup and loop, captured on the card; the launches of
        the capture alone (the warm-up's are read away first)."""
        s = train_mod.setup(cfg, dev.type)
        loop = loop_mod.make_scan_train_loop(
            s.step, train_mod.make_cache(cache_cfg, None, dev), GRAPH_K, optimizer=s.opt)
        loop.warm_up()
        read_counts(fa, rf)
        loop.capture()
        return s, loop, read_counts(fa, rf)

    def dispatch(loop):
        loop()
        return loop.losses.tolist()

    s, loop, _ = run(gconfig, gconfig)
    straight = dispatch(loop) + dispatch(loop)
    want = {**host_state(s), "counter": loop.counter.cpu().clone()}
    del s, loop
    basics.shutdown()
    s, loop, _ = run(gconfig, gconfig)
    first = dispatch(loop)
    ckpt.save(tmp, ckpt_tree(s, counter=loop.counter), step=GRAPH_K)
    del s, loop
    basics.shutdown()
    s, loop, counts = run(dataclasses.replace(gconfig, seed=1), gconfig)
    ckpt.init_optimizer_state(s.opt)      # the capture's warm-up made it on the card
    restore_in_place(torch, ckpt, tmp, ckpt_tree(s, counter=loop.counter), GRAPH_K)
    train_mod.hvd_opt.broadcast_parameters(s.model.state_dict(), root_rank=0)
    train_mod.hvd_opt.broadcast_optimizer_state(s.opt, root_rank=0)
    resumed = first + dispatch(loop)
    replays = read_counts(fa, rf)
    hold_counts("at the resumed loop's capture (one step)", counts,
                {k: config.layers for k in KERNELS})
    hold_counts("in its replays (no Python runs)", replays, {})
    paths[f"21b: capture of the resumed loop, K = {GRAPH_K}"] = counts
    hold_resumed(f"graphed K = {GRAPH_K}: 1 dispatch, saved, a seed-1 run captured "
                 f"then restored in place, 1 dispatch, vs 2 dispatches", resumed,
                 straight, {**host_state(s), "counter": loop.counter.cpu().clone()},
                 want)
    del s, loop
    basics.shutdown()


def zero_to_flat(torch, fa, rf, basics, train_mod, ckpt, config, dev, tmp,
                 straight, want, paths) -> None:
    """21c. ZeRO at HOROVOD_MESH=1x1 for CKPT_STEPS steps, ``save_sharded``,
    restored into the flat data-parallel run, CKPT_STEPS more, against the
    flat run that never stopped (21a's)."""
    from horovod_tpu_torch.parallel import sharded as sh

    n = CKPT_STEPS
    tokens = train_mod.make_batch(config, 0, dev)
    os.environ["HOROVOD_MESH"] = "1x1"
    try:
        z = train_mod.setup(dataclasses.replace(config, sharded=True), dev.type)
    finally:
        os.environ.pop("HOROVOD_MESH")
    first = [z.step(tokens).item() for _ in range(n)]
    rows, st = z.opt.rows, z.opt.optimizer.state
    tree = {"params": rows,
            "exp_avg": sh.ShardedBuckets([st[r]["exp_avg"] for r in rows]),
            "exp_avg_sq": sh.ShardedBuckets([st[r]["exp_avg_sq"] for r in rows]),
            "step": st[rows[0]]["step"]}
    ckpt.save_sharded(tmp, tree, z.opt.shard_plan, step=n, layout=z.opt.layout)
    buckets = z.opt.shard_plan.num_buckets
    del z, tree, rows, st
    basics.shutdown()
    s = train_mod.setup(dataclasses.replace(config, seed=1), dev.type)
    ckpt.init_optimizer_state(s.opt)
    params, st = s.opt.params, s.opt.optimizer.state
    flat = {"params": params, "exp_avg": [st[p]["exp_avg"] for p in params],
            "exp_avg_sq": [st[p]["exp_avg_sq"] for p in params],
            "step": st[params[0]]["step"]}
    restore_in_place(torch, ckpt, tmp, flat, n)
    with torch.no_grad():
        for p in params[1:]:
            st[p]["step"].copy_(st[params[0]]["step"])
    train_mod.hvd_opt.broadcast_parameters(s.model.state_dict(), root_rank=0)
    train_mod.hvd_opt.broadcast_optimizer_state(s.opt, root_rank=0)
    read_counts(fa, rf)
    resumed = first + [s.step(tokens).item() for _ in range(n)]
    counts = read_counts(fa, rf)
    hold_counts(f"{n} flat steps after the ZeRO restore", counts,
                {k: config.layers * n for k in KERNELS})
    paths[f"21c: {n} flat steps restored from a ZeRO checkpoint"] = counts
    hold_resumed(f"ZeRO (1x1, {buckets} buckets) {n} steps, save_sharded, restored "
                 f"into the flat run, {n} more, vs {2 * n} flat", resumed, straight,
                 host_state(s), want)
    del s
    basics.shutdown()


def checkpoint_phase(torch, fa, rf, basics, train_mod, loop_mod, card, dev,
                     paths) -> None:
    """Phase 21: 21a, 21e and 21d on one run's state, then 21b and 21c."""
    import shutil
    import tempfile

    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import ckpt_async

    config = train_mod.TrainConfig()

    def part(label, fn, *args):
        log(f"  {label}")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            return fn(*args, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # 21a, then 21e and 21d on the resumed run's state.
    def a_e_d(tmp):
        s, tokens, straight, want = eager_resume(
            torch, fa, rf, basics, train_mod, ckpt, config, dev,
            os.path.join(tmp, "a"), paths)
        shutil.rmtree(os.path.join(tmp, "a"))
        log(f"  (21e) export for inference, {CKPT_STEPS * 2} steps' state")
        export_check(torch, fa, rf, ckpt, s, tokens, config, dev, tmp, paths)
        shutil.rmtree(os.path.join(tmp, "serve"))
        log("  (21d) commit costs at full width")
        commit_costs(torch, ckpt, ckpt_async, s, tokens, dev, tmp, card)
        del s
        basics.shutdown()
        return straight, want

    straight, want = part(f"(21a) eager: {CKPT_STEPS} steps, save, a fresh "
                          f"seed-1 run, restore, {CKPT_STEPS} steps", a_e_d)
    part(f"(21b) graphed, K = {GRAPH_K}", lambda tmp: graphed_resume(
        torch, fa, rf, basics, train_mod, loop_mod, ckpt, config, dev, tmp, paths))
    part("(21c) ZeRO into flat", lambda tmp: zero_to_flat(
        torch, fa, rf, basics, train_mod, ckpt, config, dev, tmp, straight, want,
        paths))
    gc.collect()
    torch.cuda.empty_cache()


# Phase 22. Tuning and measurement of the training path, at full width in
# a world of one over NCCL. In a world of one the exchange moves no value:
# whatever the fusion threshold, bucket count, ladder or mesh, a step with
# the wire at full width is the same arithmetic, so every such candidate,
# the controller's run and ZeRO at 1x1 are held bit-equal to the plain run.
# A bf16 wire rounds each gradient once: phase 5's loss limit (1e-2).
TUNE_THRESHOLDS = (4 << 20, 64 << 20)
TUNE_BUCKETS = (1, 4)
TUNE_WIRES = ("none", "bf16")
TUNE_WINDOW = dict(warmup=1, iters=2, reps=2)
TUNE_PEAK_SPREAD, TUNE_LEAK = 1e9, 0.1e9       # bytes
CONTROL_WINDOWS = 12


class CountedFactory:
    """A step factory that reads the kernels' launch counts of each
    candidate: those since the previous candidate's build, read when the
    next one is built and at ``finish()``."""

    def __init__(self, factory, fa, rf) -> None:
        self.factory, self.fa, self.rf, self.counts = factory, fa, rf, []

    def __call__(self, fusion_threshold, **knobs):
        self.finish()
        return self.factory(fusion_threshold, **knobs)

    def finish(self):
        counts = read_counts(self.fa, self.rf)
        if len(self.counts) < len(self.factory.records):
            self.counts.append(counts)


def planned_buckets(torch, train_mod, config, threshold, num_buckets) -> int:
    """The port's fusion plan for the config's model, from its shapes alone
    (the model built on the meta device)."""
    from horovod_tpu_torch.convert import jax_ordered
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel import fusion

    with torch.device("meta"):
        model = TransformerLM(vocab=config.vocab, dim=config.dim,
                              heads=config.heads, layers=config.layers,
                              mlp_ratio=config.mlp_ratio,
                              dtype=getattr(torch, config.dtype))
    params = [p for _, p in jax_ordered(model.named_parameters())]
    return fusion.build_plan(params, threshold, num_buckets).num_buckets


def held_memory(torch, dev) -> int:
    """``memory_allocated`` once the dropped objects are freed and without
    cuBLAS's workspaces, which it keeps for each stream it ran on for the
    life of the process (64-96 MiB a stream here), not for a candidate."""
    gc.collect()
    torch.cuda.synchronize(dev)
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def tune_sweep(torch, fa, rf, basics, train_mod, card, dev, paths):
    """22a: ``tune`` over thresholds x buckets x wires, graphed."""
    from horovod_tpu_torch import autotune

    from horovod_tpu_torch.loop import WARMUP_STEPS

    config = train_mod.TrainConfig(steps_per_dispatch=GRAPH_K)
    captured_steps = WARMUP_STEPS + 1
    basics.init("cuda")
    before = held_memory(torch, dev)
    factory = CountedFactory(train_mod.TuneStepFactory(config), fa, rf)
    read_counts(fa, rf)
    t0 = time.perf_counter()
    report = autotune.tune(factory, thresholds=TUNE_THRESHOLDS,
                           num_buckets=TUNE_BUCKETS, compressions=TUNE_WIRES,
                           gp_rounds=1, **TUNE_WINDOW)
    factory.factory.close()
    factory.finish()
    sweep_s = time.perf_counter() - t0
    records = factory.factory.records
    after = held_memory(torch, dev)
    log(f"  {len(records)} candidates in {sweep_s:.1f} s ({TUNE_WINDOW}, "
        f"{GRAPH_K} steps a dispatch), on {card}; knob curve (steps/s are "
        f"dispatches of {GRAPH_K} steps a second):")
    for line in report.knob_curve().splitlines():
        log(f"    {line}")
    best = report.best
    log(f"  best {best.config}: {best.steps_per_s * GRAPH_K:.3f} steps/s, "
        f"{1e3 / (best.steps_per_s * GRAPH_K):.2f} ms a step")
    rates = {(m.fusion_threshold, m.num_buckets, m.compression): m.steps_per_s
             for m in report.table}
    first_peak = records[0]["peak_bytes"]
    for r, counts in zip(records, factory.counts):
        want = planned_buckets(torch, train_mod, config, r["fusion_threshold"],
                               r["num_buckets"])
        rate = rates[(r["fusion_threshold"], r["num_buckets"], r["compression"])]
        log(f"  {r['fusion_threshold'] >> 20:>4} MiB x {r['num_buckets']} x "
            f"{r['compression']:<4}: {r['planned_buckets']} buckets (plan "
            f"{want}; {r['wires'].count('bfloat16')} ship at bf16), build + capture {r['build_s']:.2f} s, peak "
            f"{r['peak_bytes'] / 1e9:.3f} GB, {rate * GRAPH_K:.3f} steps/s "
            f"({1e3 / (rate * GRAPH_K):.2f} ms a step), first dispatch's "
            f"losses {r['losses']}")
        if r["planned_buckets"] != want:
            raise AssertionError(f"candidate {r}: {r['planned_buckets']} buckets, "
                                 f"the fusion plan has {want}")
        hold_counts(f"candidate {r['fusion_threshold'] >> 20} MiB x "
                    f"{r['num_buckets']} x {r['compression']} ({captured_steps} "
                    f"steps: warm-up and capture; replays run no Python)",
                    counts, {k: config.layers * captured_steps for k in KERNELS})
        if abs(r["peak_bytes"] - first_peak) > TUNE_PEAK_SPREAD:
            raise AssertionError(f"candidate {r}: peak {r['peak_bytes']} B, the "
                                 f"first's {first_peak} B: memory accumulates")
    paths["22a: tune, one candidate's warm-up and capture"] = factory.counts[0]
    none = [r["losses"] for r in records if r["compression"] == "none"]
    if any(losses != none[0] for losses in none):
        raise AssertionError(f"'none' candidates' first dispatches differ: {none}")
    bf16 = [r["losses"] for r in records if r["compression"] == "bf16"]
    gaps = [max(abs(a - b) / abs(b) for a, b in zip(losses, none[0]))
            for losses in bf16]
    log(f"  {len(none)} 'none' candidates bit-equal; each bf16 candidate against "
        f"them: loss {min(gaps):.3e}-{max(gaps):.3e} relative (limit 1e-2; above "
        f"0, or the wire was not applied)")
    if not max(gaps) <= 1e-2:
        raise AssertionError(f"bf16 candidates' losses {max(gaps)} from 'none'")
    if not min(gaps) > 0:
        raise AssertionError("a bf16 candidate's losses equal the 'none' ones: "
                             "the wire was not applied")
    for r in records:
        if ("bfloat16" in r["wires"]) != (r["compression"] == "bf16"):
            raise AssertionError(f"candidate {r['compression']}: bucket wires "
                                 f"{r['wires']}")
    log(f"  memory allocated before the sweep {before / 1e9:.3f} GB, after "
        f"{after / 1e9:.3f} GB; peaks {min(r['peak_bytes'] for r in records) / 1e9:.3f}"
        f"-{max(r['peak_bytes'] for r in records) / 1e9:.3f} GB")
    if abs(after - before) > TUNE_LEAK:
        raise AssertionError(f"the sweep kept {after - before} B allocated")
    return best


def controller_run(torch, fa, rf, basics, train_mod, card, dev, paths):
    """22b: ``TrainingController`` driving ``TrainRecapture``, against the
    same loop with no controller."""
    from horovod_tpu_torch.control import TrainingController
    from horovod_tpu_torch.loop import WARMUP_STEPS
    from horovod_tpu_torch.metrics.registry import MetricsRegistry

    config = train_mod.TrainConfig(steps_per_dispatch=GRAPH_K)
    read_counts(fa, rf)
    job = train_mod.TrainRecapture(config, "cuda")
    tc = TrainingController(rejit=job.rejit, canary_steps=2, cooldown_s=0.0,
                            reg=MetricsRegistry())
    losses, rates = [], []
    for _ in range(CONTROL_WINDOWS):
        t0 = time.perf_counter()
        job()
        torch.cuda.synchronize(dev)
        rate = GRAPH_K / (time.perf_counter() - t0)
        losses.append(job.loop.losses.tolist())
        rates.append(rate)
        tc.on_step(rate)
    counts = read_counts(fa, rf)
    for d in tc.loop.history:
        log(f"  decision: {d['verdict']} {d['knob']} {d['prev']} -> {d['value']} "
            f"({d['reason']}; canary mean {d['canary_mean']} vs baseline "
            f"{d['baseline']} steps/s)")
    for change, secs in job.recaptures:
        log(f"  recapture {change}: {secs:.3f} s (rebuild, warm-up, capture)")
    log(f"  windows' steps/s {[round(r, 3) for r in rates]} on {card}; final "
        f"knobs {job.knobs}")
    if not tc.loop.history:
        raise AssertionError("the controller decided nothing in "
                             f"{CONTROL_WINDOWS} windows")
    captures = 1 + len(job.recaptures)
    hold_counts(f"controller run ({captures} captures, each after "
                f"{WARMUP_STEPS} warm-up steps)", counts,
                {k: config.layers * (WARMUP_STEPS + 1) * captures for k in KERNELS})
    paths[f"22b: controller, {CONTROL_WINDOWS} windows, every capture"] = counts
    del job, tc
    basics.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    plain = train_mod.TrainRecapture(config, "cuda")
    read_counts(fa, rf)
    want = []
    for _ in range(CONTROL_WINDOWS):
        plain()
        want.append(plain.loop.losses.tolist())
    if losses != want:
        raise AssertionError(f"controller run's losses {losses} differ from the "
                             f"plain run's {want}")
    log(f"  {CONTROL_WINDOWS} windows ({CONTROL_WINDOWS * GRAPH_K} steps) "
        f"bit-equal to the run without a controller; last losses {want[-1]}")
    return plain, statistics.median(rates)


def roofline_and_timeline(torch, fa, rf, basics, train_mod, card, dev, paths,
                          plain, step_rate):
    """22c: the roofline of the eager step and of the graphed dispatch, and
    the timeline's device pane over one dispatch."""
    import shutil
    import tempfile

    from horovod_tpu_torch.utils import roofline, timeline

    peaks = roofline.device_peaks(dev)
    log(f"  device peaks: {peaks.describe()}; nvidia-smi max clocks (SM, "
        f"memory): {roofline.smi_max_clocks(dev.index or 0)}; on {card}")
    box = [plain.loop.counter.clone()]

    def eager_step():
        x, y, box[0] = plain.cache.sample(box[0])
        plain.s.step(x, y)

    layers = train_mod.TrainConfig().layers

    def whole_profile(label, run, calls, steps, **kw):
        """A profile of ``calls`` calls of ``steps`` steps each whose trace
        holds every launch of B1-B3, and the number of profiles taken: a
        trace that lost kernel records is taken again, up to
        ``PROFILE_TRIES`` times."""
        want = {k: layers * calls * steps for k in KERNELS}
        for attempt in range(1, PROFILE_TRIES + 1):
            rep = roofline.profile_device_ops(run, steps=calls, peaks=peaks, **kw)
            if not rep.get("ok"):
                return rep, attempt
            records = {k: rep["port_kernel_records"].get(k, 0) for k in KERNELS}
            if records == want:
                return rep, attempt
            log(f"  the trace of the {label} holds {records} kernels of B1-B3, "
                f"{want} ran: the profiler lost records ({attempt} of "
                f"{PROFILE_TRIES} profiles)")
        raise AssertionError(f"{label}: {PROFILE_TRIES} traces lost kernel records")

    eager_step()
    read_counts(fa, rf)
    eager, tries = whole_profile("eager step", eager_step, 2, 1)
    counts = read_counts(fa, rf)
    graph, _ = whole_profile(f"graphed dispatch ({GRAPH_K} steps)", plain, 1,
                             GRAPH_K, costs=eager.get("kernel_costs"))
    read_counts(fa, rf)
    b, t, h, hkv, d = SLICE_SHAPE
    per_step = {k: layers * bound((k, b * h, b * hkv, t, d, 2, True), "bfloat16")[0]
                for k in KERNELS}
    for label, rep, steps in (("eager step", eager, 1), (f"graphed dispatch "
                              f"({GRAPH_K} steps)", graph, GRAPH_K)):
        log(f"  roofline, {label}:")
        for line in roofline.format_report(rep).splitlines():
            log(f"    {line}")
        if not rep.get("ok"):
            continue
        counted = rep["port_kernel_tflop_per_step"]
        log(f"  B1-B3 TFLOP counted a call: {counted}; from the launch "
            f"shapes, {steps} x 12 layers: "
            f"{ {k: round(v * steps / 1e12, 4) for k, v in per_step.items()} }; "
            f"unattributed {rep['unattributed_ms_per_step']} ms a call")
        share = rep["model_tflop_per_step"] * 1e12 / steps * step_rate \
            / peaks.bf16_flops
        log(f"  whole step: {rep['model_tflop_per_step'] / steps:.3f} TFLOP at "
            f"{step_rate:.3f} steps/s (22b's median window) = "
            f"{share * 100:.1f}% of the device-read {peaks.bf16_flops / 1e12:.1f} "
            f"TFLOP/s ({share * peaks.bf16_flops / 989e12 * 100:.1f}% of 989)")
        for k, v in per_step.items():
            if abs(counted.get(k, 0.0) * 1e12 - v * steps) > 1e-6 * v * steps:
                raise AssertionError(f"{label}: {k} counted {counted.get(k)} "
                                     f"TFLOP, the shapes give {v * steps / 1e12}")
    if not eager.get("ok"):
        raise AssertionError(f"no roofline of the eager step: {eager}")
    hold_counts(f"the profiled eager steps ({tries} profiles of 2)", counts,
                {k: 2 * layers * tries for k in KERNELS})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with timeline.trace(tmp):
            plain()
            torch.cuda.synchronize(dev)
        path = os.path.join(tmp, timeline.DEVICE_TRACE)
        with open(path) as f:
            text = f.read()
        seen = {k: tc in text for k, tc in (("flash_fwd", "fwd_tc_kernel<128, 0, "),
                                            ("flash_bwd_dq", "dq_tc_kernel<128, 0, "),
                                            ("flash_bwd_dkv", "dkv_tc_kernel<128, 0, "))}
        log(f"  timeline.trace over one graphed dispatch: {path}, "
            f"{len(text)} B; B1-B3's kernels named: {seen}")
        if not all(seen.values()):
            log("  the replays' kernels were not seen by the profiler "
                "(graph_kernels_seen: false)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    read_counts(fa, rf)


def zero_tune(torch, fa, rf, basics, train_mod, dev, paths):
    """22d: ``tune(mesh_shapes=("1x1", "1x1x1"))`` through ZeRO, the
    second candidate with a named model axis of one (the model cut over a
    model group of one), against the flat candidate, 3 steps a call,
    twice: graphed (each candidate's step captured on a capturable Adam)
    and with ``graphed=False`` (every candidate's steps eager on a plain
    Adam). The three bit-equal; the memory the graphed sweep leaves
    allocated held to 22a's rule."""
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.loop import WARMUP_STEPS

    config = train_mod.TrainConfig(steps_per_dispatch=3)
    window = dict(warmup=1, iters=1, reps=1, gp_rounds=0)
    for graphed in (True, False):
        basics.init("cuda")
        before = held_memory(torch, dev)
        factory = CountedFactory(train_mod.TuneStepFactory(config, "cuda",
                                                           graphed=graphed), fa, rf)
        read_counts(fa, rf)
        flat = autotune.tune(factory, thresholds=(64 << 20,), **window)
        zero = autotune.tune(factory, thresholds=(64 << 20,),
                             mesh_shapes=("1x1", "1x1x1"), **window)
        factory.factory.close()
        factory.finish()
        after = held_memory(torch, dev)
        a, b, c = factory.factory.records
        log(f"  {'graphed' if graphed else 'eager'}: flat {a['planned_buckets']} "
            f"buckets, graphed {a['graphed']}, losses {a['losses']}, "
            f"{flat.best.steps_per_s * 3:.3f} steps/s; ZeRO 1x1 "
            f"{b['planned_buckets']} buckets, graphed {b['graphed']}, losses "
            f"{b['losses']}, {zero.best.steps_per_s * 3:.3f} steps/s, best config "
            f"{zero.best.config}; 1x1x1 (model size {c['model_size']}) "
            f"{c['planned_buckets']} buckets, graphed {c['graphed']}, losses "
            f"{c['losses']}")
        if (a["graphed"], b["graphed"], c["graphed"]) != (graphed,) * 3:
            raise AssertionError(f"a candidate ran {'eagerly' if graphed else 'graphed'}")
        if a["losses"] != b["losses"] or a["planned_buckets"] != b["planned_buckets"]:
            raise AssertionError("ZeRO at 1x1 is not bit-equal to the flat candidate")
        if c["losses"] != b["losses"] or c["model_size"] != 1 or \
                c["planned_buckets"] != b["planned_buckets"]:
            raise AssertionError("the 1x1x1 candidate is not bit-equal to 1x1")
        # Graphed: the warm-up and the capture run Python, the replays none.
        steps, what = (WARMUP_STEPS + 1, "warm-up and capture") if graphed \
            else (6, "2 calls of 3 steps")
        for counts, r in zip(factory.counts, (a, b, c)):
            hold_counts(f"{'ZeRO ' + r['mesh_shape'] if r['mesh_shape'] else 'flat'}, {what} "
                        f"({steps} steps)", counts,
                        {k: config.layers * steps for k in KERNELS})
        paths[f"22d: tune, ZeRO 1x1, {what}"] = factory.counts[1]
        paths[f"22d: tune, ZeRO 1x1x1, {what}"] = factory.counts[2]
        log(f"  memory allocated before {before / 1e9:.3f} GB, after "
            f"{after / 1e9:.3f} GB; peaks {a['peak_bytes'] / 1e9:.3f} (flat), "
            f"{b['peak_bytes'] / 1e9:.3f} (ZeRO 1x1) and "
            f"{c['peak_bytes'] / 1e9:.3f} GB (ZeRO 1x1x1)")
        if graphed and abs(after - before) > TUNE_LEAK:
            raise AssertionError(f"22d kept {after - before} B allocated")
        basics.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


def tuning_phase(torch, fa, rf, basics, train_mod, card, dev, paths) -> None:
    """Phase 22: 22a, 22b, 22c on 22b's plain run, 22d."""
    log(f"  (22a) tune: thresholds {[t >> 20 for t in TUNE_THRESHOLDS]} MiB x "
        f"buckets {TUNE_BUCKETS} x wires {TUNE_WIRES}, one GP/EI round, graphed "
        f"K = {GRAPH_K}")
    tune_sweep(torch, fa, rf, basics, train_mod, card, dev, paths)
    basics.shutdown()
    log(f"  (22b) TrainingController over TrainRecapture, {CONTROL_WINDOWS} "
        f"windows of one dispatch, canary 2, no cooldown")
    plain, step_rate = controller_run(torch, fa, rf, basics, train_mod, card,
                                      dev, paths)
    log("  (22c) roofline of the eager step and the graphed dispatch; the "
        "timeline's device pane")
    roofline_and_timeline(torch, fa, rf, basics, train_mod, card, dev, paths,
                          plain, step_rate)
    del plain
    basics.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    log("  (22d) tune(mesh_shapes=('1x1', '1x1x1')) through ZeRO against the "
        "flat candidate, 3 steps a call, graphed and all eager (graphed=False)")
    zero_tune(torch, fa, rf, basics, train_mod, dev, paths)


LAUNCH_STEPS = 3
ELASTIC_STEPS = 5
ELASTIC_FAULT_STEP = 2
# The construction is commit 1 and step i's commit is commit i + 1, so the
# 3rd commit, step 2's, writes the checkpoint the worker is killed after.
ELASTIC_CKPT_EVERY = 3


def launched_worker(out: str, steps: int = LAUNCH_STEPS) -> int:
    """23a's worker, started by ``python -m horovod_tpu_torch.runner``:
    ``init()`` from the launcher's env, ``steps`` steps of phase 4's model
    and batch; its losses and launches go to ``out`` (JSON), with the
    launched rank and the control leader it dialed, if any."""
    from horovod_tpu_torch import train as train_mod
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import flash_attention as fa

    config = train_mod.TrainConfig()
    s = train_mod.setup(config, "cuda")
    tokens = train_mod.make_batch(config, basics.rank(), basics.device())
    fa.reset_launches()
    losses = [s.step(tokens).item() for _ in range(steps)]
    with open(out, "w") as f:
        json.dump({"losses": losses, "launches": dict(fa.launches),
                   "rank": basics.rank(), "size": basics.size(),
                   "coord_addr": os.environ.get("HOROVOD_COORD_ADDR"),
                   "launched_rank": os.environ.get("HOROVOD_RANK"),
                   "ctrl_addrs": os.environ.get("HOROVOD_CTRL_ADDRS")}, f)
    basics.shutdown()
    return 0


def elastic_worker(ckpt_dir: str, out: str) -> dict:
    """23b's training function, shipped by ``run_elastic`` by reference
    (``chip_smoke.elastic_worker``): phase 4's model and batch under
    ``hvd.elastic.run``, a commit after every step, a checkpoint every
    ``ELASTIC_CKPT_EVERY``-th commit; a respawned worker cold-starts from
    the checkpoint. The model and its optimizer are built without a
    collective (a joiner meets the others first in ``ElasticState.sync``).
    Writes the final parameters to ``out``; returns its losses, the step it
    resumed from, the load's and each commit's seconds, the wall-clock
    time it resumed at and its B1-B3 launches."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train as train_mod
    from horovod_tpu_torch.convert import jax_ordered
    from horovod_tpu_torch.ops import flash_attention as fa

    hvd.init("cuda")
    dev = hvd.device()
    config = train_mod.TrainConfig()
    model = train_mod.build_model(config, dev)
    opt = hvd.DistributedOptimizer(train_mod.adam(model.parameters(), config),
                                   jax_ordered(model.named_parameters()))
    step = train_mod.make_train_step(model, opt)
    tokens = train_mod.make_batch(config, hvd.rank(), dev)
    state = hvd.elastic.ElasticState(
        checkpoint_dir=ckpt_dir, checkpoint_every=ELASTIC_CKPT_EVERY,
        model=model, opt=opt, step=0, losses=[])
    t0 = time.perf_counter()
    resumed = state.load_checkpoint()
    load_s = time.perf_counter() - t0
    resumed_step = int(state.step) if resumed else 0
    resumed_at = time.time()
    fa.reset_launches()
    commits = []

    @hvd.elastic.run
    def train(state):
        while state.step < ELASTIC_STEPS:
            state.losses = state.losses + [step(tokens).item()]
            state.step += 1
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            state.commit()
            commits.append((int(state.step), time.perf_counter() - t))
        return state.step

    train(state)
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()}, out)
    return {"losses": list(state.losses), "resumed_step": resumed_step,
            "load_s": load_s, "resumed_at": resumed_at, "commits": commits,
            "launches": dict(fa.launches), "rank": hvd.rank(),
            "generation": int(os.environ.get("HOROVOD_ELASTIC_GENERATION", 0))}


def launcher_env() -> dict:
    """This process's env for the launched workers, with the repo on their
    path and no launched-world identity of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "HOROVOD_COORD_ADDR", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    return env


def launched_run(config, tmp, want_losses, card, paths, check_build,
                 env) -> None:
    """23a: ``--check-build``'s output (``check_build``, a running
    process), then one worker through the CLI, with ``env``."""
    stdout, stderr = check_build.communicate(timeout=300)
    if check_build.returncode != 0:
        raise AssertionError(f"--check-build failed:\n{stderr[-3000:]}")
    for line in stdout.splitlines():
        log(f"  | {line}")
    out = os.path.join(tmp, "launched.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "1", "--",
         sys.executable, os.path.abspath(__file__), "--launched-worker", out],
        env=env, capture_output=True, text=True, timeout=600)
    launch_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the launched worker failed ({proc.returncode}):"
                             f"\n{proc.stderr[-3000:]}")
    with open(out) as f:
        got = json.load(f)
    log(f"  (23a) python -m horovod_tpu_torch.runner -np 1: rank {got['rank']} "
        f"of {got['size']} at {got['coord_addr']}, losses {got['losses']} vs "
        f"{want_losses[:LAUNCH_STEPS]}; launch to exit {launch_s:.1f} s ({card})")
    if got["size"] != 1 or got["losses"] != want_losses[:LAUNCH_STEPS]:
        raise AssertionError("the launched worker's losses are not bit-equal "
                             "to the in-process run's")
    counts = {k: got["launches"].get(k, 0) for k in {**KERNELS, **RING_KERNELS}}
    hold_counts("in the launched worker", counts,
                {k: config.layers * LAUNCH_STEPS for k in KERNELS})
    paths[f"23a: {LAUNCH_STEPS} steps in the worker that "
          f"python -m horovod_tpu_torch.runner launched"] = counts


def elastic_run(torch, config, tmp, want_losses, want_params, card,
                paths) -> None:
    """23b: the elastic job, killed after a checkpointed commit, respawned,
    resumed from the checkpoint."""
    import importlib

    from horovod_tpu_torch.runner import run_elastic

    # Shipped by reference: the workers import chip_smoke from their path.
    worker = importlib.import_module("chip_smoke").elastic_worker
    events = os.path.join(tmp, "events.jsonl")
    out = os.path.join(tmp, "elastic_params.pt")
    saved = dict(os.environ)
    os.environ.clear()
    os.environ.update(launcher_env())
    try:
        results = run_elastic(
            worker, args=(os.path.join(tmp, "ckpt"), out),
            num_proc=1, timeout=900,
            env={"HOROVOD_FAULT_INJECT_STEP": str(ELASTIC_FAULT_STEP),
                 "HOROVOD_FAULT_INJECT_INDEX": "0",
                 "HOROVOD_ELASTIC_BLACKLIST_THRESHOLD": "2",
                 "HOROVOD_CKPT_ASYNC": "0",
                 "HOROVOD_ELASTIC_EVENT_LOG": events,
                 # The jiterator's kernel cache lives under HOME: without
                 # it each worker compiles erfinv for the init again.
                 **{k: saved[k] for k in ("HOME",) if k in saved}})
    finally:
        os.environ.clear()
        os.environ.update(saved)
    (got,) = results
    with open(events) as f:
        log_events = [json.loads(line) for line in f]
    failed = [e for e in log_events if e["event"] == "worker_failed"]
    gens = [e["generation"] for e in log_events
            if e["event"] == "rendezvous_complete"]
    log(f"  (23b) run_elastic(num_proc=1): driver events "
        f"{[e['event'] for e in log_events]}; generations {gens}")
    log(f"  respawned worker resumed from step {got['resumed_step']} "
        f"(load_checkpoint {got['load_s']:.3f} s), losses {got['losses']} vs "
        f"{want_losses}")
    if got["resumed_step"] <= 0:
        raise AssertionError("the respawned worker did not resume from the "
                             "checkpoint (step 0)")
    if len(failed) != 1 or gens != [1, 2]:
        raise AssertionError(f"expected one failure and generations [1, 2]: "
                             f"{failed}, {gens}")
    recovered = got["resumed_at"] - failed[0]["time_unix_s"]
    commits = ", ".join(f"step {st} {sec:.3f} s" for st, sec in got["commits"])
    n_params = sum(p.numel() for p in want_params.values())
    log(f"  commits (host snapshot of {n_params:,} "
        f"parameters and Adam's moments; step "
        f"{ELASTIC_CKPT_EVERY} also writes the checkpoint): {commits}; "
        f"failure seen by the driver to resumed from the checkpoint "
        f"{recovered:.1f} s ({card})")
    params = torch.load(out, weights_only=True)
    differ = [k for k in want_params if not torch_equal(params[k], want_params[k])]
    log(f"  final parameters: {len(differ)} of {len(want_params)} differ from "
        f"the run that never stopped")
    if got["losses"] != want_losses or differ:
        raise AssertionError(f"the resumed elastic run is not bit-equal to the "
                             f"run that never stopped ({differ[:5]})")
    counts = {k: got["launches"].get(k, 0) for k in {**KERNELS, **RING_KERNELS}}
    resumed = ELASTIC_STEPS - got["resumed_step"]
    hold_counts("in the respawned elastic worker", counts,
                {k: config.layers * resumed for k in KERNELS})
    paths[f"23b: {resumed} steps of the elastic worker respawned after the "
          f"fault"] = counts


def launcher_phase(torch, fa, rf, basics, train_mod, card, paths,
                   want_losses) -> None:
    """Phase 23, on phase 4's model."""
    import tempfile

    t_phase = time.perf_counter()
    config = train_mod.TrainConfig()
    # --check-build probes the GPUs in a child of its own: it runs beside
    # the in-process steps, which it does not time.
    check_build = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "--check-build"],
        env=launcher_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        basics.shutdown()
        s = train_mod.setup(config, "cuda")
        dev = basics.device()
        tokens = train_mod.make_batch(config, 0, dev)
        read_counts(fa, rf)
        losses = [s.step(tokens).item() for _ in range(ELASTIC_STEPS)]
        counts = read_counts(fa, rf)
        want_params = {n: p.detach().cpu()
                       for n, p in s.model.named_parameters()}
        log(f"  the run that never stopped, in this process: losses {losses}")
        if want_losses is not None and \
                losses != list(want_losses[:ELASTIC_STEPS]):
            raise AssertionError(f"the in-process run's losses {losses} are "
                                 f"not phase 4's {want_losses}")
        hold_counts(f"{ELASTIC_STEPS} steps in this process", counts,
                    {k: config.layers * ELASTIC_STEPS for k in KERNELS})
        paths[f"23: {ELASTIC_STEPS} steps of the run that never stopped"] = counts
        del s, tokens
        basics.shutdown()
        gc.collect()
        torch.cuda.empty_cache()
        # 23a's worker runs beside 23b's elastic job: two processes on the
        # card, each checked bit for bit; 23a's env is taken here, before
        # elastic_run swaps this process's environment.
        with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
            launched = pool.submit(launched_run, config, tmp, losses, card,
                                   paths, check_build, launcher_env())
            elastic_run(torch, config, tmp, losses, want_params, card, paths)
            launched.result()
    finally:
        if check_build.poll() is None:
            check_build.kill()
            check_build.communicate()
    log(f"  phase 23 took {time.perf_counter() - t_phase:.1f} s ({card})")


# Phase 24. Observability of the training path, in a world of one over NCCL
# at full width: the span recorder, the flight ring, the metrics exposition
# and the plan gauges, fed by the port's own exchange. Tracing changes no
# value: every traced loss and parameter is held bit-equal to the untraced
# run from the same weights and batch (the same kernels in the same order;
# the CUDA events are recorded on the streams beside them). The counters
# are read over HTTP from /metrics before and after the steps, and must
# move by exactly the plan's bytes a step; a replay of a captured step
# issues no host call, so nothing moves while a graph replays.
TRACE_STEPS = 3


@contextlib.contextmanager
def env_set(env: dict):
    """``env`` in os.environ for the block, the previous values after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_local_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scrape(port: int) -> dict:
    """``/metrics`` of this process's exposition: each sample's value by its
    name with labels."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def traced_eager(torch, fa, rf, basics, train_mod, card, dev, paths, tmp) -> dict:
    from horovod_tpu_torch import metrics as hvd_metrics
    from horovod_tpu_torch.tracing import collector, flight

    config = train_mod.TrainConfig()
    tokens = train_mod.make_batch(config, 0, dev)
    tdir, fdir = os.path.join(tmp, "trace"), os.path.join(tmp, "flight")
    port = free_local_port()
    runs = {}
    for traced in (False, True):
        env = {"HOROVOD_TRACE_DIR": tdir, "HOROVOD_FLIGHT_DIR": fdir,
               "HOROVOD_METRICS_PORT": str(port)} if traced else {}
        with env_set(env):
            gc.collect()
            torch.cuda.empty_cache()
            s = train_mod.setup(config, "cuda")
            before = scrape(port) if traced else {}
            losses, ms, windows = [], [], []
            read_counts(fa, rf)
            for _ in range(TRACE_STEPS):
                torch.cuda.synchronize(dev)
                t0, p0 = time.monotonic_ns(), time.perf_counter()
                loss = s.step(tokens)
                torch.cuda.synchronize(dev)
                windows.append((t0, time.monotonic_ns()))
                ms.append(1e3 * (time.perf_counter() - p0))
                losses.append(loss.item())
            run = {"losses": losses, "ms": ms, "windows": windows,
                   "counts": read_counts(fa, rf), "buckets": s.opt.plan.num_buckets,
                   "plan": [n for _, n in hvd_metrics.last_plan()],
                   "params": {n: p.detach().cpu() for n, p in s.model.named_parameters()}}
            if traced:
                run["after"] = scrape(port)
                run["before"] = before
            del s
            basics.shutdown()
        runs[traced] = run
    plain, traced = runs[False], runs[True]
    differ = [n for n in plain["params"]
              if not torch_equal(plain["params"][n], traced["params"][n])]
    log(f"  (24a) {TRACE_STEPS} eager steps, traced vs untraced: losses "
        f"{traced['losses']} vs {plain['losses']}; parameters that differ: "
        f"{len(differ)} of {len(plain['params'])}")
    if traced["losses"] != plain["losses"] or differ:
        raise AssertionError(f"a traced step is not bit-equal to an untraced one: "
                             f"{traced['losses']} vs {plain['losses']}, {differ[:5]}")
    for label, run in (("untraced", plain), ("traced", traced)):
        hold_counts(f"24a, {label}, {TRACE_STEPS} steps", run["counts"],
                    {k: config.layers * TRACE_STEPS for k in KERNELS})
        paths[f"24a: {TRACE_STEPS} steps, {label}"] = run["counts"]
    log(f"  step ms untraced {[round(t, 3) for t in plain['ms']]}, traced "
        f"{[round(t, 3) for t in traced['ms']]}; median of steps 1-"
        f"{TRACE_STEPS - 1}: {statistics.median(plain['ms'][1:]):.3f} vs "
        f"{statistics.median(traced['ms'][1:]):.3f} ms, on {card}")
    nb, plan = traced["buckets"], traced["plan"]
    spans, metas = collector.load_spans(tdir)
    by_tid: dict = {}
    for sp in spans:
        by_tid.setdefault(sp["tid"], []).append(sp)
    device_ms = {}
    for b in range(nb):
        for k in range(1, TRACE_STEPS + 1):
            tid = f"grad.{b}#{k}"
            phases = sorted(sp["phase"] for sp in by_tid.get(tid, []))
            if phases != ["done", "enqueue", "wire"]:
                raise AssertionError(f"{tid}: phases {phases}, expected enqueue, "
                                     "wire and done")
            (wire,) = [sp for sp in by_tid[tid] if sp["phase"] == "wire"]
            w0, w1 = traced["windows"][k - 1]
            if not w0 <= wire["t0"] <= wire["t1"] <= w1:
                raise AssertionError(f"{tid}: wire span {wire['t0']}..{wire['t1']} "
                                     f"outside its step's host window {w0}..{w1}")
            device_ms.setdefault(b, []).append((wire["t1"] - wire["t0"]) / 1e6)
    log(f"  spans: grad.0#1 .. grad.{nb - 1}#{TRACE_STEPS} each with enqueue, wire "
        f"and done, every wire span inside its step's host window; "
        f"{len(spans)} spans, clock offset {metas[0]['clock_offset_ns']} ns")
    log(f"  per-bucket device ms (wire span: the input ready to the end "
        f"event), steps 1-{TRACE_STEPS}: "
        + "; ".join(f"{b} ({plan[b]} B): {[round(t, 4) for t in device_ms[b]]}"
                    for b in range(nb)))
    trace_path = os.path.join(tdir, "trace.json")
    collector.merge_trace(tdir, trace_path)

    def strict(c):
        raise ValueError(f"trace.json holds {c}")

    with open(trace_path) as f:
        events = json.loads(f.read(), parse_constant=strict)["traceEvents"]
    log(f"  merge_trace: strict JSON, {len(events)} events")
    after, before = traced["after"], traced["before"]
    moved = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in (
        'horovod_collective_bytes_total{op="allreduce"}',
        'horovod_collectives_total{op="allreduce"}')}
    want = {'horovod_collective_bytes_total{op="allreduce"}': TRACE_STEPS * sum(plan),
            'horovod_collectives_total{op="allreduce"}': TRACE_STEPS * nb}
    gauges = {k: after.get(k) for k in ("horovod_fusion_buckets",
                                        "horovod_fusion_planned_bytes",
                                        "horovod_compiled_wire_bytes_per_step")}
    want_gauges = {"horovod_fusion_buckets": nb,
                   "horovod_fusion_planned_bytes": sum(plan),
                   "horovod_compiled_wire_bytes_per_step": sum(plan)}
    log(f"  /metrics over HTTP: counters moved {moved} (want {want}); plan "
        f"gauges {gauges} (want {want_gauges})")
    if moved != want or gauges != want_gauges:
        raise AssertionError(f"/metrics: {moved} vs {want}, {gauges} vs {want_gauges}")
    ring = flight.read_ring(os.path.join(fdir, "flight-rank0.ring"))
    held = sum(1 for r in ring["records"] if str(r.get("tid", "")).startswith("grad."))
    log(f"  read_ring: {len(ring['records'])} records, {held} of them the "
        f"exchange's spans; fingerprint {ring['meta']['fingerprint']['hash']}")
    if not held:
        raise AssertionError("the flight ring holds none of the exchange's spans")
    return plain


def traced_graph(torch, fa, rf, basics, train_mod, loop_mod, dev, paths,
                 tmp) -> None:
    from horovod_tpu_torch import metrics as hvd_metrics
    from horovod_tpu_torch import tracing

    config = train_mod.TrainConfig(steps_per_dispatch=GRAPH_K)
    tdir = os.path.join(tmp, "trace_graph")
    plan_path = os.path.join(tdir, "compiled-plan-rank0.jsonl")
    span_path = tracing.span_path(tdir, 0)
    runs = {}
    for traced in (False, True):
        with env_set({"HOROVOD_TRACE_DIR": tdir} if traced else {}):
            gc.collect()
            torch.cuda.empty_cache()
            s = train_mod.setup(config, "cuda")
            cache = train_mod.make_cache(config, s.sp, dev)
            loop = loop_mod.make_scan_train_loop(s.step, cache, GRAPH_K,
                                                 optimizer=s.opt)
            loop.warm_up()
            read_counts(fa, rf)
            loop.capture()
            counts = read_counts(fa, rf)
            rec = tracing.get_recorder()
            if traced:
                rec.flush()
                with open(span_path) as f:
                    lines_before = sum(1 for _ in f)
            counters = hvd_metrics.registry().snapshot()["counters"]
            losses = []
            for _ in range(GRAPH_DISPATCHES):
                loop()
                losses += loop.losses.tolist()
            moved = {k: v for k, v in hvd_metrics.registry().snapshot()["counters"].items()
                     if v != counters.get(k)}
            run = {"losses": losses, "counts": counts, "moved": moved}
            if traced:
                rec.flush()
                with open(span_path) as f:
                    run["span_lines"] = (lines_before, sum(1 for _ in f))
            del loop, s
            basics.shutdown()
        runs[traced] = run
    plain, traced = runs[False], runs[True]
    with open(plan_path) as f:
        lines = [json.loads(x) for x in f]
    captures = [x for x in lines if "capture" in x]
    log(f"  (24b) graphed, K = {GRAPH_K}, {GRAPH_DISPATCHES} dispatches: losses "
        f"traced {traced['losses']} vs untraced {plain['losses']}; compiled-plan "
        f"lines {len(lines)} ({len(captures)} from captures: "
        f"{[(x['capture'], x['num_buckets']) for x in captures]}); span lines "
        f"before and after the replays {traced['span_lines']}; counters moved "
        f"during the replays {traced['moved']}")
    for label, run in (("untraced", plain), ("traced", traced)):
        hold_counts(f"24b, capture, {label}", run["counts"],
                    {k: config.layers for k in KERNELS})
        paths[f"24b: capture of one step, {label}"] = run["counts"]
    if traced["losses"] != plain["losses"]:
        raise AssertionError("the traced graphed run is not bit-equal to the "
                             "untraced one")
    if len(captures) != 1 or traced["span_lines"][0] != traced["span_lines"][1] \
            or traced["moved"] or plain["moved"]:
        raise AssertionError("a capture must write one compiled-plan line, and "
                             "no span or counter may move while a graph replays")


def observability_phase(torch, fa, rf, basics, train_mod, loop_mod, card, dev,
                        paths) -> dict:
    """Phase 24; returns 24a's untraced run (losses and parameters), which
    phase 26c's traced run is held to."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        plain = traced_eager(torch, fa, rf, basics, train_mod, card, dev, paths, tmp)
        traced_graph(torch, fa, rf, basics, train_mod, loop_mod, dev, paths, tmp)
    return plain


# -- phase 25: the serving vertical ---------------------------------------------

# TinyLM at the TransformerLM cell's widths, through the JAX package's env
# contract (HOROVOD_SERVE_LLM_{VOCAB,DIM,MAX_CONTEXT,SEED}).
SERVE_LM = dict(vocab=32000, dim=1024, max_context=4096, seed=0)
SERVE_LENS = (1, 7, 33, 64, 129, 256, 400, 512)     # 25a's prompts
SERVE_HTTP_LENS = (2, 5, 17, 48, 80, 150, 200, 300)  # 25b adds these
SERVE_SHARED = 32       # leading tokens every prompt shares (the prefix run)
SERVE_NEW = 32          # tokens generated per request
SERVE_BLOCK = 16
SERVE_POOL = 36         # blocks: the 544-token sequence needs 34 of the 34
#                         usable above the 5% watermark, so the 8 sequences
#                         (107 blocks at their ends) must queue and preempt
SERVE_HTTP_POOL = 4096  # the serving config's pool, 536,870,912 B of K and V
SERVE_KILL_AT = 24      # 25b: the decode replica dies at its 24th submit
# 25c: bench.py:1633-1634's MLP on 64-wide inputs; decode_steps 4 feeds each
# step's output to the next, so its model ends 64 wide
INFER_IN = 64
INFER_RUNS = ((1, (256, 128, 10)), (4, (256, 128, 64)))
INFER_REQUESTS = 64
SERVE_TIMEOUT_S = 600


def serving_prompts(lens, seed: int) -> list:
    """Prompts of the given lengths over TinyLM's vocabulary, made from
    ``seed``; each starts with the same ``SERVE_SHARED`` tokens (or a
    prefix of them), so the prefix cache has prefixes to share."""
    import numpy as np

    rs = np.random.RandomState(seed)
    base = [int(t) for t in rs.randint(0, SERVE_LM["vocab"], SERVE_SHARED)]
    return [base[:min(n, SERVE_SHARED)]
            + [int(t) for t in rs.randint(0, SERVE_LM["vocab"],
                                           max(n - SERVE_SHARED, 0))]
            for n in lens]


def generate_with_logits(torch, sm, params, prompt, n) -> tuple:
    """``lm_generate`` step for step, keeping each generated position's
    logits (on the host) and the K/V it builds: (tokens, logits, K, V)."""
    k, v, nxt = sm.lm_prefill(params, prompt)
    # the prefill's last step again, for its logits (the same operations on
    # the same values)
    last, _, _ = sm.lm_logits_step(params, prompt[-1], len(prompt) - 1,
                                   k[:-1], v[:-1])
    if int(last.argmax()) != nxt:
        raise AssertionError("the prefill's last step did not repeat")
    out, logits = [nxt], [last.cpu()]
    ks, vs = list(k), list(v)
    while len(out) < n:
        lg, kv_k, kv_v = sm.lm_logits_step(params, out[-1], len(ks),
                                           torch.stack(ks), torch.stack(vs))
        ks.append(kv_k)
        vs.append(kv_v)
        out.append(int(lg.argmax()))
        logits.append(lg.cpu())
    return out, torch.stack(logits), torch.stack(ks), torch.stack(vs)


def hold_card_against_cpu(torch, label, card, cpu) -> dict:
    """The near-tie rule: logits within 1e-4 x max|logit| at every position
    up to the first where the tokens part; tokens equal up to the first
    position whose top-2 gap (on the card) is under that tolerance. Returns
    the near-tie positions met, where the tokens parted (or None) and the
    largest logit error over its tolerance."""
    tok_c, lg_c = card[0], card[1]
    tok_h, lg_h = cpu[0], cpu[1]
    ties, worst = [], 0.0
    for i in range(len(tok_c)):
        tol = 1e-4 * float(lg_c[i].abs().max())
        err = float((lg_c[i] - lg_h[i]).abs().max())
        worst = max(worst, err / tol)
        top2 = torch.topk(lg_c[i], 2).values
        gap = float(top2[0] - top2[1])
        if gap < tol:
            ties.append(i)
        if err > tol:
            raise AssertionError(f"{label}: logits at new token {i} differ by "
                                 f"{err:.3e} > {tol:.3e}")
        if tok_c[i] != tok_h[i]:
            if gap >= tol:
                raise AssertionError(
                    f"{label}: token {i} {tok_c[i]} on the card, {tok_h[i]} on "
                    f"the CPU, top-2 gap {gap:.3e} >= {tol:.3e}")
            log(f"    {label}: tokens part at the near-tie at {i}")
            return {"near_ties": ties, "parted_at": i, "err_over_tol": worst}
    if ties:
        log(f"    {label}: near-ties (top-2 gap < 1e-4 x max|logit|) at "
            f"{ties}, tokens equal")
    return {"near_ties": ties, "parted_at": None, "err_over_tol": worst}


def percentile(xs, q) -> float:
    xs = sorted(xs)
    return xs[min(int(len(xs) * q / 100), len(xs) - 1)]


def scheduler_run(torch, sm, kvm, schm, params, prompts, oracle, label,
                  draft_k, prefix) -> dict:
    """One IterationScheduler run over the paged pool on the card: tokens
    and K/V (read back before each sequence retires) bitwise the card's
    oracle; returns the run's counters and times."""

    class Recording(schm.IterationScheduler):
        def _retire(self, seq):
            k, v = self.cache.gather(seq.seq_id, seq.kv_len)
            kept[seq.seq_id] = (k.clone(), v.clone(), time.monotonic())
            super()._retire(seq)

    kept = {}
    cache = kvm.PagedKVCache(SERVE_POOL, SERVE_BLOCK, SERVE_LM["dim"],
                             watermark=0.05, prefix_cache=bool(prefix),
                             device=params["embed"].device)
    sched = Recording(cache, params, max_active=8, admission_window=64,
                      draft_params=sm.draft_lm_params(params) if draft_k else None,
                      draft_k=draft_k)
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        seq = schm.Sequence(i, p, SERVE_NEW)
        seq.submit_t = t0
        sched.submit(seq)
    steps = 0
    while len(sched.finished) < len(prompts):
        sched.step()
        steps += 1
        if steps > 20000:
            raise AssertionError(f"{label}: the scheduler did not finish")
    sync(torch, params["embed"].device)
    wall = time.monotonic() - t0
    st = sched.stats()
    ttft, tpot = [], []
    for seq in sched.finished:
        want_tokens, _, want_k, want_v = oracle[seq.seq_id]
        if seq.state != "finished" or seq.out != want_tokens:
            raise AssertionError(f"{label}: sequence {seq.seq_id} {seq.state}, "
                                 f"tokens {seq.out[:8]}... != the oracle's "
                                 f"{want_tokens[:8]}...")
        k, v, done_t = kept[seq.seq_id]
        if not (torch.equal(k, want_k) and torch.equal(v, want_v)):
            raise AssertionError(f"{label}: sequence {seq.seq_id}'s K/V differ "
                                 f"from the oracle's")
        ttft.append(seq.first_token_rel_s)
        tpot.append((done_t - t0 - seq.first_token_rel_s) / (len(seq.out) - 1))
    out = {"wall_s": wall, "iterations": st["iterations_total"],
           "preemptions": st["preemptions_total"],
           "decode_tokens_per_s": st["tokens_decode_total"] / st["decode_busy_s"],
           "ttft_p50_ms": 1e3 * percentile(ttft, 50),
           "ttft_p99_ms": 1e3 * percentile(ttft, 99),
           "tpot_p50_ms": 1e3 * percentile(tpot, 50),
           "tpot_p99_ms": 1e3 * percentile(tpot, 99),
           "spec_acceptance": (st["spec_accepted_total"] / st["spec_proposed_total"]
                               if st["spec_proposed_total"] else None),
           "prefix_hit_tokens": st["prefix_hit_tokens_total"],
           "cow_copies": st["cow_copies_total"]}
    log(f"    {label}: 8 sequences bitwise the oracle (tokens and K/V) in "
        f"{wall:.2f} s, {out['iterations']} iterations, preemptions "
        f"{out['preemptions']}, decode {out['decode_tokens_per_s']:.1f} tok/s "
        f"(engine busy time), TTFT p50/p99 {out['ttft_p50_ms']:.1f}/"
        f"{out['ttft_p99_ms']:.1f} ms, TPOT p50/p99 {out['tpot_p50_ms']:.2f}/"
        f"{out['tpot_p99_ms']:.2f} ms, spec acceptance {out['spec_acceptance']}, "
        f"prefix hit tokens {out['prefix_hit_tokens']}")
    return out


def serving_in_process(torch, dev) -> dict:
    """25a: TinyLM on the card against the CPU; the scheduler's three runs
    against the card's oracle."""
    import numpy as np

    from horovod_tpu_torch.serving import model as sm
    from horovod_tpu_torch.serving.llm import kv_cache as kvm
    from horovod_tpu_torch.serving.llm import scheduler as schm

    sm.exact_float32(dev)
    params_np = sm.tiny_lm_params(**SERVE_LM)
    card = sm.lm_params_to_torch(params_np, dev)
    cpu = sm.lm_params_to_torch(params_np, "cpu")
    pool_bytes = 2 * SERVE_HTTP_POOL * SERVE_BLOCK * SERVE_LM["dim"] * 4
    log(f"  (25a) TinyLM {SERVE_LM}: {sm.lm_params_nbytes(card):,} B of weights "
        f"on the card; a pool of {SERVE_HTTP_POOL} x {SERVE_BLOCK} holds "
        f"{pool_bytes:,} B of K and V")
    rows_exact = {r: sm._gemm_rows_exact(SERVE_LM["dim"], dev, r)
                  for r in range(1, 6)}
    log(f"    _gemm_rows_exact(1024, {dev}, rows) on the card: {rows_exact}")
    prompts = serving_prompts(SERVE_LENS, 0)
    oracle, t0 = {}, time.perf_counter()
    for i, p in enumerate(prompts):
        oracle[i] = generate_with_logits(torch, sm, card, p, SERVE_NEW)
        if sm.lm_generate(card, p, SERVE_NEW) != oracle[i][0]:
            raise AssertionError(f"prompt {i}: lm_generate and its logit twin "
                                 f"part on the card")
    sync(torch, dev)
    log(f"    the card's oracle, 8 prompts of {list(SERVE_LENS)} tokens, "
        f"{SERVE_NEW} new each: {time.perf_counter() - t0:.2f} s (twice)")
    t0 = time.perf_counter()
    ties = {}
    for i, p in enumerate(prompts):
        host = generate_with_logits(torch, sm, cpu, p, SERVE_NEW)
        ties[i] = hold_card_against_cpu(torch, f"prompt {i} ({len(p)} tokens)",
                                        oracle[i], host)
    log(f"    the card against the CPU by the near-tie rule "
        f"({time.perf_counter() - t0:.1f} s on the CPU): {ties}")
    runs = {}
    for label, draft_k, prefix in (("plain", 0, 0), ("draft_k=4", 4, 0),
                                   ("prefix_cache=1", 0, 1)):
        runs[label] = scheduler_run(torch, sm, kvm, schm, card, prompts, oracle,
                                    label, draft_k, prefix)
    if runs["plain"]["preemptions"] < 1:
        raise AssertionError("the plain run never preempted: the pool forced "
                             "nothing")
    del cpu
    return {"card": card, "sm": sm, "oracle": oracle, "prompts": prompts,
            "rows_exact": rows_exact, "runs": runs, "np": np}


def run_router(spec: dict, tmp: str, env: Optional[dict] = None) -> dict:
    """Run ``chip_smoke.py --serving-router`` on ``spec`` in a process of
    its own (the router must create no CUDA context), with ``env`` added to
    this process's, and return its report."""
    path_in = os.path.join(tmp, f"router-{spec['mode']}-in.json")
    path_out = os.path.join(tmp, f"router-{spec['mode']}-out.json")
    with open(path_in, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, **(env or {}),
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--serving-router", path_in, path_out], env=env,
                          capture_output=True, text=True, timeout=SERVE_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"the {spec['mode']} router failed "
                             f"(rc {proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-5000:]}")
    with open(path_out) as f:
        return json.load(f)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hold_replicas_on(label, report, dev) -> None:
    """Each replica's own ``stats`` reports a device of ``dev``'s type and
    TF32 off; the router never initialized CUDA."""
    for pool, reps in report["replica_stats"].items():
        if not reps:
            raise AssertionError(f"{label}: no {pool} replica answered stats")
        for rid, st in reps.items():
            if not (st.get("device") or "").startswith(dev.type) or \
                    st["numerics"]["allow_tf32"]:
                raise AssertionError(f"{label}: {pool} replica {rid} reports "
                                     f"{st.get('device')}, {st.get('numerics')}")
    if report["router_cuda_initialized"]:
        raise AssertionError(f"{label}: the router created a CUDA context")


def router_device(dev):
    """The routers' ``device=``: None on the card (the default, which gives
    replica i card i % device_count), "cpu" for a CPU rehearsal."""
    return None if dev.type == "cuda" else "cpu"


def serving_http(torch, state, dev, tmp) -> None:
    """25b: LLMServer over HTTP, one prefill and one decode replica (a
    wave, then a wave with the decode replica killed), then colocated."""
    sm, card = state["sm"], state["card"]
    from horovod_tpu_torch.serving.llm.handoff import handoff_nbytes, pack_kv

    np = state["np"]
    prompts = state["prompts"] + serving_prompts(SERVE_HTTP_LENS, 1)
    want = [state["oracle"][i][0] for i in range(len(state["prompts"]))]
    want += [sm.lm_generate(card, p, SERVE_NEW) for p in prompts[len(want):]]
    bytes_want = sum(handoff_nbytes(pack_kv(
        p, np.zeros((len(p), SERVE_LM["dim"]), np.float32),
        np.zeros((len(p), SERVE_LM["dim"]), np.float32), 0)) for p in prompts)
    report = run_router({"mode": "llm", "prompts": prompts, "lm": SERVE_LM,
                         "kill_at": SERVE_KILL_AT,
                         "device": router_device(dev)}, tmp)
    for run in report["runs"]:
        label = f"LLMServer {run['label']}"
        for w, wave in enumerate(run["waves"]):
            bad = [i for i, (code, toks) in enumerate(wave["results"])
                   if code != 200 or toks != want[i]]
            if bad:
                raise AssertionError(f"{label} wave {w}: requests {bad} differ "
                                     f"from the card's oracle: "
                                     f"{[wave['results'][i] for i in bad[:2]]}")
        log(f"    {label}: replicas ready in {run['ready_s']:.1f} s; "
            + "; ".join(f"wave {w}: 16 concurrent requests in {wave['s']:.2f} s, "
                        f"every token stream the card's oracle"
                        for w, wave in enumerate(run["waves"])))
        log(f"      preemptions {run['preemptions']}, handoff bytes by wave "
            f"{[wave['handoff_bytes'] for wave in run['waves']]} "
            f"(handoff_nbytes of the 16 prompts: {bytes_want:,}), deaths "
            f"{run['deaths']}, respawns {run['respawns']}, respawn ready "
            f"{run.get('respawn_s')}, replicas {run['devices']}")
        if run["label"] == "disaggregated":
            if run["waves"][0]["handoff_bytes"] != bytes_want:
                raise AssertionError(f"{label}: wave 0 moved "
                                     f"{run['waves'][0]['handoff_bytes']} B, "
                                     f"handoff_nbytes says {bytes_want}")
            if run["deaths"] < 1 or run["respawns"] < 1:
                raise AssertionError(f"{label}: the decode replica was not killed "
                                     f"and respawned ({run['deaths']} deaths)")
        else:
            if not run["stream_equal"]:
                raise AssertionError(f"{label}: the streamed body does not "
                                     f"reassemble to the plain one")
            log("      a streamed body reassembled to the non-streaming one")
        hold_replicas_on(label, run, dev)
    log(f"    every replica reported a {dev.type} device with TF32 off; the "
        f"router process never initialized CUDA")


def infer_model(torch, dev, path, k, features, inputs):
    """25c's MLP ``features`` on ``INFER_IN``-wide inputs (weights drawn from
    seed ``k``), exported to ``path``; returns the in-process eager forward
    (K times) of ``inputs`` at each padding bucket."""
    import numpy as np

    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch.models.cnn_layers import init_cnn
    from horovod_tpu_torch.models.mlp import MLP
    from horovod_tpu_torch.serving import model as sm
    from horovod_tpu_torch.serving.batcher import bucket_sizes

    model = MLP(features=features, in_features=INFER_IN)
    init_cnn(model, torch.Generator().manual_seed(k))
    ckpt.export_for_inference(path, {"params": model.state_dict()})
    apply_fn = sm.mlp_builder(sm.load_for_serving(path), dev)
    ref = {}
    with torch.no_grad():
        for b in bucket_sizes(8):
            rows = []
            for s in range(0, len(inputs), b):
                x = np.zeros((b, INFER_IN), np.float32)
                chunk = inputs[s:s + b]
                x[:len(chunk)] = chunk
                y = torch.as_tensor(x).to(dev)
                for _ in range(k):
                    y = apply_fn(y)
                rows.append(y.cpu().numpy()[:len(chunk)])
            ref[b] = np.concatenate(rows)
    return ref


def hold_infer_outputs(label, ref, outputs) -> dict:
    """Raise unless each response is bitwise the in-process forward at one
    of the padding buckets; returns the responses by the buckets they
    match."""
    import numpy as np

    hits = {}
    for i, out in enumerate(outputs):
        got = np.asarray(out, np.float32)
        match = tuple(b for b in ref if np.array_equal(got, ref[b][i]))
        if not match:
            raise AssertionError(f"{label}: response {i} matches the "
                                 f"in-process forward at no bucket")
        hits[match] = hits.get(match, 0) + 1
    return hits


def infer_inputs():
    import numpy as np

    return np.random.RandomState(2).uniform(
        -1, 1, (INFER_REQUESTS, INFER_IN)).astype(np.float32)


def serving_infer(torch, dev, tmp) -> None:
    """25c: InferenceServer, two replicas on the card, decode_steps 1 and 4;
    every response bitwise the in-process forward (K times) at the bucket
    it ran in."""
    inputs = infer_inputs()
    runs = []
    refs = []
    for k, features in INFER_RUNS:
        path = os.path.join(tmp, f"mlp-k{k}")
        refs.append(infer_model(torch, dev, path, k, features, inputs))
        runs.append({"checkpoint": path, "decode_steps": k})
    report = run_router({"mode": "infer", "runs": runs,
                         "inputs": inputs.tolist(),
                         "device": router_device(dev)}, tmp)
    for (k, features), ref, run in zip(INFER_RUNS, refs, report["runs"]):
        label = f"InferenceServer decode_steps={k}, MLP{features}"
        hits = hold_infer_outputs(label, ref, run["outputs"])
        log(f"    {label}: replicas ready in {run['ready_s']:.1f} s; "
            f"{INFER_REQUESTS} responses in {run['s']:.2f} s, each bitwise the "
            f"in-process forward at a bucket (responses by the buckets they "
            f"match: {hits}); "
            f"captures per replica (recompiles) {run['recompiles']}, "
            f"horovod_serve_recompiles_total {run['recompiles_total']}, mean "
            f"batch {run['mean_batch']}")
        hold_replicas_on(label, run, dev)


def serving_phase(torch, fa, rf, dev, paths) -> None:
    import tempfile

    read_counts(fa, rf)
    state = serving_in_process(torch, dev)
    counts = read_counts(fa, rf)
    hold_counts("on 25a's path (TinyLM runs on PyTorch ops)", counts, {})
    paths["25a: the serving plane in process"] = counts
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        log("  (25b) LLMServer over HTTP on the card")
        serving_http(torch, state, dev, tmp)
        del state
        torch.cuda.empty_cache()
        log("  (25c) InferenceServer on the card")
        serving_infer(torch, dev, tmp)


def _post_json(port: int, path: str, body: dict, timeout: float):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode()[:500]}


def _concurrently(fn, items, workers: int) -> list:
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, items))


def _wait(cond, timeout: float, what: str) -> float:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)
    return time.monotonic() - t0


def _stream(port: int, body: dict, timeout: float) -> list:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        lines = []
        while True:
            raw = resp.readline()
            if not raw:
                break
            lines.append(json.loads(raw))
        return lines
    finally:
        conn.close()


def _llm_router(spec: dict) -> dict:
    from horovod_tpu_torch.serving.config import LLMConfig, ServeConfig
    from horovod_tpu_torch.serving.llm import LLMServer

    prompts = spec["prompts"]
    runs = []
    for label, colocated in (("disaggregated", 0), ("colocated", 1)):
        cfg = ServeConfig.from_env(port=0, slo_ms=SERVE_TIMEOUT_S * 1e3,
                                   max_retries=3,
                                   replica_start_timeout_s=SERVE_TIMEOUT_S)
        llm = LLMConfig.from_env(
            colocated=colocated, prefill_replicas=1, decode_replicas=1,
            num_blocks=SERVE_HTTP_POOL, block_size=SERVE_BLOCK, max_active=8,
            max_new_tokens=SERVE_NEW, ttft_slo_ms=SERVE_TIMEOUT_S * 1e3,
            **spec["lm"])
        server = LLMServer(config=cfg, llm_config=llm, device=spec["device"])
        if not colocated:
            # the decode pool's first replica (id 0) dies at its
            # SERVE_KILL_AT-th submit: in the second wave of 16
            server.pools["decode"].replica_env.update({
                "HOROVOD_FAULT_INJECT_STEP": str(spec["kill_at"]),
                "HOROVOD_FAULT_INJECT_INDEX": "0"})
        t0 = time.monotonic()
        server.start()
        try:
            if not server.wait_ready(SERVE_TIMEOUT_S):
                raise RuntimeError(f"no replica ready: "
                                   f"{ {r: p.describe() for r, p in server.pools.items()} }")
            run = {"label": label, "ready_s": time.monotonic() - t0, "waves": []}
            counters = server.reg.snapshot()["counters"]
            first = dict(counters)   # the registry is the process's: deltas
            for _ in range(1 if colocated else 2):
                before = dict(counters)
                t1 = time.monotonic()
                results = _concurrently(
                    lambda p: _post_json(server.port, "/v1/generate",
                                         {"prompt": p, "max_tokens": SERVE_NEW},
                                         SERVE_TIMEOUT_S), prompts, len(prompts))
                wave_s = time.monotonic() - t1
                counters = server.reg.snapshot()["counters"]
                run["waves"].append({
                    "s": wave_s,
                    "results": [(code, body.get("tokens", body.get("error")))
                                for code, body in results],
                    "handoff_bytes": counters.get(
                        "horovod_serve_llm_handoff_bytes_total", 0)
                    - before.get("horovod_serve_llm_handoff_bytes_total", 0)})
            if not colocated:
                dec = server.pools["decode"]
                run["respawn_s"] = _wait(lambda: dec.serving_count() >= 1,
                                         SERVE_TIMEOUT_S, "the decode respawn")
            else:
                body = {"prompt": prompts[3], "max_tokens": SERVE_NEW}
                plain = _post_json(server.port, "/v1/generate", body,
                                   SERVE_TIMEOUT_S)[1]
                lines = _stream(server.port, dict(body, stream=True),
                                SERVE_TIMEOUT_S)
                run["stream_equal"] = (
                    [ln["token"] for ln in lines[:-1]] == plain["tokens"]
                    == lines[-1]["tokens"] and set(lines[-1]) == set(plain))
            run["deaths"], run["respawns"] = (
                counters.get(k, 0) - first.get(k, 0)
                for k in ("horovod_serve_replica_deaths_total",
                          "horovod_serve_replica_respawns_total"))
            run["preemptions"] = server.stats()["serving"]["llm"]["preemptions_total"]
            run["replica_stats"] = {role: {str(k): {"device": v.get("device"),
                                                    "numerics": v.get("numerics")}
                                           for k, v in p.replica_stats().items()}
                                    for role, p in server.pools.items()}
            run["devices"] = {role: {str(k): r["device"] for k, r in
                                     p.describe()["replicas"].items()}
                              for role, p in server.pools.items()}
        finally:
            server.stop()
        runs.append(run)
    return {"runs": runs}


def _infer_router(spec: dict) -> dict:
    from horovod_tpu_torch.serving import InferenceServer, ServeConfig

    inputs = spec["inputs"]
    servers, runs, starts = [], [], []
    t0 = time.monotonic()
    try:
        # both servers' replicas come up at once
        for r in spec["runs"]:
            cfg = ServeConfig.from_env(port=0, min_replicas=2, max_replicas=2,
                                       max_batch=8, max_wait_ms=5.0,
                                       slo_ms=SERVE_TIMEOUT_S * 1e3,
                                       decode_steps=r["decode_steps"],
                                       replica_start_timeout_s=SERVE_TIMEOUT_S)
            t1 = time.monotonic()
            servers.append(InferenceServer(r["checkpoint"], config=cfg,
                                           device=spec["device"]).start())
            starts.append(time.monotonic() - t1)
        before = servers[0].reg.snapshot()["counters"].get(
            "horovod_serve_recompiles_total", 0)
        readies = []
        for server in servers:
            _wait(lambda: server.manager.serving_count() >= 2,
                  SERVE_TIMEOUT_S, "two replicas")
            readies.append(time.monotonic() - t0)
        for server, ready, start_s in zip(servers, readies, starts):
            t1 = time.monotonic()
            results = _concurrently(
                lambda x: _post_json(server.port, "/v1/infer", {"inputs": x},
                                     SERVE_TIMEOUT_S), inputs, 16)
            s = time.monotonic() - t1
            bad = [body for code, body in results if code != 200]
            if bad:
                raise RuntimeError(f"{len(bad)} requests failed: {bad[:2]}")
            stats = server.manager.replica_stats()
            snap = server.stats()
            total = snap["metrics"]["counters"].get(
                "horovod_serve_recompiles_total", 0)
            runs.append({
                "ready_s": ready, "start_s": start_s, "s": s,
                "outputs": [body["outputs"] for _, body in results],
                "recompiles": {str(k): v["recompiles"] for k, v in stats.items()},
                "recompiles_total": total - before,
                "mean_batch": snap["serving"]["mean_batch_size"],
                "replica_stats": {"infer": {str(k): {
                    "device": v.get("device"), "numerics": v.get("numerics")}
                    for k, v in stats.items()}}})
            before = total
    finally:
        for server in servers:
            server.stop()
    return {"runs": runs}


def serving_router(path_in: str, path_out: str) -> int:
    """The router process of 25b and 25c: runs the servers ``path_in``
    describes, drives them over HTTP, and writes what it saw (and whether
    this process ever initialized CUDA) to ``path_out``."""
    import torch

    with open(path_in) as f:
        spec = json.load(f)
    report = _llm_router(spec) if spec["mode"] == "llm" else _infer_router(spec)
    initialized = torch.cuda.is_initialized()
    for run in report["runs"]:
        run["router_cuda_initialized"] = initialized
    with open(path_out, "w") as f:
        json.dump(report, f)
    return 0


# -- phase 26: the pod-scale trees -----------------------------------------------

# Phase 26. The control tree, the telemetry tree and checkpoint streaming
# carry the full-width model and the served MLP on the card. Fake hosts are
# hvd-agent processes with HOROVOD_HOSTNAME set, all on this machine; each
# host's control leader lives in its agent, keyed with the job's derived
# secret. The trees are host code: no kernel of their own; the steps they
# carry launch B1-B3.
STREAM_COMMIT = 2      # 26a: the committed step the cold start streams
STREAM_STEPS = 5       # 26a: the run that never stopped
TREE_STEPS = 3         # 26c: phase 24's traced run; 26d: each worker's steps
# 26d: slots on fake hosts a and b. init() refuses a launched world whose
# size is not a multiple of its host's slots (common/topology.py
# validate, in both packages), so each host takes two.
TREE_SLOTS = (2, 2)
# 26d: the leaders' registration window (HOROVOD_CTRL_BATCH_S, default
# 0.05 s). A host's two workers each import torch before they register,
# tens to hundreds of ms apart; one second lets one batch carry both.
TREE_BATCH_S = "1.0"


@contextlib.contextmanager
def fake_hosts(names, secret: bytes, env: Optional[dict] = None):
    """hvd-agents standing in for hosts ``names`` (HOROVOD_HOSTNAME), with
    ``env`` added to their environment; yields their ports, and stops them
    (and with them every leader and worker they host) after."""
    procs, ports = [], []
    try:
        for name in names:
            e = dict(launcher_env(), HOROVOD_HOSTNAME=name,
                     HOROVOD_AGENT_SECRET=secret.hex(), **(env or {}))
            e.pop("HOROVOD_CTRL_TREE", None)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.runner.agent",
                 "--port", "0"], env=e, stdout=subprocess.PIPE, text=True))
        for name, proc in zip(names, procs):
            info = json.loads(proc.stdout.readline() or "{}")
            if info.get("agent") != "ready":
                raise AssertionError(f"fake host {name}: the agent did not start")
            ports.append(info["port"])
            # the workers it spawns share its stdout: keep the pipe drained
            threading.Thread(target=proc.stdout.read, daemon=True).start()
        yield ports
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def start_leader(agent_port: int, secret: bytes, job_id: str, **fields):
    """Start job ``job_id``'s control leader on the fake host at
    ``agent_port``; returns its port and the job's derived secret (the
    workers' HOROVOD_SECRET)."""
    from horovod_tpu_torch.runner.network import BasicClient, derive_key

    client = BasicClient([("127.0.0.1", agent_port)], secret, timeout=30.0)
    try:
        resp = client.request({"kind": "ctrl", "cmd": "start", "job_id": job_id,
                               **fields})
    finally:
        client.close()
    if not resp.get("ok"):
        raise AssertionError(f"the control leader did not start: {resp}")
    return resp["port"], derive_key(secret, b"hvd-job:" + job_id.encode())


def sha256_file(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def hash_seconds(nbytes: int, reps: int = 16) -> tuple:
    """Seconds of one SHA-256 and of one HMAC-SHA256 (the channel's MAC)
    over ``nbytes`` of data on this host, each the median of ``reps``."""
    import hashlib
    import hmac

    data = os.urandom(nbytes)
    key = os.urandom(32)
    out = []
    for fn in (lambda: hashlib.sha256(data).digest(),
               lambda: hmac.new(key, data, hashlib.sha256).digest()):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        out.append(statistics.median(times))
    return tuple(out)


def tensor_digests(torch, s) -> dict:
    """SHA-256 of the bytes of every parameter and Adam state tensor of
    ``s`` (equal digests: bit-equal tensors), by phase 21's names."""
    import hashlib

    def digest(t):
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return hashlib.sha256(raw.numpy().tobytes()).hexdigest()

    out = {f"param {n}": digest(p) for n, p in s.model.named_parameters()}
    for i, st in s.opt.optimizer.state_dict()["state"].items():
        out.update({f"adam {i} {k}": digest(v) if torch.is_tensor(v) else repr(v)
                    for k, v in st.items()})
    return out


def cold_start_worker(dest: str, out: str) -> int:
    """26a's fresh process. It has no view of the committed directory: only
    HOROVOD_SECRET and HOROVOD_CKPT_STREAM_FROM. It asks the leader for the
    manifest (timed alone), streams the checkpoint into ``dest``
    (``fetch_from_peer``), restores it in place on the card into a run drawn
    from seed 1, and runs the steps after the commit; its numbers go to
    ``out`` (JSON)."""
    import torch

    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import train as train_mod
    from horovod_tpu_torch.ckpt_async import stream
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import ring_flash as rf
    from horovod_tpu_torch.runner.network import BasicClient

    key = bytes.fromhex(os.environ["HOROVOD_SECRET"])
    sources = stream.stream_sources_from_env()
    client = BasicClient(sources, key, timeout=600.0)
    try:
        t0 = time.perf_counter()
        man = client.request({"kind": "ckpt_manifest"})
        manifest_s = time.perf_counter() - t0
    finally:
        client.close()
    t0 = time.perf_counter()
    fetched = stream.fetch_from_peer(sources, key, dest)
    fetch_s = time.perf_counter() - t0
    config = train_mod.TrainConfig()
    s = train_mod.setup(dataclasses.replace(config, seed=1), "cuda")
    ckpt.init_optimizer_state(s.opt)
    t0 = time.perf_counter()
    got = restore_in_place(torch, ckpt, dest, ckpt_tree(s, step=0),
                           ckpt.latest_step(dest))
    restore_s = time.perf_counter() - t0
    train_mod.hvd_opt.broadcast_parameters(s.model.state_dict(), root_rank=0)
    train_mod.hvd_opt.broadcast_optimizer_state(s.opt, root_rank=0)
    tokens = train_mod.make_batch(config, 0, basics.device())
    read_counts(fa, rf)
    losses = [s.step(tokens).item() for _ in range(STREAM_STEPS - STREAM_COMMIT)]
    counts = read_counts(fa, rf)
    with open(out, "w") as f:
        json.dump({"manifest_s": manifest_s, "fetch_s": fetch_s,
                   "restore_s": restore_s, "step": int(got["step"]),
                   "losses": losses, "launches": counts,
                   "digests": tensor_digests(torch, s),
                   "manifest": man, "fetched": fetched,
                   "chunk": stream.stream_chunk_bytes()}, f)
    basics.shutdown()
    return 0


def streamed_cold_start(torch, fa, rf, basics, train_mod, card, paths, tmp,
                        agent_port, secret, want_losses) -> None:
    """26a: the full-width model trained STREAM_COMMIT steps and committed,
    then on to STREAM_STEPS (the run that never stopped); the commit
    exported by fake host a's leader and cold-started in a fresh process
    through ``fetch_from_peer``."""
    from horovod_tpu_torch import checkpoint as ckpt

    config = train_mod.TrainConfig()
    s = train_mod.setup(config, "cuda")
    tokens = train_mod.make_batch(config, 0, basics.device())
    read_counts(fa, rf)
    losses = [s.step(tokens).item() for _ in range(STREAM_COMMIT)]
    root = os.path.join(tmp, "committed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(root, ckpt_tree(s, step=STREAM_COMMIT), step=STREAM_COMMIT)
    save_s = time.perf_counter() - t0
    losses += [s.step(tokens).item() for _ in range(STREAM_STEPS - STREAM_COMMIT)]
    counts = read_counts(fa, rf)
    hold_counts(f"26a, {STREAM_STEPS} steps with a commit at step {STREAM_COMMIT}",
                counts, {k: config.layers * STREAM_STEPS for k in KERNELS})
    paths[f"26a: {STREAM_STEPS} steps of the run that never stopped, a commit "
          f"at step {STREAM_COMMIT}"] = counts
    if losses != list(want_losses[:STREAM_STEPS]):
        raise AssertionError(f"26a: the run's losses {losses} are not phase 4's "
                             f"{want_losses}")
    want = tensor_digests(torch, s)
    del s
    basics.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    nbytes = tree_bytes(root)
    port, job_secret = start_leader(agent_port, secret, "stream", ckpt_dir=root)
    dest = os.path.join(tmp, "cold-start-host", "ckpt")
    out = os.path.join(tmp, "cold-start.json")
    env = dict(launcher_env(), HOROVOD_SECRET=job_secret.hex(),
               HOROVOD_CKPT_STREAM_FROM=f"127.0.0.1:{port}")
    env.pop("HOROVOD_CKPT_STREAM_DIR", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--cold-start", dest, out], env=env,
                          capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"26a: the cold-started process failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(out) as f:
        got = json.load(f)
    man = got["manifest"]
    if got["fetched"] != man or man["total_bytes"] != nbytes:
        raise AssertionError(f"26a: the fetch's manifest differs, or its "
                             f"{man['total_bytes']} B are not the commit's {nbytes}")
    t0 = time.perf_counter()
    differ = [e["path"] for e in man["files"]
              if sha256_file(os.path.join(dest, e["path"])) != e["sha256"]]
    hash_s = time.perf_counter() - t0
    chunks = sum(max(1, math.ceil(e["size"] / got["chunk"])) for e in man["files"])
    fetch_s, manifest_s = got["fetch_s"], got["manifest_s"]
    sha_s, hmac_s = hash_seconds(got["chunk"])
    log(f"  commit of {nbytes:,} B ({len(man['files'])} files) at step "
        f"{STREAM_COMMIT}: save {save_s:.3f} s; the leader's manifest (SHA-256 of "
        f"every file) {manifest_s:.3f} s; fetch_from_peer {fetch_s:.3f} s = "
        f"{nbytes / fetch_s / 1e9:.3f} GB/s ({nbytes / max(fetch_s - manifest_s, 1e-9) / 1e9:.3f} "
        f"GB/s after its own manifest), {chunks} chunks of {got['chunk']:,} B; "
        f"restore in place {got['restore_s']:.3f} s; the fresh process "
        f"{child_s:.1f} s in all ({card})")
    per_chunk = (fetch_s - manifest_s) / chunks
    log(f"  a chunk's hashing on this host: SHA-256 {1e3 * sha_s:.2f} ms, "
        f"HMAC-SHA256 {1e3 * hmac_s:.2f} ms, so the leader's HMAC, the client's "
        f"HMAC and its SHA-256 take {1e3 * (sha_s + 2 * hmac_s):.2f} ms of the "
        f"fetch's {1e3 * per_chunk:.2f} ms per chunk")
    log(f"  streamed files against the leader's SHA-256 of the committed ones "
        f"({hash_s:.1f} s): {len(differ)} of {len(man['files'])} differ")
    if differ:
        raise AssertionError(f"26a: streamed files differ: {differ}")
    differ = [k for k in want if got["digests"].get(k) != want[k]]
    log(f"  restored from the stream at step {got['step']} in a seed-1 run, "
        f"{STREAM_STEPS - STREAM_COMMIT} more steps: losses {got['losses']} vs "
        f"{losses[STREAM_COMMIT:]}; tensors whose SHA-256 differs: {len(differ)} "
        f"of {len(want)} (parameters and Adam moments)")
    if got["step"] != STREAM_COMMIT or got["losses"] != losses[STREAM_COMMIT:] \
            or differ or got["digests"].keys() != want.keys():
        raise AssertionError(f"26a: the cold-started run is not bit-equal to the "
                             f"run that never stopped ({differ[:5]})")
    counts = {k: got["launches"].get(k, 0) for k in {**KERNELS, **RING_KERNELS}}
    hold_counts("in the cold-started process", counts,
                {k: config.layers * (STREAM_STEPS - STREAM_COMMIT) for k in KERNELS})
    paths[f"26a: {STREAM_STEPS - STREAM_COMMIT} steps of the process cold-started "
          f"from the stream"] = counts


def streamed_serving(torch, dev, tmp, agent_port, secret) -> None:
    """26b: 25c's exported MLP served from a path that does not exist on the
    serving side: the router's manager streams it from fake host a's
    leader before the first replica spawns."""
    k, features = INFER_RUNS[0]
    inputs = infer_inputs()
    exported = os.path.join(tmp, "exported-mlp")
    ref = infer_model(torch, dev, exported, k, features, inputs)
    port, job_secret = start_leader(agent_port, secret, "serve", ckpt_dir=exported)
    missing = os.path.join(tmp, "serving-host", "mlp")
    report = run_router(
        {"mode": "infer", "runs": [{"checkpoint": missing, "decode_steps": k}],
         "inputs": inputs.tolist(), "device": router_device(dev)}, tmp,
        env={"HOROVOD_SECRET": job_secret.hex(),
             "HOROVOD_CKPT_STREAM_FROM": f"127.0.0.1:{port}"})
    (run,) = report["runs"]
    label = f"InferenceServer decode_steps={k}, MLP{features}, streamed"
    hits = hold_infer_outputs(label, ref, run["outputs"])
    hold_replicas_on(label, run, dev)
    files = sorted(os.listdir(exported))
    same = [f for f in files if sha256_file(os.path.join(exported, f))
            == sha256_file(os.path.join(missing, f))]
    log(f"    {label}: the manager's start() (the fetch) {run['start_s']:.3f} s, "
        f"replicas ready {run['ready_s']:.1f} s after the start, the fetch inside; "
        f"{INFER_REQUESTS} responses in {run['s']:.2f} s, each bitwise the "
        f"in-process forward at a bucket ({hits}); streamed files identical "
        f"to the exported ones: {len(same)} of {len(files)}")
    if same != files:
        raise AssertionError(f"{label}: streamed files differ from the exported")


def settled_stats(svc) -> dict:
    """``svc.stats()`` once its counters stop moving: a service flushes a
    request's bytes just after it answers."""
    last = None
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        cur = svc.stats()
        if cur == last:
            return cur
        last = cur
        time.sleep(0.02)
    return last


def telemetry_tree_run(torch, fa, rf, basics, train_mod, card, paths, tmp,
                       untraced) -> None:
    """26c: phase 24's traced eager run, pushing through a
    ``RankTelemetryClient`` to host a's ``TelemetryAgent``, whose root is a
    ``DriverService``; then ``bundle --leader`` over that run."""
    import pickle

    from horovod_tpu_torch import metrics as hvd_metrics
    from horovod_tpu_torch.metrics.aggregate import merge_snapshots
    from horovod_tpu_torch.metrics.registry import MetricsRegistry
    from horovod_tpu_torch.runner.network import make_secret
    from horovod_tpu_torch.runner.service import DriverService
    from horovod_tpu_torch.telemetry import RankTelemetryClient, TelemetryAgent
    from horovod_tpu_torch.tracing import bundle

    config = train_mod.TrainConfig()
    tdir, fdir = os.path.join(tmp, "trace"), os.path.join(tmp, "flight")
    key = make_secret()
    root = DriverService(1, key)
    # The leader a HostAgent would host for the job (its ``telemetry``
    # command), made here because its root hop is attached in process, as
    # the JAX package's pod smoke makes its leaders.
    agent = TelemetryAgent(key, host_name="a", flight_dir=fdir, trace_dir=tdir,
                           interval_s=1.0, expected_ranks=[0], reg=MetricsRegistry())
    counter = ('horovod_collective_bytes_total{op="allreduce"}',
               'horovod_collectives_total{op="allreduce"}')
    try:
        agent.attach_root(root.addresses(), start_loop=False)
        with env_set({"HOROVOD_TRACE_DIR": tdir, "HOROVOD_FLIGHT_DIR": fdir}):
            gc.collect()
            torch.cuda.empty_cache()
            s = train_mod.setup(config, "cuda")
            tokens = train_mod.make_batch(config, 0, basics.device())
            rc = RankTelemetryClient([("127.0.0.1", agent.port)], key, rank=0)
            before = hvd_metrics.registry().snapshot()["counters"]
            ticks, losses = [], []
            read_counts(fa, rf)
            for _ in range(TREE_STEPS):
                losses.append(s.step(tokens).item())
                a0, r0 = settled_stats(agent), settled_stats(root)
                req = rc.push(hvd_metrics.registry().snapshot())
                agent.push_to_root_once()
                a1, r1 = settled_stats(agent), settled_stats(root)
                ticks.append((req["full"], len(pickle.dumps(req)),
                              a1["bytes_in"] - a0["bytes_in"],
                              r1["bytes_in"] - r0["bytes_in"]))
            counts = read_counts(fa, rf)
            params = {n: p.detach().cpu() for n, p in s.model.named_parameters()}
            plan = [n for _, n in hvd_metrics.last_plan()]
            offset = rc.composed_clock_offset()
            del s
            basics.shutdown()
        snap = hvd_metrics.registry().snapshot()
        rc.push(snap)
        agent.push_to_root_once()
        pod = root.pod_metrics()
        summary = bundle.make_bundle(os.path.join(tmp, "bundle"),
                                     leaders=[f"127.0.0.1:{agent.port}"],
                                     leader_key=key)
        rc.close()
    finally:
        agent.stop()
        root.stop()
    hold_counts(f"26c, {TREE_STEPS} traced steps through the telemetry tree",
                counts, {k: config.layers * TREE_STEPS for k in KERNELS})
    paths[f"26c: {TREE_STEPS} traced steps through the telemetry tree"] = counts
    differ = [n for n in params if not torch_equal(params[n], untraced["params"][n])]
    log(f"  (26c) losses {losses} vs phase 24's untraced {untraced['losses']}; "
        f"parameters that differ: {len(differ)} of {len(params)}")
    if losses != untraced["losses"] or differ:
        raise AssertionError("26c: the traced run through the telemetry tree is "
                             "not bit-equal to the untraced run")
    for i, (full, req_b, leader_b, root_b) in enumerate(ticks):
        log(f"  tick {i + 1}: rank push {'full snapshot' if full else 'delta'} "
            f"{req_b:,} B pickled, {leader_b:,} B in at the leader; leader to root "
            f"{root_b:,} B in at the root")
    moved = {k: snap["counters"].get(k, 0.0) - before.get(k, 0.0) for k in counter}
    pod_c = {k: pod["counters"].get(k) for k in counter}
    own = {k: snap["counters"].get(k) for k in counter}
    flat = merge_snapshots([snap])
    log(f"  the root's pod view {pod_c} vs the rank's own registry {own}; the "
        f"run moved {moved} (plan: {TREE_STEPS} x {sum(plan):,} B in {len(plan)} "
        f"buckets); pod view bitwise the flat merge: "
        f"{json.dumps(pod, sort_keys=True) == json.dumps(flat, sort_keys=True)}")
    if pod_c != own or json.dumps(pod, sort_keys=True) != json.dumps(flat, sort_keys=True) \
            or moved != {counter[0]: TREE_STEPS * sum(plan),
                         counter[1]: TREE_STEPS * len(plan)}:
        raise AssertionError("26c: the root's pod view is not the rank's registry")
    log(f"  composed clock offset (rank to leader to root) {offset[0]} ns, "
        f"error bound {offset[1]} ns")
    with open(os.path.join(tmp, "bundle", "MANIFEST.md")) as f:
        manifest = f.read()
    log(f"  bundle --leader: {summary['hosts_swept']} host swept, "
        f"{summary['flight_files']} flight files, trace {bool(summary['trace'])}, "
        f"coverage gaps {summary['coverage_gaps']}")
    if summary["coverage_gaps"] or summary["hosts_swept"] != 1 \
            or not summary["flight_files"] or not summary["trace"] \
            or "| a | ok |" not in manifest:
        raise AssertionError(f"26c: the sweep named gaps or missed the run: "
                             f"{summary}")


def tree_worker(out: str) -> int:
    """26d's worker, launched by ``run_command`` across the fake hosts: a
    world of one of its own on the shared card (``init(comm=[rank])`` at a
    rendezvous address of its own, since the launched world's is one for
    all), then 23a's worker for TREE_STEPS steps."""
    from horovod_tpu_torch.common import basics

    rank = int(os.environ["HOROVOD_RANK"])
    os.environ["HOROVOD_COORD_ADDR"] = f"127.0.0.1:{free_local_port()}"
    basics.init("cuda", comm=[rank])
    return launched_worker(os.path.join(out, f"rank{rank}.json"), TREE_STEPS)


def recording_driver(base):
    """``base`` recording each request it handles (not the per-rank ones a
    ``host_*`` request loops through) as (kind, client address), and its
    wire totals when it stops."""
    made = []
    depth = threading.local()

    class Recording(base):
        def __init__(self, *a, **k):
            self.seen = []
            super().__init__(*a, **k)
            made.append(self)

        def handle(self, req, client_addr):
            n = getattr(depth, "n", 0)
            if n == 0:
                self.seen.append((req.get("kind"), client_addr))
            depth.n = n + 1
            try:
                return super().handle(req, client_addr)
            finally:
                depth.n = n

        def stop(self):
            self.final_stats = self.stats()
            super().stop()

    return Recording, made


def control_tree_run(torch, fa, rf, card, paths, tmp, ports, secret,
                     want_losses, layers) -> None:
    """26d: ``run_command`` of 4 workers across fake hosts a and b with the
    tree on (``HOROVOD_CTRL_TREE`` unset). The flat control plane runs on
    the card in every one-host launch (phases 23a, 27a, 28a, 30), and
    tests/test_torch_port_ctrl.py holds the tree to it across fake hosts."""
    import horovod_tpu_torch.runner as prunner

    spec = ",".join(f"127.0.0.1@{p}:{n}" for p, n in zip(ports, TREE_SLOTS))
    world = sum(TREE_SLOTS)
    out = os.path.join(tmp, "tree")
    os.makedirs(out)
    saved = prunner.DriverService
    cls, made = recording_driver(saved)
    prunner.DriverService = cls
    prev = os.environ.pop("HOROVOD_CTRL_TREE", None)
    try:
        t0 = time.perf_counter()
        rc = prunner.run_command(
            [sys.executable, os.path.abspath(__file__), "--tree-worker", out],
            hosts=spec, agent_secret=secret, timeout=600,
            env={"HOROVOD_DEVICE_ORDINAL": "0"})
        secs = time.perf_counter() - t0
    finally:
        prunner.DriverService = saved
        if prev is not None:
            os.environ["HOROVOD_CTRL_TREE"] = prev
    if rc != 0:
        raise AssertionError(f"26d: run_command exited {rc}")
    workers = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            workers.append(json.load(f))
    (driver,) = made
    seen, stats = driver.seen, driver.final_stats
    for w in workers:
        if w["losses"] != list(want_losses[:TREE_STEPS]) or w["size"] != 1:
            raise AssertionError(f"26d: launched rank {w['launched_rank']}'s "
                                 f"losses {w['losses']} are not phase 4's first "
                                 f"{TREE_STEPS}")
        if not w["ctrl_addrs"]:
            raise AssertionError(f"26d: launched rank {w['launched_rank']} "
                                 f"dialed the driver, not its host's leader")
    counts = {k: sum(w["launches"].get(k, 0) for w in workers)
              for k in {**KERNELS, **RING_KERNELS}}
    hold_counts(f"26d tree, {world} workers x {TREE_STEPS} steps", counts,
                {k: layers * TREE_STEPS * world for k in KERNELS})
    paths[f"26d: {TREE_STEPS} steps in each of the {world} workers "
          f"run_command launched across two fake hosts, tree"] = counts
    kinds = {}
    for kind, addr in seen:
        kinds.setdefault(kind, []).append(addr)
    request_conns = {a for k, a in seen if k != "host_wait_assignment"}
    wait_conns = {a for k, a in seen if k == "host_wait_assignment"}
    batches = [a for k, a in seen if k == "host_register"]
    per_host = {a: batches.count(a) for a in set(batches)}
    log(f"  (26d) tree: {world} workers in {secs:.1f} s, each one's losses "
        f"phase 4's first {TREE_STEPS}; at the driver: "
        f"{stats['connections_total']} connections, {stats['bytes_in']:,} B in "
        f"+ {stats['bytes_out']:,} B out of control traffic, requests by kind "
        f"{ {k: len(v) for k, v in sorted(kinds.items())} }; worker-side request "
        f"connections {len(request_conns)} (one per host leader), wait "
        f"connections {len(wait_conns)}; host_register per leader connection "
        f"{sorted(per_host.values())} ({card})")
    if len(request_conns) != len(ports) or len(wait_conns) != len(ports) \
            or "register" in {k for k, _ in seen} \
            or any(n > 1 for n in per_host.values()) or len(per_host) != len(ports):
        raise AssertionError(f"26d: the driver did not see one leader per host "
                             f"carrying each host's registrations in one batch: "
                             f"{seen}")


def trees_phase(torch, fa, rf, basics, train_mod, card, dev, paths, want_losses,
                untraced) -> None:
    import secrets
    import tempfile

    t_phase = time.perf_counter()
    secret = secrets.token_bytes(32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trees_") as tmp, \
            fake_hosts(("a", "b"), secret, {"HOROVOD_CTRL_BATCH_S": TREE_BATCH_S}) \
            as ports:
        t0 = time.perf_counter()
        log(f"  (26a) streamed cold start: the full-width model committed at step "
            f"{STREAM_COMMIT}, exported by fake host a's control leader, "
            f"cold-started in a fresh process")
        streamed_cold_start(torch, fa, rf, basics, train_mod, card, paths, tmp,
                            ports[0], secret, want_losses)
        log(f"  26a took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log("  (26b) serving cold start: 25c's MLP streamed to a router whose "
            "checkpoint path does not exist")
        streamed_serving(torch, dev, tmp, ports[0], secret)
        log(f"  26b took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log(f"  (26c) the telemetry tree over phase 24's traced run, {TREE_STEPS} "
            f"steps")
        telemetry_tree_run(torch, fa, rf, basics, train_mod, card, paths, tmp,
                           untraced)
        log(f"  26c took {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        log(f"  (26d) the control tree: run_command of {sum(TREE_SLOTS)} workers "
            f"across fake hosts a:{TREE_SLOTS[0]} and b:{TREE_SLOTS[1]} on the one "
            f"card, the tree on (HOROVOD_CTRL_TREE unset)")
        control_tree_run(torch, fa, rf, card, paths, tmp, ports, secret,
                         want_losses, train_mod.TrainConfig().layers)
        log(f"  26d took {time.perf_counter() - t0:.1f} s")
    log(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s ({card})")


# -- phase 27: the eager engine --------------------------------------------------

ENGINE_TIMED = 3                   # timed allreduces of the big tensor, ring only
ENGINE_SLOTS = (2, 2)
EAGER_EPOCHS, EAGER_STEPS = 2, 8


def world_worker():
    """tests/torch_port_engine_world_worker.py: phase 27's engine world, its
    launchers, its sizes and its oracle."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import torch_port_engine_world_worker as W

    return W


def cpu_model() -> str:
    """The host's CPU and core count from /proc/cpuinfo: its model name, or,
    where the machine reports none ("unknown" in a sandbox), its vendor,
    family, model number and clock."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                      # the first processor's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "")
    if name in ("", "unknown", "-") and info.get("vendor_id"):
        name = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}, {info.get('cpu MHz', '?')} MHz")
    return f"{name or platform.machine() or 'unknown CPU'}, {os.cpu_count()} cores"


ENGINE_CLASSES = {"python": "PyEngine", "native!": "NativeEngine"}


def eager_mnist(tmp, card, cpu, device="cuda", engine="python",
                label="27a") -> dict:
    """27a (28a on the native engine): the eager MNIST example, two ranks
    on the one card, on ``engine`` (HOROVOD_ENGINE); the attention
    kernels' launches that its ranks counted."""
    from horovod_tpu_torch.common.engine import _ring_order_reduce

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    dump, trace = os.path.join(tmp, "dump"), os.path.join(tmp, "trace")
    env = dict(launcher_env(), HOROVOD_DEVICE_ORDINAL="0",
               HOROVOD_ENGINE=engine,
               MNIST_EPOCHS=str(EAGER_EPOCHS), MNIST_STEPS=str(EAGER_STEPS))
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
                    "--", sys.executable,
                    os.path.join(root, "examples", "torch_mnist_eager.py"),
                    "--device", device, "--dump", dump, "--trace", trace],
                   env=env, cwd=root, check=True, timeout=600)
    secs = time.perf_counter() - t0
    d = [np.load(os.path.join(dump, f"rank{r}.npz")) for r in range(2)]
    engines = [str(d[r]["engine"]) for r in range(2)]
    if engines != [ENGINE_CLASSES[engine]] * 2:
        raise AssertionError(f"{label}: the ranks ran {engines}, not "
                             f"{ENGINE_CLASSES[engine]}")
    params = [k for k in d[0].files if k.startswith("param.")]
    grads = [k[4:] for k in d[0].files if k.startswith("avg.")]
    if not params or len(grads) != len(params):
        raise AssertionError(f"{label}: the dump lacks leaves: {d[0].files}")
    for k in params:
        if d[0][k].tobytes() != d[1][k].tobytes():
            raise AssertionError(f"{label}: the ranks' {k} differ")
    for n in grads:
        want = _ring_order_reduce([d[0]["local." + n], d[1]["local." + n]], True)
        for r in range(2):
            if d[r]["avg." + n].tobytes() != want.tobytes():
                raise AssertionError(f"{label}: rank {r}'s averaged grad.{n} is not "
                                     "the canonical reduction")
    losses = [float(x) for x in d[0]["losses"]]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} not finite and falling")
    with open(os.path.join(trace, "host_timeline.json")) as f:
        names = {e["args"]["name"] for e in json.load(f) if e.get("ph") == "M"}
    missing = {f"grad.{n}" for n in grads} - names
    if missing:
        raise AssertionError(f"{label}: the host pane lacks {sorted(missing)}")
    log(f"  ({label}) eager MNIST, 2 ranks on cuda:0, {EAGER_EPOCHS} x {EAGER_STEPS} "
        f"steps in {secs:.1f} s (launch to exit, beside (c)'s world): "
        f"losses {losses}; parameters bitwise equal across ranks; step 1's "
        f"{len(grads)} averaged leaves bitwise the canonical reduction; host "
        f"pane {len(names)} names; every rank on {engines[0]} ({card}; host "
        f"{cpu})")
    return {k: sum(int(d[r][f"launches.{k}"]) for r in range(2))
            for k in [*KERNELS, *RING_KERNELS]}


def hold_orders(label, reports) -> None:
    if len({tuple(rep["order"]) for rep in reports}) != len(reports):
        raise AssertionError(f"{label}: the ranks did not each submit in an "
                             "order of their own")


def report_world(W, label, reports, light, card, cpu, phase="27") -> None:
    r0 = reports[0]
    mib = W.ELEMS * 4 / 2 ** 20
    world = len(reports)
    native = r0.get("engine") == "NativeEngine"
    comps = list(next(iter(r0["planes"].values())))
    log(f"  ({phase}) {label}: planes {list(r0['planes'])} x {len(comps)} wires x "
        f"{W.STEPS} steps of {mib:.0f} MiB"
        f"{f' (under none only on {light})' if light else ''} + "
        f"{W.SMALL} small tensors in {r0['_secs']:.1f} s (launch to exit), every "
        f"result the oracle's")
    for plane in r0["planes"]:
        if native:
            log(f"    {plane}: NativeEngine; shm links per rank "
                f"{[rep['shm_links'][plane]['none'] for rep in reports]}; "
                f"cross-host ring bytes, all ranks, under none "
                f"{sum(rep['cross_bytes'][plane]['none'] for rep in reports)}")
        else:
            log(f"    {plane}: coordinator connections "
                f"{sorted(set(r0['accepted'][plane].values()))}")
        for comp in comps:
            (cold_b, cold_x), (hot_b, hot_x) = \
                r0["ctrl_bytes_per_exchange"][plane][comp][:2]
            line = (f"      {comp}: control bytes per exchange cold "
                    f"{cold_b / max(cold_x, 1):.0f} B ({cold_x:.0f} exchanges), "
                    f"cached {hot_b / max(hot_x, 1):.0f} B ({hot_x:.0f})"
                    if not native else
                    f"      {comp}: control bytes not measured (the native "
                    f"core counts none)")
            line += f"; cache hits {r0['hits'][plane][comp]}"
            secs = r0["engine_s"][plane].get(comp)
            if secs:
                med = statistics.median(secs)
                alg = W.ELEMS * 4 / med / 1e9
                line += (f"; {mib:.0f} MiB allreduce {med * 1e3:.1f} ms median "
                         f"of {len(secs)} ({min(secs) * 1e3:.1f}-"
                         f"{max(secs) * 1e3:.1f}), {alg:.3f} GB/s algbw, "
                         f"{alg * 2 * (world - 1) / world:.3f} GB/s busbw")
            log(line)
    if "dist_s" in r0:
        g = r0["dist_s"]
        med = statistics.median(g["big"])
        log(f"    {g['backend']} (torch.distributed) allreduce of the same "
            f"{mib:.0f} MiB: "
            f"{med * 1e3:.1f} ms median of {len(g['big'])} "
            f"({W.ELEMS * 4 / med / 1e9:.3f} GB/s algbw); the "
            f"{W.SMALL} small ones one after another "
            f"{g['small_all'] * 1e3:.1f} ms")
    log(f"    ({card}; host {cpu})")


def engine_phase(card, paths, device="cuda") -> tuple:
    """27a beside (c)'s world on the fake hosts (neither is timed), then
    (b)'s world alone, the ring timed. Each world runs two planes, and
    the big tensor under every wire on one of them. Each rank counts its
    own attention-kernel launches; the sums are the paths' counts. Every
    world pins the Python engine (HOROVOD_ENGINE=python). Returns the
    oracle's digests and (b)'s reports, which phase 28 reuses."""
    import secrets
    import tempfile

    W = world_worker()
    t_phase = time.perf_counter()
    cpu = cpu_model()
    log(f"  host CPU: {cpu}; {card}")
    world = sum(ENGINE_SLOTS)
    shape = W.sizes(W.ELEMS, W.SMALL)
    with ThreadPoolExecutor(2) as pool, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_engine_") as tmp:
        oracle = pool.submit(W.oracle_digests, W.COMPS, W.STEPS, world, shape,
                             grids=(None, (2, 2)))
        t0 = time.perf_counter()
        mnist = pool.submit(eager_mnist, tmp, card, cpu, device)
        secret = secrets.token_bytes(32)
        with fake_hosts(("a", "b"), secret) as ports:
            spec = ",".join(f"127.0.0.1@{p}:{n}"
                            for p, n in zip(ports, ENGINE_SLOTS))
            relayed = W.launch(os.path.join(tmp, "relayed"), {
                "HOROVOD_ENGINE": "python", "T_PLANES": "ring,hier",
                "T_LIGHT": "ring"}, world, spec, secret)
        mnist_counts = mnist.result()
        log(f"  27a beside (c)'s world took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        flat = W.launch(os.path.join(tmp, "flat"), {
            "HOROVOD_ENGINE": "python", "T_PLANES": "ring,star", "T_LIGHT": "star",
            "T_TIMED": str(ENGINE_TIMED), "T_DIST": "1"}, world)
        log(f"  (b)'s world took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        want = oracle.result()
        log(f"  the oracle was ready {time.perf_counter() - t0:.1f} s later")
    # Both rings held to the flat oracle: the relayed ring is (b)'s, bitwise.
    W.hold(flat, "ring", want[None])
    W.hold(flat, "star", want[None], light=True)
    W.hold(relayed, "ring", want[None], light=True)
    W.hold(relayed, "hier", want[(2, 2)])
    hold_orders("27 b", flat)
    hold_orders("27 c", relayed)
    conns = {(label, plane): set(reps[0]["accepted"][plane].values())
             for label, reps in (("b", flat), ("c", relayed))
             for plane in reps[0]["planes"]}
    if conns != {("b", "ring"): {4}, ("b", "star"): {4}, ("c", "ring"): {2},
                 ("c", "hier"): {2}}:
        raise AssertionError(f"27: coordinator connections {conns}, expected 4 "
                             "flat and 2 through the relays")
    report_world(W, "(b) one host, ring and star", flat, "star", card, cpu)
    report_world(W, "(c) fake hosts a:2,b:2 through the relays, ring and "
                 "two-level", relayed, "ring", card, cpu)
    runs = {"27a: eager MNIST, 2 ranks on the card": mnist_counts,
            "27b/c: engine worlds (host tensors)": {
                k: sum(rep["launches"][k] for rep in flat + relayed)
                for k in [*KERNELS, *RING_KERNELS]}}
    for label, counts in runs.items():
        hold_counts(label, counts, {})
        paths[label] = counts
    log(f"  phase 27 took {time.perf_counter() - t_phase:.1f} s ({card}; host "
        f"{cpu})")
    return want, flat


# -- phase 28: the native eager engine -------------------------------------------

BENCH_DTYPES = ("f32", "bf16")
BENCH_STEPS = 3
# The shm=0 world runs the two wires whose cost is the link: the native
# top-k selection takes seconds on the 64 MiB tensor on either link, and
# the fp16 conversion is slower than the link (PERF.md §6), so neither is
# timed and neither runs without shm.
NATIVE_TIMED_COMPS = ("none", "bf16")
# The big tensor is held to the oracle under none only on the native ring
# with shm (its top-k and fp16 wires took 2 x 6.9-8.5 s and 2 x 0.7 s of
# the phase on the H100 machine's 8-core host, PERF.md §6) and on both
# planes across the fake hosts; the small tensors run every wire
# everywhere, and the CPU tests hold the native top-k on tensors above its
# floor (tests/test_torch_port_native_world.py).
SHM_LIGHT = {"1": "ring", "0": ""}


def build_native() -> tuple:
    """The native core built from horovod_tpu_torch/cc/src (g++, the flags
    of cc/Makefile): its library and the seconds the build took here."""
    from horovod_tpu_torch import cc

    t0 = time.perf_counter()
    built = os.path.exists(cc.library_path())
    return cc.lib_path(), time.perf_counter() - t0, built


def engine_benchmark() -> dict:
    """28d: examples/torch_engine_benchmark.py at -np 4 on the native
    engine, its default payload (100 MB over 160 tensors), each dtype of
    BENCH_DTYPES in one world; {dtype: its JSON line}."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "4", "--",
         sys.executable, os.path.join(root, "examples",
                                      "torch_engine_benchmark.py"),
         "--dtype", ",".join(BENCH_DTYPES), "--steps", str(BENCH_STEPS)],
        env=dict(launcher_env(), HOROVOD_ENGINE="native!"), cwd=root,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"28d: the benchmark exited {proc.returncode}:"
                             f"\n{proc.stderr[-3000:]}")
    lines = {ln["dtype"]: ln for ln in map(json.loads, (
        t for t in proc.stdout.splitlines() if t.startswith("{")))}
    if sorted(lines) != sorted(BENCH_DTYPES) or any(
            ln["engine"] != "NativeEngine" or not ln["correct"]
            for ln in lines.values()):
        raise AssertionError(f"28d: {lines}")
    return lines


def hold_cross(label, flat: int, two: int) -> None:
    if not 0 < two < flat:
        raise AssertionError(f"{label}: cross-host bytes {two} two-level "
                             f"against {flat} flat, not lower")


def native_phase(card, paths, want, python_world, native, device="cuda") -> None:
    """28: the native core on this host. (a) beside (c) on the fake hosts,
    then (b)'s world with the shm links on and off, the ring timed, then
    (d). Every world runs HOROVOD_ENGINE=native!: a failed build or init
    fails the phase; nothing falls back to the Python engine. ``want`` is
    phase 27's oracle; ``python_world`` its (b) reports (the Python ring's
    and gloo's times, printed beside)."""
    import secrets
    import tempfile

    from horovod_tpu_torch import cc

    W = world_worker()
    t_phase = time.perf_counter()
    cpu = cpu_model()
    lib, build_s, prebuilt = native
    if cc.lib_path() != lib:
        raise AssertionError(f"28: the library moved from {lib} to "
                             f"{cc.lib_path()}")
    st = os.statvfs("/dev/shm")
    log(f"  host CPU: {cpu}; {card}")
    log(f"  native core: {lib}, built from horovod_tpu_torch/cc/src in "
        f"{build_s:.1f} s at the start of the run"
        f"{' (found built)' if prebuilt else ''}; /dev/shm "
        f"{st.f_blocks * st.f_frsize / 2 ** 30:.2f} GiB, "
        f"{st.f_bavail * st.f_frsize / 2 ** 30:.2f} GiB free")
    world = sum(ENGINE_SLOTS)
    # The native core fuses the tensors that are ready in one cycle into a
    # bucket and folds the bucket's ring chunks, so a fused tensor's
    # elements fold from other ranks than its own chunks would; the oracle
    # folds each tensor alone. b and c therefore fuse nothing; d fuses.
    native_env = {"HOROVOD_ENGINE": "native!", "HOROVOD_FUSION_THRESHOLD": "0"}
    with ThreadPoolExecutor(1) as pool, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        t0 = time.perf_counter()
        mnist = pool.submit(eager_mnist, tmp, card, cpu, device, "native!",
                            "28a")
        secret = secrets.token_bytes(32)
        with fake_hosts(("a", "b"), secret) as ports:
            spec = ",".join(f"127.0.0.1@{p}:{n}"
                            for p, n in zip(ports, ENGINE_SLOTS))
            hosts = W.launch(os.path.join(tmp, "hosts"), dict(
                native_env, T_PLANES="ring,hier", T_LIGHT="ring,hier",
                T_GATHER="flat,hier"), world, spec, secret)
        mnist_counts = mnist.result()
        log(f"  28a beside (c)'s world took {time.perf_counter() - t0:.1f} s")
        shm = {}
        for on, comps in (("1", W.COMPS), ("0", NATIVE_TIMED_COMPS)):
            t0 = time.perf_counter()
            shm[on] = W.launch(os.path.join(tmp, f"shm{on}"), dict(
                native_env, HOROVOD_SHM=on, T_PLANES="ring",
                T_LIGHT=SHM_LIGHT[on],
                T_COMPS=",".join(comps), T_TIMED=str(ENGINE_TIMED),
                T_TIMED_COMPS=",".join(NATIVE_TIMED_COMPS)), world)
            log(f"  (b)'s world, HOROVOD_SHM={on}, took "
                f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bench = engine_benchmark()
        log(f"  (d) took {time.perf_counter() - t0:.1f} s")
    for on, reps in shm.items():
        W.hold(reps, "ring", {c: want[None][c] for c in reps[0]["planes"]["ring"]},
               light=bool(SHM_LIGHT[on]))
        hold_orders(f"28 b, HOROVOD_SHM={on}", reps)
        links = [rep["shm_links"]["ring"][c] for rep in reps
                 for c in rep["shm_links"]["ring"]]
        if set(links) != {2 if on == "1" else 0}:
            raise AssertionError(f"28 b: HOROVOD_SHM={on} gave shm links "
                                 f"{links}")
    W.hold(hosts, "ring", want[None], light=True)
    W.hold(hosts, "hier", want[(2, 2)], light=True)
    hold_orders("28 c", hosts)
    cross = {p: sum(rep["cross_bytes"][p]["none"] for rep in hosts)
             for p in ("ring", "hier")}
    hold_cross("28 c allreduce", cross["ring"], cross["hier"])
    gathers = [rep["gather"] for rep in hosts]
    digests = {g[m]["digest"] for g in gathers for m in ("flat", "hier")}
    if len(digests) != 1 or {g["hier"]["two_stage"] for g in gathers} != {1} \
            or {g["flat"]["two_stage"] for g in gathers} != {0}:
        raise AssertionError(f"28 c: the ragged allgathers {gathers}")
    gcross = {m: sum(g[m]["cross_bytes"] for g in gathers)
              for m in ("flat", "hier")}
    hold_cross("28 c allgather", gcross["flat"], gcross["hier"])
    for on, reps in shm.items():
        report_world(W, f"(b) one host, ring, HOROVOD_SHM={on}", reps,
                     SHM_LIGHT[on], card, cpu, phase="28")
    report_world(W, "(b) of phase 27, the Python engine, ring and star, beside "
                 "it", python_world, "star", card, cpu, phase="28")
    report_world(W, "(c) fake hosts a:2,b:2, ring and two-level", hosts,
                 "ring, hier", card, cpu, phase="28")
    rows = gathers[0]["flat"]["rows"]
    log(f"  (28c) allreduce cross-host bytes under none, all ranks: two-level "
        f"{cross['hier']} against flat {cross['ring']}; the ragged allgather "
        f"({rows} rows of 4099 float32) two-stage bitwise the flat one, "
        f"cross-host bytes {gcross['hier']} against {gcross['flat']}")
    for dt, line in bench.items():
        log(f"  (28d) engine benchmark, 4 ranks, {dt}: "
            f"{line['payload_bytes'] / 1e6:.1f} MB x {line['tensors']} tensors, "
            f"{line['ms_per_step']:.1f} ms/step, {line['gb_per_s']:.3f} GB/s "
            f"per rank ({line['steps']} steps; shm links "
            f"{line['shm_links']}; {card}; host {cpu})")
    runs = {"28a: eager MNIST on the native engine": mnist_counts,
            "28b/c: native engine worlds (host tensors)": {
                k: sum(rep["launches"][k] for reps in (*shm.values(), hosts)
                       for rep in reps)
                for k in [*KERNELS, *RING_KERNELS]}}
    for label, counts in runs.items():
        hold_counts(label, counts, {})
        paths[label] = counts
    log(f"  phase 28 took {time.perf_counter() - t_phase:.1f} s ({card}; host "
        f"{cpu})")


# -- phase 29: the real-data input path and the graphed ResNet-50 step ------------

# 29a: two dispatches of REAL_K cache-fed steps from one CUDA graph against
# 2 * REAL_K eager steps of the same step on the same cache draws, from the
# same weights (phase 13's rule: every loss, parameter, momentum buffer and
# BatchNorm statistic within 1e-6 relative, bit-equality expected).
REAL_IMAGES, REAL_K, REAL_DISPATCHES = 4096, 4, 2


def example_module(name: str):
    """``examples/<name>.py`` imported from this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_chip_smoke_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cnn_state(s) -> dict:
    """Host copies of the model's parameters and buffers and SGD's
    momentum buffers."""
    out = {k: v.detach().cpu() for k, v in s.model.state_dict().items()}
    for i, p in enumerate(s.opt.optimizer.param_groups[0]["params"]):
        st = s.opt.optimizer.state.get(p, {})
        out[f"momentum.{i}"] = st["momentum_buffer"].detach().cpu()
    return out


def graphed_cnn_against_eager(torch, fa, rf, basics, tc, cache, dev, paths) -> None:
    """29a: ``make_cnn_scan_loop`` at full width against eager cache steps."""
    from horovod_tpu_torch.loop import WARMUP_STEPS

    config = tc.CNNConfig()
    s = tc.setup_cnn(config, "cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    loop = tc.make_cnn_scan_loop(s, cache, REAL_K)
    loop.warm_up()
    warm_s = loop.capture_s
    read_counts(fa, rf)
    loop.capture()
    graph_losses = []
    for _ in range(REAL_DISPATCHES):
        loop()
        graph_losses += loop.losses.tolist()
    counts = read_counts(fa, rf)
    peak = torch.cuda.max_memory_allocated(dev)
    graphed = cnn_state(s)
    log(f"  warm-up ({WARMUP_STEPS} steps) {warm_s:.3f} s, capture "
        f"{loop.capture_s - warm_s:.3f} s, peak memory {peak / 1e9:.2f} GB")
    del loop, s

    e = tc.setup_cnn(config, "cuda")
    step = tc.cnn_cache_step(e)
    ctr, eager_losses = cache.counter(), []
    for _ in range(REAL_K * REAL_DISPATCHES):
        x, y, ctr = cache.sample(ctr)
        eager_losses.append(step(x, y).item())
    counts = {k: counts[k] + v for k, v in read_counts(fa, rf).items()}
    eager = cnn_state(e)
    del e, step
    log(f"  losses graphed {graph_losses}")
    log(f"  losses eager   {eager_losses}")
    worst_loss = max(abs(g - w) / abs(w) for g, w in zip(graph_losses, eager_losses))
    worst, equal = ("", 0.0), graph_losses == eager_losses
    for name, want in eager.items():
        got = graphed[name]
        equal = equal and torch.equal(got, want)
        err = ((got.double() - want.double()).abs().max().item()
               / max(want.double().abs().max().item(), 1e-30))
        worst = max(worst, (name, err), key=lambda x: x[1])
    kinds = sorted({k.rsplit(".", 1)[-1] if not k.startswith("momentum")
                    else "momentum_buffer" for k in eager})
    log(f"  {len(eager)} tensors compared ({', '.join(kinds)}): "
        f"{'bit-equal' if equal else 'not bit-equal'}; largest difference: "
        f"loss {worst_loss:.3e} relative, {worst[0]} {worst[1]:.3e} of its "
        f"max (limit {GRAPH_LIMIT:g})")
    if not (all(math.isfinite(x) for x in graph_losses)
            and worst_loss <= GRAPH_LIMIT and worst[1] <= GRAPH_LIMIT):
        raise AssertionError(f"29a: graphed ResNet-50 steps differ from eager: "
                             f"loss {worst_loss}, {worst}")
    hold_counts("29a: the graphed loop's capture and replays, and its eager "
                "steps", counts, {})
    paths["29a: graphed ResNet-50 loop and eager cache steps"] = counts
    basics.shutdown()
    torch.cuda.empty_cache()


def input_layer_times(torch, ds, sampler, cache, dev, card) -> None:
    """The input layer alone at full width: the cache's draw (a hash, an
    argsort of the shard's rows, two gathers and the cast) on the card,
    CUDA events; the stream's host gather (memmap rows into RAM) and its
    upload with the cast on the card, host clock around a synchronize."""
    ctr = cache.counter()
    draw_ms = time_ms(torch, lambda: cache.sample(ctr), reps=20, warmup=3,
                      inner=10)
    batch = cache.batch
    idx = next(sampler.batches(batch))
    gather, upload = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        xb, yb = ds[idx]
        t1 = time.perf_counter()
        x = torch.from_numpy(xb).to(dev).float() / 127.5 - 1.0
        y = torch.from_numpy(yb).to(dev)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        gather.append((t1 - t0) * 1e3)
        upload.append((t2 - t1) * 1e3)
    del x, y
    nbytes = xb.nbytes
    log(f"  input layer, batch {batch} of 224x224x3 uint8 ({nbytes} B): the "
        f"cache's draw {draw_ms:.4f} ms on the card (CUDA events, median of 20 "
        f"runs of 10); the stream's host gather {statistics.median(gather):.3f} "
        f"ms and upload + cast {statistics.median(upload):.3f} ms "
        f"({nbytes / statistics.median(upload) / 1e6:.3f} GB/s, pageable; host "
        f"clock, median of 10) ({card})")


def realdata_phase(torch, fa, rf, basics, tc, card, dev, paths) -> None:
    """29: (a) the graphed ResNet-50 loop against eager cache steps, the
    input layer's times; (b) ``examples/torch_realdata_benchmark.py
    --json``, all four modes, in this process (its launches counted
    here)."""
    import io
    import tempfile

    from horovod_tpu_torch import data

    t_phase = time.perf_counter()
    ex = example_module("torch_realdata_benchmark")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_realdata_") as tmp:
        data_dir = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        ex.ensure_dataset(data_dir, REAL_IMAGES, 224)
        basics.init("cuda")
        ds = data.MemmapArrayDataset(data_dir)
        sampler = data.DistributedSampler(len(ds))
        imgs, labs = ds[sampler.indices()]
        cache = data.DeviceCache(imgs, labs, batch_size=tc.CNNConfig().batch,
                                 seed=sampler.seed, device=dev)
        del imgs, labs
        log(f"  dataset {ds.images.shape} uint8 ({ds.images.nbytes} B) written "
            f"and its shard on the card ({cache.data.nbytes} B) in "
            f"{time.perf_counter() - t0:.1f} s")
        input_layer_times(torch, ds, sampler, cache, dev, card)
        log(f"  (29a) the graphed ResNet-50 loop, K = {REAL_K}: "
            f"{REAL_DISPATCHES} dispatches against "
            f"{REAL_K * REAL_DISPATCHES} eager cache steps")
        graphed_cnn_against_eager(torch, fa, rf, basics, tc, cache, dev, paths)
        del cache, ds
        gc.collect()
        torch.cuda.empty_cache()

        log("  (29b) examples/torch_realdata_benchmark.py --json, all four "
            "modes at full width")
        out = io.StringIO()
        read_counts(fa, rf)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = ex.main(["--json", "--data-dir", data_dir,
                          "--n-images", str(REAL_IMAGES)])
        counts = read_counts(fa, rf)
        if rc != 0:
            raise AssertionError(f"29b: the example returned {rc}")
        line = json.loads(out.getvalue().strip().splitlines()[-1])
    want = {"batch", "n_images"} | {f"{m}_img_s" for m in ex.MODES} | {
        f"{m}_gap_pct" for m in ex.MODES if m != "synthetic"}
    if set(line) != want or line["batch"] != tc.CNNConfig().batch:
        raise AssertionError(f"29b: the JSON line {line}")
    log(f"  {json.dumps(line)}")
    for m in ex.MODES:
        gap = line.get(f"{m}_gap_pct")
        log(f"  {m:17s} {line[f'{m}_img_s']:>9.1f} img/s"
            f"{'' if gap is None else f', gap {gap}% against synthetic'} "
            f"({card})")
    log(f"  29b took {time.perf_counter() - t0:.1f} s (every loss finite: "
        f"the example sums them on the card and fails on one that is not)")
    hold_counts("29b: the real-data example, four modes", counts, {})
    paths["29b: the real-data example, four modes"] = counts
    basics.shutdown()
    torch.cuda.empty_cache()
    log(f"  phase 29 took {time.perf_counter() - t_phase:.1f} s ({card})")


# -- phase 30: the scaling benchmark ---------------------------------------------

# (b)'s windows, and (a)'s iterations of the 100 MB allreduce: fewer than
# the example's defaults (8 steps x 3, 3), so that the script keeps its
# time limit on the slower hosts; every world still runs and is checked.
SCALE_STEPS, SCALE_REPS, SCALE_ITERS = 2, 2, 2


def scaling_phase(torch, card, cnn_step_ms, paths) -> None:
    """30: ``examples/torch_scaling_benchmark.py`` with every section, in
    a process of its own (its workers are processes; each counts its own
    launches); (c) fed phase 10's measured ResNet-50 step."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cpu = cpu_model()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "examples", "torch_scaling_benchmark.py"),
         "--eager", "--hier", "--compiled", "--compiled-mp", "--buckets-ab",
         "--project", "--step-ms", repr(cnn_step_ms), "--steps", str(SCALE_STEPS),
         "--reps", str(SCALE_REPS), "--iters", str(SCALE_ITERS)],
        env=launcher_env(), cwd=root, capture_output=True, text=True, timeout=900)
    for ln in proc.stderr.splitlines():
        if not ln.startswith("[W"):
            log(f"  {ln.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"30: the scaling benchmark exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    eager, hier = out["eager"], out["eager_hierarchical"]
    comp, mp, ab = (out["compiled"], out["compiled_multiprocess"],
                    out["compiled_buckets_ab"])
    ran = [r["world"] for r in eager["worlds"]]
    if ran != [w for w in (2, 4, 8, 16) if w <= eager["host_cpus"]] or \
            {d["world"] for d in eager["dropped_worlds"]} != \
            {w for w in (2, 4, 8, 16) if w > eager["host_cpus"]}:
        raise AssertionError(f"30a: worlds {ran}, dropped "
                             f"{eager['dropped_worlds']} on "
                             f"{eager['host_cpus']} CPUs")
    hold_cross("30a two-level ring (worst rank)",
               hier["flat_worst_rank_cross_bytes"],
               hier["hier_worst_rank_cross_bytes"])
    if [r["world"] for r in comp["worlds"]] != [1, 2, 4] or \
            [r["world"] for r in comp["nccl"]["worlds"]] != [
                w for w in (1, 2, 4) if w <= torch.cuda.device_count()]:
        raise AssertionError(f"30b: compiled worlds {comp}")
    log(f"  (30a) eager worlds {ran} (every rank's buffer of ones reduced to "
        f"exactly the world), dropped {eager['dropped_worlds']}; per-rank "
        f"import of the native engine up to "
        f"{max(r['import_s'] for r in eager['worlds']):.3f} s (it imports "
        f"torch); two-level {hier['world']} ranks as {hier['hosts']} x "
        f"{hier['ranks_per_host']}: worst rank's cross-host bytes "
        f"{hier['hier_worst_rank_cross_bytes']} against "
        f"{hier['flat_worst_rank_cross_bytes']} flat; host {cpu}; {card}")
    for r in comp["nccl"]["worlds"]:
        log(f"  (30b) NCCL world {r['world']} on {r['device']}: "
            f"{r['step_ms']:.3f} ms a step ({card})")
    log(f"  (30b) process boundary {mp['process_boundary_overhead']:+.3f}; "
        f"buckets {[(r['num_buckets'], r['step_ms']) for r in ab['rows']]} "
        f"ms on gloo world {ab['world']}")
    log(f"  (30c) projection from phase 10's {cnn_step_ms:.3f} ms step: "
        f"{json.dumps(out['projection']['rows'])}")
    counts = {k: 0 for k in [*KERNELS, *RING_KERNELS]}
    sections = [eager, hier, *comp["worlds"], *comp["nccl"]["worlds"],
                *mp["rows"], ab]
    for sec in sections:
        for k, v in sec["launches"].items():
            counts[k] += v
    hold_counts("30: the scaling benchmark's workers", counts, {})
    paths["30: the scaling benchmark's workers"] = counts
    log(f"  phase 30 took {time.perf_counter() - t_phase:.1f} s ({card}; host "
        f"{cpu})")


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

    t_start = time.perf_counter()
    _STARTED.append(t_start)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"[1] device: {card}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        native = pool.submit(build_native)
        list(pool.map(_build.build, SOURCES))
        log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
            f"({', '.join(SOURCES)}, one nvcc each, at once)")
        native = native.result()
    log(f"  the native eager engine's core (g++, beside them) in "
        f"{native[1]:.1f} s: {native[0]}")
    compiled = check_compiled(torch, fa, _build.build)
    errs = None
    timing_inputs = None
    for shape in CHECK_SHAPES:
        log(f"  shape (B, T, H, Hkv, D, causal, dtype) = {shape}")
        shape_errs, inputs = check_shape(torch, fa, dev, shape)
        if errs is None:
            errs, timing_inputs = shape_errs, inputs

    log(f"[3] timing at {CHECK_SHAPES[0]}; every built tile pair of B1-B3 "
        f"against the plain versions, and timed")
    timing = time_kernels(torch, fa, timing_inputs, CHECK_SHAPES[0])
    del timing_inputs
    torch.cuda.empty_cache()
    covered = set()
    for shape in PAIR_SHAPES:
        log(f"  shape (B, T, H, Hkv, D, causal, dtype) = {shape}")
        covered |= check_pairs(torch, fa, dev, shape)
    hold_covered(torch, "3: B1-B3", fa, KERNELS, covered)
    tile_timing = {shape: time_pairs(torch, fa, dev, shape, card)
                   for shape in TILE_TIMING_SHAPES}
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

    log(f"[7] ring kernel timing at {RING_SHAPES[0]}; every built tile pair of "
        f"B4-B6 against the plain versions over the virtual ring, and timed")
    timing.update(time_ring_kernels(torch, rf, dev))
    torch.cuda.empty_cache()
    check_ring_pairs(torch, fa, rf, ra, dev)
    for shape in TILE_TIMING_SHAPES:
        tile_timing[shape].update(time_ring_pairs(torch, fa, rf, dev, shape, card))
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

    flat_graph = {}
    for config in (train_mod.TrainConfig(steps_per_dispatch=GRAPH_K),
                   train_mod.TrainConfig(sp=1, steps_per_dispatch=GRAPH_K)):
        log(f"[13] the graphed loop, {config_label(config)}, K = {GRAPH_K}: "
            f"{GRAPH_DISPATCHES} dispatches against "
            f"{GRAPH_K * GRAPH_DISPATCHES} eager steps")
        graphed_against_eager(torch, fa, rf, basics, train_mod, loop_mod,
                              config, dev, card, paths,
                              keep=None if config.sp else flat_graph)

    log(f"[14] hierarchical data parallelism: ResNet-50 on the ('dcn', 'ici') "
        f"groups of a world of one, {HIER_THRESHOLD} and 64 MiB bucket caps")
    flat_64 = cnn_result.images_per_step / statistics.median(cnn_result.step_s[1:])
    hierarchical_resnet(torch, tc, basics, card, flat_64)

    log(f"[15] Ulysses on the flash kernels: a virtual world of {ULYSSES_N}")
    shard_timing = ulysses_on_card(torch, fa, rf, ra, dev, timing, paths)

    log(f"[16] sharded data parallelism at full width: ZeRO (HOROVOD_MESH=1x1) "
        f"and FSDP against the flat step, {SHARD_STEPS} steps each; graphed "
        f"(K = {GRAPH_K}) against eager and ZeRO graphed against phase 13's "
        f"graphed flat step")
    flat16 = sharded_phase(torch, fa, rf, basics, train_mod, card, dev, paths)
    graphed_sharded(torch, fa, rf, basics, train_mod, loop_mod, card, dev,
                    paths, flat_graph)

    log(f"[17] tensor parallelism through the trainer: a named model axis of "
        f"one (sharded_groups(1, 1, 1)) against the flat setup, eager, graphed "
        f"and with ZeRO; a virtual model group of {TP_N}")
    tensor_parallel(torch, fa, rf, basics, train_mod, loop_mod, card, dev, paths,
                    flat16, flat_graph)
    del flat_graph, flat16

    log(f"[18] the full-width MoE TransformerLM, {MOE_EXPERTS} experts in every "
        f"{MOE_EVERY}nd block: {STEPS} steps; against dense attention; the layer")
    mixture_of_experts(torch, fa, rf, basics, train_mod, card, dev, paths)

    log(f"[19] pipeline parallelism at full width: a pp group of one against the "
        f"flat step ({PP_STEPS} steps; n_micro 1 and {PP_MICRO}); a virtual pp "
        f"of {PP_N}; the pipelined step graphed (K = {GRAPH_K}) against eager")
    pipeline_parallel(torch, fa, rf, basics, train_mod, card, dev, paths)
    graphed_pipeline(torch, fa, rf, basics, train_mod, loop_mod, card, dev, paths)

    log(f"[20] the gradient exchange from the gradient hooks "
        f"(HOROVOD_LATENCY_HIDING=1, {OVERLAP_BUCKETS} buckets) against the serial "
        f"exchange, {OVERLAP_STEPS} steps each; the graphed loop with the hooks on")
    overlap_phase(torch, fa, rf, basics, train_mod, loop_mod, card, dev, paths)

    log(f"[21] checkpoint and resume at full width: eager, graphed (K = {GRAPH_K}) "
        f"and ZeRO into flat, each bit-equal to the run that never stopped; the "
        f"commit's costs; export for inference")
    checkpoint_phase(torch, fa, rf, basics, train_mod, loop_mod, card, dev, paths)

    log(f"[22] tuning and measurement of the training path at full width: "
        f"tune (graphed, K = {GRAPH_K}), the TrainingController over the "
        f"recapture hook, the roofline on the device-read peaks, the "
        f"timeline's device pane, ZeRO 1x1 through the tuner")
    tuning_phase(torch, fa, rf, basics, train_mod, card, dev, paths)

    log("[23] the launcher and elastic training at full width: the CLI's "
        "run_command of a worker, run_elastic killed after a checkpointed "
        "commit and respawned, each bit-equal to the run that never stopped")
    launcher_phase(torch, fa, rf, basics, train_mod, card, paths,
                   result.losses)

    log(f"[24] observability of the training path at full width: "
        f"{TRACE_STEPS} traced eager steps (spans, flight ring, /metrics, plan "
        f"gauges) and the graphed loop (K = {GRAPH_K}) traced, each bit-equal "
        f"to the untraced run")
    untraced = observability_phase(torch, fa, rf, basics, train_mod, loop_mod,
                                   card, dev, paths)

    log(f"[25] the serving plane on the card: TinyLM {SERVE_LM} against the "
        f"CPU and through the paged scheduler (plain, draft_k=4, "
        f"prefix_cache=1); LLMServer over HTTP (disaggregated, a decode "
        f"replica killed mid-load, colocated); InferenceServer (decode_steps "
        f"1 and 4)")
    torch.cuda.empty_cache()
    serving_phase(torch, fa, rf, dev, paths)

    log(f"[26] the pod-scale trees on the card: a streamed cold start of the "
        f"full-width model, a streamed serving cold start, the telemetry tree "
        f"over a traced run, the control tree under run_command across fake "
        f"hosts")
    torch.cuda.empty_cache()
    trees_phase(torch, fa, rf, basics, train_mod, card, dev, paths, result.losses,
                untraced)
    del untraced

    W = world_worker()
    log(f"[27] the eager engine: eager MNIST with two ranks on the card; "
        f"4-process host worlds ({W.ELEMS * 4 >> 20} MiB + {W.SMALL} "
        f"small tensors) on the ring and star planes and through the control "
        f"tree's relays, every wire, cold and cached")
    gc.collect()
    torch.cuda.empty_cache()
    oracle, python_world = engine_phase(card, paths)

    log(f"[28] the native eager engine (horovod_tpu_torch/cc): eager MNIST "
        f"with two ranks on the card; 4-process host worlds "
        f"({W.ELEMS * 4 >> 20} MiB + {W.SMALL} small tensors) with the shm "
        f"links on and off, and across fake hosts on the ring and two-level "
        f"planes with the two-stage allgather, every wire, cold and cached; "
        f"the engine benchmark")
    native_phase(card, paths, oracle, python_world, native)
    del oracle, python_world

    log(f"[29] the real-data input path at full width: a {REAL_IMAGES}-image "
        f"uint8 shard on the card, the graphed ResNet-50 loop (K = {REAL_K}) "
        f"against eager cache steps, the input layer's times, "
        f"examples/torch_realdata_benchmark.py in its four modes")
    gc.collect()
    torch.cuda.empty_cache()
    realdata_phase(torch, fa, rf, basics, tc, card, dev, paths)

    cnn_step_ms = statistics.median(cnn_result.step_s[1:]) * 1e3
    log(f"[30] examples/torch_scaling_benchmark.py: the native engine's "
        f"worlds and the two-level ring, the DistributedOptimizer step over "
        f"gloo and NCCL, 1 against 2 processes, the bucket A/B, the "
        f"projection from phase 10's step ({cnn_step_ms:.3f} ms)")
    scaling_phase(torch, card, cnn_step_ms, paths)

    log("[31] the kernels line")
    kernels = []
    for source, names in SOURCES.items():
        for kname in names:
            replaces = {**KERNELS, **RING_KERNELS}[kname]
            row = {"name": kname, "route": "cuda",
                   "source": f"horovod_tpu_torch/csrc/{source}",
                   "replaces": replaces, "launches": counts[kname],
                   "max_abs_err": errs[kname], **timing[kname],
                   "launches_by_path": {p: c[kname] for p, c in paths.items()}}
            if kname in shard_timing:
                row["ulysses_head_shard"] = shard_timing[kname]
            # Every built tile pair at the layer's shape and its head shard.
            row["tiles"] = {"x".join(map(str, shape)): tile_timing[shape][kname]
                            for shape in TILE_TIMING_SHAPES}
            if kname in compiled:   # bf16 runs on flash_tc.cuh's tensor-core kernel
                row["bf16_kernel"] = {"header": "horovod_tpu_torch/csrc/flash_tc.cuh",
                                      "compiled": compiled[kname]}
            kernels.append(row)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"host CPU: {cpu_model()}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--launched-worker"]:
        sys.exit(launched_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--serving-router"]:
        sys.exit(serving_router(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--cold-start"]:
        sys.exit(cold_start_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--tree-worker"]:
        sys.exit(tree_worker(sys.argv[2]))
    sys.exit(main())
