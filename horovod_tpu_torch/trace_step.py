"""Where one training step's device time goes.

    python -m horovod_tpu_torch.trace_step [--sp N | --model resnet50]
        [--remat] [--loss-chunk C] [--steps-per-dispatch K]

Trains a full-width model on one GPU for 3 warm-up steps, traces a fourth
with ``torch.profiler`` and prints one JSON line: the step's wall time,
the device's busy time (union of kernel intervals) and idle share, the
device time of each class of kernel (by name: convolution, batch norm,
GEMM, pooling, NCCL, copy, elementwise, other) with the class's three
largest kernels, and the 15 kernels with the most device time, by name.
By default the model is the
flash TransformerLM (``train.TrainConfig`` through ``train.train``);
``--sp N`` traces its sequence-parallel ring-flash path
(``TrainConfig(sp=N)``; on one GPU, N = 1, a ring of one). ``--model
resnet50`` traces ResNet-50 data parallelism (``train_cnn.CNNConfig()``
through ``train_cnn.train_cnn``: batch 128, bf16, channels-last).
``--remat`` and ``--loss-chunk C`` set the transformer's long-context
options. ``--steps-per-dispatch K`` trains through the graphed loop and
traces its fourth dispatch, K steps replayed from one CUDA graph; the
JSON line then says whether the profiler saw the kernels of the replays
(``graph_kernels_seen``): a trace without them shows the device idle.
Where the traced step ran NCCL kernels, the line carries ``overlap``:
``metrics.overlap.parse_overlap``'s report of how much of their time ran
under compute.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .common import basics
from .metrics.overlap import chrome_events, parse_overlap
from .train import TrainConfig, train
from .train_cnn import CNNConfig, train_cnn


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


WARMUP_STEPS = 3
TOP = 15
# (class, substrings of a kernel's name), first match wins.
KERNEL_CLASSES = [
    ("batch_norm", ("batch_norm",)),
    ("pooling", ("pool",)),
    ("nccl", ("nccl",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "nhwc", "implicit_gemm")),
    ("gemm", ("gemm", "cublas", "cutlass", "nvjet")),
    ("copy", ("copy", "catarray")),
    ("elementwise", ("elementwise", "reduce")),
]


def kernel_class(name: str) -> str:
    lowered = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in lowered for k in keys):
            return cls
    return "other"


def overlap_field(events: list) -> dict:
    """``{"overlap": parse_overlap(events)}`` when the Chrome trace's
    ``events`` hold an NCCL kernel, else ``{}``."""
    if any(e.get("cat") == "kernel" and "nccl" in e.get("name", "").lower()
           for e in events):
        return {"overlap": parse_overlap(events)}
    return {}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--sp", type=int, default=None,
                       help="ring size (TrainConfig.sp); default: no ring")
    which.add_argument("--model", choices=["transformer", "resnet50"],
                       default="transformer")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--loss-chunk", type=int, default=0)
    parser.add_argument("--steps-per-dispatch", type=int, default=None)
    args = parser.parse_args(argv)
    k = args.steps_per_dispatch
    if args.model == "resnet50":
        if args.remat or args.loss_chunk or k:
            parser.error("--remat, --loss-chunk and --steps-per-dispatch "
                         "are options of the transformer")
        config, trainer = CNNConfig(), train_cnn
        shape = {"model": config.model, "batch": config.batch,
                 "image_size": config.image_size, "dtype": config.dtype}
    else:
        config, trainer = TrainConfig(
            sp=args.sp, remat=args.remat, loss_chunk=args.loss_chunk,
            steps_per_dispatch=k), train
        shape = {"model": "TransformerLM", "layers": config.layers,
                 "sp": config.sp, "remat": config.remat,
                 "loss_chunk": config.loss_chunk, "steps_per_dispatch": k}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def around_step(i):
        return prof if i == WARMUP_STEPS else contextlib.nullcontext()

    try:
        result = trainer(config, (WARMUP_STEPS + 1) * (k or 1), device="cuda",
                         around_step=around_step)
        dev = basics.device()
        wall_us = (result.dispatch_s if k else result.step_s)[-1] * 1e6
        # Device-side events, without the ranges of user annotations (such
        # as the optimizer's), which span kernels and the gaps between them.
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
        intervals = []
        for e in kernels:
            start = e.time_range.start
            end = e.time_range.end
            by_name[e.name][0] += end - start
            by_name[e.name][1] += 1
            intervals.append((start, end))
        busy = _busy_us(intervals)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        by_class: dict[str, dict] = defaultdict(lambda: {"ms": 0.0, "top": []})
        for n, (t, _) in ranked:
            entry = by_class[kernel_class(n)]
            entry["ms"] += t / 1e3
            if len(entry["top"]) < 3:
                entry["top"].append(n[:100])
        graphed = {}
        if k:
            graphed = {"capture_s": result.capture_s,
                       "graph_kernels_seen": len(kernels) > 0}
        print(json.dumps({
            "device": torch.cuda.get_device_name(dev), **shape, **graphed,
            "step_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us if wall_us else None,
            "kernel_events": len(kernels),
            "classes": dict(sorted(by_class.items(), key=lambda kv: -kv[1]["ms"])),
            "top": [{"name": n[:120], "ms": t / 1e3, "calls": c}
                    for n, (t, c) in ranked[:TOP]],
            **overlap_field(chrome_events(prof)),
        }))
    finally:
        basics.shutdown()


if __name__ == "__main__":
    main()
