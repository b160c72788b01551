"""Where one training step's device time goes.

    python -m horovod_tpu_torch.trace_step [--sp N]

Trains the full-width flash TransformerLM (``train.TrainConfig``) on one
GPU through ``train.train`` for 3 warm-up steps, traces a fourth with
``torch.profiler`` and prints one JSON line: the step's wall time, the
device's busy time (union of kernel intervals) and idle share, and the 15
kernels with the most device time, by name. ``--sp N`` traces the
sequence-parallel ring-flash path (``TrainConfig(sp=N)``; on one GPU,
N = 1, a ring of one); without it, slice 1's flash path.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .common import basics
from .train import TrainConfig, train


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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sp", type=int, default=None,
                        help="ring size (TrainConfig.sp); default: no ring")
    config = TrainConfig(sp=parser.parse_args(argv).sp)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def around_step(i):
        return prof if i == WARMUP_STEPS else contextlib.nullcontext()

    try:
        result = train(config, WARMUP_STEPS + 1, device="cuda",
                       around_step=around_step)
        dev = basics.device()
        wall_us = result.step_s[-1] * 1e6
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
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        print(json.dumps({
            "device": torch.cuda.get_device_name(dev),
            "layers": config.layers, "sp": config.sp,
            "step_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us if wall_us else None,
            "kernel_events": len(kernels),
            "top": [{"name": n[:120], "ms": t / 1e3, "calls": c}
                    for n, (t, c) in top],
        }))
    finally:
        basics.shutdown()


if __name__ == "__main__":
    main()
