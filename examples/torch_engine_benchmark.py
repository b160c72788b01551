"""Eager-engine throughput benchmark on the PyTorch port: the counterpart of
``examples/engine_benchmark.py``. Every "step" pushes a ResNet-50-sized
gradient set through the eager engine (``basics.engine()``: the native C++
core by default, the Python engine under ``HOROVOD_ENGINE=python``) and
reports the effective allreduce bandwidth.

The payload models a real gradient exchange: about 160 tensors totalling
about 100 MB (ResNet-50 is 25.6M parameters of 4 bytes), enqueued
asynchronously in one burst like a backward pass and synchronized like
``optimizer.step()``. bfloat16 travels as 16-bit patterns
(``compression.BFLOAT16``).

    python -m horovod_tpu_torch.runner -np 4 -- python examples/torch_engine_benchmark.py
    python -m horovod_tpu_torch.runner -np 4 -- python examples/torch_engine_benchmark.py --mb 200 --steps 10

``--dtype`` takes one dtype or several, comma-separated (``f32,bf16``),
measured one after another in the same world. For each, rank 0 prints one
line of text and one JSON line: the engine's class, the world, the dtype,
the payload, the milliseconds per step, the GB/s per rank, the ring's
passes, bytes sent and shm links (native engine), and whether every
result was the exact average.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.common import basics  # noqa: E402
from horovod_tpu_torch.compression import BFLOAT16, cast  # noqa: E402

DTYPES = {"f64": np.float64, "f32": np.float32, "f16": np.float16,
          "bf16": BFLOAT16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="eager engine allreduce benchmark")
    p.add_argument("--mb", type=float, default=100.0, help="total payload MB")
    p.add_argument("--tensors", type=int, default=160,
                   help="number of tensors (ResNet-50 has ~161 param tensors)")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--dtype", default="f64",
                   help="payload dtype, or several comma-separated, from "
                        f"{sorted(DTYPES)}; 16-bit moves 2 bytes/element on "
                        "the wire")
    args = p.parse_args(argv)
    args.dtypes = args.dtype.split(",")
    bad = [d for d in args.dtypes if d not in DTYPES]
    if bad:
        p.error(f"unknown --dtype {bad}; choose from {sorted(DTYPES)}")
    return args


def bench(eng, rank: int, size: int, name: str, args) -> bool:
    """Time ``args.steps`` steps of the payload in ``name``'s dtype after
    ``args.warmup``; rank 0 prints the rate. Returns whether every result
    was the exact average."""
    dt = np.dtype(DTYPES[name])
    total_elems = int(args.mb * 1e6 / dt.itemsize)
    # Realistic skew: a few big tensors hold most bytes (conv kernels),
    # many small ones (biases/BN) ride the fusion path.
    weights = np.geomspace(1.0, 200.0, args.tensors)
    sizes = np.maximum((weights / weights.sum() * total_elems).astype(int), 16)
    tensors = [cast(np.full(s, float(rank), np.float32), dt) for s in sizes]
    payload_bytes = sum(t.nbytes for t in tensors)
    want = float(np.mean(np.arange(size)))   # exact in every dtype here
    correct = True

    def step(tag):
        nonlocal correct
        handles = [eng.enqueue("allreduce", t, f"{name}.{tag}.{i}")
                   for i, t in enumerate(tensors)]
        for h in handles:
            out = eng.synchronize(h, timeout=300)
            correct = correct and bool(
                np.all(cast(out, np.float32) == np.float32(want)))

    for w in range(args.warmup):
        step(f"w{w}")
    t0 = time.perf_counter()
    for s in range(args.steps):
        step(f"s{s}")
    per_step = (time.perf_counter() - t0) / args.steps
    gb_s = payload_bytes / 1e9 / per_step
    stats = eng.stats() if hasattr(eng, "stats") else {}
    if rank == 0:
        print(f"world {size} ({type(eng).__name__}): "
              f"{payload_bytes / 1e6:.1f} MB x {args.tensors} {name} "
              f"tensors, {per_step * 1e3:.1f} ms/step, {gb_s:.3f} GB/s "
              "effective allreduce bandwidth per rank", flush=True)
        print(json.dumps({
            "engine": type(eng).__name__, "world": size, "dtype": name,
            "tensors": args.tensors, "payload_bytes": payload_bytes,
            "steps": args.steps, "ms_per_step": per_step * 1e3,
            "gb_per_s": gb_s, "ring_passes": stats.get("ring_passes"),
            "ring_bytes_sent": stats.get("ring_bytes_sent"),
            "shm_links": stats.get("shm_links"), "correct": correct}),
            flush=True)
    return correct


def main(argv=None):
    args = parse_args(argv)
    hvd.init(device="cpu")
    eng = basics.engine()
    correct = all([bench(eng, hvd.rank(), hvd.size(), name, args)
                   for name in args.dtypes])
    hvd.shutdown()
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
