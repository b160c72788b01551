"""Real-data input path vs synthetic on the PyTorch port: the measured gap,
four ways. The counterpart of ``examples/realdata_benchmark.py``: the same
flags, modes and JSON keys, the same measurement protocol, and the same
ResNet-50 step (``train_cnn``'s: bf16, channels-last, SGD with momentum
through ``DistributedOptimizer``), fed four ways:

1. ``synthetic``: ``train_cnn``'s batch, resident on the card: the
   ceiling without an input pipeline.
2. ``stream``: a host pipeline per step: ``MemmapArrayDataset`` rows of
   ``DistributedSampler.batches``, uint8 copied host -> card, then the
   cast ``x / 127.5 - 1`` on the card.
3. ``device-cache``: this rank's shard uploaded once as uint8
   (``data.DeviceCache``); every batch drawn and cast on the card from a
   device counter, one eager step per call: no host -> card bytes per step.
4. ``device-cache-scan``: mode 3 with ``--scan-steps`` steps per dispatch,
   one CUDA graph replayed K times (``train_cnn.make_cnn_scan_loop``: the
   BatchNorm statistics, the momentum and the counter the warm-up moved
   are put back before the capture).

Protocol (the JAX example's): ``--num-warmup`` calls, then ``--reps``
windows of ``--window`` calls, one host sync per window, the median
window's rate; every mode starts from a fresh copy of the same initial
state. Every loss of a window is summed on the device and read at the
window's sync: a loss that is not finite fails the run.

    python examples/torch_realdata_benchmark.py [--json]
        [--modes synthetic,stream,device-cache,device-cache-scan]
    python examples/torch_realdata_benchmark.py --device cpu \\
        --model ResNet18 --image-size 32 --batch 2 --n-images 16 \\
        --dtype float32 --json

On the card by default at full width: ResNet-50, 224 x 224 x 3, 128
images per card, a 4,096-image uint8 dataset (616,562,688 B; each rank's
shard lives on its card in modes 3 and 4). The JSON line holds ``batch``
(images per step over all ranks), ``n_images``, ``<mode>_img_s`` and,
for every mode but ``synthetic``, ``<mode>_gap_pct`` against it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run from repo without install

import numpy as np

MODES = ("synthetic", "stream", "device-cache", "device-cache-scan")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir",
                   default=os.path.join(tempfile.gettempdir(), "hvd_torch_realdata"))
    p.add_argument("--n-images", type=int, default=4096)
    p.add_argument("--num-warmup", type=int, default=5)
    p.add_argument("--window", type=int, default=20, help="calls per window")
    p.add_argument("--reps", type=int, default=3, help="windows (median)")
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--scan-steps", type=int, default=4,
                   help="steps per dispatch for the device-cache-scan mode "
                        "(train_cnn.make_cnn_scan_loop)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--model", default="ResNet50")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch", type=int, default=128, help="images per rank")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="activations (parameters stay float32)")
    args = p.parse_args(argv)
    unknown = set(args.modes.split(",")) - set(MODES)
    if unknown:
        p.error(f"unknown modes {sorted(unknown)}; use {','.join(MODES)}")
    return args


def ensure_dataset(data_dir: str, n: int, image: int) -> None:
    """uint8 ImageNet-shaped shards (the decoded-JPEG storage format): the
    JAX example's bytes for the same ``(n, image)``."""
    img_path = os.path.join(data_dir, "images.npy")
    if os.path.exists(img_path):
        existing = np.load(img_path, mmap_mode="r")
        # A dataset written at another image size must not feed this run.
        if len(existing) >= n and existing.shape[1:] == (image, image, 3):
            return
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    out = np.lib.format.open_memmap(img_path, mode="w+", dtype=np.uint8,
                                    shape=(n, image, image, 3))
    for i in range(0, n, 512):
        m = min(512, n - i)
        out[i:i + m] = rng.integers(0, 256, (m, image, image, 3), dtype=np.uint8)
    out.flush()
    del out
    np.save(os.path.join(data_dir, "labels.npy"),
            rng.integers(0, 1000, size=(n,), dtype=np.int64))


def main(argv=None) -> int:
    args = parse_args(argv)
    modes = args.modes.split(",")
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.data import (DeviceCache, DistributedSampler,
                                        MemmapArrayDataset)
    from horovod_tpu_torch.train_cnn import (CNNConfig, cnn_cache_step,
                                             make_cnn_scan_loop, nchw,
                                             setup_cnn)

    hvd.init(args.device)
    dev = hvd.device()
    if hvd.local_rank() == 0:
        ensure_dataset(args.data_dir, args.n_images, args.image_size)
    if hvd.size() > 1:
        torch.distributed.barrier()
    ds = MemmapArrayDataset(args.data_dir)
    sampler = DistributedSampler(len(ds))
    cache = None
    if "device-cache" in modes or "device-cache-scan" in modes:
        imgs, labs = ds[sampler.indices()]          # this rank's disjoint 1/N
        cache = DeviceCache(imgs, labs, batch_size=args.batch,
                            seed=sampler.seed, device=dev)
        del imgs, labs

    config = CNNConfig(model=args.model, image_size=args.image_size,
                       batch=args.batch, num_classes=1000, dtype=args.dtype,
                       channels_last=dev.type == "cuda")
    s = setup_cnn(config, dev)
    batch = args.batch * hvd.size()
    initial = {k: v.detach().clone() for k, v in s.model.state_dict().items()}

    def fresh_state():
        with torch.no_grad():
            for k, v in s.model.state_dict().items():
                v.copy_(initial[k])
        s.opt.optimizer.state.clear()   # SGD's momentum starts anew

    def measure(mode, run_step, steps_per_call=1):
        """Chained calls, one host sync per window (the read of the
        window's summed losses), the median window's rate."""
        fresh_state()
        total = torch.zeros((), device=dev)
        for _ in range(args.num_warmup):
            total = total + run_step()
        float(total)
        rates = []
        for _ in range(args.reps):
            total = torch.zeros((), device=dev)
            t0 = time.perf_counter()
            for _ in range(args.window):
                total = total + run_step()
            value = float(total)
            rates.append(args.window / (time.perf_counter() - t0))
            if not math.isfinite(value):
                raise RuntimeError(f"{mode}: a loss of the window is not "
                                   f"finite (sum {value})")
        return float(np.median(rates)) * batch * steps_per_call

    results = {}

    if "synthetic" in modes:
        results["synthetic"] = measure(
            "synthetic", lambda: s.step(s.images, s.labels))

    if "stream" in modes:
        stream: list = []
        epoch = [0]

        def stream_step():
            if not stream:
                sampler.set_epoch(epoch[0])
                stream.extend(sampler.batches(args.batch))
                epoch[0] += 1
            xb, yb = ds[stream.pop(0)]
            x = torch.from_numpy(xb).to(dev).float() / 127.5 - 1.0
            return s.step(nchw(x, config.channels_last),
                          torch.from_numpy(yb).to(dev))

        results["stream"] = measure("stream", stream_step)

    if "device-cache" in modes:
        step = cnn_cache_step(s)
        ctr = [None]

        def cache_step():
            if ctr[0] is None:
                ctr[0] = cache.counter()
            x, y, ctr[0] = cache.sample(ctr[0])
            return step(x, y)

        results["device-cache"] = measure("device-cache", cache_step)

    if "device-cache-scan" in modes:
        K = args.scan_steps
        box = []

        def scan_step():
            if not box:   # built after measure()'s fresh state: the capture
                box.append(make_cnn_scan_loop(s, cache, K))   # sees it
            return box[0]()

        results["device-cache-scan"] = measure("device-cache-scan", scan_step, K)

    base = results.get("synthetic")
    out = {"batch": batch, "n_images": args.n_images}
    for k, v in results.items():
        out[f"{k}_img_s"] = round(v, 1)
        if base and k != "synthetic":
            out[f"{k}_gap_pct"] = round((1 - v / base) * 100, 2)
    if hvd.rank() == 0:
        where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu")
        print(f"{args.model} {args.image_size}px, {args.batch} images per "
              f"rank x {hvd.size()} on {where}", file=sys.stderr)
        if args.json:
            print(json.dumps(out))
        else:
            for k, v in results.items():
                gap = (f"  (gap {out[f'{k}_gap_pct']}%)"
                       if f"{k}_gap_pct" in out else "")
                print(f"{k:17s}: {v:,.0f} img/s{gap}")
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
