"""Synthetic image-model benchmark on the PyTorch port: the counterpart of
``examples/jax_synthetic_benchmark.py`` (the reference's
pytorch_synthetic_benchmark): img/sec per device, mean +- 1.96 sigma over
the timed iterations, and the total over the devices.

    torchrun --nproc-per-node 2 examples/torch_synthetic_benchmark.py \
        --model ResNet50 --batch-size 64

The step is ``train_cnn``'s (``setup_cnn``): the zoo's model, bf16
activations, channels-last, SGD with momentum through
``DistributedOptimizer``, on one repeated batch of synthetic images. On
the card unless ``--device cpu``. ``--roofline`` then profiles the step
with ``horovod_tpu_torch/utils/roofline.py`` and prints its report (on the
CPU: that it is unavailable).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run from repo without install

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.train_cnn import CNN_MODELS, CNNConfig, setup_cnn


def main(argv=None):
    parser = argparse.ArgumentParser(description="torch synthetic benchmark")
    parser.add_argument("--model", default="ResNet50", choices=sorted(CNN_MODELS))
    parser.add_argument("--batch-size", type=int, default=64,
                        help="per-device batch size")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-warmup-batches", type=int, default=10)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--roofline", action="store_true",
                        help="after the throughput loop, profile the step and "
                             "print its roofline")
    args = parser.parse_args(argv)

    config = CNNConfig(model=args.model, image_size=args.image_size,
                       batch=args.batch_size, dtype=args.dtype,
                       channels_last=args.device == "cuda")
    s = setup_cnn(config, args.device)
    n_dev, dev = hvd.size(), hvd.device()

    def run_batches(n):
        for _ in range(n):
            loss = s.step(s.images, s.labels)
        loss.item()               # one host sync per run of batches

    if hvd.rank() == 0:
        print(f"Model: {args.model}, batch {args.batch_size}/device x {n_dev} "
              f"devices, {dev}")
    run_batches(args.num_warmup_batches)
    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        run_batches(args.num_batches_per_iter)
        rate = args.batch_size * args.num_batches_per_iter / (time.perf_counter() - t0)
        img_secs.append(rate)
        if hvd.rank() == 0:
            print(f"Iter #{i}: {rate:.1f} img/sec per device")
    img_sec_mean = np.mean(img_secs)
    img_sec_conf = 1.96 * np.std(img_secs)
    if hvd.rank() == 0:
        print(f"Img/sec per device: {img_sec_mean:.1f} +- {img_sec_conf:.1f}")
        print(f"Total img/sec on {n_dev} device(s): "
              f"{n_dev * img_sec_mean:.1f} +- {n_dev * img_sec_conf:.1f}")
    if args.roofline:
        # Every rank runs the profiled steps (they hold collectives); rank 0
        # prints its card's report.
        from horovod_tpu_torch.utils.roofline import format_report, profile_device_ops

        rep = profile_device_ops(lambda: run_batches(1), steps=5)
        if hvd.rank() == 0:
            print(format_report(rep))
    hvd.shutdown()


if __name__ == "__main__":
    main()
