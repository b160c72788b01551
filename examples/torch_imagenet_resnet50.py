"""ImageNet-style ResNet training with checkpoint and resume on the PyTorch
port: the counterpart of ``examples/jax_imagenet_resnet50.py`` (resume-epoch
discovery, the warmup schedule, rank-0 checkpointing, the cross-rank digest
on restore, output on rank 0).

    torchrun --nproc-per-node 2 examples/torch_imagenet_resnet50.py \
        --epochs 4 --checkpoint-dir /tmp/cktorch
    python -m horovod_tpu_torch.runner -np 2 -- \
        python examples/torch_imagenet_resnet50.py --device cpu

It runs on the card by default (``--device cpu`` for the CPU). The model,
its optimizer state and the epoch are one checkpoint tree, saved on rank 0
after every epoch as ``<dir>/step_<epoch>``. A relaunch finds the newest
one (``checkpoint.latest_step``), restores it on every rank in place into
the live model and optimizer, broadcasts the resume epoch, and continues.
Each step's batch is drawn from (seed, epoch, step, rank), so a resumed
run sees the batches the uninterrupted run would have. Defaults are sized
for a smoke run; raise --image-size to 224 and --model to resnet50 for a
real one. Each line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run from repo without install

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.callbacks import warmup_schedule
from horovod_tpu_torch.convert import cnn_param_path, jax_ordered
from horovod_tpu_torch.train_cnn import CNNConfig, build_cnn, make_images

MODELS = {"resnet18": "ResNet18", "resnet50": "ResNet50"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="torch imagenet-style resume example")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--steps-per-epoch", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8, help="per rank")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--model", choices=sorted(MODELS), default="resnet18")
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-epochs", type=int, default=1)
    p.add_argument("--checkpoint-dir", default="./checkpoints-torch")
    p.add_argument("--stop-after-epoch", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def batch(config: CNNConfig, epoch: int, step: int, rank: int, device):
    """One step's (images, labels) for this rank: ``make_images`` drawn from
    (seed, epoch, step), the label added to the pixels (as the JAX example
    does) so that the model has something to learn."""
    cfg = dataclasses.replace(config, seed=(config.seed * 1009 + epoch) * 1009 + step)
    images, labels = make_images(cfg, rank, device)
    return images + labels.to(images.dtype)[:, None, None, None] / 10.0, labels


def main(argv=None):
    args = parse_args(argv)
    hvd.init(device=args.device)
    dev = hvd.device()
    verbose = hvd.rank() == 0
    config = CNNConfig(model=MODELS[args.model], num_classes=args.num_classes,
                       image_size=args.image_size, batch=args.batch_size)
    model = build_cnn(config, dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    named = jax_ordered(model.named_parameters(), cnn_param_path)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=args.base_lr, momentum=0.9),
        named)
    # The reference's gradual warmup: base_lr to base_lr * size over the
    # warmup epochs, set on the optimizer before each step.
    sched = warmup_schedule(args.base_lr, warmup_epochs=args.warmup_epochs,
                            steps_per_epoch=args.steps_per_epoch, size=hvd.size())

    def tree(epoch):
        return {"model": model.state_dict(), "opt": opt, "epoch": epoch}

    # Resume: find the newest checkpoint; every rank restores it in place
    # (the digest check makes sure they all read the same bytes), then
    # rank 0's epoch and state are broadcast.
    start_epoch = 0
    resume_step = checkpoint.latest_step(args.checkpoint_dir)
    if resume_step is not None:
        checkpoint.init_optimizer_state(opt)
        restored = checkpoint.restore(args.checkpoint_dir, template=tree(0),
                                      step=resume_step)
        start_epoch = checkpoint.broadcast_resume_state(
            {"epoch": restored["epoch"]})["epoch"]
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        if verbose:
            print(json.dumps({"resumed_from": int(resume_step)}), flush=True)

    for epoch in range(start_epoch, args.epochs):
        losses = []
        for i in range(args.steps_per_epoch):
            for group in opt.optimizer.param_groups:
                group["lr"] = sched(epoch * args.steps_per_epoch + i)
            x, y = batch(config, epoch, i, hvd.rank(), dev)
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            losses.append(hvd.metric_average(loss.item()))
        if verbose:
            print(json.dumps({"epoch": epoch + 1,
                              "train_loss": round(sum(losses) / len(losses), 6)}),
                  flush=True)
        # rank 0 writes; the others wait in save()'s barrier
        checkpoint.save(args.checkpoint_dir, tree(epoch + 1), step=epoch + 1)
        if args.stop_after_epoch and epoch + 1 >= args.stop_after_epoch:
            if verbose:
                print(json.dumps({"stopped_after_epoch": epoch + 1}), flush=True)
            break
    hvd.shutdown()


if __name__ == "__main__":
    main()
