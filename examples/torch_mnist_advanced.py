"""MNIST with the callbacks' capabilities on the PyTorch port: the
counterpart of ``examples/jax_mnist_advanced.py`` (the reference's
keras_mnist_advanced: gradual learning-rate warmup, metrics averaged over
the ranks, the root rank's broadcast, an evaluation per epoch).

The warmup is ``callbacks.warmup_schedule`` (base lr to base lr x world
size over the warmup epochs), set on the optimizer before each step; the
epoch-end metrics are averaged with ``metric_average``; the augmentation
is a random shift of up to 2 pixels on the host. Synthetic digits,
nothing downloaded; on the card unless ``--device cpu``:

    python -m horovod_tpu_torch.runner -np 2 -- \
        python examples/torch_mnist_advanced.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run from repo without install

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.callbacks import warmup_schedule
from horovod_tpu_torch.models.cnn_layers import init_cnn
from horovod_tpu_torch.models.mlp import ConvNet

EPOCHS = int(os.environ.get("MNIST_EPOCHS", "4"))
STEPS = int(os.environ.get("MNIST_STEPS", "8"))
WARMUP_EPOCHS = 2
BATCH = 32          # per rank


def synthetic_mnist(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    x += y[:, None, None, None] / 10.0
    return x[..., 0], y.astype(np.int64)


def augment(x, rng):
    """Random shift of up to 2 pixels: the ImageDataGenerator stand-in."""
    dx, dy = rng.integers(-2, 3, size=2)
    return np.roll(np.roll(x, dx, axis=1), dy, axis=2)


def main(argv=None):
    p = argparse.ArgumentParser(description="torch MNIST with callbacks")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    hvd.init(device=args.device)
    dev, size, rank = hvd.device(), hvd.size(), hvd.rank()
    model = ConvNet(num_classes=10).to(dev)
    # Ranks start apart (seeded by rank): the broadcast below joins them.
    init_cnn(model, torch.Generator(device=dev).manual_seed(rank))
    schedule = warmup_schedule(base_lr=0.005, warmup_epochs=WARMUP_EPOCHS,
                               steps_per_epoch=STEPS)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=schedule(0), momentum=0.9),
        model.named_parameters())
    # Initial-state consistency from the root (BroadcastGlobalVariables).
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    batch = BATCH * size
    rng = np.random.default_rng(rank)
    for epoch in range(EPOCHS):
        x, y = synthetic_mnist(batch * STEPS, seed=epoch)
        epoch_loss = 0.0
        model.train()
        for i in range(STEPS):
            for group in opt.optimizer.param_groups:
                group["lr"] = schedule(epoch * STEPS + i)
            lo = i * batch + rank * BATCH
            xb = torch.from_numpy(augment(x[lo:lo + BATCH], rng)).to(dev)
            yb = torch.from_numpy(y[lo:lo + BATCH]).to(dev)
            opt.zero_grad()
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            opt.step()
            epoch_loss += hvd.metric_average(loss.item())
        # Evaluation on a held-out shard per rank; the printed metrics are
        # the means over the ranks (MetricAverageCallback at epoch end).
        ex, ey = synthetic_mnist(64, seed=1000 + epoch + rank)
        model.eval()
        with torch.no_grad():
            logits = model(torch.from_numpy(ex).to(dev))
            labels = torch.from_numpy(ey).to(dev)
            val_loss = hvd.metric_average(F.cross_entropy(logits, labels).item())
            val_acc = hvd.metric_average(
                (logits.argmax(-1) == labels).float().mean().item())
        lr_now = schedule((epoch + 1) * STEPS - 1)
        if rank == 0:
            print(f"epoch {epoch}: train_loss {epoch_loss / STEPS:.4f} "
                  f"val_loss {val_loss:.4f} val_acc {val_acc:.3f} "
                  f"lr {lr_now:.4f} (averaged over {size} ranks)", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
