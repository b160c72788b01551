"""MNIST-style training on the PyTorch port: the counterpart of
``examples/jax_mnist.py``, Horovod's five-line contract:

    hvd.init(); scale lr by the world size; DistributedOptimizer;
    broadcast the parameters; train.

Runs on synthetic digits (nothing is downloaded), on the card unless
``--device cpu``:

    torchrun --nproc-per-node 2 examples/torch_mnist.py
    python -m horovod_tpu_torch.runner -np 2 -- python examples/torch_mnist.py --device cpu

Each rank trains on its slice of a global batch of 32 per rank; rank 0
prints the rank-averaged loss of each epoch.
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
from horovod_tpu_torch.models.cnn_layers import init_cnn
from horovod_tpu_torch.models.mlp import ConvNet

EPOCHS = int(os.environ.get("MNIST_EPOCHS", "3"))
STEPS = int(os.environ.get("MNIST_STEPS", "10"))
BATCH = 32          # per rank


def synthetic_mnist(n, seed):
    """(images (n, 28, 28), labels (n,)): the JAX example's digits, each
    image shifted by its label so the task is learnable."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    x += y[:, None, None, None] / 10.0
    return x[..., 0], y.astype(np.int64)


def main(argv=None):
    p = argparse.ArgumentParser(description="torch MNIST example")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    hvd.init(device=args.device)                            # 1. init
    dev, size, rank = hvd.device(), hvd.size(), hvd.rank()
    model = ConvNet(num_classes=10).to(dev)                 # flax's init scales
    init_cnn(model, torch.Generator(device=dev).manual_seed(0))
    opt = hvd.DistributedOptimizer(                         # 3. wrap the optimizer
        torch.optim.SGD(model.parameters(), lr=0.01 * size, momentum=0.9),  # 2. scale lr
        model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)   # 4. broadcast
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    batch = BATCH * size
    for epoch in range(EPOCHS):                             # 5. train
        x, y = synthetic_mnist(batch * STEPS, seed=epoch)
        epoch_loss = 0.0
        for i in range(STEPS):
            lo = i * batch + rank * BATCH
            xb = torch.from_numpy(x[lo:lo + BATCH]).to(dev)
            yb = torch.from_numpy(y[lo:lo + BATCH]).to(dev)
            opt.zero_grad()
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            opt.step()
            epoch_loss += hvd.metric_average(loss.item())
        if rank == 0:
            print(f"epoch {epoch}: loss {epoch_loss / STEPS:.4f}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
