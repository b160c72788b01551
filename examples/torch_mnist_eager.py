"""MNIST through the eager engine on the PyTorch port: the counterpart of
``examples/jax_mnist_eager.py`` (the reference's tensorflow_mnist_eager:
per-step allreduces of eagerly computed gradients).

"Eager" means the negotiated host engine (the native C++ core,
``cc/native_engine.py``, by default, or the Python engine of
``common/engine.py`` under ``HOROVOD_ENGINE=python``: coordinator
negotiation by name, the response cache, the ring or star plane, the
timeline) instead of the NCCL collectives of
``DistributedOptimizer``: each rank computes its gradients with the port's
``ConvNet`` on its device, copies them to the host, enqueues one async
allreduce per leaf, and waits for them in one ``synchronize`` sweep. The
initial parameters come from rank 0 through the engine as well, and the
epoch loss is averaged through ``hvd.allreduce`` of a Python scalar. The
example issues no ``torch.distributed`` collective, so two ranks may share
one card (``HOROVOD_DEVICE_ORDINAL=0``)::

    python -m horovod_tpu_torch.runner -np 2 -- python examples/torch_mnist_eager.py

``--device cpu`` runs off the card; ``--dump DIR`` writes each rank's
step-1 local and averaged gradient leaves, its final parameters, its
epoch losses, the engine's class name (``engine``) and the attention
kernels' launch counts (``launches.<kernel>``; the ConvNet runs none) to ``DIR/rank<r>.npz``; ``--trace DIR`` records rank 0's
steps under ``utils.timeline.trace`` (the device pane and the engine's
host pane, ``host_timeline.json``). ``MNIST_EPOCHS`` and ``MNIST_STEPS``
set the length (3 epochs of 8 steps).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run from repo without install

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.cnn_layers import init_cnn
from horovod_tpu_torch.models.mlp import ConvNet
from horovod_tpu_torch.ops import flash_attention, ring_flash
from horovod_tpu_torch.utils import timeline

EPOCHS = int(os.environ.get("MNIST_EPOCHS", "3"))
STEPS = int(os.environ.get("MNIST_STEPS", "8"))
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
    p = argparse.ArgumentParser(description="torch MNIST on the eager engine")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dump", default="")
    p.add_argument("--trace", default="")
    args = p.parse_args(argv)
    flash_attention.reset_launches()
    ring_flash.reset_launches()
    hvd.init(device=args.device)
    dev, size, rank = hvd.device(), hvd.size(), hvd.rank()
    model = ConvNet(num_classes=10).to(dev)
    init_cnn(model, torch.Generator(device=dev).manual_seed(rank))
    # Plain SGD: the averaging is the engine's.
    opt = torch.optim.SGD(model.parameters(), lr=0.01 * size, momentum=0.9)
    named = list(model.named_parameters())
    with torch.no_grad():                       # rank 0's parameters
        for name, p_ in named:
            p_.copy_(torch.from_numpy(hvd.broadcast(
                p_.detach().cpu().numpy(), root_rank=0,
                name=f"param.{name}")))

    engine = basics.engine()
    dump: dict = {}
    losses = []
    trace = (timeline.trace(args.trace) if args.trace and rank == 0
             else contextlib.nullcontext())
    with trace:
        for epoch in range(EPOCHS):
            x, y = synthetic_mnist(BATCH * STEPS, seed=100 + epoch + rank)
            epoch_loss = 0.0
            for i in range(STEPS):
                xb = torch.from_numpy(x[i * BATCH:(i + 1) * BATCH]).to(dev)
                yb = torch.from_numpy(y[i * BATCH:(i + 1) * BATCH]).to(dev)
                opt.zero_grad()
                loss = F.cross_entropy(model(xb), yb)
                loss.backward()
                local = [p_.grad.cpu().numpy() for _, p_ in named]
                handles = [engine.enqueue("allreduce", g, f"grad.{name}",
                                          average=True)
                           for (name, _), g in zip(named, local)]
                reduced = [engine.synchronize(h) for h in handles]
                for (_, p_), g in zip(named, reduced):
                    p_.grad = torch.from_numpy(np.ascontiguousarray(g)).to(dev)
                opt.step()
                if epoch == 0 and i == 0:
                    for (name, _), g, r in zip(named, local, reduced):
                        dump[f"local.{name}"] = g
                        dump[f"avg.{name}"] = r
                epoch_loss += loss.item()
            # a scalar comes back as numpy, shape (1,) on the ring plane
            mean_loss = float(np.ravel(hvd.allreduce(
                epoch_loss / STEPS, name=f"loss.ep{epoch}"))[0])
            losses.append(mean_loss)
            if rank == 0:
                print(f"epoch {epoch}: loss {mean_loss:.4f} "
                      f"({type(engine).__name__}, "
                      f"averaged over {size} ranks)", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        for name, p_ in named:
            dump[f"param.{name}"] = p_.detach().cpu().numpy()
        for k, n in {**flash_attention.launches, **ring_flash.launches}.items():
            dump[f"launches.{k}"] = np.int64(n)
        np.savez(os.path.join(args.dump, f"rank{rank}.npz"),
                 losses=np.array(losses), engine=type(engine).__name__,
                 **dump)
    hvd.shutdown()


if __name__ == "__main__":
    main()
