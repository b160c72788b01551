"""One rank of the CNN data-parallel world that tests/test_torch_port_cnn.py
(gloo, on the CPU) and tests/test_torch_port_cuda.py (NCCL, one process per
GPU) launch. It imports no JAX: the CPU test computes the JAX package's
side and hands inputs over in an .npz file.

``CNN_DEVICE=cpu``: reads ``CNN_IN`` (the JAX ResNet's params and
batch_stats, the ``CNNConfig``, the wires and the fusion threshold) and,
for each wire in turn: builds the model with ``build_cnn``, loads the
JAX weights and statistics on every rank and moves every rank but root
off them, ``broadcast_parameters`` of the whole state dict (checked equal
to root's on every rank), wraps ``SGD(lr x size, momentum)`` in
``DistributedOptimizer`` over the parameters in the JAX flatten order
(at least 3 buckets), and takes 2 steps of ``make_cnn_train_step`` on
``make_images(config, rank)``. The model runs in float64, as the JAX side
does. Writes ``CNN_OUT.<rank>.npz``: per wire, the rank-averaged losses,
the parameters in flax's layout after each step and this rank's BatchNorm
statistics after the last.

``CNN_DEVICE=cuda``: ResNet-50 at full width, bf16 channels-last, 32
images per rank. Every rank starts from other random weights; after
``broadcast_parameters`` all ranks hold root's. For 2 steps, after each
``DistributedOptimizer.step`` every parameter's ``.grad`` is the mean over
ranks of the local gradients (gathered with ``allgather``) to 1e-5 of the
largest mean (float32 sums in another order), the parameters are
identical on every rank and the BatchNorm statistics differ between ranks
(each rank keeps its own). Then ``train_cnn(CNNConfig(), 3)`` on the same
world: finite losses that fall. Rank 0 prints ``ok cnn world <n>``.

Every rank exits non-zero on any failure. Identity and rendezvous come from
the launcher's ``HOROVOD_*`` variables.
"""

import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import convert  # noqa: E402
from horovod_tpu_torch.train_cnn import (CNNConfig, build_cnn,  # noqa: E402
                                         make_cnn_train_step, make_images,
                                         train_cnn)

STEPS = 2


def _flax_tree(data, prefix: str) -> dict:
    """Nested dict of the arrays saved under ``prefix/a/b/...``."""
    tree: dict = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _distributed(model, config, wire=None, threshold=None):
    """Broadcast, then the DistributedOptimizer and the step of train_cnn."""
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    named = convert.jax_ordered(model.named_parameters(), convert.cnn_param_path)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=config.lr * hvd.size(),
                        momentum=config.momentum), named,
        compression=None if wire is None else hvd.Compression.by_name(wire),
        fusion_threshold=threshold)
    return named, opt, make_cnn_train_step(model, opt)


def cpu_parity() -> None:
    rank = hvd.rank()
    data = np.load(os.environ["CNN_IN"])
    config = CNNConfig(**json.loads(str(data["config"])))
    params, stats = _flax_tree(data, "params"), _flax_tree(data, "batch_stats")
    threshold = int(data["threshold"])
    out = {}
    for wire in str(data["wires"]).split(","):
        model = build_cnn(config, "cpu").double()
        state = convert.cnn_state_dict_from_jax(params, stats,
                                                model.state_dict().keys())
        model.load_state_dict(state)
        with torch.no_grad():
            for t in model.state_dict().values():
                t.add_(rank)
        named, opt, step = _distributed(model, config, wire, threshold)
        for name, t in model.state_dict().items():
            if not torch.equal(t, state[name].double()):
                raise AssertionError(f"{name}: not root's after the broadcast")
        if opt.plan.num_buckets < 3:
            raise AssertionError(f"{opt.plan.num_buckets} buckets, want >= 3")
        images, labels = make_images(config, rank, "cpu")
        losses = []
        for i in range(STEPS):
            losses.append(hvd.metric_average(step(images.double(), labels).item()))
            for name, p in named:
                out[f"{wire}/step{i}/{name}"] = convert.to_flax_layout(
                    name, p, convert.cnn_param_path)
        out[f"{wire}/losses"] = np.array(losses)
        for name, t in model.state_dict().items():
            if convert.cnn_flax_path(name)[0] == "batch_stats":
                out[f"{wire}/stat/{name}"] = t.numpy()
    np.savez(f"{os.environ['CNN_OUT']}.{rank}.npz", **out)


def cuda_world() -> None:
    dev, rank, size = hvd.device(), hvd.rank(), hvd.size()
    config = CNNConfig(batch=32)
    model = build_cnn(dataclasses.replace(config, seed=100 + rank), dev)
    named, opt, _ = _distributed(model, config)
    gathered = hvd.allgather(_flat(p for _, p in named)[None])
    if not all(torch.equal(gathered[r], gathered[0]) for r in range(size)):
        raise AssertionError("parameters differ after broadcast_parameters")
    images, labels = make_images(config, rank, dev)
    for i in range(STEPS):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        local = _flat(p.grad for _, p in named)
        opt.step()
        want = hvd.allgather(local[None]).mean(dim=0)
        err = (_flat(p.grad for _, p in named) - want).abs().max().item()
        if not err <= 1e-5 * want.abs().max().item():
            raise AssertionError(f"step {i}: reduced gradient off by {err}")
        params = hvd.allgather(_flat(p for _, p in named)[None])
        if not all(torch.equal(params[r], params[0]) for r in range(size)):
            raise AssertionError(f"step {i}: parameters differ across ranks")
    stats = hvd.allgather(_flat(t for n, t in model.state_dict().items()
                                if n.endswith("running_mean"))[None])
    if size > 1 and torch.equal(stats[0], stats[1]):
        raise AssertionError("BatchNorm statistics are the same on two ranks")
    del model, opt, images
    torch.cuda.empty_cache()
    result = train_cnn(CNNConfig(), 3, device="cuda")
    if not (all(math.isfinite(x) for x in result.losses)
            and result.losses[-1] < result.losses[0]):
        raise AssertionError(f"train_cnn losses {result.losses}")
    if rank == 0:
        print(f"train_cnn on {size} cards: losses {result.losses}, step s "
              f"{result.step_s}, {result.num_buckets} buckets", flush=True)
        print(f"ok cnn world {size}", flush=True)


def main() -> None:
    device = os.environ["CNN_DEVICE"]
    torch.set_num_threads(1)
    hvd.init(device=device)
    try:
        cpu_parity() if device == "cpu" else cuda_world()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
