"""The port's CNN trainer: data-parallel training of the model zoo's
ResNets, VGGs and Inception V3 through ``DistributedOptimizer``, the
counterpart of the JAX package's ResNet-50 benchmark step (``bench.py``
``_build``) and of ``examples/jax_synthetic_benchmark.py``.

``train_cnn(config, steps)`` runs Horovod's contract end to end: ``init``
-> build the model -> ``broadcast_parameters`` of the whole state dict
(BatchNorm statistics included, so every rank starts from root's) ->
``steps`` steps, each forward in training mode, softmax cross entropy,
backward, and ``DistributedOptimizer.step`` (fused bucket allreduce, then
SGD with momentum). BatchNorm statistics stay per rank and are never
averaged inside the step, as in Horovod and in the JAX benchmark. It runs
on the card unless ``device="cpu"``. ``setup_cnn`` and ``run_cnn`` are
its two halves, for callers that want the model after the steps.

The batch is random normal images and uniform labels drawn from the seed
and the rank: constant images would give every BatchNorm zero variance,
so that its output is its bias and the loss is ln(classes) whatever the
weights.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, ContextManager, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import models
from . import optimizer as hvd_opt
from .common import basics
from .compression import Compression
from .convert import cnn_param_path, jax_ordered
from .models.cnn_layers import Conv2d, Dense, init_cnn

CNN_MODELS = ("ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
              "VGG16", "VGG19", "InceptionV3")


@dataclass
class CNNConfig:
    """ResNet-50 as the JAX package's benchmark trains it on the
    accelerator (``bench.py:181-217``): 1000 classes, 224x224x3 images,
    128 images per card, bf16 activations with float32 parameters and
    BatchNorm statistics, SGD(0.01 x world size, momentum 0.9)."""

    model: str = "ResNet50"             # a name of CNN_MODELS
    num_classes: int = 1000
    image_size: int = 224
    batch: int = 128                    # per rank
    lr: float = 0.01                    # per rank; scaled by the world size
    momentum: float = 0.9
    dtype: str = "bfloat16"             # activations; params stay float32
    channels_last: bool = True
    seed: int = 0
    # The DistributedOptimizer knobs of ``bench.py``'s ``_build``; None
    # reads the env (HOROVOD_FUSION_THRESHOLD, HOROVOD_COMPRESSION,
    # HOROVOD_HIERARCHICAL_ALLREDUCE, HOROVOD_NUM_BUCKETS). The DCN tier's
    # knobs come from the env alone, as there.
    fusion_threshold: Optional[int] = None
    compression: Optional[str] = None   # a HOROVOD_COMPRESSION name
    hierarchical: Optional[bool] = None
    num_buckets: Optional[int] = None


@dataclass
class CNNResult:
    losses: list = field(default_factory=list)       # per step, rank-averaged
    step_s: list = field(default_factory=list)       # host clock per step
    images_per_step: int = 0                          # over all ranks
    num_buckets: int = 0
    params: int = 0
    hierarchical: bool = False                        # as resolved
    ici_size: Optional[int] = None                    # the ladder's tiers
    dcn_size: Optional[int] = None


def build_cnn(config: CNNConfig, device) -> nn.Module:
    """The config's model in training mode, with random weights drawn from
    its seed (the last BatchNorm scale of each residual branch at 0)."""
    if config.model not in CNN_MODELS:
        raise ValueError(f"model {config.model!r}: use one of {CNN_MODELS}")
    kwargs = dict(num_classes=config.num_classes,
                  dtype=getattr(torch, config.dtype))
    if config.model.startswith("VGG"):
        kwargs["image_size"] = config.image_size
    model = getattr(models, config.model)(**kwargs).to(device)
    init_cnn(model, torch.Generator(device=device).manual_seed(config.seed))
    return model.train()


def make_images(config: CNNConfig, rank: int, device):
    """This rank's (images, labels), drawn from (seed, rank): images
    standard normal, NCHW-shaped float32, in channels-last memory when the
    config asks for it; labels uniform over the classes."""
    gen = torch.Generator(device="cpu").manual_seed(
        config.seed * 1_000_003 + 7919 * (rank + 1))
    size = config.image_size
    nhwc = torch.randn(config.batch, size, size, 3, generator=gen)
    labels = torch.randint(0, config.num_classes, (config.batch,), generator=gen)
    images = nhwc.permute(0, 3, 1, 2)
    if not config.channels_last:
        images = images.contiguous()
    return images.to(device), labels.to(device)


def make_cnn_train_step(model: nn.Module, opt: hvd_opt.DistributedOptimizer):
    """``step(images, labels) -> loss`` (a 0-d tensor on the device, this
    rank's): forward in training mode (updating this rank's BatchNorm
    statistics), softmax cross entropy, backward, allreduce and SGD."""

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        opt.zero_grad()
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def forward_macs(model: nn.Module, images: torch.Tensor) -> int:
    """Multiply-adds per image of the model's convolutions and Dense
    layers in one forward on ``images``, from their weight and output
    shapes."""
    macs = []

    def count(module, _, out):
        per_output = module.weight[0].numel()    # in x kh x kw, or in
        macs.append(per_output * out.numel() // out.shape[0])

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv2d, Dense))]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for h in hooks:
            h.remove()
    return sum(macs)


@dataclass
class CNNSetup:
    """What ``setup_cnn`` builds for one rank."""

    model: nn.Module
    opt: hvd_opt.DistributedOptimizer
    step: Callable
    images: torch.Tensor
    labels: torch.Tensor


def setup_cnn(config: CNNConfig, device=None) -> CNNSetup:
    """init -> model -> broadcasts -> the train step and this rank's batch."""
    basics.init(device)
    dev = basics.device()
    model = build_cnn(config, dev)
    hvd_opt.broadcast_parameters(model.state_dict(), root_rank=0)
    named = jax_ordered(model.named_parameters(), cnn_param_path)
    opt = hvd_opt.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=config.lr * basics.size(),
                        momentum=config.momentum), named,
        compression=(None if config.compression is None
                     else Compression.by_name(config.compression)),
        fusion_threshold=config.fusion_threshold,
        num_buckets=config.num_buckets, hierarchical=config.hierarchical)
    hvd_opt.broadcast_optimizer_state(opt, root_rank=0)
    images, labels = make_images(config, basics.rank(), dev)
    return CNNSetup(model=model, opt=opt, step=make_cnn_train_step(model, opt),
                    images=images, labels=labels)


def run_cnn(s: CNNSetup, steps: int,
            around_step: Optional[Callable[[int], ContextManager]] = None,
            ) -> CNNResult:
    """``steps`` steps of ``s`` on its one repeated batch.

    ``around_step(i)``, if given, returns a context manager that step ``i``
    runs inside (a profiler around one step, for example).
    """
    dev = basics.device()
    groups = s.opt.groups
    result = CNNResult(images_per_step=s.images.shape[0] * basics.size(),
                       num_buckets=s.opt.plan.num_buckets,
                       params=sum(p.numel() for p in s.opt.params),
                       hierarchical=s.opt.hierarchical,
                       ici_size=groups.ici_size if groups else None,
                       dcn_size=groups.dcn_size if groups else None)
    for i in range(steps):
        with around_step(i) if around_step else contextlib.nullcontext():
            t0 = time.perf_counter()
            loss = s.step(s.images, s.labels)
            result.losses.append(hvd_opt.metric_average(loss.item()))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            result.step_s.append(time.perf_counter() - t0)
    return result


def train_cnn(config: CNNConfig, steps: int, device=None,
              around_step: Optional[Callable[[int], ContextManager]] = None,
              ) -> CNNResult:
    """init -> model -> broadcasts -> ``steps`` steps on one repeated batch
    (``run_cnn`` of ``setup_cnn``)."""
    return run_cnn(setup_cnn(config, device), steps, around_step)
