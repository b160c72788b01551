"""Flax's convolution-net layers in PyTorch, for the port's CNN zoo.

The port's CNNs take NCHW-shaped tensors, as torchvision's models do; on
the card they live in ``torch.channels_last`` memory, which is the JAX
package's NHWC layout under another shape (an NHWC array permuted to NCHW
is channels-last with no copy). Each layer keeps flax's numerics:

- ``same_pads``: flax/XLA ``padding="SAME"``, from the input size at run
  time. On a stride of 2 it is asymmetric, the extra row and column at the
  end; torch's ``padding=`` is symmetric, so such a pad is applied
  explicitly (``F.pad``; -inf for a max-pool, 0 otherwise).
- ``Conv2d`` and ``Dense``: float32 parameters (weight OIHW and (out, in));
  input, weight and bias cast to ``dtype`` before the product, as flax's
  ``nn.Conv(dtype=...)`` and ``nn.Dense(dtype=...)`` do.
- ``BatchNorm``: flax's ``nn.BatchNorm``: statistics in float32 whatever
  the input dtype, the biased batch variance both to normalise and to
  update the running variance, ``momentum`` in flax's sense (0.9 keeps 90%
  of the running value: torch's 0.1).
- ``max_pool`` and ``avg_pool``: flax's, ``avg_pool`` counting the padded
  zeros (flax's ``count_include_pad=True``).

``init_cnn`` draws weights at flax's default scales.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

Pads = tuple[tuple[int, int], tuple[int, int]]


def same_pads(size: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> Pads:
    """((top, bottom), (left, right)) of XLA's SAME padding for an input of
    spatial ``size``: the output is ceil(size / stride), and of the padding
    that takes, the odd row or column goes at the end."""
    pads = []
    for n, k, s in zip(size, kernel, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pads(x: torch.Tensor, kernel, strides, padding: str) -> Pads:
    if padding == "SAME":
        return same_pads(x.shape[2:], kernel, strides)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    raise ValueError(f"padding {padding!r}: use 'SAME' or 'VALID'")


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    """channels_last for a channels-last tensor that is not also contiguous
    (as a tensor with one channel or a 1x1 image is)."""
    if not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _padded(x: torch.Tensor, pads: Pads, value: float = 0.0):
    """(x, padding for the op): a symmetric pad is the op's own argument;
    an asymmetric one is applied to ``x`` here."""
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def max_pool(x: torch.Tensor, kernel, strides, padding: str = "VALID"):
    """flax ``nn.max_pool``; SAME pads with -inf."""
    x, pad = _padded(x, _pads(x, kernel, strides, padding), float("-inf"))
    return F.max_pool2d(x, kernel, strides, pad)


def avg_pool(x: torch.Tensor, kernel, strides, padding: str = "VALID"):
    """flax ``nn.avg_pool``: every window divides by its full size, padded
    zeros included."""
    x, pad = _padded(x, _pads(x, kernel, strides, padding))
    return F.avg_pool2d(x, kernel, strides, pad, count_include_pad=True)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on NCHW tensors: ``weight`` (out, in, kh, kw) and
    ``bias`` in float32, both cast to ``dtype`` with the input. The cast
    weight takes the input's memory format, so a channels-last input meets
    a channels-last weight."""

    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding: str = "SAME",
                 bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype, memory_format=_memory_format(x))
        b = None if self.bias is None else self.bias.to(self.dtype)
        x, pad = _padded(x, _pads(x, self.kernel, self.strides, self.padding))
        return F.conv2d(x, w, b, self.strides, pad)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` (out, in) and ``bias`` in float32,
    cast to ``dtype`` with the input."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels (dim 1) of an NCHW tensor.

    Parameters ``weight`` and ``bias`` (flax's ``scale`` and ``bias``) and
    buffers ``running_mean`` and ``running_var`` (flax's ``mean`` and
    ``var``) are float32; the output is ``dtype``. In training mode the
    batch's statistics normalise and update the running ones,
    ``running = momentum * running + (1 - momentum) * batch``, with the
    biased variance, as flax does. ``F.batch_norm`` would update with the
    unbiased one, so the running statistics are kept here instead: the
    normalisation (``torch._batch_norm_impl_index``, which takes cuDNN's
    kernel where PyTorch's rules allow it and the native one elsewhere)
    returns the batch's mean and 1/sqrt(var + eps), and var is recovered
    from the latter, with no second pass over the activations.
    ``zero_scale`` starts ``weight`` at 0 (the last norm of a residual
    branch in the JAX ResNet)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        with torch.no_grad():
            var = invstd.double().pow(-2).sub(self.eps).clamp_min(0.0)
            keep = self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(var.to(invstd.dtype), alpha=1.0 - keep)
        return y.to(self.dtype)


@torch.no_grad()
def init_cnn(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at flax's default scales, drawn on the generator's
    device: conv and Dense kernels truncated normal at +-2 std with
    variance 1/fan_in (lecun_normal), biases 0; BatchNorm scale 1 (0 where
    ``zero_scale``), bias 0, running mean 0 and variance 1."""
    for module in model.modules():
        if isinstance(module, (Conv2d, Dense)):
            fan_in = math.prod(module.weight.shape[1:])
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(0.0 if module.zero_scale else 1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW tensor in flax's (h, w, c) order, as the JAX models
    flatten their NHWC arrays before a Dense (a view for channels-last
    memory)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
