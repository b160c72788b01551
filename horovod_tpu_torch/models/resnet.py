"""ResNet v1.5 (18 to 152), the counterpart of
``horovod_tpu.models.resnet``: the stride in the 3x3 of the bottleneck,
the last BatchNorm scale of every residual branch starting at 0, the
optional 2x2 space-to-depth stem, bf16 activations with float32
parameters and BatchNorm statistics, a float32 head.

Submodules carry the names of the flax scopes (``conv_init``, ``bn_init``,
``BottleneckBlock_3.Conv_1``, ``conv_proj``, ``norm_proj``, ``head``), so
``convert.cnn_flax_path`` maps a parameter to its flax path by renaming
the leaf alone. Inputs are NCHW-shaped (channels-last memory on the card).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cnn_layers import BatchNorm, Conv2d, Dense, max_pool


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1, with a projection shortcut where the
    shape changes."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        out = filters * self.expansion
        s = (strides, strides)
        self.Conv_0 = Conv2d(in_features, filters, (1, 1), dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv2d(filters, filters, (3, 3), s, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype)
        self.Conv_2 = Conv2d(filters, out, (1, 1), dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out, dtype=dtype, zero_scale=True)
        self.project = in_features != out or strides != 1
        if self.project:
            self.conv_proj = Conv2d(in_features, out, (1, 1), s, dtype=dtype)
            self.norm_proj = BatchNorm(out, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3(stride) -> 3x3, for ResNet-18/34."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        s = (strides, strides)
        self.Conv_0 = Conv2d(in_features, filters, (3, 3), s, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv2d(filters, filters, (3, 3), dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype, zero_scale=True)
        self.project = in_features != filters or strides != 1
        if self.project:
            self.conv_proj = Conv2d(in_features, filters, (1, 1), s, dtype=dtype)
            self.norm_proj = BatchNorm(filters, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """Fold each 2x2 patch of an NCHW tensor into channels, ordered
    (dy, dx, c) as the JAX stem orders them: (n, c, h, w) -> (n, 4c, h/2,
    w/2), in channels-last memory."""
    n, c, h, w = x.shape
    x = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
    return x.permute(0, 3, 1, 2)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls: type,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 space_to_depth: bool = False):
        super().__init__()
        self.dtype, self.space_to_depth = dtype, space_to_depth
        if space_to_depth:
            self.conv_init = Conv2d(12, num_filters, (4, 4), dtype=dtype)
        else:
            self.conv_init = Conv2d(3, num_filters, (7, 7), (2, 2), dtype=dtype)
        self.bn_init = BatchNorm(num_filters, dtype=dtype)
        self.block_names = []
        features = num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                block = block_cls(features, num_filters * 2 ** i,
                                  2 if i > 0 and j == 0 else 1, dtype)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block)
                self.block_names.append(name)
                features = num_filters * 2 ** i * block_cls.expansion
        self.head = Dense(features, num_classes, dtype=torch.float32)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.space_to_depth:
            x = space_to_depth(x)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.head(x).float()


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3), block_cls=BottleneckBlock)
