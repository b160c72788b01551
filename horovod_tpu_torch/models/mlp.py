"""MNIST-scale models, the counterparts of ``horovod_tpu.models.mlp``.

flax infers a Dense layer's input width at its first call; a torch module
needs it up front, so ``MLP`` takes ``in_features`` and ``ConvNet`` the
``image_size`` of its one-channel input (MNIST's). Both flatten in flax's
NHWC order: ``MLP`` given an NCHW image flattens it as the JAX model
flattens the NHWC one, and ``ConvNet`` flattens its (c, h, w) features as
(h, w, c), so the converted rows of its first Dense need no permutation.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cnn_layers import Conv2d, Dense, flatten_nhwc, max_pool


class MLP(nn.Module):
    def __init__(self, features: Sequence[int] = (128, 64, 10),
                 dtype: torch.dtype = torch.float32, in_features: int = 784):
        super().__init__()
        self.dtype = dtype
        self.num_layers = len(features)
        widths = [in_features, *features]
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            self.add_module(f"Dense_{i}", Dense(
                widths[i], widths[i + 1], torch.float32 if last else dtype))

    def forward(self, x):
        x = flatten_nhwc(x) if x.dim() == 4 else x.reshape(x.shape[0], -1)
        x = x.to(self.dtype)
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.num_layers - 1}")(x)


class ConvNet(nn.Module):
    """The reference MNIST conv topology (two convs, two dense). A 3-d
    input (n, h, w) is one channel."""

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 image_size: int = 28):
        super().__init__()
        self.Conv_0 = Conv2d(1, 32, (5, 5), bias=True, dtype=dtype)
        self.Conv_1 = Conv2d(32, 64, (5, 5), bias=True, dtype=dtype)
        side = image_size // 2 // 2
        self.Dense_0 = Dense(side * side * 64, 512, dtype)
        self.Dense_1 = Dense(512, num_classes, torch.float32)

    def forward(self, x):
        if x.dim() == 3:
            x = x[:, None]
        x = max_pool(F.relu(self.Conv_0(x)), (2, 2), (2, 2))
        x = max_pool(F.relu(self.Conv_1(x)), (2, 2), (2, 2))
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(x)
