"""VGG-16 and VGG-19, with or without BatchNorm, the counterparts of
``horovod_tpu.models.vgg``.

Submodules carry the flax names: ``conv_{i}`` and ``bn_{i}``, where i is
the layer's index in the configuration (max-pools included), then ``fc1``,
``fc2`` and ``head``. flax infers ``fc1``'s input width from the image at
its first call; here ``image_size`` gives it. The features are flattened
in flax's (h, w, c) order, so ``fc1``'s converted rows need no
permutation.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cnn_layers import BatchNorm, Conv2d, Dense, flatten_nhwc, max_pool

_CFG = {
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 use_bn: bool = True, dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224):
        super().__init__()
        self.dtype, self.use_bn, self.cfg = dtype, use_bn, _CFG[depth]
        features, side = 3, image_size
        for i, spec in enumerate(self.cfg):
            if spec == "M":
                side //= 2
                continue
            self.add_module(f"conv_{i}", Conv2d(features, spec, (3, 3),
                                                bias=not use_bn, dtype=dtype))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(spec, dtype=dtype))
            features = spec
        self.fc1 = Dense(side * side * features, 4096, dtype)
        self.fc2 = Dense(4096, 4096, dtype)
        self.head = Dense(4096, num_classes, torch.float32)

    def forward(self, x):
        x = x.to(self.dtype)
        for i, spec in enumerate(self.cfg):
            if spec == "M":
                x = max_pool(x, (2, 2), (2, 2))
                continue
            x = getattr(self, f"conv_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = F.relu(x)
        x = F.relu(self.fc1(flatten_nhwc(x)))
        x = F.relu(self.fc2(x))
        return self.head(x).float()


VGG16 = partial(VGG, depth=16)
VGG19 = partial(VGG, depth=19)
