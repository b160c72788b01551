"""Inception V3 without the auxiliary head, the counterpart of
``horovod_tpu.models.inception``.

Every block registers its ``ConvBN_k`` submodules in the order the flax
block constructs them, which is the order its expressions name them from
left to right: ``c(64, (5, 5))(c(48, (1, 1))(x))`` makes the 5x5 first.
So ``c = list(self.children())`` in a forward is the flax numbering, and
``c[1](c[2](x))`` is that expression. BatchNorm epsilon is 1e-3 here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cnn_layers import BatchNorm, Conv2d, Dense, avg_pool, max_pool


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding: str = "SAME",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, kernel, strides, padding,
                             dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-3, dtype=dtype)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _add_convs(module: nn.Module, specs, dtype: torch.dtype) -> None:
    """Register ``ConvBN_k`` for each (in, out, kernel[, strides, padding])
    of ``specs``, in order."""
    for k, spec in enumerate(specs):
        module.add_module(f"ConvBN_{k}", ConvBN(*spec, dtype=dtype))


_S2 = (2, 2)


class InceptionA(nn.Module):
    def __init__(self, in_features: int, pool_features: int, dtype: torch.dtype):
        super().__init__()
        cin = in_features
        _add_convs(self, [(cin, 64, (1, 1)), (48, 64, (5, 5)), (cin, 48, (1, 1)),
                          (96, 96, (3, 3)), (64, 96, (3, 3)), (cin, 64, (1, 1)),
                          (cin, pool_features, (1, 1))], dtype)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        c = list(self.children())
        b4 = c[6](avg_pool(x, (3, 3), (1, 1), "SAME"))
        return torch.cat([c[0](x), c[1](c[2](x)), c[3](c[4](c[5](x))), b4], dim=1)


class InceptionB(nn.Module):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, in_features: int, dtype: torch.dtype):
        super().__init__()
        cin = in_features
        _add_convs(self, [(cin, 384, (3, 3), _S2, "VALID"),
                          (96, 96, (3, 3), _S2, "VALID"), (64, 96, (3, 3)),
                          (cin, 64, (1, 1))], dtype)
        self.out_features = 384 + 96 + cin

    def forward(self, x):
        c = list(self.children())
        b3 = max_pool(x, (3, 3), _S2)
        return torch.cat([c[0](x), c[1](c[2](c[3](x))), b3], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_features: int, channels_7x7: int, dtype: torch.dtype):
        super().__init__()
        cin, f = in_features, channels_7x7
        _add_convs(self, [(cin, 192, (1, 1)),
                          (f, 192, (7, 1)), (f, f, (1, 7)), (cin, f, (1, 1)),
                          (f, f, (7, 1)), (f, f, (1, 7)), (f, f, (7, 1)),
                          (cin, f, (1, 1)), (f, 192, (1, 7)),
                          (cin, 192, (1, 1))], dtype)
        self.out_features = 4 * 192

    def forward(self, x):
        c = list(self.children())
        b3 = c[8](c[4](c[5](c[6](c[7](x)))))
        b4 = c[9](avg_pool(x, (3, 3), (1, 1), "SAME"))
        return torch.cat([c[0](x), c[1](c[2](c[3](x))), b3, b4], dim=1)


class InceptionD(nn.Module):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, in_features: int, dtype: torch.dtype):
        super().__init__()
        cin = in_features
        _add_convs(self, [(192, 320, (3, 3), _S2, "VALID"), (cin, 192, (1, 1)),
                          (192, 192, (7, 1)), (192, 192, (1, 7)),
                          (cin, 192, (1, 1)), (192, 192, (3, 3), _S2, "VALID")],
                   dtype)
        self.out_features = 320 + 192 + cin

    def forward(self, x):
        c = list(self.children())
        b2 = c[5](c[2](c[3](c[4](x))))
        return torch.cat([c[0](c[1](x)), b2, max_pool(x, (3, 3), _S2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_features: int, dtype: torch.dtype):
        super().__init__()
        cin = in_features
        _add_convs(self, [(cin, 320, (1, 1)), (cin, 384, (1, 1)),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (448, 384, (3, 3)), (cin, 448, (1, 1)),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (cin, 192, (1, 1))], dtype)
        self.out_features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        c = list(self.children())
        b2 = c[1](x)
        b2 = torch.cat([c[2](b2), c[3](b2)], dim=1)
        b3 = c[4](c[5](x))
        b3 = torch.cat([c[6](b3), c[7](b3)], dim=1)
        b4 = c[8](avg_pool(x, (3, 3), (1, 1), "SAME"))
        return torch.cat([c[0](x), b2, b3, b4], dim=1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        # stem: 299x299x3 -> 35x35x192
        _add_convs(self, [(3, 32, (3, 3), _S2, "VALID"),
                          (32, 32, (3, 3), (1, 1), "VALID"), (32, 64, (3, 3)),
                          (64, 80, (1, 1), (1, 1), "VALID"),
                          (80, 192, (3, 3), (1, 1), "VALID")], dtype)
        self.block_names = []
        features = 192
        blocks = [(InceptionA, (32,)), (InceptionA, (64,)), (InceptionA, (64,)),
                  (InceptionB, ()), (InceptionC, (128,)), (InceptionC, (160,)),
                  (InceptionC, (160,)), (InceptionC, (192,)), (InceptionD, ()),
                  (InceptionE, ()), (InceptionE, ())]
        for cls, args in blocks:
            k = sum(n.startswith(cls.__name__) for n in self.block_names)
            name = f"{cls.__name__}_{k}"
            block = cls(features, *args, dtype=dtype)
            self.add_module(name, block)
            self.block_names.append(name)
            features = block.out_features
        self.head = Dense(features, num_classes, torch.float32)

    def forward(self, x):
        x = x.to(self.dtype)
        x = self.ConvBN_1(self.ConvBN_0(x))
        x = max_pool(self.ConvBN_2(x), (3, 3), _S2)
        x = max_pool(self.ConvBN_4(self.ConvBN_3(x)), (3, 3), _S2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.head(x).float()
