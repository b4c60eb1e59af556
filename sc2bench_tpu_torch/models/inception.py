"""Inception-v3 tail over NCHW (counterpart of
`sc2bench_tpu/models/inception.py`): the Mixed_5b..Mixed_7c blocks behind
a bottleneck that replaces everything before Mixed_5b.

torchvision's key space: `inception_modules.Mixed_*.<branch>.conv|bn` with
the branch names of torchvision's `InceptionA`..`InceptionE` (`branch1x1`,
`branch5x5_1`, `branch3x3dbl_2`, `branch7x7x3_4`, ...), and `fc`. Each
`BasicConv` is a bias-free conv, BatchNorm with eps 1e-3 (Flax's
running-variance rule) and ReLU; the 1x7 and 7x1 convs pad (0, 3) and
(3, 0); the pooled branches average over 3x3 padded by 1, the pads
counted; the reduction blocks max-pool 3x3/2 unpadded.

`forward(x, mode, generator, io)` records `bottleneck_layer_out`,
`Mixed_6e_out` and `Mixed_7c_out` in `io`, the JAX module's sown names.
There is no `forward_tail`, as in JAX: the model serves no split.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..registry import register_model
from .layer import get_layer
from .resnet import BatchNorm2d


class BasicConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel,
                 stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel,
                              stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _pool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(in_channels, pool_features, 1)
        self.out_channels = 224 + pool_features

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)
        self.out_channels = 480 + in_channels

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(in_channels, 192, 1)
        self.out_channels = 768

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)
        self.out_channels = 512 + in_channels

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(in_channels, 192, 1)
        self.out_channels = 2048

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_pool3(x))], 1)


# (name, block, its argument besides the input width)
_BLOCKS = (('Mixed_5b', InceptionA, 32), ('Mixed_5c', InceptionA, 64),
           ('Mixed_5d', InceptionA, 64), ('Mixed_6a', InceptionB, None),
           ('Mixed_6b', InceptionC, 128), ('Mixed_6c', InceptionC, 160),
           ('Mixed_6d', InceptionC, 160), ('Mixed_6e', InceptionC, 192),
           ('Mixed_7a', InceptionD, None), ('Mixed_7b', InceptionE, None),
           ('Mixed_7c', InceptionE, None))
_SOWN = ('Mixed_6e', 'Mixed_7c')


class SplittableInceptionV3(nn.Module):
    """Bottleneck layer + Mixed_5b..Mixed_7c + average pool and fc."""

    def __init__(self, bottleneck_layer: nn.Module, num_classes: int = 1000):
        super().__init__()
        self.bottleneck_layer = bottleneck_layer
        blocks, c = OrderedDict(), bottleneck_layer.out_channels
        for name, block, arg in _BLOCKS:
            blocks[name] = block(c) if arg is None else block(c, arg)
            c = blocks[name].out_channels
        self.inception_modules = nn.Sequential(blocks)
        self.fc = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        sub = {} if io is not None else None
        z = self.bottleneck_layer(x, mode=mode, generator=generator, io=sub)
        if io is not None:
            io.update({f'bottleneck_layer.{k}': v for k, v in sub.items()})
            io['bottleneck_layer_out'] = z
        for name, block in self.inception_modules.named_children():
            z = block(z)
            if io is not None and name in _SOWN:
                io[f'{name}_out'] = z
        return self.fc(torch.mean(z, dim=(2, 3)))


@register_model
def splittable_inception_v3(bottleneck_config: dict, num_classes: int = 1000,
                            device=None, **kwargs) -> SplittableInceptionV3:
    """Factory: the bottleneck from the layer registry and the Inception-v3
    tail, placed on `device` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    bottleneck = get_layer(bottleneck_config['key'],
                           **bottleneck_config.get('kwargs', {}))
    return SplittableInceptionV3(bottleneck, num_classes=num_classes).to(dev)
