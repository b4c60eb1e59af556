"""ResNet v1.5 blocks over NCHW (counterpart of
`sc2bench_tpu/models/resnet.py`): the classification tail behind the
splittable models. Torchvision key space (`conv1`, `bn1`, ...,
`downsample.0/1`); BatchNorm with eps 1e-5.
"""
from __future__ import annotations

from torch import nn


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) + shortcut. The shortcut is projected
    when the block changes the channel count or the stride. bn3 starts with
    zero scales (zero-init residual), as in the JAX package."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=1e-5)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride=strides,
                               padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters, eps=1e-5)
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=1e-5)
        nn.init.zeros_(self.bn3.weight)
        self.relu = nn.ReLU()
        self.downsample = None
        if in_channels != out or strides != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride=strides, bias=False),
                nn.BatchNorm2d(out, eps=1e-5))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNetStage(nn.Sequential):
    """One layerN stage: `blocks` bottleneck blocks, stride on the first."""

    def __init__(self, in_channels: int, filters: int, blocks: int,
                 strides: int = 1):
        layers = []
        for i in range(blocks):
            layers.append(BottleneckBlock(
                in_channels, filters, strides=strides if i == 0 else 1))
            in_channels = filters * BottleneckBlock.expansion
        super().__init__(*layers)
