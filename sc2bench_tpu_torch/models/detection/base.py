"""Detection backbone (counterpart of
`sc2bench_tpu/models/detection/base.py`): a (splittable) ResNet body that
returns [C2, C3, C4, C5] for the FPN.

Without a `bottleneck_layer` it is the stem and layer1 of a ResNet (the
teacher: torchvision's `conv1`, `bn1`, `layer1`); with one, the bottleneck
in their place. layer2-4 at stride 2 each. BatchNorm keeps its statistics
as Flax's does and trains when the module does: torchvision's detection
backbones freeze it, the JAX package does not (`frozen_bn` False in every
config; `FrozenBatchNorm` is not ported).

`forward(x, mode, generator, io)` fills `io` with the JAX package's names:
`bottleneck_layer_out` (or `layer1_out`), `layer2_out` ... `layer4_out`,
and the bottleneck's own under `bottleneck_layer.`. `dtype` is the
stages' compute dtype (`models/precision.py`); the bottleneck keeps its
own.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..backbone import STAGE_SIZES
from ..layer import get_layer
from ..precision import compute, resolve_dtype
from ..resnet import BatchNorm2d, BottleneckBlock, ResNetStage


class SplittableDetectionBackbone(nn.Module):
    """(bottleneck | stem + layer1) + layer2-4 -> [C2, C3, C4, C5]."""

    def __init__(self, bottleneck_layer: nn.Module | None = None,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.bottleneck_layer = bottleneck_layer
        if bottleneck_layer is None:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = BatchNorm2d(64, eps=1e-5)
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
            self.layer1 = ResNetStage(64, 64, stage_sizes[0])
            c = 64 * BottleneckBlock.expansion
        else:
            c = bottleneck_layer.out_channels
        self.layer2 = ResNetStage(c, 128, stage_sizes[1], strides=2)
        self.layer3 = ResNetStage(512, 256, stage_sizes[2], strides=2)
        self.layer4 = ResNetStage(1024, 512, stage_sizes[3], strides=2)
        self.out_channels_list = [c, 512, 1024, 2048]

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> list:
        if self.bottleneck_layer is None:
            with compute(self.dtype, x):
                c2 = self.layer1(self.maxpool(self.relu(self.bn1(
                    self.conv1(x)))))
            name = 'layer1_out'
        else:
            sub = {} if io is not None else None
            c2 = self.bottleneck_layer(x, mode=mode, generator=generator,
                                       io=sub)
            if io is not None:
                io.update({f'bottleneck_layer.{k}': v
                           for k, v in sub.items()})
            name = 'bottleneck_layer_out'
        if io is not None:
            io[name] = c2
        return self.forward_tail(c2, io=io)

    def forward_tail(self, c2: torch.Tensor, io: dict | None = None) -> list:
        """[C2, C3, C4, C5] from the bottleneck's (decoded) feature."""
        feats = [c2]
        with compute(self.dtype, c2):
            for i in (2, 3, 4):
                feats.append(getattr(self, f'layer{i}')(feats[-1]))
                if io is not None:
                    io[f'layer{i}_out'] = feats[-1]
        return feats

    @classmethod
    def from_config(cls, backbone_config, frozen_bn: bool = False,
                    dtype=None):
        """From a config's `backbone_config`: `resnet_name` (ResNet-50 or
        -101) and an optional `bottleneck_config` built by `get_layer`; the
        stages compute in `dtype`."""
        backbone_config = backbone_config or {}
        if frozen_bn or backbone_config.get('frozen_bn', False):
            raise NotImplementedError('FrozenBatchNorm is not ported yet '
                                      '(ROADMAP Queue A item 7)')
        bottleneck = None
        bcfg = backbone_config.get('bottleneck_config')
        if bcfg:
            bottleneck = get_layer(bcfg['key'], **bcfg.get('kwargs', {}))
        return cls(bottleneck, stage_sizes=STAGE_SIZES[
            backbone_config.get('resnet_name', 'resnet50')], dtype=dtype)


class BackboneWithFPN(nn.Module):
    """torchvision's `backbone` of a Faster R-CNN: `body` then `fpn`."""

    def __init__(self, body: SplittableDetectionBackbone,
                 out_channels: int = 256):
        super().__init__()
        from .fpn import FeaturePyramidNetwork
        self.body = body
        self.fpn = FeaturePyramidNetwork(body.out_channels_list, out_channels)

    def forward(self, x, mode='train', generator=None, io=None) -> list:
        return self.fpn(self.body(x, mode=mode, generator=generator, io=io))
