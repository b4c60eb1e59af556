"""Splittable classification backbone (counterpart of
`sc2bench_tpu/models/backbone.py`): the stem+layer1 of a ResNet replaced
by a learned bottleneck; layer2-4 and the classifier form the server-side
tail. Both builders register under the 'model' namespace.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..registry import register_model
from .layer import get_layer
from .resnet import BottleneckBlock, ResNet, ResNetStage

STAGE_SIZES = {'resnet50': (3, 4, 6, 3), 'resnet101': (3, 4, 23, 3),
               'resnet152': (3, 8, 36, 3)}


class SplittableResNet(nn.Module):
    """Bottleneck layer + ResNet layer2-4 + avgpool/fc."""

    def __init__(self, bottleneck_layer: nn.Module,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000):
        super().__init__()
        self.bottleneck_layer = bottleneck_layer
        c = bottleneck_layer.out_channels
        self.layer2 = ResNetStage(c, 128, stage_sizes[1], strides=2)
        c = 128 * BottleneckBlock.expansion
        self.layer3 = ResNetStage(c, 256, stage_sizes[2], strides=2)
        c = 256 * BottleneckBlock.expansion
        self.layer4 = ResNetStage(c, 512, stage_sizes[3], strides=2)
        self.fc = nn.Linear(512 * BottleneckBlock.expansion, num_classes)

    def forward(self, x: torch.Tensor, mode: str = 'finetune'
                ) -> torch.Tensor:
        """Logits without a bitstream: the bottleneck's `mode` forward,
        then the tail."""
        return self.forward_tail(self.bottleneck_layer(x, mode=mode))

    def forward_tail(self, feature: torch.Tensor) -> torch.Tensor:
        """Server-side tail from a decoded bottleneck feature (NCHW)."""
        z = self.layer4(self.layer3(self.layer2(feature)))
        return self.fc(torch.mean(z, dim=(2, 3)))


@register_model(name='resnet')
def resnet_builder(stage_sizes=(3, 4, 6, 3), num_classes=1000,
                   device=None) -> ResNet:
    """Config-resolvable plain ResNet of any stage sizes, placed on
    `device` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    return ResNet(stage_sizes=tuple(stage_sizes),
                  num_classes=num_classes).to(dev)


@register_model
def splittable_resnet(bottleneck_config: dict, resnet_name: str = 'resnet50',
                      num_classes: int = 1000, stage_sizes=None,
                      device=None) -> SplittableResNet:
    """Factory: bottleneck from the layer registry + ResNet tail selected by
    name (`stage_sizes` overrides the depth). The model is placed on
    `device`, CUDA unless asked otherwise."""
    dev = resolve_device(device)
    stage_sizes = tuple(stage_sizes) if stage_sizes \
        else STAGE_SIZES[resnet_name]
    bottleneck = get_layer(bottleneck_config['key'],
                           **bottleneck_config.get('kwargs', {}))
    model = SplittableResNet(bottleneck, stage_sizes=stage_sizes,
                             num_classes=num_classes)
    return model.to(dev)
