"""Splittable classification backbone (counterpart of
`sc2bench_tpu/models/backbone.py`): the stem+layer1 of a ResNet replaced
by a learned bottleneck; layer2-4 and the classifier form the server-side
tail. Both builders register under the 'model' namespace.

`forward(x, mode, generator, io)` fills the dict `io` with the JAX
package's captured intermediates: `bottleneck_layer_out`, `layer2_out` ...
`layer4_out`, and in the 'train' mode `bottleneck_layer.eb_out`.
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

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """Logits without a bitstream: the bottleneck's `mode` forward
        ('train' draws its noise from `generator`), then the tail. With
        `io`, the intermediates under their JAX names."""
        sub = {} if io is not None else None
        z = self.bottleneck_layer(x, mode=mode, generator=generator, io=sub)
        if io is not None:
            io.update({f'bottleneck_layer.{k}': v for k, v in sub.items()})
            io['bottleneck_layer_out'] = z
        return self.forward_tail(z, io=io)

    def forward_tail(self, feature: torch.Tensor, io: dict | None = None
                     ) -> torch.Tensor:
        """Server-side tail from a decoded bottleneck feature (NCHW)."""
        z = feature
        for i in (2, 3, 4):
            z = getattr(self, f'layer{i}')(z)
            if io is not None:
                io[f'layer{i}_out'] = z
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
