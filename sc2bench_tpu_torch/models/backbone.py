"""Splittable classification backbones (counterpart of
`sc2bench_tpu/models/backbone.py`): the stem+layer1 of a ResNet replaced
by a learned bottleneck; layer2-4 and the classifier form the server-side
tail. The builders register under the 'model' namespace:
`splittable_resnet` (ResNet-50/101/152, and `resnest50d`, which JAX maps
to a plain ResNet tail), `splittable_resnest` (the split-attention tail of
`models/resnest.py`) and `splittable_densenet`.

`SplittableResNet` takes `skips_avgpool` (return layer4's feature),
`skips_fc` (return the pooled feature; with either there is no fc, as
the JAX model has no fc parameters then) and
`frozen_bn` (`FrozenBatchNorm2d` in layer2-4).

`SplittableDenseNet` is torchvision's DenseNet from denseblock3 on, in its
key space: `features.denseblock{3,4}.denselayer{L}.norm1|conv1|norm2|conv2`
(L from 1), `features.transition3.norm|conv` (the transition after block 3
only), `features.norm5` and `classifier`; growth 32, BatchNorm eps 1e-5,
its 2x2/2 transition pool without padding. It has no `forward_tail`, as in
JAX.

`forward(x, mode, generator, io)` fills the dict `io` with the JAX
package's captured intermediates: `bottleneck_layer_out`, `layer2_out` ...
`layer4_out` (the DenseNet: `bottleneck_layer_out`), and in the 'train'
mode `bottleneck_layer.eb_out`.

`dtype` (float32 by default, or bfloat16) is the tail's compute dtype
(`models/precision.py`): layer2-4 run in it, fc in float32; the
bottleneck keeps its own.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..registry import get, register_model
from .layer import get_layer
from .precision import compute, linear_head, resolve_dtype
from .resnest import SplittableResNeSt
from .resnet import BatchNorm2d, BottleneckBlock, ResNet, ResNetStage

STAGE_SIZES = {'resnet50': (3, 4, 6, 3), 'resnet101': (3, 4, 23, 3),
               'resnet152': (3, 8, 36, 3), 'resnest50d': (3, 4, 6, 3)}
RESNEST_STAGE_SIZES = {'resnest50d': (3, 4, 6, 3),
                       'resnest101e': (3, 4, 23, 3)}
DENSENET_BLOCKS = {'densenet169': (6, 12, 32, 32),
                   'densenet201': (6, 12, 48, 32)}


class SplittableResNet(nn.Module):
    """Bottleneck layer + ResNet layer2-4 + avgpool/fc."""

    def __init__(self, bottleneck_layer: nn.Module,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, dtype=None,
                 skips_avgpool: bool = False, skips_fc: bool = False,
                 frozen_bn: bool = False):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.skips_avgpool, self.skips_fc = skips_avgpool, skips_fc
        self.bottleneck_layer = bottleneck_layer
        c = bottleneck_layer.out_channels
        for i, filters in ((2, 128), (3, 256), (4, 512)):
            setattr(self, f'layer{i}', ResNetStage(
                c, filters, stage_sizes[i - 1], strides=2,
                frozen_bn=frozen_bn))
            c = filters * BottleneckBlock.expansion
        if not (skips_avgpool or skips_fc):
            self.fc = nn.Linear(c, num_classes)

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
        """Server-side tail from a decoded bottleneck feature (NCHW):
        float32 logits (or the feature the skips ask for)."""
        z = feature
        with compute(self.dtype, z):
            for i in (2, 3, 4):
                z = getattr(self, f'layer{i}')(z)
                if io is not None:
                    io[f'layer{i}_out'] = z
            if self.skips_avgpool:
                return z
            z = torch.mean(z, dim=(2, 3))
        if self.skips_fc:
            return z
        return linear_head(self.fc, z)


@register_model(name='resnet')
def resnet_builder(stage_sizes=(3, 4, 6, 3), num_classes=1000,
                   dtype=None, device=None) -> ResNet:
    """Config-resolvable plain ResNet of any stage sizes and compute
    `dtype`, placed on `device` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    return ResNet(stage_sizes=tuple(stage_sizes), num_classes=num_classes,
                  dtype=dtype).to(dev)


def _bottleneck(bottleneck_config: dict) -> nn.Module:
    return get_layer(bottleneck_config['key'],
                     **bottleneck_config.get('kwargs', {}))


@register_model
def splittable_resnet(bottleneck_config: dict, resnet_name: str = 'resnet50',
                      num_classes: int = 1000, skips_avgpool: bool = False,
                      skips_fc: bool = False, frozen_bn: bool = False,
                      stage_sizes=None, dtype=None,
                      device=None) -> SplittableResNet:
    """Factory: bottleneck from the layer registry + ResNet tail selected by
    name (`stage_sizes` overrides the depth), the skips and `frozen_bn` of
    the class, the tail's compute `dtype` (the bottleneck's is its
    config's). The model is placed on `device`, CUDA unless asked
    otherwise."""
    dev = resolve_device(device)
    stage_sizes = tuple(stage_sizes) if stage_sizes \
        else STAGE_SIZES[resnet_name]
    model = SplittableResNet(_bottleneck(bottleneck_config),
                             stage_sizes=stage_sizes, num_classes=num_classes,
                             dtype=dtype, skips_avgpool=skips_avgpool,
                             skips_fc=skips_fc, frozen_bn=frozen_bn)
    return model.to(dev)


@register_model
def splittable_resnest(bottleneck_config: dict,
                       resnest_name: str = 'resnest50d',
                       num_classes: int = 1000, skips_avgpool: bool = False,
                       skips_fc: bool = False, dtype=None, device=None,
                       **kwargs) -> SplittableResNeSt:
    """Factory: bottleneck + the radix-2 split-attention tail of
    `resnest50d` (or `resnest101e`), placed on `device` (CUDA unless asked
    otherwise)."""
    dev = resolve_device(device)
    model = SplittableResNeSt(_bottleneck(bottleneck_config),
                              stage_sizes=RESNEST_STAGE_SIZES[resnest_name],
                              num_classes=num_classes,
                              skips_avgpool=skips_avgpool,
                              skips_fc=skips_fc, dtype=dtype)
    return model.to(dev)


class _DenseLayer(nn.Module):
    """BN-ReLU-1x1 conv (4 x growth) -> BN-ReLU-3x3 conv (growth); its
    output is concatenated to its input."""

    def __init__(self, in_channels: int, growth_rate: int):
        super().__init__()
        self.norm1 = BatchNorm2d(in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, 4 * growth_rate, 1, bias=False)
        self.norm2 = BatchNorm2d(4 * growth_rate, eps=1e-5)
        self.conv2 = nn.Conv2d(4 * growth_rate, growth_rate, 3, padding=1,
                               bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], 1)


class _Transition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm = BatchNorm2d(in_channels, eps=1e-5)
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class SplittableDenseNet(nn.Module):
    """Bottleneck layer + DenseNet denseblock3, transition3, denseblock4,
    norm5, average pool and classifier (module doc)."""

    def __init__(self, bottleneck_layer: nn.Module, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 32, 32),
                 num_classes: int = 1000):
        super().__init__()
        self.bottleneck_layer = bottleneck_layer
        self.features = nn.Sequential()
        c = bottleneck_layer.out_channels
        for bi, num_layers in enumerate(block_config[2:], start=3):
            block = nn.Sequential()
            for li in range(1, num_layers + 1):
                block.add_module(f'denselayer{li}',
                                 _DenseLayer(c, growth_rate))
                c += growth_rate
            self.features.add_module(f'denseblock{bi}', block)
            if bi != len(block_config):
                self.features.add_module(f'transition{bi}',
                                         _Transition(c, c // 2))
                c //= 2
        self.features.add_module('norm5', BatchNorm2d(c, eps=1e-5))
        self.classifier = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        sub = {} if io is not None else None
        z = self.bottleneck_layer(x, mode=mode, generator=generator, io=sub)
        if io is not None:
            io.update({f'bottleneck_layer.{k}': v for k, v in sub.items()})
            io['bottleneck_layer_out'] = z
        z = torch.relu(self.features(z))
        return self.classifier(torch.mean(z, dim=(2, 3)))


@register_model
def splittable_densenet(bottleneck_config: dict,
                        densenet_name: str = 'densenet169',
                        num_classes: int = 1000, device=None,
                        **kwargs) -> SplittableDenseNet:
    """Factory: bottleneck + the DenseNet-169 or -201 tail, placed on
    `device` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    return SplittableDenseNet(_bottleneck(bottleneck_config),
                              block_config=DENSENET_BLOCKS[densenet_name],
                              num_classes=num_classes).to(dev)


def get_backbone(key: str, **kwargs):
    """The model of the 'model' registry's builder `key`, built with
    `kwargs` (`device` among them)."""
    return get('model', key)(**kwargs)


def check_if_updatable(model) -> bool:
    """Whether `model` has the updatable surface: `update` and a
    `bottleneck_updated` flag (a `SplitClassifierRuntime`)."""
    return hasattr(model, 'update') and hasattr(model, 'bottleneck_updated')
