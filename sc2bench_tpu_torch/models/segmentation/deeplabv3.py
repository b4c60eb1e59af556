"""DeepLabv3 heads and builder (counterpart of
`sc2bench_tpu/models/segmentation/deeplabv3.py`).

Torchvision's Sequential layout, so that its keys name the parameters:
`classifier` = [ASPP, 3x3 conv, BN, ReLU, 1x1 conv] with ASPP's
`convs.{0..4}` (1x1, three 3x3 dilated at rates 12/24/36, the pooled
branch [pool, conv, BN, ReLU]) and `project` [conv, BN, ReLU];
`aux_classifier` (FCNHead) = [3x3 conv, BN, ReLU, -, 1x1 conv]. Where
torchvision has Dropout (0.5 after ASPP's projection, 0.1 at FCNHead's
index 3) there is none, as in the JAX package, whose training steps the
port follows: FCNHead keeps the index with an `Identity`.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...device import resolve_device
from ...registry import register_model
from ..backbone import STAGE_SIZES
from ..layer import get_layer
from ..resnet import BatchNorm2d
from .base import BaseSegmentationModel, SegmentationBackbone


def _conv_bn_relu(cin: int, cout: int, k: int, dilation: int = 1
                  ) -> list[nn.Module]:
    return [nn.Conv2d(cin, cout, k, padding=dilation * (k // 2),
                      dilation=dilation, bias=False),
            BatchNorm2d(cout, eps=1e-5), nn.ReLU()]


class ASPPConv(nn.Sequential):
    def __init__(self, in_channels: int, out_channels: int, rate: int):
        super().__init__(*_conv_bn_relu(in_channels, out_channels, 3, rate))


class ASPPPooling(nn.Sequential):
    """Global average, 1x1 conv, BN, ReLU, broadcast back to the map."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         *_conv_bn_relu(in_channels, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    def __init__(self, in_channels: int, rates: Sequence[int] = (12, 24, 36),
                 out_channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            [nn.Sequential(*_conv_bn_relu(in_channels, out_channels, 1))]
            + [ASPPConv(in_channels, out_channels, r) for r in rates]
            + [ASPPPooling(in_channels, out_channels)])
        self.project = nn.Sequential(*_conv_bn_relu(
            len(self.convs) * out_channels, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([conv(x) for conv in self.convs],
                                      dim=1))


class DeepLabHead(nn.Sequential):
    def __init__(self, in_channels: int, num_classes: int = 21):
        super().__init__(ASPP(in_channels),
                         *_conv_bn_relu(256, 256, 3),
                         nn.Conv2d(256, num_classes, 1))


class FCNHead(nn.Sequential):
    def __init__(self, in_channels: int, num_classes: int = 21):
        mid = in_channels // 4
        super().__init__(*_conv_bn_relu(in_channels, mid, 3), nn.Identity(),
                         nn.Conv2d(mid, num_classes, 1))


def create_deeplabv3(backbone: SegmentationBackbone, num_classes: int = 21,
                     uses_aux: bool = False, dtype=None
                     ) -> BaseSegmentationModel:
    """Heads over a feature backbone: DeepLabHead on layer4 (2048
    channels), FCNHead on layer3 (1024) when `uses_aux`, computing in
    `dtype`."""
    return BaseSegmentationModel(
        backbone, DeepLabHead(2048, num_classes),
        FCNHead(1024, num_classes) if uses_aux else None, dtype=dtype)


@register_model
def deeplabv3_model(bottleneck_config=None, backbone_name='resnet50',
                    num_classes=21, uses_aux=False, dtype=None, device=None,
                    **kwargs) -> BaseSegmentationModel:
    """DeepLabv3 over a plain or (with `bottleneck_config`, any layer that
    `get_layer` builds) splittable dilated ResNet-50/101, placed on
    `device` (CUDA unless asked otherwise). `dtype` ('bfloat16' or float32
    by default) is the compute dtype of the stages, ASPP and the heads;
    the bottleneck keeps its own. Other kwargs of the JAX builder
    (`num_input_channels`) are accepted and unused."""
    dev = resolve_device(device)
    bottleneck = None
    if bottleneck_config:
        bottleneck = get_layer(bottleneck_config['key'],
                               **bottleneck_config.get('kwargs', {}))
    backbone = SegmentationBackbone(
        bottleneck, stage_sizes=STAGE_SIZES[backbone_name],
        return_aux=uses_aux, dtype=dtype)
    return create_deeplabv3(backbone, num_classes, uses_aux,
                            dtype=dtype).to(dev)
