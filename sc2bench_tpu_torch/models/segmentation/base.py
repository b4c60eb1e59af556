"""Segmentation base (counterpart of
`sc2bench_tpu/models/segmentation/base.py`): the backbone's feature maps
('out' = layer4, 'aux' = layer3), the heads, and bilinear upsampling to
the input's size.

Torchvision's DeepLabv3 key space: `backbone.<name>` (`conv1`, `bn1`,
`layer1` ... `layer4` for a plain ResNet body; `bottleneck_layer` in place
of the stem and layer1 for a splittable one), `classifier`,
`aux_classifier`. layer3 and layer4 are dilated, so 'out' is at stride 8.

Upsampling is `F.interpolate(mode='bilinear', align_corners=False)`, the
half-pixel rule of `jax.image.resize(..., 'bilinear')`.

`forward(x, mode, generator, io)` fills `io` with the JAX package's
captured names: `backbone.bottleneck_layer_out` (or
`backbone.layer1_out`), `backbone.layer2_out` ... `backbone.layer4_out`,
and the bottleneck's own under `backbone.bottleneck_layer.` (its
`eb_out` in the 'train' mode).

`dtype` (float32 by default, or bfloat16; `models/precision.py`) is the
compute dtype of the backbone's stages and of the heads, whose logits
are cast to float32 before the upsampling; the bottleneck keeps its own.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..precision import compute, resolve_dtype
from ..resnet import BatchNorm2d, BottleneckBlock, ResNetStage


def upsample_to(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode='bilinear',
                         align_corners=False)


class SegmentationBackbone(nn.Module):
    """A (splittable) ResNet body as the dict-feature backbone. Without a
    `bottleneck_layer`, the stem and layer1 of a ResNet; with one, the
    bottleneck in their place. layer2 at stride 2; layer3 and layer4
    dilated (1, 2, 2, ... and 2, 4, 4, ...)."""

    def __init__(self, bottleneck_layer: nn.Module | None = None,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 return_aux: bool = True, dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.return_aux = return_aux
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
        self.layer3 = ResNetStage(512, 256, stage_sizes[2], strides=2,
                                  dilation=1, dilate=True)
        self.layer4 = ResNetStage(1024, 512, stage_sizes[3], strides=2,
                                  dilation=2, dilate=True)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> dict:
        if self.bottleneck_layer is None:
            with compute(self.dtype, x):
                z = self.layer1(self.maxpool(self.relu(self.bn1(
                    self.conv1(x)))))
            name = 'layer1_out'
        else:
            sub = {} if io is not None else None
            z = self.bottleneck_layer(x, mode=mode, generator=generator,
                                      io=sub)
            if io is not None:
                io.update({f'bottleneck_layer.{k}': v
                           for k, v in sub.items()})
            name = 'bottleneck_layer_out'
        if io is not None:
            io[name] = z
        return self.forward_tail(z, io=io)

    def forward_tail(self, feature: torch.Tensor, io: dict | None = None
                     ) -> dict:
        """{'out': layer4's map, 'aux': layer3's (with `return_aux`)} from
        the bottleneck's (decoded) feature."""
        features = {}
        z = feature
        with compute(self.dtype, z):
            for i in (2, 3, 4):
                z = getattr(self, f'layer{i}')(z)
                if io is not None:
                    io[f'layer{i}_out'] = z
                if i == 3 and self.return_aux:
                    features['aux'] = z
        features['out'] = z
        return features


class BaseSegmentationModel(nn.Module):
    """backbone -> classifier head (+ aux head) -> bilinear upsampling to
    the input's size. Returns {'out': logits (N, K, H, W)[, 'aux': ...]}."""

    def __init__(self, backbone: SegmentationBackbone, classifier: nn.Module,
                 aux_classifier: nn.Module | None = None, dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.backbone = backbone
        self.classifier = classifier
        self.aux_classifier = aux_classifier

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> dict:
        sub = {} if io is not None else None
        features = self.backbone(x, mode=mode, generator=generator, io=sub)
        if io is not None:
            io.update({f'backbone.{k}': v for k, v in sub.items()})
        size = x.shape[-2:]
        result = {'out': upsample_to(self._head(self.classifier,
                                                features['out']), size)}
        if self.aux_classifier is not None and 'aux' in features:
            result['aux'] = upsample_to(
                self._head(self.aux_classifier, features['aux']), size)
        return result

    def _head(self, head: nn.Module, feature: torch.Tensor) -> torch.Tensor:
        """A head's float32 logits, computed in the model's dtype."""
        with compute(self.dtype, feature):
            return head(feature).to(torch.float32)

    # ---- deploy split (the runtime's ops) ----------------------------------
    def encode_ops(self, x: torch.Tensor, medians: torch.Tensor) -> dict:
        return self.backbone.bottleneck_layer.encode_ops(x, medians)

    def decode_ops_to_output(self, symbols: torch.Tensor,
                             medians: torch.Tensor, input_hw) -> torch.Tensor:
        """Main-head logits (N, K, *input_hw) from the latent's symbols
        (NCHW): bottleneck decoder, dilated tail, head, upsampling."""
        feature = self.backbone.bottleneck_layer.decode_ops(symbols, medians)
        out = self._head(self.classifier,
                         self.backbone.forward_tail(feature)['out'])
        return upsample_to(out, input_hw)
