"""ResNeSt (split-attention ResNet) over NCHW (counterpart of
`sc2bench_tpu/models/resnest.py`): timm's `resnest50d` teacher and the
split-attention tail of `SplittableResNeSt`.

timm's key space: `conv1.{0,1,3,4,6}` and `bn1` (the deep 32-32-64 stem),
`layer{i}.{j}.conv1|bn1|conv3|bn3`, the split-attention conv as
`layer{i}.{j}.conv2.conv|bn0|fc1|bn1|fc2` and the average-down shortcut as
`layer{i}.{j}.downsample.1|2` (index 0 is its pool), `fc`.

As in the JAX package:
  - the split-attention conv is a 3x3 conv of `groups * radix` groups to
    `channels * radix` channels, whose output splits channel-major as
    (radix, channels); the attention reads the global average of the sum
    over the splits through two biased 1x1 convs (`fc1` to
    max(channels * radix // 4, 32), `fc2` back) and takes a softmax over
    the radix axis (a sigmoid at radix 1);
  - a stride-2 block pools after the split-attention conv (`avd`: a 3x3/2
    average pool padded by 1, the pads counted) and its shortcut is a 2x2/2
    average pool without padding that floors odd sizes (timm's rounds up
    and leaves pads out), then the 1x1 conv and BatchNorm. At an odd
    input the two branches then differ in size and the block raises, as
    the JAX block does;
  - BatchNorm has eps 1e-5 and Flax's running-variance rule, its scales
    start at one (no zero-init residual).

`forward(x, io=...)` records `layer1_out` ... `layer4_out` (the teacher)
or `bottleneck_layer_out`, `layer2_out` ... `layer4_out` (the splittable
model) in `io`. `dtype` (float32 by default, or bfloat16) is the compute
dtype of the stages (`models/precision.py`); fc runs in float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..registry import register_model
from .precision import compute, linear_head, resolve_dtype
from .resnet import BatchNorm2d


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5)


class SplitAttentionConv(nn.Module):
    """timm's `SplAtConv2d`: (N, in, H, W) -> (N, channels, H', W')."""

    def __init__(self, in_channels: int, channels: int, radix: int = 2,
                 groups: int = 1, stride: int = 1,
                 reduction_factor: int = 4):
        super().__init__()
        self.radix, self.channels = radix, channels
        inter = max(channels * radix // reduction_factor, 32)
        self.conv = nn.Conv2d(in_channels, channels * radix, 3, stride=stride,
                              padding=1, groups=groups * radix, bias=False)
        self.bn0 = _bn(channels * radix)
        self.relu = nn.ReLU()
        self.fc1 = nn.Conv2d(channels, inter, 1)
        self.bn1 = _bn(inter)
        self.fc2 = nn.Conv2d(inter, channels * radix, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, c = self.radix, self.channels
        y = self.relu(self.bn0(self.conv(x)))
        n, _, h, w = y.shape
        splits = y.view(n, r, c, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        a = self.fc2(self.relu(self.bn1(self.fc1(gap)))).view(n, r, c)
        attn = torch.softmax(a, dim=1) if r > 1 else torch.sigmoid(a)
        return torch.einsum('nrchw,nrc->nchw', splits, attn)


class ResNeStBlock(nn.Module):
    """1x1 -> split-attention 3x3 (-> `avd` pool) -> 1x1 (x4) + shortcut;
    the shortcut is projected when the block changes the channel count or
    the stride (`avg_down` pool first when it strides)."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 radix: int = 2):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.bn1 = _bn(filters)
        self.relu = nn.ReLU()
        self.conv2 = SplitAttentionConv(filters, filters, radix=radix)
        self.avd_last = nn.AvgPool2d(3, strides, padding=1) \
            if strides > 1 else None
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample = None
        if in_channels != out or strides > 1:
            pool = nn.AvgPool2d(strides, strides) if strides > 1 \
                else nn.Identity()
            self.downsample = nn.Sequential(
                pool, nn.Conv2d(in_channels, out, 1, bias=False), _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.relu(self.bn1(self.conv1(x))))
        if self.avd_last is not None:
            y = self.avd_last(y)
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNeStStage(nn.Sequential):
    """One layerN stage: `blocks` blocks, the stride on the first."""

    def __init__(self, in_channels: int, filters: int, blocks: int,
                 strides: int = 1, radix: int = 2):
        layers = []
        for i in range(blocks):
            layers.append(ResNeStBlock(in_channels, filters,
                                       strides=strides if i == 0 else 1,
                                       radix=radix))
            in_channels = filters * ResNeStBlock.expansion
        super().__init__(*layers)


def _tail_stages(module: nn.Module, in_channels: int, stage_sizes,
                 radix: int, first: int) -> None:
    """layer{first}..layer4 of `module` (64, 128, 256, 512 filters)."""
    c = in_channels
    for i, filters in enumerate((64, 128, 256, 512), start=1):
        if i < first:
            continue
        setattr(module, f'layer{i}', ResNeStStage(
            c, filters, stage_sizes[i - 1], strides=1 if i == 1 else 2,
            radix=radix))
        c = filters * ResNeStBlock.expansion


class ResNeSt(nn.Module):
    """timm's `resnest50d`: the deep stem (three 3x3 convs, 32-32-64, the
    first at stride 2; a 3x3/2 max pool), layer1-4, average pool, fc."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, radix: int = 2, dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False), _bn(32),
            nn.ReLU(), nn.Conv2d(32, 32, 3, padding=1, bias=False), _bn(32),
            nn.ReLU(), nn.Conv2d(32, 64, 3, padding=1, bias=False))
        self.bn1 = _bn(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        _tail_stages(self, 64, stage_sizes, radix, first=1)
        self.fc = nn.Linear(512 * ResNeStBlock.expansion, num_classes)

    def forward(self, x: torch.Tensor, io: dict | None = None
                ) -> torch.Tensor:
        """Logits (float32); with `io`, each stage's output as
        `layer{i}_out`."""
        with compute(self.dtype, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for i in range(1, 5):
                x = getattr(self, f'layer{i}')(x)
                if io is not None:
                    io[f'layer{i}_out'] = x
            x = torch.mean(x, dim=(2, 3))
        return linear_head(self.fc, x)


class SplittableResNeSt(nn.Module):
    """Bottleneck layer (in place of the stem and layer1) + ResNeSt
    layer2-4 + average pool and fc. `skips_avgpool` returns layer4's
    feature, `skips_fc` the pooled one; with either there is no fc, as
    the JAX model has no fc parameters then (Flax builds none for a Dense
    it never calls)."""

    def __init__(self, bottleneck_layer: nn.Module,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, radix: int = 2,
                 skips_avgpool: bool = False, skips_fc: bool = False,
                 dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.skips_avgpool, self.skips_fc = skips_avgpool, skips_fc
        self.bottleneck_layer = bottleneck_layer
        _tail_stages(self, bottleneck_layer.out_channels, stage_sizes, radix,
                     first=2)
        if not (skips_avgpool or skips_fc):
            self.fc = nn.Linear(512 * ResNeStBlock.expansion, num_classes)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """The bottleneck's `mode` forward, then the tail; with `io`, the
        intermediates under their JAX names."""
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


@register_model
def resnest50d(num_classes: int = 1000, dtype=None, device=None,
               **kwargs) -> ResNeSt:
    """timm's `resnest50d` teacher, placed on `device` (CUDA unless asked
    otherwise)."""
    dev = resolve_device(device)
    return ResNeSt(num_classes=num_classes, dtype=dtype).to(dev)
