"""RegNetY over NCHW (counterpart of `sc2bench_tpu/models/regnet.py`): the
splittable student (a bottleneck in place of the stem and s1, then s2-s4
and the head) and the full classifier, its teacher (`regnety_064`,
RegNetY-6.4GF). timm key space: `stem.conv`/`stem.bn`, stages `s1`-`s4`
of blocks `b1`..`bN` (1-indexed), each `conv1.conv`/`conv1.bn`,
`conv2.*`, `se.fc1`/`se.fc2`, `conv3.*` and `downsample.conv`/`.bn`;
`head.fc`. BatchNorm with eps 1e-5 and Flax's running-variance rule.

`generate_regnet_params` gives the widths and depths of the RegNet design
space from (w0, wa, wm, depth, group width).

`forward(x, io=...)` records each stage's output under the JAX package's
names (`s1_out` ... `s4_out`; the student `bottleneck_layer_out` and
`s2_out` ... `s4_out`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..registry import register_model
from .layer import get_layer
from .resnet import BatchNorm2d

# (stage widths s2.., stage depths s2.., group width) of the splittable
# student; the teacher adds s1
REGNET_PRESETS = {
    'regnety_064': ((288, 576, 1296), (7, 14, 2), 72),
    'regnety_016': ((120, 336, 888), (6, 17, 2), 24),
}


def generate_regnet_params(w0, wa, wm, depth, group_width, q=8):
    """Per-stage widths and depths from the RegNet design space
    (Radosavovic et al.): block j's width w0 * wm^round(log((w0 + wa j)
    / w0) / log wm), rounded to a multiple of `q`, then of the group width
    (at least one group); runs of equal widths are stages. The JAX
    package's arithmetic, step for step."""
    ks = np.round(np.log((w0 + wa * np.arange(depth)) / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = np.round(widths / q) * q
    widths = np.minimum(widths, np.round(widths / group_width) * group_width
                        + group_width * (widths % group_width > 0) * 0)
    widths = [int(max(group_width, round(w / group_width) * group_width))
              for w in widths]
    stage_widths, stage_depths = [], []
    for w in widths:
        if stage_widths and stage_widths[-1] == w:
            stage_depths[-1] += 1
        else:
            stage_widths.append(w)
            stage_depths.append(1)
    return stage_widths, stage_depths


class ConvBn(nn.Module):
    """timm `ConvNormAct` without its activation: a bias-free convolution
    (`conv`, symmetric padding k // 2) and BatchNorm (`bn`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return self.bn(self.conv(x))


class SEBlock(nn.Module):
    """Squeeze-and-excitation: the mean over space, a 1x1 conv with bias
    (`fc1`) to a quarter of the channels of the BLOCK's input, ReLU, a 1x1
    conv with bias (`fc2`) back, sigmoid gate."""

    def __init__(self, channels: int, in_ch: int):
        super().__init__()
        se_ch = max(1, int(in_ch * 0.25))
        self.fc1 = nn.Conv2d(channels, se_ch, 1)
        self.fc2 = nn.Conv2d(se_ch, channels, 1)

    def forward(self, x):
        s = torch.mean(x, dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class RegNetBottleneck(nn.Module):
    """1x1 -> grouped 3x3 (stride; `width // group_width` groups) -> SE ->
    1x1, then ReLU of the sum with the shortcut, which a 1x1 conv + BN
    projects when the stride or the width changes."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 group_width: int = 8):
        super().__init__()
        self.conv1 = ConvBn(in_ch, width)
        self.conv2 = ConvBn(width, width, 3, stride,
                            groups=max(1, width // group_width))
        self.se = SEBlock(width, in_ch)
        self.conv3 = ConvBn(width, width)
        self.downsample = ConvBn(in_ch, width, 1, stride) \
            if stride != 1 or in_ch != width else None

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = self.conv3(self.se(F.relu(self.conv2(y))))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(shortcut + y)


class RegNetStage(nn.Sequential):
    """`depth` blocks `b1`..`b{depth}`, stride 2 on the first."""

    def __init__(self, in_ch: int, width: int, depth: int, group_width: int):
        super().__init__(OrderedDict(
            (f'b{i + 1}', RegNetBottleneck(in_ch if i == 0 else width, width,
                                           2 if i == 0 else 1, group_width))
            for i in range(depth)))


class _Head(nn.Module):
    """timm's `head` (key `head.fc`): the mean over space, then `fc`."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(in_ch, num_classes)

    def forward(self, x):
        return self.fc(torch.mean(x, dim=(2, 3)))


class SplittableRegNet(nn.Module):
    """Bottleneck (in place of the stem and s1) + s2-s4 + head."""

    def __init__(self, bottleneck_layer: nn.Module,
                 stage_widths: Sequence[int] = (288, 576, 1296),
                 stage_depths: Sequence[int] = (7, 14, 2),
                 group_width: int = 72, num_classes: int = 1000):
        super().__init__()
        self.bottleneck_layer = bottleneck_layer
        c = bottleneck_layer.out_channels
        for i, (w, d) in enumerate(zip(stage_widths, stage_depths), start=2):
            setattr(self, f's{i}', RegNetStage(c, w, d, group_width))
            c = w
        self.head = _Head(c, num_classes)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """Logits without a bitstream (the bottleneck's `mode` forward,
        then the tail); with `io`, the intermediates under their JAX
        names."""
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
            z = getattr(self, f's{i}')(z)
            if io is not None:
                io[f's{i}_out'] = z
        return self.head(z)


class RegNet(nn.Module):
    """The full RegNetY classifier: stem (3x3/2 conv to 32, BN, ReLU),
    s1-s4 and the head."""

    def __init__(self, stage_widths: Sequence[int] = (144, 288, 576, 1296),
                 stage_depths: Sequence[int] = (2, 7, 14, 2),
                 group_width: int = 72, num_classes: int = 1000):
        super().__init__()
        self.stem = ConvBn(3, 32, 3, 2)
        c = 32
        for i, (w, d) in enumerate(zip(stage_widths, stage_depths), start=1):
            setattr(self, f's{i}', RegNetStage(c, w, d, group_width))
            c = w
        self.num_stages = len(stage_widths)
        self.head = _Head(c, num_classes)

    def forward(self, x: torch.Tensor, io: dict | None = None
                ) -> torch.Tensor:
        """Logits; with `io`, each stage's output as `s{i}_out`."""
        z = F.relu(self.stem(x))
        for i in range(1, self.num_stages + 1):
            z = getattr(self, f's{i}')(z)
            if io is not None:
                io[f's{i}_out'] = z
        return self.head(z)


@register_model
def regnety_064(num_classes: int = 1000, device=None, **kwargs) -> RegNet:
    """The RegNetY-6.4GF teacher, built on `device` (CUDA unless asked
    otherwise)."""
    dev = resolve_device(device)
    with torch.device(dev):
        return RegNet(num_classes=num_classes).to(dev)


@register_model
def splittable_regnet(bottleneck_config: dict,
                      regnet_name: str = 'regnety_064',
                      num_classes: int = 1000, device=None,
                      **kwargs) -> SplittableRegNet:
    """The bottleneck from the layer registry + the tail of the named
    RegNet preset, built on `device` (CUDA unless asked otherwise)."""
    widths, depths, group_width = REGNET_PRESETS[regnet_name]
    dev = resolve_device(device)
    with torch.device(dev):
        bottleneck = get_layer(bottleneck_config['key'],
                               **bottleneck_config.get('kwargs', {}))
        return SplittableRegNet(bottleneck, widths, depths, group_width,
                                num_classes).to(dev)
