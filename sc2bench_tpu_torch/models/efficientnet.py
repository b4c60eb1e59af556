"""EfficientNet over NCHW (counterpart of
`sc2bench_tpu/models/efficientnet.py`): the compound-scaled classifier
(EfficientNet-B0's seven stages, widths times `width_coefficient` rounded
to multiples of 8, depths times `depth_coefficient` rounded up) behind the
input-compression wrappers; `tf_efficientnet_l2_ns(_475)` is width 4.3,
depth 5.3 (88 blocks, stem 136, head 5,504 channels, about 480M
parameters).

timm `tf_efficientnet` key space: `conv_stem`, `bn1`, `blocks.{s}.{b}`,
`conv_head`, `bn2`, `classifier`. Stage 0's blocks (expand ratio 1) are
timm's `DepthwiseSeparableConv` (`conv_dw`, `bn1`, `se.conv_reduce`/
`se.conv_expand`, `conv_pw` -- the PROJECTION --, `bn2`); the others its
`InvertedResidual` (`conv_pw` expand, `bn1`, `conv_dw`, `bn2`, `se.*`,
`conv_pwl` project, `bn3`). Convolutions with a stride or a kernel above 1
pad TF-'SAME' (more on the bottom/right on even inputs at stride 2), as
the `tf_` weights need; BatchNorm eps 1e-3 with Flax's running-variance
rule. `forward(x, io=...)` records `stage{s}_out`, as the JAX package
sows it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..registry import register_model
from .hybrid_vit import pad_same
from .resnet import BatchNorm2d

# (expand_ratio, channels, num_layers, stride, kernel) -- EfficientNet-B0
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def round_channels(c, width_coefficient, divisor=8):
    c *= width_coefficient
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def round_repeats(r, depth_coefficient):
    return int(math.ceil(depth_coefficient * r))


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-3)


class SameConv(nn.Conv2d):
    """A bias-free convolution with TF-'SAME' padding from the input's
    size."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, padding=0,
                         groups=groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(pad_same(x, self.kernel_size[0],
                                        self.stride[0]))


class SqueezeExcite(nn.Module):
    """The mean over space, a 1x1 conv with bias (`conv_reduce`) to a
    quarter of the channels of the BLOCK's input, SiLU, a 1x1 conv with
    bias (`conv_expand`) back, sigmoid gate."""

    def __init__(self, channels: int, in_ch: int):
        super().__init__()
        se_ch = max(1, int(in_ch * 0.25))
        self.conv_reduce = nn.Conv2d(channels, se_ch, 1)
        self.conv_expand = nn.Conv2d(se_ch, channels, 1)

    def forward(self, x):
        s = torch.mean(x, dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv_expand(F.silu(
            self.conv_reduce(s))))


class MBConv(nn.Module):
    """Expand (1x1, BN, SiLU; only when `expand_ratio` > 1) -> depthwise
    k x k (stride, 'SAME'), BN, SiLU -> SE -> project (1x1, BN), plus the
    input at stride 1 with equal widths. The module names follow timm:
    see the module doc."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int,
                 stride: int = 1, kernel: int = 3):
        super().__init__()
        mid = in_ch * expand_ratio
        self.expand = expand_ratio != 1
        self.residual = stride == 1 and in_ch == out_ch
        dw = SameConv(mid, mid, kernel, stride, groups=mid)
        project = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.se = SqueezeExcite(mid, in_ch)
        if self.expand:
            self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
            self.bn1 = _bn(mid)
            self.conv_dw, self.bn2 = dw, _bn(mid)
            self.conv_pwl, self.bn3 = project, _bn(out_ch)
        else:
            self.conv_dw, self.bn1 = dw, _bn(mid)
            self.conv_pw, self.bn2 = project, _bn(out_ch)

    def forward(self, x):
        if self.expand:
            y = F.silu(self.bn1(self.conv_pw(x)))
            y = self.se(F.silu(self.bn2(self.conv_dw(y))))
            y = self.bn3(self.conv_pwl(y))
        else:
            y = self.se(F.silu(self.bn1(self.conv_dw(x))))
            y = self.bn2(self.conv_pw(y))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """Stem (3x3/2 'SAME', BN, SiLU), the seven scaled stages, head (1x1,
    BN, SiLU), the mean over space and `classifier`."""

    def __init__(self, width_coefficient: float = 1.0,
                 depth_coefficient: float = 1.0, num_classes: int = 1000):
        super().__init__()
        stem = round_channels(32, width_coefficient)
        self.conv_stem = SameConv(3, stem, 3, 2)
        self.bn1 = _bn(stem)
        c, stages = stem, []
        for expand, ch, n, stride, k in B0_STAGES:
            out_ch = round_channels(ch, width_coefficient)
            blocks = []
            for b in range(round_repeats(n, depth_coefficient)):
                blocks.append(MBConv(c, out_ch, expand,
                                     stride if b == 0 else 1, k))
                c = out_ch
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        head = round_channels(1280, width_coefficient)
        self.conv_head = nn.Conv2d(c, head, 1, bias=False)
        self.bn2 = _bn(head)
        self.classifier = nn.Linear(head, num_classes)

    def forward(self, x: torch.Tensor, io: dict | None = None
                ) -> torch.Tensor:
        """Logits; with `io`, each stage's output as `stage{s}_out`."""
        z = F.silu(self.bn1(self.conv_stem(x)))
        for s, stage in enumerate(self.blocks):
            z = stage(z)
            if io is not None:
                io[f'stage{s}_out'] = z
        z = F.silu(self.bn2(self.conv_head(z)))
        return self.classifier(torch.mean(z, dim=(2, 3)))


def _build(device, **kwargs) -> EfficientNet:
    dev = resolve_device(device)
    with torch.device(dev):
        return EfficientNet(**kwargs).to(dev)


@register_model
def efficientnet(width_coefficient: float = 1.0,
                 depth_coefficient: float = 1.0, num_classes: int = 1000,
                 device=None, **kwargs) -> EfficientNet:
    """A compound-scaled EfficientNet, built on `device` (CUDA unless
    asked otherwise)."""
    return _build(device, width_coefficient=width_coefficient,
                  depth_coefficient=depth_coefficient,
                  num_classes=num_classes)


@register_model
def tf_efficientnet_l2_ns(num_classes: int = 1000, device=None,
                          **kwargs) -> EfficientNet:
    """EfficientNet-L2 (width 4.3, depth 5.3), the noisy-student anchor,
    built on `device` (CUDA unless asked otherwise)."""
    return _build(device, width_coefficient=4.3, depth_coefficient=5.3,
                  num_classes=num_classes)


@register_model
def tf_efficientnet_l2_ns_475(num_classes: int = 1000, device=None,
                              **kwargs) -> EfficientNet:
    """EfficientNet-L2 for the 475 px evaluation: the same network (the
    resolution is the data pipeline's)."""
    return _build(device, width_coefficient=4.3, depth_coefficient=5.3,
                  num_classes=num_classes)
