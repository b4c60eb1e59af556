"""ResNet v1.5 over NCHW (counterpart of `sc2bench_tpu/models/resnet.py`):
the full classifier (the teacher) and the blocks of the classification
tail behind the splittable models. Torchvision key space (`conv1`, `bn1`,
`layer1.0.conv1`, ..., `downsample.0/1`, `fc`); BatchNorm with eps 1e-5
that keeps its running statistics as Flax's does (`BatchNorm2d`).

`FrozenBatchNorm2d` (the `frozen_bn` option of the detection backbone)
normalizes by its running statistics in every mode and passes no gradient
to its affine terms, with BatchNorm's state-dict keys.

`forward(x, io=...)` records each stage's output in the dict `io` under
the JAX package's names (`layer1_out` ... `layer4_out`), the counterpart
of its `sow('intermediates', ...)`, for the distillation losses.
`forward_until`/`forward_from` split the network at a named layer, the
head/tail boundary of the fine-tuning family (`models/entropic.py`).

`ResNet(dtype=torch.bfloat16)` runs its convolutions in bfloat16 (its
stages and blocks in its dtype, `models/precision.py`), BatchNorm's
statistics in float32, and fc in float32 on the pooled feature.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.dist import group_sum, is_multi
from .precision import compute, linear_head, resolve_dtype


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose train-mode update of `running_var` uses the biased
    batch variance, as Flax's `nn.BatchNorm` does (torch's uses the
    unbiased one); momentum 0.1 on the batch value equals Flax's 0.9 on
    the old one. Normalization is torch's own in both modes, except over
    one value a channel (ASPP's pooled branch at batch 1), where torch's
    raises and Flax's gives a zero variance: then the Flax arithmetic.
    In a data-parallel group, train mode normalizes by the group's
    statistics (`_forward_group`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if is_multi():
            return self._forward_group(x)
        if x.numel() == x.shape[1]:
            return self._forward_one_value(x)
        # torch's op updates copies of the statistics (the autograd graph
        # keeps them); its running var is (1-m)*old + m*var*n/(n-1), so
        # ((n-1)*that + (1-m)*old)/n = (1-m)*old + m*var, Flax's
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.copy_(mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=n - 1).div_(n)
            self.num_batches_tracked.add_(1)
        return y

    def _forward_group(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode in a data-parallel group: the statistics of the
        global batch, as Flax's BatchNorm takes them over a JAX mesh. The
        per-channel sum, sum of squares and count are summed over the
        group in one differentiable all-reduce (float32); the running
        variance moves toward the biased variance, Flax's rule."""
        shape = (1, -1, 1, 1)
        c = x.shape[1]
        xf = x.float()
        local = torch.cat([
            xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
            xf.new_full((1,), float(x.numel() // c))])
        total = group_sum(local)
        n = total[-1]
        mean = total[:c] / n
        var = torch.clamp_min(total[c:2 * c] / n - mean * mean, 0.0)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return (y * self.weight.view(shape)
                + self.bias.view(shape)).to(x.dtype)

    def _forward_one_value(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over one value a channel: mean x, variance 0, so the
        output is the bias and the statistics move toward (x, 0)."""
        shape = (1, -1, 1, 1)
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean.view(shape)) ** 2).mean(dim=(0, 2, 3))
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y * self.weight.view(shape) + self.bias.view(shape)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm whose affine terms and running statistics are all frozen
    (counterpart of the JAX package's `FrozenBatchNorm`, torchvision's
    `FrozenBatchNorm2d` of the detection backbones): it normalizes by the
    running statistics in train and eval mode alike, never updates them,
    and passes no gradient to `weight` and `bias` (Flax's
    `stop_gradient`). They stay parameters, so an optimizer gives them a
    zero gradient and its weight decay still moves them, as optax's does.
    The state-dict keys are `BatchNorm2d`'s. Computes in float32 and
    returns the input's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight.detach()
        y = (x.float() - self.running_mean.view(shape)) * inv.view(shape) \
            + self.bias.detach().view(shape)
        return y.to(x.dtype)


def _bn(channels: int, frozen: bool = False) -> nn.Module:
    return FrozenBatchNorm2d(channels) if frozen \
        else BatchNorm2d(channels, eps=1e-5)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride, dilation) -> 1x1(x4) + shortcut. The shortcut is
    projected when the block changes the channel count or the stride. bn3
    starts with zero scales (zero-init residual), as in the JAX package.
    `dilation` dilates (and pads by) the 3x3 conv, DeepLabv3's
    stride-replaced stages; `frozen_bn` makes every BatchNorm a
    `FrozenBatchNorm2d`."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 dilation: int = 1, frozen_bn: bool = False):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.bn1 = _bn(filters, frozen_bn)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride=strides,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = _bn(filters, frozen_bn)
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = _bn(out, frozen_bn)
        nn.init.zeros_(self.bn3.weight)
        self.relu = nn.ReLU()
        self.downsample = None
        if in_channels != out or strides != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride=strides, bias=False),
                _bn(out, frozen_bn))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNetStage(nn.Sequential):
    """One layerN stage: `blocks` bottleneck blocks, stride on the first.
    With `dilate` the stride is replaced by dilation (torchvision's
    `replace_stride_with_dilation`): the stride becomes 1, the first block
    keeps the incoming `dilation` and the later ones take `dilation *
    strides`. `frozen_bn` freezes every block's BatchNorm."""

    def __init__(self, in_channels: int, filters: int, blocks: int,
                 strides: int = 1, dilation: int = 1, dilate: bool = False,
                 frozen_bn: bool = False):
        first_stride = 1 if dilate else strides
        later_dilation = dilation * strides if dilate else dilation
        layers = []
        for i in range(blocks):
            layers.append(BottleneckBlock(
                in_channels, filters,
                strides=first_stride if i == 0 else 1,
                dilation=dilation if i == 0 else later_dilation,
                frozen_bn=frozen_bn))
            in_channels = filters * BottleneckBlock.expansion
        super().__init__(*layers)


class ResNet(nn.Module):
    """Stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool), layer1-4, global
    average pool and fc. `stage_sizes`: (3, 4, 6, 3) is ResNet-50,
    (3, 4, 23, 3) ResNet-101, (3, 8, 36, 3) ResNet-152. `dtype` is the
    compute dtype (float32 by default, or bfloat16)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        c = 64
        for i, (filters, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  stage_sizes)):
            setattr(self, f'layer{i + 1}', ResNetStage(
                c, filters, blocks, strides=1 if i == 0 else 2))
            c = filters * BottleneckBlock.expansion
        self.fc = nn.Linear(c, num_classes)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        with compute(self.dtype, x):
            return self.maxpool(self.relu(self.bn1(self.conv1(x))))

    def forward(self, x: torch.Tensor, io: dict | None = None
                ) -> torch.Tensor:
        """Logits (float32); with `io`, each stage's output as
        `layer{i}_out`."""
        with compute(self.dtype, x):
            x = self.stem(x)
            for i in range(1, 5):
                x = getattr(self, f'layer{i}')(x)
                if io is not None:
                    io[f'layer{i}_out'] = x
            x = torch.mean(x, dim=(2, 3))
        return linear_head(self.fc, x)

    def forward_until(self, x: torch.Tensor, split_layer: str = 'layer2',
                      include_stem: bool = True) -> torch.Tensor:
        """Head: the stem, then layer1 up to `split_layer` inclusive
        ('stem': the stem only)."""
        with compute(self.dtype, x):
            if include_stem:
                x = self.stem(x)
            if split_layer == 'stem':
                return x
            for i in range(1, 5):
                x = getattr(self, f'layer{i}')(x)
                if split_layer == f'layer{i}':
                    return x
        raise ValueError(f'unknown split layer {split_layer}')

    def forward_from(self, feature: torch.Tensor,
                     split_layer: str = 'layer2') -> torch.Tensor:
        """Tail: the stages after `split_layer`, the average pool and fc;
        'avgpool' means fc alone, on an already pooled (n, C) feature."""
        x = feature
        if split_layer != 'avgpool':
            names = ['stem'] + [f'layer{i}' for i in range(1, 5)]
            if split_layer not in names:
                raise ValueError(f'unknown split layer {split_layer}')
            with compute(self.dtype, x):
                for name in names[names.index(split_layer) + 1:]:
                    x = getattr(self, name)(x)
                x = torch.mean(x, dim=(2, 3))
        return linear_head(self.fc, x)


def resnet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kwargs)


def resnet101(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kwargs)


def resnet152(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), **kwargs)


RESNET_BUILDERS: dict[str, Callable[..., ResNet]] = {
    'resnet50': resnet50,
    'resnet101': resnet101,
    'resnet152': resnet152,
}
