"""Feature Pyramid Network and anchors (counterpart of
`sc2bench_tpu/models/detection/fpn.py`).

torchvision's key space: `inner_blocks.{i}.0` (the lateral 1x1 convs) and
`layer_blocks.{i}.0` (the 3x3 smoothing convs). The top-down pathway
upsamples by `F.interpolate(mode='nearest-exact')`, which samples at
half-pixel centres as `jax.image.resize(..., 'nearest')` does (plain
'nearest' agrees with it only at an exact 2x), and P6 is P5 max-pooled by
a 1x1 window at stride 2.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FeaturePyramidNetwork(nn.Module):
    """Lateral 1x1 + top-down upsampling + 3x3 smoothing over [C2 ... C5]
    -> [P2 ... P5] (+ P6 with `extra_maxpool`)."""

    def __init__(self, in_channels_list: Sequence[int],
                 out_channels: int = 256, extra_maxpool: bool = True):
        super().__init__()
        self.extra_maxpool = extra_maxpool
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, out_channels, 1))
            for c in in_channels_list)
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(out_channels, out_channels, 3,
                                    padding=1))
            for _ in in_channels_list)

    def forward(self, features):
        laterals = [block(f) for block, f in zip(self.inner_blocks,
                                                 features)]
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i] + F.interpolate(
                laterals[i + 1], size=laterals[i].shape[-2:],
                mode='nearest-exact')
        outs = [block(lat) for block, lat in zip(self.layer_blocks,
                                                 laterals)]
        if self.extra_maxpool:
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return outs


def generate_anchors(feature_shapes, image_hw,
                     sizes=((32,), (64,), (128,), (256,), (512,)),
                     aspect_ratios=(0.5, 1.0, 2.0)):
    """Per-level anchor boxes (numpy float32, (H * W * A, 4) each, in
    (y, x, anchor) order): torchvision AnchorGenerator's zero-centred cell
    anchors shifted by the level's stride, canvas // map size."""
    ih, iw = image_hw
    all_anchors = []
    for (fh, fw), level_sizes in zip(feature_shapes, sizes):
        stride_h = ih // fh
        stride_w = iw // fw
        cell = []
        for ar in aspect_ratios:
            for size in level_sizes:
                # torchvision convention: aspect_ratio = h / w
                h = size * np.sqrt(ar)
                w = size / np.sqrt(ar)
                cell.append([-w / 2, -h / 2, w / 2, h / 2])
        cell = np.asarray(cell, np.float32).round()
        shifts_x = np.arange(fw, dtype=np.float32) * stride_w
        shifts_y = np.arange(fh, dtype=np.float32) * stride_h
        sx, sy = np.meshgrid(shifts_x, shifts_y)
        shifts = np.stack([sx.ravel(), sy.ravel(),
                           sx.ravel(), sy.ravel()], axis=1)
        anchors = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
        all_anchors.append(anchors)
    return [np.asarray(a, np.float32) for a in all_anchors]


def cached_anchors(cache: dict, features, image_hw, sizes,
                   aspect_ratios) -> torch.Tensor:
    """The concatenated anchors of the levels' maps `features` on the
    canvas `image_hw`, on their device, built once per shape and device
    into `cache`."""
    shapes = tuple(tuple(f.shape[-2:]) for f in features)
    key = (shapes, tuple(image_hw), features[0].device)
    if key not in cache:
        cache[key] = torch.from_numpy(np.concatenate(generate_anchors(
            shapes, image_hw, sizes=sizes, aspect_ratios=aspect_ratios))
        ).to(features[0].device)
    return cache[key]
