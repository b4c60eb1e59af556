"""Mask and keypoint heads extending Faster R-CNN (counterpart of
`sc2bench_tpu/models/detection/heads.py`).

torchvision's key space: the mask head's four 3x3 convs of 256 are
`mask_head.{i}.0` (`MaskRCNNHeads`), its 2x2 stride-2 deconvolution and
per-class 1x1 conv `mask_predictor.conv5_mask|mask_fcn_logits`
(`MaskRCNNPredictor`); the keypoint head's eight 3x3 convs of 512 are
`keypoint_head.{2i}` (a flat Sequential with the ReLUs between) and its
4x4 stride-2 deconvolution `keypoint_predictor.kps_score_lowres`, whose
output is upsampled 2x bilinearly (half-pixel centres, which is
`jax.image.resize(..., 'bilinear')` at an exact 2x, edges included). In a
Mask or Keypoint R-CNN these children sit under `roi_heads`.

Pooled RoIs and logits are NCHW: `MaskHead` gives (D, C, 28, 28) from
(D, 256, 14, 14), `KeypointHead` (D, K, 56, 56). `predict_masks` returns
the JAX package's (D, 28, 28) sigmoid probabilities of each box's class.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.roi_align import multiscale_roi_align


class MaskRCNNHeads(nn.Sequential):
    def __init__(self, in_channels: int = 256, width: int = 256,
                 layers: int = 4):
        super().__init__(*[nn.Sequential(
            nn.Conv2d(in_channels if i == 0 else width, width, 3, padding=1),
            nn.ReLU()) for i in range(layers)])


class MaskRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 91):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(in_channels, in_channels, 2,
                                             stride=2)
        self.mask_fcn_logits = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x):
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class KeypointRCNNHeads(nn.Sequential):
    def __init__(self, in_channels: int = 256, width: int = 512,
                 layers: int = 8):
        mods = []
        for i in range(layers):
            mods += [nn.Conv2d(in_channels if i == 0 else width, width, 3,
                               padding=1), nn.ReLU()]
        super().__init__(*mods)


class KeypointRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int = 512, num_keypoints: int = 17):
        super().__init__()
        self.kps_score_lowres = nn.ConvTranspose2d(
            in_channels, num_keypoints, 4, stride=2, padding=1)

    def forward(self, x):
        return F.interpolate(self.kps_score_lowres(x), scale_factor=2,
                             mode='bilinear', align_corners=False)


def mask_logits(owner: nn.Module, pooled: torch.Tensor) -> torch.Tensor:
    """Per-class mask logits of `owner`'s `mask_head` and
    `mask_predictor`."""
    return owner.mask_predictor(owner.mask_head(pooled))


def keypoint_logits(owner: nn.Module, pooled: torch.Tensor) -> torch.Tensor:
    """Keypoint heatmaps of `owner`'s `keypoint_head` and
    `keypoint_predictor`."""
    return owner.keypoint_predictor(owner.keypoint_head(pooled))


class MaskHead(nn.Module):
    """4x conv3x3(256) + 2x deconv + per-class 1x1: (D, 256, 14, 14) ->
    (D, num_classes, 28, 28) logits."""

    def __init__(self, num_classes: int = 91, in_channels: int = 256):
        super().__init__()
        self.mask_head = MaskRCNNHeads(in_channels)
        self.mask_predictor = MaskRCNNPredictor(256, num_classes)

    def forward(self, pooled):
        return mask_logits(self, pooled)


class KeypointHead(nn.Module):
    """8x conv3x3(512) + 2x deconv + 2x bilinear upsample: (D, 256, 14, 14)
    -> (D, num_keypoints, 56, 56) heatmaps."""

    def __init__(self, num_keypoints: int = 17, in_channels: int = 256):
        super().__init__()
        self.keypoint_head = KeypointRCNNHeads(in_channels)
        self.keypoint_predictor = KeypointRCNNPredictor(512, num_keypoints)

    def forward(self, pooled):
        return keypoint_logits(self, pooled)


def pool_rois(features, boxes: torch.Tensor, image_hw,
              output_size: int = 14) -> torch.Tensor:
    """(D, C, out, out) RoIAlign of `boxes` (D, 4) over P2-P5 of ONE image
    (each (C, H, W)), the levels' scales from the canvas height as in the
    JAX package."""
    scales = [1.0 / (image_hw[0] / f.shape[1]) for f in features]
    return multiscale_roi_align(features, boxes, output_size=output_size,
                                scales=scales)


def predict_masks(apply, features, boxes: torch.Tensor, image_hw,
                  labels: torch.Tensor) -> torch.Tensor:
    """(D, 28, 28) mask probabilities of each box's class; `apply(pooled)`
    gives the mask head's (D, C, 28, 28) logits, `features` are P2-P5 of
    one image."""
    logits = apply(pool_rois(features, boxes, image_hw))
    per_class = logits[torch.arange(logits.shape[0],
                                    device=logits.device), labels.long()]
    return torch.sigmoid(per_class)


def mask_loss(mask_logits: torch.Tensor, gt_masks_at_rois: torch.Tensor,
              fg_mask: torch.Tensor) -> torch.Tensor:
    """BCE between per-class mask logits (D, 28, 28) and the gt masks
    RoI-aligned to 28x28, averaged over the foreground RoIs."""
    bce = torch.clamp(mask_logits, min=0) - mask_logits * gt_masks_at_rois \
        + torch.log1p(torch.exp(-torch.abs(mask_logits)))
    per_roi = bce.mean(dim=(1, 2))
    fg = fg_mask.to(per_roi.dtype)
    return torch.sum(per_roi * fg) / torch.clamp(fg.sum(), min=1)
