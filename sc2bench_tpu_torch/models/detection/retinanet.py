"""RetinaNet over the splittable backbone (counterpart of
`sc2bench_tpu/models/detection/retinanet.py`).

torchvision's RetinaNet key space: `backbone.body` (the
`SplittableDetectionBackbone`), `backbone.fpn.inner_blocks|layer_blocks.
{i}.0` (P3-P5 from C3-C5) and `backbone.fpn.extra_blocks.p6|p7` (P6 a
3x3/2 conv of C5, P7 one of relu(P6)); `head.classification_head.conv.
{i}.0` and `.cls_logits` (its bias the focal loss's prior,
-log((1 - 0.01) / 0.01)), `head.regression_head.conv.{i}.0` and
`.bbox_reg`, both heads shared over the five levels.

The forward returns the JAX package's dict: 'anchors' (A, 4), 'cls_logits'
(N, A, C), 'bbox_deltas' (N, A, 4), 'image_hw' and 'level_sizes'. Each
level's NCHW map goes to NHWC before it is flattened, so the anchors run
in (y, x, anchor) order, `generate_anchors`' order, as in JAX.
`retinanet_loss` is the focal classification and L1 regression loss over
the matched anchors; `retinanet_postprocess` keeps the best 4,000
candidates (a stable descending sort: ties, the many candidates scored
-1, go to the lower index as in `jax.lax.top_k`) and runs class-aware
NMS into 100 fixed slots. A candidate's box is `boxes[index // C]`, never
a repeat of every box over the classes (18.3 M candidates at 91 classes
on the 800x1344 canvas).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...ops.boxes import (batched_nms_mask, box_iou, clip_boxes,
                          decode_boxes, encode_boxes,
                          remove_small_boxes_mask)
from ...registry import register_model
from .base import SplittableDetectionBackbone
from .fpn import cached_anchors
from .rcnn import _sort_desc

FOCAL_ALPHA, FOCAL_GAMMA = 0.25, 2.0
FG_IOU, BG_IOU = 0.5, 0.4
SCORE_THRESH, NMS_THRESH, DETECTIONS_PER_IMG = 0.05, 0.5, 100
TOPK_PER_LEVEL = 1000
PRIOR_PROBABILITY = 0.01


class LastLevelP6P7(nn.Module):
    """P6 = conv3x3/2(C5), P7 = conv3x3/2(relu(P6))."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.p6 = nn.Conv2d(in_channels, out_channels, 3, stride=2,
                            padding=1)
        self.p7 = nn.Conv2d(out_channels, out_channels, 3, stride=2,
                            padding=1)

    def forward(self, c5):
        p6 = self.p6(c5)
        return [p6, self.p7(F.relu(p6))]


class RetinaFPN(nn.Module):
    """Lateral 1x1 + top-down nearest upsampling + 3x3 smoothing over
    [C3, C4, C5] -> [P3, P4, P5], then P6 and P7 from C5."""

    def __init__(self, in_channels_list: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, out_channels, 1))
            for c in in_channels_list)
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(out_channels, out_channels, 3,
                                    padding=1))
            for _ in in_channels_list)
        self.extra_blocks = LastLevelP6P7(in_channels_list[-1], out_channels)

    def forward(self, features):
        laterals = [block(f) for block, f in zip(self.inner_blocks,
                                                 features)]
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i] + F.interpolate(
                laterals[i + 1], size=laterals[i].shape[-2:],
                mode='nearest-exact')
        outs = [block(lat) for block, lat in zip(self.layer_blocks,
                                                 laterals)]
        return outs + self.extra_blocks(features[-1])


def _conv_tower(channels: int, depth: int = 4) -> nn.Sequential:
    return nn.Sequential(*[nn.Sequential(
        nn.Conv2d(channels, channels, 3, padding=1), nn.ReLU())
        for _ in range(depth)])


class RetinaNetClassificationHead(nn.Module):
    def __init__(self, in_channels: int, num_anchors: int, num_classes: int):
        super().__init__()
        self.conv = _conv_tower(in_channels)
        self.cls_logits = nn.Conv2d(in_channels, num_anchors * num_classes,
                                    3, padding=1)
        nn.init.constant_(self.cls_logits.bias, -math.log(
            (1 - PRIOR_PROBABILITY) / PRIOR_PROBABILITY))

    def forward(self, x):
        return self.cls_logits(self.conv(x))


class RetinaNetRegressionHead(nn.Module):
    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.conv = _conv_tower(in_channels)
        self.bbox_reg = nn.Conv2d(in_channels, num_anchors * 4, 3, padding=1)

    def forward(self, x):
        return self.bbox_reg(self.conv(x))


class RetinaNetHead(nn.Module):
    """The classification and regression towers, shared over the levels:
    per level (N, A*C, H, W) logits and (N, A*4, H, W) deltas."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 9,
                 num_classes: int = 91):
        super().__init__()
        self.classification_head = RetinaNetClassificationHead(
            in_channels, num_anchors, num_classes)
        self.regression_head = RetinaNetRegressionHead(in_channels,
                                                       num_anchors)

    def forward(self, features):
        return ([self.classification_head(f) for f in features],
                [self.regression_head(f) for f in features])


class _RetinaBackbone(nn.Module):
    def __init__(self, body: SplittableDetectionBackbone):
        super().__init__()
        self.body = body
        self.fpn = RetinaFPN(body.out_channels_list[1:])


class RetinaNet(nn.Module):
    """backbone (C2-C5) -> RetinaFPN (P3-P7) -> the shared head."""

    def __init__(self, body: SplittableDetectionBackbone,
                 num_classes: int = 91,
                 anchor_sizes: Sequence = ((32, 40, 50), (64, 81, 101),
                                           (128, 161, 203),
                                           (256, 322, 406),
                                           (512, 645, 812)),
                 aspect_ratios: Sequence = (0.5, 1.0, 2.0)):
        super().__init__()
        self.num_classes = num_classes
        self.anchor_sizes = tuple(tuple(s) for s in anchor_sizes)
        self.aspect_ratios = tuple(aspect_ratios)
        self.num_anchors = len(self.aspect_ratios) * len(self.anchor_sizes[0])
        self.backbone = _RetinaBackbone(body)
        self.head = RetinaNetHead(num_anchors=self.num_anchors,
                                  num_classes=num_classes)
        self._anchors = {}

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> dict:
        image_hw = tuple(x.shape[-2:])
        body = self.backbone.body(x, mode=mode, generator=generator, io=io)
        features = self.backbone.fpn(body[1:])
        logits, deltas = self.head(features)
        n, c = x.shape[0], self.num_classes
        return {
            'anchors': cached_anchors(self._anchors, features, image_hw,
                                      self.anchor_sizes, self.aspect_ratios),
            'cls_logits': torch.cat([lg.permute(0, 2, 3, 1).reshape(n, -1, c)
                                     for lg in logits], dim=1),
            'bbox_deltas': torch.cat([d.permute(0, 2, 3, 1).reshape(n, -1, 4)
                                      for d in deltas], dim=1),
            'image_hw': image_hw,
            'level_sizes': [int(np.prod(lg.shape[-2:])) * self.num_anchors
                            for lg in logits]}


def retinanet_loss(outputs: dict, targets: dict, *_unused) -> dict:
    """{'classification': focal loss, 'bbox_regression': L1} over the
    anchors matched at IoU 0.5 (0.4-0.5 ignored; each gt's best anchor
    foreground), each over the image's foreground count, averaged over
    the images. targets: 'boxes' (N, G, 4), 'boxes_valid', 'labels'."""
    anchors = outputs['anchors']
    cls, reg = [], []
    for i in range(outputs['cls_logits'].shape[0]):
        logits = outputs['cls_logits'][i]
        gt_boxes = targets['boxes'][i]
        gt_valid = targets['boxes_valid'][i]
        iou = torch.where(gt_valid[None, :], box_iou(anchors, gt_boxes),
                          -1.0)
        best_gt = torch.argmax(iou, dim=1)
        best_iou = torch.clamp(iou.max(dim=1).values, min=-1.0)
        gt_best = iou.max(dim=0).values
        is_best = ((iou >= gt_best[None, :] - 1e-6) & (iou > 0)
                   & gt_valid[None, :]).any(dim=1)
        fg = (best_iou >= FG_IOU) | is_best
        valid = fg | (best_iou < BG_IOU)
        cls_t = torch.where(fg, targets['labels'][i][best_gt].long(), 0)
        onehot = F.one_hot(cls_t, logits.shape[-1]).to(logits.dtype) \
            * fg[:, None].to(logits.dtype)
        p = torch.sigmoid(logits)
        ce = -(onehot * torch.log(torch.clamp(p, min=1e-8))
               + (1 - onehot) * torch.log(torch.clamp(1 - p, min=1e-8)))
        p_t = onehot * p + (1 - onehot) * (1 - p)
        alpha_t = onehot * FOCAL_ALPHA + (1 - onehot) * (1 - FOCAL_ALPHA)
        focal = alpha_t * (1 - p_t) ** FOCAL_GAMMA * ce
        n_fg = torch.clamp(fg.sum(), min=1)
        cls.append(torch.sum(focal * valid[:, None]) / n_fg)
        reg_t = encode_boxes(gt_boxes[best_gt], anchors)
        reg.append(torch.sum(torch.abs(outputs['bbox_deltas'][i] - reg_t)
                             * fg[:, None]) / n_fg)
    return {'classification': torch.stack(cls).mean(),
            'bbox_regression': torch.stack(reg).mean()}


def retinanet_postprocess(outputs: dict, score_thresh=SCORE_THRESH,
                          nms_thresh=NMS_THRESH,
                          detections_per_img=DETECTIONS_PER_IMG) -> dict:
    """Fixed-size detections per image: {'boxes' (N, D, 4), 'scores',
    'labels', 'valid' (N, D)} on the canvas, the JAX package's slots."""
    anchors = outputs['anchors']
    image_hw = outputs['image_hw']
    c = outputs['cls_logits'].shape[-1]
    dets = []
    for logits, deltas in zip(outputs['cls_logits'],
                              outputs['bbox_deltas']):
        scores = torch.sigmoid(logits)                         # (A, C)
        boxes = clip_boxes(decode_boxes(deltas, anchors), image_hw)
        # candidate a * C + k is anchor a's class k; class 0 never counts
        ok = (scores > score_thresh) \
            & remove_small_boxes_mask(boxes, 1e-2)[:, None]
        ok[:, 0] = False
        scores = scores.reshape(-1)
        sel = torch.where(ok.reshape(-1), scores, -1.0)
        cap = min(sel.shape[0], TOPK_PER_LEVEL * 4)
        top_idx = _sort_desc(sel)[:cap]
        idx, keep = batched_nms_mask(boxes[top_idx // c], sel[top_idx],
                                     top_idx % c, nms_thresh,
                                     detections_per_img)
        final = top_idx[idx]
        dets.append({'boxes': boxes[final // c],
                     'scores': torch.where(keep, scores[final], 0.0),
                     'labels': final % c,
                     'valid': keep & (scores[final] > score_thresh)})
    return {k: torch.stack([d[k] for d in dets]) for k in dets[0]}


@register_model
def retinanet_model(backbone_config=None, num_classes=91, device=None,
                    **kwargs) -> RetinaNet:
    """RetinaNet over the (splittable) ResNet of `backbone_config`, on
    `device` (CUDA unless asked otherwise); other kwargs are accepted and
    unused, as in the JAX builder."""
    body = SplittableDetectionBackbone.from_config(backbone_config)
    return RetinaNet(body, num_classes=num_classes).to(
        resolve_device(device))
