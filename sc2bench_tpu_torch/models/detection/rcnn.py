"""Faster R-CNN + FPN over the splittable backbone (counterpart of
`sc2bench_tpu/models/detection/rcnn.py`).

torchvision's key space: `backbone.body` (`SplittableDetectionBackbone`),
`backbone.fpn.{inner,layer}_blocks.{i}.0`, `rpn.head.conv.0.0`,
`rpn.head.cls_logits|bbox_pred`, `roi_heads.box_head.fc6|fc7`,
`roi_heads.box_predictor.cls_score|bbox_pred`. Feature maps are NCHW; the
RPN's outputs are flattened in (y, x, anchor) order, as the JAX package's
NHWC maps are, and `fc6` reads each pooled RoI as (c, y, x).

The forward returns the JAX package's dense dict: 'features' (P2 ... P6),
'anchors', 'objectness' (N, A), 'rpn_deltas' (N, A, 4), 'proposals' (N,
R, 4), 'proposal_valid' (N, R), 'image_hw' and, unless `rpn_only`,
'class_logits' (N, R, K) and 'box_regression' (N, R, K, 4). The proposal
budgets follow the module's mode, as JAX's follow its `train` flag
(2,000 / 2,000 training, 1,000 / 1,000 in eval), and the proposals carry
no gradient. `postprocess_detections` gives fixed-size detections; the
losses and samplers are torchvision's with the JAX package's static-shape
rules. Where JAX takes top-k or a stable argsort this module takes a
stable descending sort, so that ties go to the lower index as they do in
`jax.lax.top_k`.

Random draws (the RPN and RoI samplers) come from an explicit
`torch.Generator`, image by image in order; `uniforms` replaces them for
tests that feed another package's draws.

`dtype` (float32 by default, or bfloat16; `models/precision.py`) is the
compute dtype of the backbone's stages, the FPN, the RPN head, RoIAlign
and the box head; the heads' outputs are cast to float32 before any box
decoding, and the bottleneck keeps its own dtype.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...ops.boxes import (batched_nms_mask, box_iou, clip_boxes,
                          decode_boxes, encode_boxes,
                          remove_small_boxes_mask)
from ...ops.roi_align import multiscale_roi_align
from ...registry import register_model
from ..precision import compute, resolve_dtype
from .base import BackboneWithFPN, SplittableDetectionBackbone
from .fpn import generate_anchors

# torchvision fasterrcnn_resnet50_fpn defaults
RPN_PRE_NMS_TOP_N = {'training': 2000, 'testing': 1000}
RPN_POST_NMS_TOP_N = {'training': 2000, 'testing': 1000}
RPN_NMS_THRESH = 0.7
RPN_FG_IOU, RPN_BG_IOU = 0.7, 0.3
RPN_BATCH_PER_IMAGE, RPN_POSITIVE_FRACTION = 256, 0.5
BOX_SCORE_THRESH, BOX_NMS_THRESH, DETECTIONS_PER_IMG = 0.05, 0.5, 100
BOX_FG_IOU, BOX_BG_IOU = 0.5, 0.5
BOX_BATCH_PER_IMAGE, BOX_POSITIVE_FRACTION = 512, 0.25
BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
# torchvision fastrcnn_loss smooth-L1 beta
BOX_REG_BETA = 1.0 / 9


def _sort_desc(scores: torch.Tensor) -> torch.Tensor:
    """Indices of `scores` in descending order, ties lower index first
    (`jax.lax.top_k`'s order)."""
    return torch.sort(scores, descending=True, stable=True).indices


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Sequential(nn.Sequential(
            nn.Conv2d(in_channels, in_channels, 3, padding=1), nn.ReLU()))
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, features):
        logits, deltas = [], []
        for f in features:
            t = self.conv(f)
            logits.append(self.cls_logits(t))
            deltas.append(self.bbox_pred(t))
        return logits, deltas


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int = 256 * 7 * 7,
                 representation_size: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_features, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)

    def forward(self, x):
        return F.relu(self.fc7(F.relu(self.fc6(x.flatten(1)))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int = 1024, num_classes: int = 91):
        super().__init__()
        self.cls_score = nn.Linear(in_channels, num_classes)
        self.bbox_pred = nn.Linear(in_channels, num_classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class _RPN(nn.Module):
    def __init__(self, num_anchors: int):
        super().__init__()
        self.head = RPNHead(num_anchors=num_anchors)


class _RoIHeads(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.box_head = TwoMLPHead()
        self.box_predictor = FastRCNNPredictor(num_classes=num_classes)


def _topk_per_level(objectness, level_sizes, k_per_level):
    """Indices of each level's top-k of the flat objectness."""
    idxs, offset = [], 0
    for n, k in zip(level_sizes, k_per_level):
        idxs.append(_sort_desc(objectness[offset:offset + n])[:k] + offset)
        offset += n
    return torch.cat(idxs)


def propose(objectness, deltas, anchors, level_sizes, image_hw,
            training: bool):
    """One image's RPN proposals (torchvision filter_proposals with the
    JAX package's static shapes): objectness (A,), deltas (A, 4), anchors
    (A, 4) -> (boxes (R, 4), valid (R,))."""
    mode = 'training' if training else 'testing'
    pre_k = RPN_PRE_NMS_TOP_N[mode]
    post_k = RPN_POST_NMS_TOP_N[mode]
    k_per_level = [min(pre_k, n) for n in level_sizes]
    keep = _topk_per_level(objectness, level_sizes, k_per_level)
    level_ids = torch.cat([torch.full((k,), i, dtype=torch.int64,
                                      device=keep.device)
                           for i, k in enumerate(k_per_level)])
    scores = torch.sigmoid(objectness[keep])
    boxes = clip_boxes(decode_boxes(deltas[keep], anchors[keep]), image_hw)
    scores = torch.where(remove_small_boxes_mask(boxes, 1e-3), scores, -1.0)
    # level-aware NMS: boxes on different levels never suppress each other
    idx, nms_valid = batched_nms_mask(boxes, scores, level_ids,
                                      RPN_NMS_THRESH, post_k)
    return boxes[idx], nms_valid & (scores[idx] > 0)


class FasterRCNN(nn.Module):
    """Backbone (+ bottleneck) -> FPN -> RPN -> RoI heads."""

    def __init__(self, body: SplittableDetectionBackbone,
                 num_classes: int = 91,
                 anchor_sizes: Sequence = ((32,), (64,), (128,), (256,),
                                           (512,)),
                 aspect_ratios: Sequence = (0.5, 1.0, 2.0), dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.num_classes = num_classes
        self.anchor_sizes = tuple(anchor_sizes)
        self.aspect_ratios = tuple(aspect_ratios)
        self.backbone = BackboneWithFPN(body)
        self.rpn = _RPN(len(self.aspect_ratios))
        self.roi_heads = _RoIHeads(num_classes)
        self._anchors = {}

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None, rpn_only: bool = False) -> dict:
        """The dense outputs of the module doc from an NCHW canvas batch;
        `io` gets the backbone's captured features under `backbone.`;
        `rpn_only` skips the box head (the training step then runs it on
        the sampled proposals only)."""
        sub = {} if io is not None else None
        with compute(self.dtype, x):
            features = self.backbone(x, mode=mode, generator=generator,
                                     io=sub)
        if io is not None:
            io.update({f'backbone.{k}': v for k, v in sub.items()})
        return self.detect(features, tuple(x.shape[-2:]), rpn_only=rpn_only)

    # ---- deploy split (the runtime's ops) ----------------------------------
    def encode_ops(self, x: torch.Tensor, medians: torch.Tensor) -> dict:
        return self.backbone.body.bottleneck_layer.encode_ops(x, medians)

    def decode_ops(self, symbols: torch.Tensor,
                   medians: torch.Tensor) -> torch.Tensor:
        return self.backbone.body.bottleneck_layer.decode_ops(symbols,
                                                              medians)

    def forward_from_bottleneck(self, c2: torch.Tensor, image_hw) -> dict:
        """The server side from a decoded bottleneck feature: layer2-4,
        FPN, RPN, box head on the canvas `image_hw`."""
        with compute(self.dtype, c2):
            features = self.backbone.fpn(self.backbone.body.forward_tail(c2))
        return self.detect(features, tuple(image_hw))

    def decode_ops_to_detections(self, symbols: torch.Tensor,
                                 medians: torch.Tensor, image_hw) -> dict:
        """`postprocess_detections` of the canvas `image_hw` from the
        latent's symbols (NCHW)."""
        return postprocess_detections(self.forward_from_bottleneck(
            self.decode_ops(symbols, medians), image_hw))

    # ---- heads -------------------------------------------------------------
    def anchors(self, features, image_hw) -> torch.Tensor:
        """The concatenated anchors of the levels' maps on the canvas,
        built once per shape and device."""
        shapes = tuple(tuple(f.shape[-2:]) for f in features)
        key = (shapes, tuple(image_hw), features[0].device)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(np.concatenate(
                generate_anchors(shapes, image_hw, sizes=self.anchor_sizes,
                                 aspect_ratios=self.aspect_ratios))
            ).to(features[0].device)
        return self._anchors[key]

    def detect(self, features, image_hw, rpn_only: bool = False) -> dict:
        with compute(self.dtype, features[0]):
            objectness, deltas = self.rpn.head(features)
        objectness = [o.to(torch.float32) for o in objectness]
        deltas = [d.to(torch.float32) for d in deltas]
        level_sizes = [int(np.prod(o.shape[1:])) for o in objectness]
        anchors = self.anchors(features, image_hw)
        n = features[0].shape[0]
        obj_flat = torch.cat([o.permute(0, 2, 3, 1).reshape(n, -1)
                              for o in objectness], dim=1)
        del_flat = torch.cat([d.permute(0, 2, 3, 1).reshape(n, -1, 4)
                              for d in deltas], dim=1)
        props = [propose(obj_flat[i], del_flat[i], anchors, level_sizes,
                         image_hw, training=self.training) for i in range(n)]
        # torchvision decodes proposals from detached RPN deltas: the RoI
        # losses must not optimize coordinates through the RPN head
        proposals = torch.stack([p for p, _ in props]).detach()
        out = {'features': features, 'anchors': anchors,
               'objectness': obj_flat, 'rpn_deltas': del_flat,
               'proposals': proposals,
               'proposal_valid': torch.stack([v for _, v in props]),
               'image_hw': tuple(image_hw)}
        if not rpn_only:
            out['class_logits'], out['box_regression'] = self.roi_predict(
                features, proposals, image_hw)
        return out

    def roi_predict(self, features, proposals: torch.Tensor, image_hw):
        """Box head and predictor over (N, R, 4) proposals: (class logits
        (N, R, K), box regression (N, R, K, 4)). The levels' scales come
        from the canvas height, as in the JAX package."""
        levels = features[:4]
        scales = [1.0 / (image_hw[0] / f.shape[2]) for f in levels]
        n, r = proposals.shape[:2]
        with compute(self.dtype, proposals):
            pooled = torch.cat([
                multiscale_roi_align([f[i] for f in levels], proposals[i],
                                     output_size=7, scales=scales)
                for i in range(n)])
            logits, deltas = self.roi_heads.box_predictor(
                self.roi_heads.box_head(pooled))
        return (logits.to(torch.float32).reshape(n, r, -1),
                deltas.to(torch.float32).reshape(n, r, self.num_classes, 4))


def postprocess_detections(outputs: dict, score_thresh=BOX_SCORE_THRESH,
                           nms_thresh=BOX_NMS_THRESH,
                           detections_per_img=DETECTIONS_PER_IMG,
                           pre_nms_cap=4096) -> dict:
    """Fixed-size detections per image (torchvision RoIHeads.postprocess
    with the JAX package's static shapes): {'boxes' (N, D, 4), 'scores',
    'labels', 'valid' (N, D)} on the canvas. At most `pre_nms_cap`
    candidates, the best scores, enter the class-aware NMS, as in JAX
    (torchvision has no cap); None lifts it."""
    logits = outputs['class_logits']
    deltas = outputs['box_regression']
    image_hw = outputs['image_hw']
    n, r, c = logits.shape
    scores = torch.softmax(logits, dim=-1)
    labels_all = torch.arange(1, c, device=logits.device).repeat(r)
    dets = []
    for i in range(n):
        boxes = clip_boxes(decode_boxes(
            deltas[i], outputs['proposals'][i][:, None, :],
            weights=BOX_REG_WEIGHTS), image_hw)             # (R, K, 4)
        fg_scores = scores[i, :, 1:].reshape(-1)
        fg_boxes = boxes[:, 1:, :].reshape(-1, 4)
        ok = (fg_scores > score_thresh) \
            & remove_small_boxes_mask(fg_boxes, 1e-2) \
            & outputs['proposal_valid'][i].repeat_interleave(c - 1)
        sel_scores = torch.where(ok, fg_scores, -1.0)
        cap = sel_scores.shape[0] if pre_nms_cap is None \
            else min(sel_scores.shape[0], int(pre_nms_cap))
        top_idx = _sort_desc(sel_scores)[:cap]
        idx, keep = batched_nms_mask(fg_boxes[top_idx], sel_scores[top_idx],
                                     labels_all[top_idx], nms_thresh,
                                     detections_per_img)
        final = top_idx[idx]
        dets.append({'boxes': fg_boxes[final],
                     'scores': torch.where(keep, fg_scores[final], 0.0),
                     'labels': labels_all[final],
                     'valid': keep & (fg_scores[final] > score_thresh)})
    return {k: torch.stack([d[k] for d in dets]) for k in dets[0]}


# ---------------------------------------------------------------------------
# Training losses (torchvision GeneralizedRCNN losses, static shapes)
# ---------------------------------------------------------------------------

def _smooth_l1(x, beta):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


def sigmoid_ce(logits, labels):
    labels = labels.to(logits.dtype)
    return torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))


def _match(iou):
    """(best column, best value clamped at -1) of each row."""
    return torch.argmax(iou, dim=1), torch.clamp(iou.max(dim=1).values,
                                                 min=-1.0)


def _match_anchors(anchors, gt_boxes, gt_valid, fg_iou, bg_iou,
                   allow_low_quality):
    """(matched gt index, labels 1 fg / 0 bg / -1 ignore) of each anchor."""
    iou = torch.where(gt_valid[None, :], box_iou(anchors, gt_boxes), -1.0)
    best_gt, best_iou = _match(iou)
    labels = torch.where(best_iou >= fg_iou, 1,
                         torch.where(best_iou < bg_iou, 0, -1))
    if allow_low_quality:
        # anchors that are the argmax of some gt become fg
        gt_best = iou.max(dim=0).values
        is_best = ((iou >= gt_best[None, :] - 1e-6) & (iou > 0)
                   & gt_valid[None, :]).any(dim=1)
        labels = torch.where(is_best, 1, labels)
    return best_gt, torch.where(gt_valid.any(), labels,
                                torch.zeros_like(labels))


def _rank(scores):
    """Each entry's position in the stable descending order."""
    order = _sort_desc(scores)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank


def _sample_mask(labels, batch_size, positive_fraction, generator=None,
                 uniforms=None):
    """A random fg/bg subsample of a fixed budget: (pos_sel, neg_sel).
    Each side ranks its candidates by a uniform draw, from `generator`
    (fg then bg) or the pair `uniforms`."""
    if uniforms is None:
        uniforms = tuple(torch.rand(labels.shape, generator=generator,
                                    device=labels.device) for _ in range(2))
    num_pos_target = int(batch_size * positive_fraction)
    pos = labels == 1
    neg = labels == 0
    n_pos = torch.clamp(pos.sum(), max=num_pos_target)
    pos_sel = pos & (_rank(torch.where(pos, uniforms[0], -1.0)) < n_pos)
    neg_sel = neg & (_rank(torch.where(neg, uniforms[1], -1.0))
                     < batch_size - n_pos)
    return pos_sel, neg_sel


def _image_uniforms(uniforms, i):
    return None if uniforms is None else uniforms[i]


def rpn_loss(outputs, targets, generator=None, uniforms=None):
    """(objectness BCE, box smooth-L1) over each image's 256 sampled
    anchors, averaged over the images. targets: 'boxes' (N, G, 4),
    'boxes_valid' (N, G)."""
    anchors = outputs['anchors']
    cls, reg = [], []
    for i in range(outputs['objectness'].shape[0]):
        gt_boxes, gt_valid = targets['boxes'][i], targets['boxes_valid'][i]
        matched, labels = _match_anchors(anchors, gt_boxes, gt_valid,
                                         RPN_FG_IOU, RPN_BG_IOU, True)
        pos_sel, neg_sel = _sample_mask(
            labels, RPN_BATCH_PER_IMAGE, RPN_POSITIVE_FRACTION, generator,
            _image_uniforms(uniforms, i))
        denom = torch.clamp((pos_sel | neg_sel).sum(), min=1)
        reg_targets = encode_boxes(gt_boxes[matched], anchors)
        reg.append(torch.sum(_smooth_l1(outputs['rpn_deltas'][i]
                                        - reg_targets, 1.0 / 9)
                             * pos_sel[:, None]) / denom)
        cls.append(torch.sum(torch.where(
            pos_sel | neg_sel,
            sigmoid_ce(outputs['objectness'][i], labels == 1), 0.0)) / denom)
    return torch.stack(cls).mean(), torch.stack(reg).mean()


def _match_and_sample_rois(props, valid, gt_boxes, gt_valid, gt_labels,
                           batch_size, positive_fraction, generator=None,
                           uniforms=None):
    """One image's proposal -> gt matching at IoU 0.5 and fg/bg subsample:
    (pos_sel, neg_sel, class targets (bg 0), regression targets)."""
    iou = torch.where(gt_valid[None, :] & valid[:, None],
                      box_iou(props, gt_boxes), -1.0)
    best_gt, best_iou = _match(iou)
    fg = best_iou >= BOX_FG_IOU
    labels01 = torch.where(fg, 1, torch.where(valid, 0, -1))
    pos_sel, neg_sel = _sample_mask(labels01, batch_size, positive_fraction,
                                    generator, uniforms)
    cls_targets = torch.where(fg, gt_labels[best_gt].long(), 0)
    reg_targets = encode_boxes(gt_boxes[best_gt], props,
                               weights=BOX_REG_WEIGHTS)
    return pos_sel, neg_sel, cls_targets, reg_targets


def _fastrcnn_terms(logits, per_cls_deltas_src, cls_targets, reg_targets,
                    ce_weight, pos_weight, denom):
    """torchvision `fastrcnn_loss`: CE over the sampled rows, smooth-L1
    (beta 1/9) summed over the positives, both over the sampled count."""
    log_probs = torch.log_softmax(logits, dim=-1)
    ce = -log_probs.gather(1, cls_targets[:, None])[:, 0]
    cls_loss = torch.sum(ce * ce_weight) / denom
    per_cls = per_cls_deltas_src.gather(
        1, cls_targets[:, None, None].expand(-1, 1, 4))[:, 0]
    reg_loss = torch.sum(_smooth_l1(per_cls - reg_targets, BOX_REG_BETA)
                         * pos_weight[:, None]) / denom
    return cls_loss, reg_loss


def roi_loss(outputs, targets, generator=None, uniforms=None):
    """Fast R-CNN loss of the box head run on the full proposal set, the
    sampled rows weighted (the same estimator in expectation as sampling
    before the head, which `detection_loss(apply_roi=...)` does)."""
    cls, reg = [], []
    for i in range(outputs['class_logits'].shape[0]):
        pos_sel, neg_sel, cls_t, reg_t = _match_and_sample_rois(
            outputs['proposals'][i], outputs['proposal_valid'][i],
            targets['boxes'][i], targets['boxes_valid'][i],
            targets['labels'][i], BOX_BATCH_PER_IMAGE, BOX_POSITIVE_FRACTION,
            generator, _image_uniforms(uniforms, i))
        sel = pos_sel | neg_sel
        c, r = _fastrcnn_terms(outputs['class_logits'][i],
                               outputs['box_regression'][i], cls_t, reg_t,
                               sel.to(torch.float32),
                               pos_sel.to(torch.float32),
                               torch.clamp(sel.sum(), min=1))
        cls.append(c)
        reg.append(r)
    return torch.stack(cls).mean(), torch.stack(reg).mean()


def sample_rois(outputs, targets, generator=None, uniforms=None,
                batch_size=BOX_BATCH_PER_IMAGE,
                positive_fraction=BOX_POSITIVE_FRACTION) -> dict:
    """torchvision `select_training_samples` with static shapes: per image
    the gt boxes appended to the proposals, matched at IoU 0.5, and a
    fixed budget (25% positive) sampled before the box head. Returns the
    sampled 'proposals' with their 'cls_targets', 'reg_targets', 'weight'
    (0 past the rows selected) and 'positive', each (N, batch_size, ...)."""
    per_image = []
    for i in range(outputs['proposals'].shape[0]):
        gt_boxes = targets['boxes'][i]
        gt_valid = targets['boxes_valid'][i]
        all_props = torch.cat([outputs['proposals'][i], gt_boxes])
        all_valid = torch.cat([outputs['proposal_valid'][i], gt_valid])
        pos_sel, neg_sel, cls_t, reg_t = _match_and_sample_rois(
            all_props, all_valid, gt_boxes, gt_valid, targets['labels'][i],
            batch_size, positive_fraction, generator,
            _image_uniforms(uniforms, i))
        sel = pos_sel | neg_sel
        # stable partition: selected rows first, truncated to the budget
        order = torch.sort((~sel).to(torch.int8), stable=True).indices[
            :batch_size]
        per_image.append({'proposals': all_props[order],
                          'cls_targets': cls_t[order],
                          'reg_targets': reg_t[order],
                          'weight': sel[order].to(torch.float32),
                          'positive': pos_sel[order]})
    return {k: torch.stack([s[k] for s in per_image]) for k in per_image[0]}


def roi_loss_sampled(class_logits, box_regression, sampled):
    """Fast R-CNN loss over the pre-sampled proposals."""
    cls, reg = [], []
    for i in range(class_logits.shape[0]):
        w = sampled['weight'][i]
        c, r = _fastrcnn_terms(
            class_logits[i], box_regression[i], sampled['cls_targets'][i],
            sampled['reg_targets'][i], w,
            sampled['positive'][i].to(torch.float32) * w,
            torch.clamp(w.sum(), min=1.0))
        cls.append(c)
        reg.append(r)
    return torch.stack(cls).mean(), torch.stack(reg).mean()


def detection_loss(outputs, targets, generator=None, apply_roi=None,
                   return_roi_outputs=False, uniforms=None):
    """RPN + RoI losses {'loss_objectness', 'loss_rpn_box_reg',
    'loss_classifier', 'loss_box_reg'}. With `apply_roi(features,
    proposals) -> (class_logits, box_regression)` the proposals are
    sampled before the box head (torchvision's order); otherwise the head
    outputs in `outputs` are weighted (`roi_loss`). The draws come from
    `generator`: the RPN sampler's of each image, then the RoI sampler's;
    `uniforms` = {'rpn': [(fg, bg) per image], 'roi': [...]} replaces
    them."""
    uniforms = uniforms or {}
    rpn_cls, rpn_reg = rpn_loss(outputs, targets, generator,
                                uniforms.get('rpn'))
    roi_out = None
    if apply_roi is not None:
        sampled = sample_rois(outputs, targets, generator,
                              uniforms.get('roi'))
        roi_out = apply_roi(outputs['features'], sampled['proposals'])
        box_cls, box_reg = roi_loss_sampled(*roi_out, sampled)
    else:
        box_cls, box_reg = roi_loss(outputs, targets, generator,
                                    uniforms.get('roi'))
        if 'class_logits' in outputs:
            roi_out = (outputs['class_logits'], outputs['box_regression'])
    losses = {'loss_objectness': rpn_cls, 'loss_rpn_box_reg': rpn_reg,
              'loss_classifier': box_cls, 'loss_box_reg': box_reg}
    return (losses, roi_out) if return_roi_outputs else losses


@register_model
def faster_rcnn_model(backbone_config=None, num_classes=91,
                      backbone_fpn_kwargs=None, dtype=None, device=None,
                      **kwargs) -> FasterRCNN:
    """Faster R-CNN over the (splittable) ResNet of `backbone_config`,
    placed on `device` (CUDA unless asked otherwise). `dtype`
    ('bfloat16', or float32 by default) is the compute dtype of the
    backbone's stages, the FPN and the heads; the bottleneck keeps its
    own. Other kwargs of the JAX builder are accepted and unused."""
    dev = resolve_device(device)
    body = SplittableDetectionBackbone.from_config(
        backbone_config, dtype=dtype, **(backbone_fpn_kwargs or {}))
    return FasterRCNN(body, num_classes=num_classes, dtype=dtype).to(dev)
