"""Plain reference of Faster R-CNN R50-FPN behind the FP bottleneck
(torchvision's `fasterrcnn_resnet50_fpn` at test time, with the split
point of sc2-benchmark's splittable backbone).

From the decoded feature C2: layer2-4 (C3-C5), the FPN (lateral 1x1,
nearest top-down upsampling at half-pixel centres, 3x3 smoothing, P6 by
max pooling P5 at stride 2), the RPN head on P2-P6 with three anchors a
position, proposals (the top 1,000 a level by objectness, decoded, clipped,
small boxes dropped, NMS at 0.7 within each level, 1,000 kept), RoIAlign
7x7 with two samples a bin on P2-P5 (level floor(4 + log2(sqrt(area) / 224
+ 1e-6))), the two-layer box head and the predictor, and the detections
(softmax, class-wise boxes with weights (10, 10, 5, 5), score above 0.05,
boxes of 0.01 and more, at most the best 4,096 candidates into class-wise
NMS at 0.5, 100 kept). Every list has a fixed size: unkept slots point at
the best candidate and are marked invalid, as the port's static shapes
are. NMS is the greedy loop over a stable descending sort; the FPN's
level offset of torchvision's `batched_nms` separates levels and classes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import resnet_fp as R

FPN_IN = (256, 512, 1024, 2048)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
PRE_NMS, POST_NMS, RPN_NMS = 1000, 1000, 0.7
SCORE_THRESH, BOX_NMS, DETECTIONS, PRE_NMS_CAP = 0.05, 0.5, 100, 4096
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
BBOX_CLIP = math.log(1000.0 / 16)


def _linear_specs(name, cout, cin, std=None, zero_bias=False):
    bound = 1.0 / math.sqrt(cin)
    return [(f'{name}.weight', (cout, cin), ('normal', std or bound)),
            (f'{name}.bias', (cout,), ('const', 0.0) if zero_bias
             else ('uniform', -bound, bound))]


def _conv_bias_specs(name, cout, cin, k, std=None):
    shape = (cout, cin, k, k)
    init = ('normal', std) if std else R._he(shape)
    return [(f'{name}.weight', shape, init), (f'{name}.bias', (cout,),
                                              ('const', 0.0))]


def specs(cfg):
    """The detector's tensors in torchvision's key space: the student's
    bottleneck and layer2-4 under `backbone.body`, He-normal FPN and RPN
    convolutions with zero biases, the RPN's and predictor's outputs
    normal with std 0.01, 0.01, 0.01 and 0.001 (torchvision's init)."""
    out = R.bottleneck_specs('backbone.body.bottleneck_layer',
                             cfg['bottleneck_channels'],
                             cfg['target_channels'])
    out += R.tail_specs('backbone.body.', cfg['target_channels'])
    for i, c in enumerate(FPN_IN):
        out += _conv_bias_specs(f'backbone.fpn.inner_blocks.{i}.0', 256, c, 1)
    for i in range(len(FPN_IN)):
        out += _conv_bias_specs(f'backbone.fpn.layer_blocks.{i}.0', 256, 256,
                                3)
    a = len(ASPECT_RATIOS)
    out += _conv_bias_specs('rpn.head.conv.0.0', 256, 256, 3)
    out += _conv_bias_specs('rpn.head.cls_logits', a, 256, 1, 0.01)
    out += _conv_bias_specs('rpn.head.bbox_pred', 4 * a, 256, 1, 0.01)
    out += _linear_specs('roi_heads.box_head.fc6', 1024, 256 * 7 * 7)
    out += _linear_specs('roi_heads.box_head.fc7', 1024, 1024)
    k = cfg['num_classes']
    out += _linear_specs('roi_heads.box_predictor.cls_score', k, 1024, 0.01,
                         True)
    out += _linear_specs('roi_heads.box_predictor.bbox_pred', 4 * k, 1024,
                         0.001, True)
    return out


PREFIX = 'backbone.body.bottleneck_layer'


def features(sd, sym):
    """[P2 ... P6] from NCHW symbols."""
    c2 = R.decode(sd, R.dequantize(sd, sym, PREFIX), PREFIX)
    io = {}
    R.tail(sd, c2, io, 'backbone.body.')
    cs = [c2, io['layer2_out'], io['layer3_out'], io['layer4_out']]
    p = 'backbone.fpn'
    lat = [F.conv2d(c, sd[f'{p}.inner_blocks.{i}.0.weight'],
                    sd[f'{p}.inner_blocks.{i}.0.bias'])
           for i, c in enumerate(cs)]
    for i in range(len(lat) - 2, -1, -1):
        lat[i] = lat[i] + F.interpolate(lat[i + 1], size=lat[i].shape[-2:],
                                        mode='nearest-exact')
    outs = [F.conv2d(x, sd[f'{p}.layer_blocks.{i}.0.weight'],
                     sd[f'{p}.layer_blocks.{i}.0.bias'], padding=1)
            for i, x in enumerate(lat)]
    outs.append(F.max_pool2d(outs[-1], 1, stride=2))
    return outs


def anchors(feats, canvas):
    """(A, 4) anchors of all levels in (level, y, x, anchor) order."""
    ih, iw = canvas
    out = []
    for f, size in zip(feats, ANCHOR_SIZES):
        fh, fw = f.shape[-2:]
        cell = np.asarray([[-size / math.sqrt(ar) / 2,
                            -size * math.sqrt(ar) / 2,
                            size / math.sqrt(ar) / 2,
                            size * math.sqrt(ar) / 2] for ar in ASPECT_RATIOS],
                          np.float32).round()
        sy, sx = np.meshgrid(np.arange(fh, dtype=np.float32) * (ih // fh),
                             np.arange(fw, dtype=np.float32) * (iw // fw),
                             indexing='ij')
        shift = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
        out.append((shift + cell[None]).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out)).to(feats[0].device)


def decode_boxes(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    wx, wy, ww, wh = weights
    px = (boxes[..., 0] + boxes[..., 2]) / 2
    py = (boxes[..., 1] + boxes[..., 3]) / 2
    pw = boxes[..., 2] - boxes[..., 0]
    ph = boxes[..., 3] - boxes[..., 1]
    cx = deltas[..., 0] / wx * pw + px
    cy = deltas[..., 1] / wy * ph + py
    w = torch.exp(torch.clamp(deltas[..., 2] / ww, max=BBOX_CLIP)) * pw
    h = torch.exp(torch.clamp(deltas[..., 3] / wh, max=BBOX_CLIP)) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def clip(boxes, canvas):
    h, w = canvas
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       -1)


def big_enough(boxes, min_size):
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) \
        & ((boxes[..., 3] - boxes[..., 1]) >= min_size)


def iou(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (x[:, 2] - x[:, 0]).clamp(min=0) * (x[:, 3] - x[:, 1]).clamp(
            min=0)
    return inter / (area(a)[:, None] + area(b)[None, :] - inter).clamp(
        min=1e-9)


def nms(boxes, scores, groups, threshold, max_out):
    """Greedy NMS within each group: (indices (max_out,), kept (max_out,)),
    the kept boxes in descending score order (ties: lower index first);
    empty slots index 0 and not kept."""
    offset = groups.to(boxes.dtype) * (boxes.max() + 1.0)
    b = boxes + offset[:, None]
    order = torch.sort(scores, descending=True, stable=True).indices
    over = (iou(b[order], b[order]) > threshold).cpu().numpy()
    alive = np.ones(len(order), bool)
    kept = []
    for i in range(len(order)):
        if not alive[i]:
            continue
        kept.append(i)
        if len(kept) == max_out:
            break
        alive &= ~over[i]
    idx = torch.zeros(max_out, dtype=torch.int64, device=boxes.device)
    valid = torch.zeros(max_out, dtype=torch.bool, device=boxes.device)
    idx[:len(kept)] = order[torch.as_tensor(kept, device=boxes.device,
                                            dtype=torch.int64)]
    valid[:len(kept)] = True
    return idx, valid


def rpn(sd, feats, canvas):
    """(proposals (1000, 4), valid (1000,)) of one image."""
    p = 'rpn.head'
    obj, dlt = [], []
    for f in feats:
        t = F.relu(F.conv2d(f, sd[f'{p}.conv.0.0.weight'],
                            sd[f'{p}.conv.0.0.bias'], padding=1))
        obj.append(F.conv2d(t, sd[f'{p}.cls_logits.weight'],
                            sd[f'{p}.cls_logits.bias'])[0].permute(1, 2, 0)
                   .reshape(-1))
        dlt.append(F.conv2d(t, sd[f'{p}.bbox_pred.weight'],
                            sd[f'{p}.bbox_pred.bias'])[0].permute(1, 2, 0)
                   .reshape(-1, 4))
    anc = anchors(feats, canvas)
    keep, levels, start = [], [], 0
    for lvl, o in enumerate(obj):
        k = min(PRE_NMS, len(o))
        keep.append(torch.sort(o, descending=True, stable=True).indices[:k]
                    + start)
        levels.append(torch.full((k,), lvl, device=o.device))
        start += len(o)
    keep, levels = torch.cat(keep), torch.cat(levels)
    scores = torch.sigmoid(torch.cat(obj)[keep])
    boxes = clip(decode_boxes(torch.cat(dlt)[keep], anc[keep]), canvas)
    scores = torch.where(big_enough(boxes, 1e-3), scores, -1.0)
    idx, kept = nms(boxes, scores, levels, RPN_NMS, POST_NMS)
    return boxes[idx], kept & (scores[idx] > 0)


def roi_align(feats, boxes, canvas, out=7, ratio=2):
    """(R, C, 7, 7) RoIAlign of one image's boxes, each from its FPN
    level (P2-P5), torchvision's aligned=False sampling."""
    levels = feats[:4]
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * \
        (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-6)).clamp(
        2, 5).to(torch.int64) - 2
    pooled = torch.zeros((len(boxes), feats[0].shape[1], out, out),
                         device=boxes.device)
    grid = torch.arange(out, device=boxes.device, dtype=torch.float32)
    sub = torch.arange(ratio, device=boxes.device, dtype=torch.float32)
    for k, f in enumerate(levels):
        sel = torch.nonzero(lvl == k).flatten()
        if len(sel) == 0:
            continue
        scale = 1.0 / (canvas[0] / f.shape[2])
        b = boxes[sel] * scale
        w = (b[:, 2] - b[:, 0]).clamp(min=1.0)
        h = (b[:, 3] - b[:, 1]).clamp(min=1.0)
        bh, bw = (h / out)[:, None, None], (w / out)[:, None, None]
        ys = grid[None, :, None] * bh + (sub[None, None, :] + 0.5) * bh \
            / ratio + b[:, 1, None, None]
        xs = grid[None, :, None] * bw + (sub[None, None, :] + 0.5) * bw \
            / ratio + b[:, 0, None, None]
        pooled[sel] = _bilinear(f[0], ys, xs)
    return pooled


def _bilinear(fmap, ys, xs):
    """Mean of the bilinear samples at ys (R, out, s) x xs (R, out, s) of
    fmap (C, H, W); samples outside [-1, size] are zero."""
    c, h, w = fmap.shape
    y = ys[:, :, None, :, None]
    x = xs[:, None, :, None, :]
    y, x = torch.broadcast_tensors(y, x)
    valid = (y >= -1.0) & (y <= h) & (x >= -1.0) & (x <= w)
    y0, x0 = torch.floor(y), torch.floor(x)
    ly, lx = y - y0, x - x0
    flat = fmap.reshape(c, -1)

    def tap(yy, xx):
        yi = yy.to(torch.int64).clamp(0, h - 1)
        xi = xx.to(torch.int64).clamp(0, w - 1)
        return flat[:, (yi * w + xi).reshape(-1)].reshape(c, *y.shape)
    v = tap(y0, x0) * ((1 - ly) * (1 - lx)) + tap(y0, x0 + 1) * (
        (1 - ly) * lx) + tap(y0 + 1, x0) * (ly * (1 - lx)) \
        + tap(y0 + 1, x0 + 1) * (ly * lx)
    v = v * valid
    return v.mean(dim=(4, 5)).permute(1, 0, 2, 3)


def box_head(sd, feats, proposals, canvas):
    """(class logits (R, K), box regression (R, K, 4)) of one image's
    proposals."""
    x = roi_align(feats, proposals, canvas).flatten(1)
    p = 'roi_heads.box_head'
    x = F.relu(F.linear(x, sd[f'{p}.fc6.weight'], sd[f'{p}.fc6.bias']))
    x = F.relu(F.linear(x, sd[f'{p}.fc7.weight'], sd[f'{p}.fc7.bias']))
    p = 'roi_heads.box_predictor'
    logits = F.linear(x, sd[f'{p}.cls_score.weight'], sd[f'{p}.cls_score.bias'])
    deltas = F.linear(x, sd[f'{p}.bbox_pred.weight'], sd[f'{p}.bbox_pred.bias'])
    return logits, deltas.reshape(len(x), -1, 4)


def detections(logits, deltas, proposals, valid, canvas):
    """{boxes (100, 4), scores, labels, valid} of one image."""
    r, k = logits.shape
    scores = torch.softmax(logits, -1)
    boxes = clip(decode_boxes(deltas, proposals[:, None, :], BOX_WEIGHTS),
                 canvas)
    fg = scores[:, 1:].reshape(-1)
    fg_boxes = boxes[:, 1:, :].reshape(-1, 4)
    labels = torch.arange(1, k, device=logits.device).repeat(r)
    ok = (fg > SCORE_THRESH) & big_enough(fg_boxes, 1e-2) \
        & valid.repeat_interleave(k - 1)
    sel = torch.where(ok, fg, -1.0)
    top = torch.sort(sel, descending=True, stable=True).indices[:PRE_NMS_CAP]
    idx, kept = nms(fg_boxes[top], sel[top], labels[top], BOX_NMS, DETECTIONS)
    final = top[idx]
    return {'boxes': fg_boxes[final],
            'scores': torch.where(kept, fg[final], 0.0),
            'labels': labels[final],
            'valid': kept & (fg[final] > SCORE_THRESH)}


def flops_forward(sd, sym, canvas):
    """The dense part of one image's server step (for FLOP counting):
    decoder, layer2-4, FPN, RPN head and the box head on 1,000 RoIs."""
    feats = features(sd, sym)
    p = 'rpn.head'
    for f in feats:
        t = F.relu(F.conv2d(f, sd[f'{p}.conv.0.0.weight'],
                            sd[f'{p}.conv.0.0.bias'], padding=1))
        F.conv2d(t, sd[f'{p}.cls_logits.weight'], sd[f'{p}.cls_logits.bias'])
        F.conv2d(t, sd[f'{p}.bbox_pred.weight'], sd[f'{p}.bbox_pred.bias'])
    x = torch.empty((POST_NMS, 256 * 7 * 7), device=sym.device)
    q = 'roi_heads'
    x = F.linear(x, sd[f'{q}.box_head.fc6.weight'], sd[f'{q}.box_head.fc6.bias'])
    x = F.linear(x, sd[f'{q}.box_head.fc7.weight'], sd[f'{q}.box_head.fc7.bias'])
    F.linear(x, sd[f'{q}.box_predictor.cls_score.weight'])
    F.linear(x, sd[f'{q}.box_predictor.bbox_pred.weight'])
