"""Box operations for detection (counterpart of `sc2bench_tpu/ops/boxes.py`).

Boxes are (x1, y1, x2, y2) in canvas coordinates. IoU, encode/decode and
clipping are elementwise tensor math in the JAX package's order of
operations. NMS is the JAX package's: greedy (torchvision `nms` semantics)
with ties broken by a stable sort, first index first, and a fixed-size
result `(indices (max_out,), keep (max_out,))`.

`nms_mask` resolves the greedy set tile by tile on the device: the
score-sorted boxes in tiles of `_NMS_TILE`, each tile first suppressed by
the kept boxes of the tiles before it, then settled by iterating the
recurrence kept[i] = base[i] and no kept j < i in the tile with
iou(j, i) > t to its fixed point, which is unique and is the greedy set.
The host reads one flag per `_NMS_STEPS` iterations (has the tile
settled?) together with the kept count: once `max_out` boxes are kept the
later tiles cannot change the result and are skipped. So a call costs a
few device-to-host reads a tile, and no host loop over `max_out`. Each
read is a wait span (`detect.nms.read`) and counts in `nms.host_reads`;
`nms.tiles` counts the tiles swept (`utils/profiling.py`).
`_nms_mask_serial`, the sequential select-best/suppress loop, is the
oracle the tests hold it against, and serves small inputs, as in JAX.
"""
from __future__ import annotations

import math

import torch

from ..utils.profiling import count, span

# torchvision BoxCoder's clamp on dw, dh
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
_NMS_TILE = 512
# fixed-point iterations between two reads of the convergence flag
_NMS_STEPS = 8


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix (N, M) of boxes a (N, 4) and b (M, 4)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Regression targets (dx, dy, dw, dh) of `reference` (ground truth)
    with respect to `proposals` (anchors): torchvision BoxCoder.encode."""
    wx, wy, ww, wh = weights
    px = (proposals[..., 0] + proposals[..., 2]) / 2
    py = (proposals[..., 1] + proposals[..., 3]) / 2
    pw = torch.clamp(proposals[..., 2] - proposals[..., 0], min=1e-6)
    ph = torch.clamp(proposals[..., 3] - proposals[..., 1], min=1e-6)
    gx = (reference[..., 0] + reference[..., 2]) / 2
    gy = (reference[..., 1] + reference[..., 3]) / 2
    gw = torch.clamp(reference[..., 2] - reference[..., 0], min=1e-6)
    gh = torch.clamp(reference[..., 3] - reference[..., 1], min=1e-6)
    return torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                        ww * torch.log(gw / pw), wh * torch.log(gh / ph)],
                       dim=-1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply regression deltas to boxes: torchvision BoxCoder.decode, dw
    and dh clamped at log(1000 / 16)."""
    wx, wy, ww, wh = weights
    px = (boxes[..., 0] + boxes[..., 2]) / 2
    py = (boxes[..., 1] + boxes[..., 3]) / 2
    pw = boxes[..., 2] - boxes[..., 0]
    ph = boxes[..., 3] - boxes[..., 1]
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)
    cx = dx * pw + px
    cy = dy * ph + py
    w = torch.exp(dw) * pw
    h = torch.exp(dh) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def clip_boxes(boxes: torch.Tensor, image_hw) -> torch.Tensor:
    h, w = image_hw
    return torch.stack([
        torch.clamp(boxes[..., 0], 0, w), torch.clamp(boxes[..., 1], 0, h),
        torch.clamp(boxes[..., 2], 0, w), torch.clamp(boxes[..., 3], 0, h)],
        dim=-1)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float
                            ) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w >= min_size) & (h >= min_size)


def _nms_mask_serial(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float, max_out: int):
    """Greedy NMS as `max_out` select-best/suppress steps (the JAX
    package's `_nms_mask_serial`): the best live score (first index on
    ties), then every box over the threshold with it dies. The oracle of
    `nms_mask`."""
    n = boxes.shape[0]
    iou = box_iou(boxes, boxes)
    alive = torch.ones(n, dtype=torch.bool, device=boxes.device)
    out_idx = torch.zeros(max_out, dtype=torch.int64, device=boxes.device)
    out_valid = torch.zeros(max_out, dtype=torch.bool, device=boxes.device)
    neg_inf = torch.tensor(-math.inf, dtype=scores.dtype,
                           device=scores.device)
    for i in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        best = torch.argmax(masked)
        valid = masked[best] > -math.inf
        alive = alive & ~(iou[best] > iou_threshold) & valid
        out_idx[i] = best
        out_valid[i] = valid
    return out_idx, out_valid


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float, max_out: int):
    """Greedy NMS with a static-size result: (indices (max_out,) int64,
    keep (max_out,) bool), the first `max_out` kept boxes in score order;
    a score of -inf is out of support. Equal to `_nms_mask_serial`, to
    which small inputs go, as in the JAX package. (Fewer than `max_out`
    entries when there are fewer than `max_out` boxes, as JAX's tiled
    form gives.)"""
    n = boxes.shape[0]
    if n <= _NMS_TILE // 2 and max_out <= 64:
        return _nms_mask_serial(boxes, scores, iou_threshold, max_out)
    dev = boxes.device
    t_sz = _NMS_TILE
    n_pad = -(-n // t_sz) * t_sz
    order = torch.sort(-scores, stable=True).indices
    sup = box_iou(boxes[order], boxes[order]) > iou_threshold
    base = scores[order] > -math.inf
    if n_pad != n:
        sup = torch.nn.functional.pad(sup, (0, n_pad - n, 0, n_pad - n))
        base = torch.nn.functional.pad(base, (0, n_pad - n))
    tri = torch.ones(t_sz, t_sz, dtype=torch.bool, device=dev).triu(1)
    kept = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    n_kept = 0
    for r0 in range(0, n_pad, t_sz):
        count('nms.tiles')
        tile_base = base[r0:r0 + t_sz]
        if r0:
            tile_base = tile_base & ~(sup[:r0, r0:r0 + t_sz]
                                      & kept[:r0, None]).any(0)
        tile_sup = sup[r0:r0 + t_sz, r0:r0 + t_sz] & tri
        # the fixed point of k -> base & ~any_j(sup[j] & k[j]) from
        # k = base; steps past it leave it as it is
        k = tile_base
        for _ in range(0, t_sz + _NMS_STEPS, _NMS_STEPS):
            for _ in range(_NMS_STEPS):
                prev = k
                k = tile_base & ~(tile_sup & k[:, None]).any(0)
            count('nms.host_reads')
            with span('detect.nms.read', wait=True):
                moved, tile_kept = torch.stack([(k != prev).any().long(),
                                                k.sum()]).tolist()
            if not moved:
                break
        kept[r0:r0 + t_sz] = k
        n_kept += tile_kept
        if n_kept >= max_out:
            break       # the later tiles cannot enter the first max_out
    pos = torch.arange(n, device=dev)
    priority = torch.where(kept[:n], pos, n)
    top = torch.sort(priority, stable=True).indices[:max_out]
    out_valid = priority[top] < n
    out_idx = torch.where(out_valid, order[top], 0)
    return out_idx, out_valid


def fast_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float, max_out: int):
    """One-shot NMS (YOLACT's Fast NMS) with JAX's contract: (indices
    (max_out,) int32, keep (max_out,) bool). The top min(n, 4 max_out)
    scores by a stable descending sort (ties first index first, as
    `lax.top_k`); a box is kept when its largest IoU with a higher-scored
    candidate is at most the threshold and its score is above -inf, so a
    suppressed box still suppresses (more aggressive than greedy NMS, but
    no loop). The kept boxes fill the first slots in score order; the rest
    are index 0, keep False. The detection path uses `nms_mask`, as JAX's
    does."""
    n = boxes.shape[0]
    dev = boxes.device
    k = min(n, max(4 * max_out, max_out))
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    b = boxes[order]
    iou = box_iou(b, b).triu(1)
    max_iou = iou.max(0).values if k else iou.new_zeros(0)
    keep = (max_iou <= iou_threshold) & (scores[order] > -math.inf)
    # kept boxes to slots 0.. in order; slot max_out takes the rest
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < max_out), rank, max_out)
    out_idx = torch.zeros(max_out + 1, dtype=torch.int32, device=dev)
    out_valid = torch.zeros(max_out + 1, dtype=torch.bool, device=dev)
    out_idx[slot] = torch.where(slot < max_out, order, 0).to(torch.int32)
    out_valid[slot] = slot < max_out
    return out_idx[:max_out], out_valid[:max_out]


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     idxs: torch.Tensor, iou_threshold: float, max_out: int):
    """Category-aware NMS by the coordinate-offset trick (torchvision
    `batched_nms`): boxes of different `idxs` never overlap."""
    with span('detect.nms'):
        max_coord = torch.max(boxes) + 1.0
        offsets = idxs.to(boxes.dtype) * max_coord
        return nms_mask(boxes + offsets[:, None], scores, iou_threshold,
                        max_out)
