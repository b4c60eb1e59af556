"""COCO bbox, segm and keypoint AP in numpy (counterpart of
`sc2bench_tpu/utils/coco_eval.py`), in place of pycocotools' `COCOeval`.

The COCO protocol: per (category, IoU threshold) greedy matching of the
detections in score order, crowd regions as ignore (IoU over the
detection's area), area-range filtering, the maxDets cut, and 101-point
interpolated precision averaged over IoU 0.50:0.95. `summarize` gives the
12 standard metrics; an area range with no ground truth gives -1, as in
pycocotools. One evaluator scores one `iou_type`: 'bbox' (box IoU),
'segm' (`_mask_iou` over full-size binary masks: predictions' and
targets' 'masks' lists; `paste_mask` puts a 28x28 probability mask into
the image) or 'keypoints' (`_oks_iou`, object keypoint similarity with
`KPT_SIGMAS`: 'keypoints' (G, K, 3) of the targets, (D, K, 3) of the
predictions, decoded from heatmaps by `keypoints_from_heatmaps`). A
'segm' or 'keypoints' evaluator given predictions without masks or
keypoints falls back to box IoU, as JAX's does.
"""
from __future__ import annotations

import numpy as np

from ..parallel.dist import all_gather_object, is_multi

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    'all': (0.0, 1e10),
    'small': (0.0, 32 ** 2),
    'medium': (32 ** 2, 96 ** 2),
    'large': (96 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def paste_mask(mask28: np.ndarray, box_xyxy, height: int, width: int,
               thresh: float = 0.5) -> np.ndarray:
    """A (28, 28) probability mask pasted into an image-sized binary mask
    at `box` (bilinear resize to the box's integer extent, then the
    threshold): torchvision's `paste_masks_in_image` step."""
    x1, y1, x2, y2 = [float(v) for v in box_xyxy]
    x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
    x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
    w = max(x2i - x1i, 1)
    h = max(y2i - y1i, 1)
    ys = (np.arange(h) + 0.5) / h * mask28.shape[0] - 0.5
    xs = (np.arange(w) + 0.5) / w * mask28.shape[1] - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, mask28.shape[0] - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, mask28.shape[1] - 1)
    y1f = np.clip(y0 + 1, 0, mask28.shape[0] - 1)
    x1f = np.clip(x0 + 1, 0, mask28.shape[1] - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    m = (mask28[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
         + mask28[np.ix_(y0, x1f)] * (1 - wy) * wx
         + mask28[np.ix_(y1f, x0)] * wy * (1 - wx)
         + mask28[np.ix_(y1f, x1f)] * wy * wx)
    out = np.zeros((height, width), bool)
    oy1, oy2 = max(y1i, 0), min(y2i, height)
    ox1, ox2 = max(x1i, 0), min(x2i, width)
    if oy2 > oy1 and ox2 > ox1:
        out[oy1:oy2, ox1:ox2] = \
            (m[oy1 - y1i:oy2 - y1i, ox1 - x1i:ox2 - x1i] >= thresh)
    return out


def _mask_iou(det_masks, gt_masks, iscrowd):
    """IoU matrix over binary masks; a crowd gt takes intersection over
    the detection's area (pycocotools' RLE IoU)."""
    out = np.zeros((len(det_masks), len(gt_masks)))
    d_areas = [m.sum() for m in det_masks]
    for j, gm in enumerate(gt_masks):
        g_area = gm.sum()
        for i, dm in enumerate(det_masks):
            inter = np.logical_and(dm, gm).sum()
            denom = d_areas[i] if iscrowd[j] else \
                d_areas[i] + g_area - inter
            out[i, j] = inter / max(denom, 1e-10)
    return out


# COCO keypoint per-joint falloff constants (sigmas), nose .. right ankle
KPT_SIGMAS = np.asarray([
    .026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
    .107, .107, .087, .087, .089, .089])


def _oks_iou(det_kps, gt_kps, gt_areas, iscrowd):
    """Object keypoint similarity matrix (pycocotools' computeOks): det_kps
    (D, K, 2|3), gt_kps (G, K, 3) with the visibility in [:, :, 2]; 0
    against a gt without a visible keypoint."""
    out = np.zeros((len(det_kps), len(gt_kps)))
    vars_ = (2 * KPT_SIGMAS) ** 2
    for j, gk in enumerate(gt_kps):
        gk = np.asarray(gk, np.float64)
        vis = gk[:, 2] > 0
        s2 = max(float(gt_areas[j]), 1e-10)
        for i, dk in enumerate(det_kps):
            dk = np.asarray(dk, np.float64)
            dx = dk[:, 0] - gk[:, 0]
            dy = dk[:, 1] - gk[:, 1]
            e = (dx ** 2 + dy ** 2) / vars_[:len(dx)] / s2 / 2
            out[i, j] = np.mean(np.exp(-e[vis])) if vis.any() else 0.0
    return out


def keypoints_from_heatmaps(heatmaps: np.ndarray,
                            boxes: np.ndarray) -> np.ndarray:
    """(D, H, W, K) heatmaps -> (D, K, 3) image-space keypoints: each
    joint's argmax cell centre mapped into the detection box, its score
    the peak value."""
    d, hh, ww, k = heatmaps.shape
    out = np.zeros((d, k, 3), np.float32)
    for i in range(d):
        x1, y1, x2, y2 = boxes[i]
        for j in range(k):
            hm = heatmaps[i, :, :, j]
            py, px = divmod(int(np.argmax(hm)), ww)
            out[i, j, 0] = x1 + (px + 0.5) / ww * (x2 - x1)
            out[i, j, 1] = y1 + (py + 0.5) / hh * (y2 - y1)
            out[i, j, 2] = hm[py, px]
    return out


def _bbox_iou_xywh(dets, gts, iscrowd):
    """IoU with crowd semantics: for a crowd gt, intersection / det
    area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.maximum(0, np.minimum(dx2[:, None], gx2[None, :])
                    - np.maximum(dx1[:, None], gx1[None, :]))
    iy = np.maximum(0, np.minimum(dy2[:, None], gy2[None, :])
                    - np.maximum(dy1[:, None], gy1[None, :]))
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), d_area,
                     d_area + g_area - inter)
    return inter / np.maximum(union, 1e-10)


def _xyxy_to_xywh(boxes):
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    out = boxes.copy()
    out[:, 2] = boxes[:, 2] - boxes[:, 0]
    out[:, 3] = boxes[:, 3] - boxes[:, 1]
    return out


class CocoEvaluator:
    """`add_gt` each image's target (boxes xyxy, labels, iscrowd, area,
    image_id; 'masks' or 'keypoints' for those types), `update` with
    predictions, then `accumulate` and `summarize` -> the 12 COCO metrics
    of `iou_type` ('bbox', 'segm' or 'keypoints')."""

    IOU_TYPES = ('bbox', 'segm', 'keypoints')

    def __init__(self, iou_type='bbox'):
        if iou_type not in self.IOU_TYPES:
            raise ValueError(f'unknown iou_type {iou_type!r}: one of '
                             f'{self.IOU_TYPES}')
        self.iou_type = iou_type
        self.gts = {}          # image_id -> target dict
        self.preds = {}        # image_id -> {'boxes', 'scores', 'labels'}

    def add_gt(self, target):
        self.gts[target['image_id']] = target

    def update(self, res: dict):
        """res: {image_id: {'boxes' (xyxy), 'scores', 'labels'[, 'masks':
        list of HxW bool][, 'keypoints': (D, K, 3)]}}."""
        for img_id, pred in res.items():
            entry = {
                'boxes': np.asarray(pred['boxes'], np.float64).reshape(-1, 4),
                'scores': np.asarray(pred['scores'], np.float64).ravel(),
                'labels': np.asarray(pred['labels'], np.int64).ravel(),
            }
            if 'masks' in pred:
                entry['masks'] = list(pred['masks'])
            if 'keypoints' in pred:
                entry['keypoints'] = np.asarray(pred['keypoints'],
                                                np.float64)
            self.preds[img_id] = entry

    def synchronize_between_processes(self):
        """Gather the predictions and the ground truths (masks and
        keypoints with them) of every process of a data-parallel group,
        keyed by image id, so that shards which
        overlap (the wrap padding, or a test loader every process reads
        whole) count each image once, as JAX does (`all_gather_object`,
        through the CPU). Nothing to do in one process."""
        if not is_multi():
            return
        preds, gts = {}, {}
        for part_preds, part_gts in all_gather_object((self.preds,
                                                       self.gts)):
            preds.update(part_preds)
            gts.update(part_gts)
        # merged in rank order, so every rank holds the same order
        self.preds, self.gts = preds, gts

    # ---- the COCO protocol ---------------------------------------------
    def _evaluate_img(self, dt, gt, iou_thrs, area_rng, max_det):
        """Greedy matching for one (image, category): the detections'
        scores, matches and ignore flags per IoU threshold, and the gts'
        ignore flags."""
        g_ignore = gt['ignore'] | (gt['area'] < area_rng[0]) \
            | (gt['area'] > area_rng[1])
        order_g = np.argsort(g_ignore, kind='stable')
        g_boxes = gt['boxes_xywh'][order_g]
        g_iscrowd = gt['iscrowd'][order_g]
        g_ign = g_ignore[order_g]
        d_order = np.argsort(-dt['scores'], kind='stable')[:max_det]
        d_boxes = dt['boxes_xywh'][d_order]
        d_scores = dt['scores'][d_order]
        if self.iou_type == 'segm' and 'masks' in dt:
            d_masks = [dt['masks'][k] for k in d_order]
            d_area = np.asarray([m.sum() for m in d_masks], np.float64)
            ious = _mask_iou(d_masks, [gt['masks'][k] for k in order_g],
                             g_iscrowd)
        elif self.iou_type == 'keypoints' and 'keypoints' in dt:
            d_area = d_boxes[:, 2] * d_boxes[:, 3]
            ious = _oks_iou([dt['keypoints'][k] for k in d_order],
                            [gt['keypoints'][k] for k in order_g],
                            gt['area'][order_g], g_iscrowd)
        else:
            d_area = d_boxes[:, 2] * d_boxes[:, 3]
            ious = _bbox_iou_xywh(d_boxes, g_boxes, g_iscrowd)
        n_thr, n_d, n_g = len(iou_thrs), len(d_boxes), len(g_boxes)
        dt_m = np.zeros((n_thr, n_d), np.int64) - 1
        gt_m = np.zeros((n_thr, n_g), np.int64) - 1
        dt_ig = np.zeros((n_thr, n_d), bool)
        for t, thr in enumerate(iou_thrs):
            for d in range(n_d):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for g in range(n_g):
                    if gt_m[t, g] >= 0 and not g_iscrowd[g]:
                        continue
                    if best_g >= 0 and not g_ign[best_g] and g_ign[g]:
                        break  # sorted: once into ignored gts, stop
                    if ious[d, g] < best_iou:
                        continue
                    best_iou = ious[d, g]
                    best_g = g
                if best_g >= 0:
                    dt_m[t, d] = best_g
                    gt_m[t, best_g] = d
                    dt_ig[t, d] = g_ign[best_g]
        # unmatched detections outside the area range are ignored
        out_of_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig |= (dt_m == -1) & out_of_rng[None, :]
        return d_scores, dt_m, dt_ig, g_ign

    def _accumulate(self, cat_ids, area_name, max_det):
        area_rng = AREA_RANGES[area_name]
        ap_per_cat, ar_per_cat = [], []
        for cat in cat_ids:
            scores_all, matched_all, ignored_all = [], [], []
            n_gt = 0
            for img_id, gt in self.gts.items():
                sel_g = gt['labels'] == cat
                g = {
                    'boxes_xywh': _xyxy_to_xywh(
                        np.asarray(gt['boxes'], np.float64)[sel_g]),
                    'iscrowd': np.asarray(gt['iscrowd'])[sel_g],
                    'area': np.asarray(gt['area'], np.float64)[sel_g],
                }
                extra = {'segm': 'masks', 'keypoints': 'keypoints'}.get(
                    self.iou_type)
                if extra in gt:
                    g[extra] = [m for m, keep in zip(gt[extra], sel_g)
                                if keep]
                g['ignore'] = g['iscrowd'].astype(bool)
                pred = self.preds.get(img_id)
                if pred is None:
                    d = {'boxes_xywh': np.zeros((0, 4)),
                         'scores': np.zeros(0)}
                else:
                    sel_d = pred['labels'] == cat
                    d = {'boxes_xywh': _xyxy_to_xywh(pred['boxes'][sel_d]),
                         'scores': pred['scores'][sel_d]}
                    if extra in pred:
                        d[extra] = [m for m, keep in zip(pred[extra], sel_d)
                                    if keep]
                if len(g['boxes_xywh']) == 0 and len(d['boxes_xywh']) == 0:
                    continue
                s, dt_m, dt_ig, g_ign = self._evaluate_img(
                    d, g, IOU_THRS, area_rng, max_det)
                scores_all.append(s)
                matched_all.append(dt_m >= 0)
                ignored_all.append(dt_ig)
                n_gt += int((~g_ign).sum())
            if n_gt == 0:
                continue
            if scores_all:
                order = np.argsort(-np.concatenate(scores_all), kind='stable')
                matched = np.concatenate(matched_all, axis=1)[:, order]
                ignored = np.concatenate(ignored_all, axis=1)[:, order]
            else:
                matched = np.zeros((len(IOU_THRS), 0), bool)
                ignored = np.zeros((len(IOU_THRS), 0), bool)
            aps, ars = [], []
            for t in range(len(IOU_THRS)):
                keep = ~ignored[t]
                tp = np.cumsum(matched[t][keep])
                fp = np.cumsum(~matched[t][keep])
                recall = tp / n_gt
                precision = tp / np.maximum(tp + fp, 1e-10)
                if len(precision) == 0:  # no detections of this category
                    aps.append(0.0)
                    ars.append(0.0)
                    continue
                # precision envelope + 101-point interpolation
                for i in range(len(precision) - 1, 0, -1):
                    precision[i - 1] = max(precision[i - 1], precision[i])
                idx = np.searchsorted(recall, RECALL_THRS, side='left')
                q = np.where(idx < len(precision),
                             precision[np.minimum(idx, len(precision) - 1)],
                             0.0)
                aps.append(np.mean(q))
                ars.append(recall[-1])
            ap_per_cat.append(aps)
            ar_per_cat.append(ars)
        if not ap_per_cat:
            return np.full(len(IOU_THRS), np.nan), \
                np.full(len(IOU_THRS), np.nan)
        return (np.mean(np.asarray(ap_per_cat), axis=0),
                np.mean(np.asarray(ar_per_cat), axis=0))

    def accumulate(self):
        cat_ids = sorted({int(c) for gt in self.gts.values()
                          for c in np.asarray(gt['labels']).tolist()})
        self._ap_all, self._ar_all = {}, {}
        for area in AREA_RANGES:
            self._ap_all[area], self._ar_all[area] = self._accumulate(
                cat_ids, area, 100)
        self._ar_maxdets = {
            md: self._accumulate(cat_ids, 'all', md)[1] for md in MAX_DETS}

    def summarize(self) -> dict:
        def nm(a):
            a = np.asarray(a, np.float64)
            valid = a[~np.isnan(a)]
            return float(valid.mean()) if valid.size else -1.0

        ap = self._ap_all
        return {
            'AP': nm(ap['all']),
            'AP50': nm(ap['all'][0]),
            'AP75': nm(ap['all'][5]),
            'AP_small': nm(ap['small']),
            'AP_medium': nm(ap['medium']),
            'AP_large': nm(ap['large']),
            'AR_1': nm(self._ar_maxdets[1]),
            'AR_10': nm(self._ar_maxdets[10]),
            'AR_100': nm(self._ar_maxdets[100]),
            'AR_small': nm(self._ar_all['small']),
            'AR_medium': nm(self._ar_all['medium']),
            'AR_large': nm(self._ar_all['large']),
        }
