"""COCO-format detection data on the host (counterpart of
`sc2bench_tpu/datasets/coco.py`): the instances JSON parsed without
pycocotools, images without annotations left out, (x, y, w, h) boxes as
(x1, y1, x2, y2), and one target dict an image ('boxes', 'labels',
'area', 'iscrowd', 'image_id'). `SyntheticDetectionDataset` makes the JAX
package's numpy draws, image i from seed + i. `rasterize_polygon` turns a
COCO polygon segmentation into a binary mask (the segm targets); like
JAX's, no loader calls it.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..registry import register_dataset


class CocoIndex:
    """The images, categories and annotations of an instances JSON."""

    def __init__(self, annotation_path):
        with open(Path(annotation_path).expanduser()) as f:
            self.dataset = json.load(f)
        self.imgs = {img['id']: img for img in self.dataset.get('images', [])}
        self.cats = {c['id']: c for c in self.dataset.get('categories', [])}
        self.img_to_anns = defaultdict(list)
        self.anns = {}
        for ann in self.dataset.get('annotations', []):
            self.img_to_anns[ann['image_id']].append(ann)
            self.anns[ann['id']] = ann

    def get_img_ids(self):
        return sorted(self.imgs)

    def load_anns_for_img(self, img_id):
        return self.img_to_anns.get(img_id, [])


@register_dataset
class CocoDetectionDataset:
    """img_dir/<file_name> and an instances JSON; items are (image HWC
    uint8, target dict)."""

    def __init__(self, img_dir, ann_file_path, remove_non_annotated_imgs=True,
                 transforms=None, **kwargs):
        self.img_dir = Path(img_dir).expanduser()
        self.coco = CocoIndex(ann_file_path)
        self.transforms = transforms
        ids = self.coco.get_img_ids()
        if remove_non_annotated_imgs:
            ids = [i for i in ids if len(self.coco.load_anns_for_img(i)) > 0]
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        from PIL import Image
        img_id = self.ids[idx]
        info = self.coco.imgs[img_id]
        img = Image.open(self.img_dir / info['file_name']).convert('RGB')
        boxes, labels, areas, iscrowd = [], [], [], []
        for a in self.coco.load_anns_for_img(img_id):
            x, y, w, h = a['bbox']
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(a['category_id'])
            areas.append(a.get('area', w * h))
            iscrowd.append(a.get('iscrowd', 0))
        target = {
            'boxes': np.asarray(boxes, np.float32).reshape(-1, 4),
            'labels': np.asarray(labels, np.int32),
            'area': np.asarray(areas, np.float32),
            'iscrowd': np.asarray(iscrowd, np.int32),
            'image_id': img_id,
        }
        sample = np.asarray(img, np.uint8)
        if self.transforms is not None:
            sample, target = self.transforms(sample, target)
        return sample, target


@register_dataset
class SyntheticDetectionDataset:
    """Random uint8 images and 1 ... max_boxes boxes of random classes in
    1 ... num_classes - 1, the JAX package's draws. Two options of the
    port's, off by default, give the targets of the segm and keypoint
    evaluations: `with_masks` adds 'masks' (each box's inscribed octagon
    through `rasterize_polygon`, image-sized bool) and sets 'area' to the
    mask's, as COCO's annotations give it; `num_keypoints` adds
    'keypoints' (n, K, 3), points drawn inside each box after JAX's draws,
    all visible (2). The image, boxes and labels stay JAX's."""

    def __init__(self, num_samples=16, image_size=(128, 128), max_boxes=5,
                 num_classes=91, seed=0, with_masks=False, num_keypoints=0,
                 **kwargs):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.max_boxes = max_boxes
        self.num_classes = num_classes
        self.seed = seed
        self.with_masks = with_masks
        self.num_keypoints = int(num_keypoints)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        h, w = self.image_size
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        n = int(rng.integers(1, self.max_boxes + 1))
        x1 = rng.uniform(0, w * 0.6, n)
        y1 = rng.uniform(0, h * 0.6, n)
        bw = rng.uniform(w * 0.1, w * 0.4, n)
        bh = rng.uniform(h * 0.1, h * 0.4, n)
        boxes = np.stack([x1, y1, np.minimum(x1 + bw, w),
                          np.minimum(y1 + bh, h)], 1).astype(np.float32)
        target = {
            'boxes': boxes,
            'labels': rng.integers(1, self.num_classes, n).astype(np.int32),
            'area': ((boxes[:, 2] - boxes[:, 0])
                     * (boxes[:, 3] - boxes[:, 1])).astype(np.float32),
            'iscrowd': np.zeros(n, np.int32),
            'image_id': idx,
        }
        if self.with_masks:
            target['masks'] = [rasterize_polygon([_octagon(b)], h, w)
                               for b in boxes]
            target['area'] = np.asarray([m.sum() for m in target['masks']],
                                        np.float32)
        if self.num_keypoints:
            u = rng.uniform(0, 1, (n, self.num_keypoints, 2))
            kps = np.full((n, self.num_keypoints, 3), 2, np.float32)
            kps[..., 0] = boxes[:, None, 0] + u[..., 0] * (
                boxes[:, None, 2] - boxes[:, None, 0])
            kps[..., 1] = boxes[:, None, 1] + u[..., 1] * (
                boxes[:, None, 3] - boxes[:, None, 1])
            target['keypoints'] = kps
        return img, target


def _octagon(box) -> list:
    """The flat ring of the octagon inscribed in an (x1, y1, x2, y2) box,
    its corners cut at a quarter of each side."""
    x1, y1, x2, y2 = (float(v) for v in box)
    dx, dy = (x2 - x1) / 4, (y2 - y1) / 4
    return [x1 + dx, y1, x2 - dx, y1, x2, y1 + dy, x2, y2 - dy,
            x2 - dx, y2, x1 + dx, y2, x1, y2 - dy, x1, y1 + dy]


def rasterize_polygon(polygons, height: int, width: int) -> np.ndarray:
    """COCO polygon segmentation -> (height, width) bool mask, an even-odd
    scanline fill at pixel centres in numpy (in place of pycocotools'
    `frPyObjects`/`decode`). `polygons`: flat [x0, y0, x1, y1, ...]
    rings; a ring of fewer than 3 points is skipped."""
    mask = np.zeros((height, width), bool)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        xs, ys = pts[:, 0], pts[:, 1]
        x2s, y2s = np.roll(xs, -1), np.roll(ys, -1)
        ring = np.zeros((height, width), bool)
        for y_i, y in enumerate(np.arange(height) + 0.5):
            crosses = ((ys <= y) & (y2s > y)) | ((y2s <= y) & (ys > y))
            if not crosses.any():
                continue
            with np.errstate(divide='ignore', invalid='ignore'):
                x_int = xs + (y - ys) / (y2s - ys) * (x2s - xs)
            x_cross = np.sort(x_int[crosses])
            for a, b in zip(x_cross[0::2], x_cross[1::2]):
                lo = max(int(np.ceil(a - 0.5)), 0)
                hi = min(int(np.ceil(b - 0.5)), width)
                if hi > lo:
                    ring[y_i, lo:hi] = True
        mask |= ring
    return mask


def pad_detection_targets(targets, max_boxes: int) -> dict:
    """A list of target dicts as fixed-size arrays: 'boxes' (N, max_boxes,
    4), 'labels' (N, max_boxes), 'boxes_valid' (N, max_boxes); boxes past
    `max_boxes` are dropped."""
    n = len(targets)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    valid = np.zeros((n, max_boxes), bool)
    for i, t in enumerate(targets):
        k = min(len(t['boxes']), max_boxes)
        boxes[i, :k] = t['boxes'][:k]
        labels[i, :k] = t['labels'][:k]
        valid[i, :k] = True
    return {'boxes': boxes, 'labels': labels, 'boxes_valid': valid}
