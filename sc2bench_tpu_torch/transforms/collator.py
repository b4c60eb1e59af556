"""Batch collation (counterpart of `sc2bench_tpu/transforms/collator.py`):
for segmentation, images and masks of different sizes padded to the
batch's largest (or to a multiple of `pad_to`); for detection, the
samples as they are."""
from __future__ import annotations

import numpy as np

from ..registry import register_collate


def cat_list(images, fill_value=0, pad_to=None) -> np.ndarray:
    """HWC (or HW) arrays stacked into one array padded with `fill_value`
    at the bottom and right to the largest height and width, each rounded
    up to a multiple of `pad_to` when given."""
    max_h = max(img.shape[0] for img in images)
    max_w = max(img.shape[1] for img in images)
    if pad_to is not None:
        max_h = -(-max_h // pad_to) * pad_to
        max_w = -(-max_w // pad_to) * pad_to
    shape = (len(images), max_h, max_w, *images[0].shape[2:])
    out = np.full(shape, fill_value, dtype=images[0].dtype)
    for i, img in enumerate(images):
        out[i, :img.shape[0], :img.shape[1]] = img
    return out


@register_collate
def pascal_seg_collate_fn(batch, pad_to=None):
    """(images padded with 0, int32 targets padded with 255, the ignore
    index)."""
    images, targets = zip(*[(np.asarray(s), np.asarray(t)) for s, t in batch])
    return (cat_list(images, 0, pad_to),
            cat_list(targets, 255, pad_to).astype(np.int32))


@register_collate
def pascal_seg_eval_collate_fn(batch):
    """The samples unpadded: (list of images, list of targets)."""
    images, targets = zip(*batch)
    return list(images), list(targets)


@register_collate
def coco_collate_fn(batch):
    """(images, targets) as tuples, unpadded: the detection engine resizes
    and pads each batch to its canvas."""
    return tuple(zip(*batch))
