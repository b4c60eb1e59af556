"""Aspect-ratio-grouped batch sampling for detection (counterpart of
`sc2bench_tpu/datasets/sampler.py`).

Each batch draws its images from one aspect-ratio bucket, so a padded
canvas wastes less. The epoch's order is the JAX package's numpy
permutation (`default_rng(seed + epoch)`), so the index lists equal
JAX's, the padded leftovers and the length included. As in JAX, the
engines batch in loader order and do not use it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np


def create_aspect_ratio_groups(aspect_ratios, k: int = 0) -> list:
    """Each ratio's bucket among 2k+1 log-spaced bins from 1/2 to 2 (one
    bin, at 1, for k = 0)."""
    bins = (2 ** np.linspace(-1, 1, 2 * k + 1)).tolist() if k > 0 else [1.0]
    return [bisect.bisect_right(bins, ar) for ar in aspect_ratios]


def compute_aspect_ratios(dataset) -> list:
    """Width over height of every item: from the dataset's
    `get_height_and_width(i)`, else from a COCO dataset's index
    (`coco.imgs` by `ids`, as `CocoDetectionDataset` holds them), else
    from each loaded image (HWC)."""
    if hasattr(dataset, 'get_height_and_width'):
        return [w / h for h, w in (dataset.get_height_and_width(i)
                                   for i in range(len(dataset)))]
    if hasattr(dataset, 'coco'):
        imgs = dataset.coco.imgs
        return [imgs[i]['width'] / imgs[i]['height'] for i in dataset.ids]
    ratios = []
    for i in range(len(dataset)):
        img, _ = dataset[i]
        h, w = np.asarray(img).shape[:2]
        ratios.append(w / h)
    return ratios


class GroupedBatchSampler:
    """Lists of dataset indices, each list from one group, `batch_size`
    long: the epoch's order (shuffled by `default_rng(seed + epoch)`)
    fills each group's buffer, a full buffer is a batch, and at the end
    each group's leftover is padded with its own first members (cycling)
    so every index is visited once an epoch."""

    def __init__(self, group_ids, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.group_ids = np.asarray(group_ids)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        order = np.arange(len(self.group_ids))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        buffers = defaultdict(list)
        for idx in order:
            g = self.group_ids[idx]
            buffers[g].append(int(idx))
            if len(buffers[g]) == self.batch_size:
                yield buffers[g]
                buffers[g] = []
        for g, buf in buffers.items():
            if buf:
                pool = [int(i) for i in np.where(self.group_ids == g)[0]]
                while len(buf) < self.batch_size:
                    buf.append(pool[len(buf) % len(pool)])
                yield buf
        self.epoch += 1

    def __len__(self):
        counts = np.bincount(self.group_ids)
        return int(sum(-(-c // self.batch_size) for c in counts if c))
