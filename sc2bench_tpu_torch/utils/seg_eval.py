"""Segmentation evaluator (counterpart of `sc2bench_tpu/utils/seg_eval.py`):
confusion matrix -> global accuracy, per-class accuracy, IoU and mIoU,
targets outside [0, num_classes) (255) ignored.

The matrix is int64 on the evaluator's device: `update` adds a batch's
counts there with no transfer and no synchronization (the ignored pixels
go to an overflow bin that is dropped), and `compute` reads it once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.dist import all_reduce_sum


class SegEvaluator:
    def __init__(self, num_classes: int, device='cpu'):
        self.num_classes = num_classes
        self.mat = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                               device=device)

    def update(self, target, pred):
        """Add the counts of int `target` and `pred` (tensors or arrays of
        one shape, any layout)."""
        n = self.num_classes
        dev = self.mat.device
        t = torch.as_tensor(target, device=dev).reshape(-1).long()
        p = torch.as_tensor(pred, device=dev).reshape(-1).long()
        idx = torch.where((t >= 0) & (t < n), n * t + p,
                          torch.full_like(t, n * n))
        counts = torch.zeros(n * n + 1, dtype=torch.int64, device=dev)
        counts.scatter_add_(0, idx, torch.ones_like(idx))
        self.mat += counts[:-1].view(n, n)

    def reset(self):
        self.mat.zero_()

    def reduce_from_all_processes(self):
        """The matrix summed over the data-parallel group (nothing to do
        in one process)."""
        all_reduce_sum(self.mat)

    def compute(self):
        """(global accuracy, per-class accuracy, per-class IoU), float64."""
        h = self.mat.cpu().numpy().astype(np.float64)
        acc_global = np.diag(h).sum() / max(h.sum(), 1)
        acc = np.diag(h) / np.maximum(h.sum(1), 1)
        iou = np.diag(h) / np.maximum(h.sum(1) + h.sum(0) - np.diag(h), 1)
        return acc_global, acc, iou

    def __str__(self):
        acc_global, acc, iou = self.compute()
        return ('global correct: {:.1f}\naverage row correct: {}\n'
                'IoU: {}\nmean IoU: {:.1f}').format(
            acc_global * 100,
            [f'{i:.1f}' for i in (acc * 100).tolist()],
            [f'{i:.1f}' for i in (iou * 100).tolist()],
            iou.mean() * 100)
