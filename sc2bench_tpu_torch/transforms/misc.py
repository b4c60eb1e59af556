"""Host transforms (counterpart of `sc2bench_tpu/transforms/misc.py`).

The tensor quantizers of the CR+BQ family: FP16 truncation, or Jacob et
al.'s asymmetric affine quantization at `num_bits`. They work on numpy
arrays on the host, and their output is the compressed object whose
pickled size the data-size protocol counts: a float16 array, or
{'tensor': uint8 (int32 at other widths), 'scale': np.float32,
'zero_point': np.int32}, the JAX package's types, so the sizes are equal
byte for byte.

`ClearTargetTransform` drops a sample's target.

The image transforms of the input-compression wrappers work on HWC numpy
images, as the JAX package's do: `AdaptivePad` pads to a multiple of the
codec's stride, `CustomToTensor` scales uint8 (or PIL) to [0, 1] float32,
`Normalize` standardizes per channel; `default_collate_w_pil` batches
arrays and passes PIL images through as lists. The wrappers turn a batch
into NCHW once, before the classifier.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..registry import register_transform


@register_transform
class ClearTargetTransform:
    """Drops the target, keeping the sample: (sample, None)."""

    def __call__(self, sample, *args):
        return sample, None


def quantize_tensor(x, num_bits: int = 8) -> dict:
    """Asymmetric affine quantization: the zero point from the minimum,
    values rounded and clamped to [0, 2^b - 1]."""
    x = np.asarray(x, np.float32)
    qmin, qmax = 0.0, 2.0 ** num_bits - 1.0
    min_val, max_val = float(x.min()), float(x.max())
    scale = (max_val - min_val) / (qmax - qmin) if max_val > min_val else 1.0
    zero_point = int(np.clip(round(qmin - min_val / scale), qmin, qmax))
    q = np.clip(np.round(zero_point + x / scale), qmin, qmax)
    dtype = np.uint8 if num_bits == 8 else np.int32
    return {'tensor': q.astype(dtype), 'scale': np.float32(scale),
            'zero_point': np.int32(zero_point)}


def dequantize_tensor(q: dict) -> np.ndarray:
    return q['scale'] * (q['tensor'].astype(np.float32)
                         - np.float32(q['zero_point']))


@register_transform
class SimpleQuantizer:
    """FP16 (num_bits=16) by a dtype cast, else `quantize_tensor`."""

    def __init__(self, num_bits=8, **kwargs):
        self.num_bits = num_bits

    def __call__(self, z):
        if self.num_bits == 16:
            return np.asarray(z, np.float16)
        return quantize_tensor(z, self.num_bits)


@register_transform
class SimpleDequantizer:
    """Inverse of `SimpleQuantizer`, to float32."""

    def __init__(self, num_bits=8, **kwargs):
        self.num_bits = num_bits

    def __call__(self, z):
        if self.num_bits == 16:
            return np.asarray(z, np.float32)
        return dequantize_tensor(z)


@register_transform
class AdaptivePad:
    """Pad H and W of an HWC (or NHWC) array up to a multiple of `factor`
    with `fill`, at the bottom and right (split in two halves with
    `centered`); with `returns_org_patch_size` also the original (h, w)."""

    def __init__(self, fill=0, padding_position='hw', factor=128,
                 returns_org_patch_size=False, centered=False, **kwargs):
        self.fill = fill
        self.factor = factor
        self.returns_org_patch_size = returns_org_patch_size
        self.centered = centered

    def padded_size(self, h, w):
        f = self.factor
        return (-(-h // f)) * f, (-(-w // f)) * f

    def __call__(self, x):
        x = np.asarray(x)
        h, w = x.shape[-3], x.shape[-2]
        ph, pw = self.padded_size(h, w)
        dh, dw = ph - h, pw - w
        if self.centered:
            pads = ((dh // 2, dh - dh // 2), (dw // 2, dw - dw // 2), (0, 0))
        else:
            pads = ((0, dh), (0, dw), (0, 0))
        if x.ndim == 4:
            pads = ((0, 0),) + pads
        out = np.pad(x, pads, constant_values=self.fill)
        if self.returns_org_patch_size:
            return out, (h, w)
        return out


@register_transform
class CustomToTensor:
    """PIL or uint8 HWC -> float32 HWC in [0, 1] (the target, if given, to
    int64)."""

    def __init__(self, converts_sample=True, converts_target=True, **kwargs):
        self.converts_sample = converts_sample
        self.converts_target = converts_target

    def __call__(self, sample, target=None):
        if self.converts_sample:
            sample = np.asarray(sample, np.float32) / 255.0
        if target is not None and self.converts_target:
            target = np.asarray(target, np.int64)
        if target is None:
            return sample
        return sample, target


@dataclasses.dataclass
class Normalize:
    """Channel-wise (x - mean) / std of HWC float arrays."""

    mean: tuple = (0.485, 0.456, 0.406)
    std: tuple = (0.229, 0.224, 0.225)

    def __call__(self, x):
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        return (np.asarray(x, np.float32) - mean) / std


register_transform(Normalize)


def default_collate_w_pil(batch):
    """Stack arrays, pass PIL images (and other objects) through as lists;
    tuples are collated field by field."""
    first = batch[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate_w_pil(list(s)) for s in zip(*batch))
    if isinstance(first, np.ndarray):
        return np.stack(batch)
    if isinstance(first, (int, float)):
        return np.asarray(batch)
    return list(batch)
