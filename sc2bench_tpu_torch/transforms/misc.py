"""Tensor quantizers of the CR+BQ family (counterpart of the quantizers in
`sc2bench_tpu/transforms/misc.py`): FP16 truncation, or Jacob et al.'s
asymmetric affine quantization at `num_bits`. They work on numpy arrays on
the host, and their output is the compressed object whose pickled size the
data-size protocol counts: a float16 array, or {'tensor': uint8 (int32 at
other widths), 'scale': np.float32, 'zero_point': np.int32}, the JAX
package's types, so the sizes are equal byte for byte.
"""
from __future__ import annotations

import numpy as np

from ..registry import register_transform


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
