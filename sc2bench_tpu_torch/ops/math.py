"""Numeric primitives for the entropy-model stack (counterpart of
`sc2bench_tpu/ops/math.py`).

`lower_bound`/`upper_bound` with CompressAI's pass-through gradients,
uniform-noise and straight-through quantization, and the host-side 16-bit
CDF quantizer, a copy of the JAX package's numpy function. Training noise
comes from an explicit `torch.Generator` on the tensor's device, never from
the global random state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.dist import all_reduce_sum, global_rows, is_multi


class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes x upward (a negative gradient). For a `replicated` x (a
    parameter's value, the same on every rank of a data-parallel group)
    the sign that decides is that of the group's summed gradient, so
    that the ranks' average is the global batch's gradient."""

    @staticmethod
    def forward(ctx, x, bound, replicated=False):
        ctx.save_for_backward(x)
        ctx.bound = bound
        ctx.replicated = replicated
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        sign = g
        if ctx.replicated and is_multi():
            sign = all_reduce_sum(g.detach().clone())
        return torch.where((x >= ctx.bound) | (sign < 0), g,
                           torch.zeros_like(g)), None, None


class _UpperBound(torch.autograd.Function):
    """min(x, bound); the gradient passes where x <= bound or where it
    pushes x downward (a positive gradient)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where((x <= ctx.bound) | (g > 0), g,
                           torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float,
                replicated: bool = False) -> torch.Tensor:
    """max(x, bound) with a gradient that still flows below the bound when
    it pushes x upward (likelihoods clipped at the bound keep training).
    `replicated`: x is a parameter's value, not a batch's (see
    `_LowerBound`)."""
    return _LowerBound.apply(x, bound, replicated)


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """min(x, bound) with the mirrored pass-through gradient."""
    return _UpperBound.apply(x, bound)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def quantize_noise(x: torch.Tensor, generator: torch.Generator
                   ) -> torch.Tensor:
    """Training-time quantization: x + U(-0.5, 0.5), the noise drawn from
    `generator` (on x's device). In a data-parallel group x is this
    rank's block of the global batch: the noise is drawn for the global
    batch and the block kept (`parallel.dist.global_rows`), as JAX draws
    it for the global array."""
    def draw(rows):
        out = torch.empty_like(x) if rows == x.shape[0] else torch.empty(
            (rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
        return out.uniform_(-0.5, 0.5, generator=generator)

    return x + global_rows(draw, x.shape[0])


def quantize_dequantize(x: torch.Tensor, means=None) -> torch.Tensor:
    """round(x - means) + means, with no gradient trick: callers detach."""
    if means is None:
        return torch.round(x)
    return torch.round(x - means) + means


def quantize_symbols(x: torch.Tensor, means=None) -> torch.Tensor:
    """Integer symbols for entropy coding: round(x - means) as int32."""
    if means is not None:
        x = x - means
    return torch.round(x).to(torch.int32)


def softplus_inv(y: float) -> float:
    """Inverse of softplus on floats (host-side init helper)."""
    return float(np.log(np.expm1(y)))


def pmf_to_quantized_cdf(pmf: np.ndarray, precision: int = 16) -> np.ndarray:
    """Quantize a pmf (including a final tail-mass entry) to an integer CDF
    with `2**precision` total mass and no zero-frequency symbols.

    Same semantics as CompressAI's C++ `pmf_to_quantized_cdf`: per-symbol
    `round(p * 2^precision)` in float32, integer renormalization by
    truncating division, partial sum with the final entry pinned to
    `2^precision`, then zero-width intervals widened by stealing one count
    from the lowest-frequency symbol with freq > 1. Returns an int32 cdf of
    length len(pmf)+1 with cdf[0]=0, cdf[-1]=2**precision."""
    pmf32 = np.asarray(pmf, dtype=np.float32)
    if np.any(pmf32 < 0) or not np.all(np.isfinite(pmf32)):
        raise ValueError('pmf must be finite and non-negative')
    total_mass = 1 << precision
    # C++: std::round(p * (1 << precision)) evaluated in float32
    freqs = np.round(pmf32 * np.float32(total_mass)).astype(np.uint64)
    total = int(freqs.sum())
    if total == 0:
        raise ValueError('pmf sums to zero')
    # integer renormalization: (2^precision * f) / total, truncating
    freqs = (np.uint64(total_mass) * freqs) // np.uint64(total)
    cdf = np.zeros(len(pmf32) + 1, dtype=np.int64)
    np.cumsum(freqs, out=cdf[1:])
    cdf[-1] = total_mass
    # A steal turns its own zero interval into 1 and lowers one interval
    # of freq > 1 by one: no other interval becomes or stops being zero, so
    # the zero intervals are found once, in the order they are fixed.
    for i in np.flatnonzero(cdf[:-1] == cdf[1:]):
        # steal one count from the lowest-frequency symbol with freq > 1
        # (the first of equals)
        freqs = np.diff(cdf)
        stealable = np.where(freqs > 1, freqs, np.iinfo(np.int64).max)
        best_steal = int(np.argmin(stealable))
        if freqs[best_steal] <= 1:
            raise ValueError(
                'cannot normalize pmf: too many symbols for precision')
        if best_steal < i:
            cdf[best_steal + 1:i + 1] -= 1
        else:
            cdf[i + 1:best_steal + 1] += 1
    if cdf[0] != 0 or cdf[-1] != total_mass or np.any(np.diff(cdf) <= 0):
        raise ValueError('quantized cdf is not a valid 16-bit table')
    return cdf.astype(np.int32)
