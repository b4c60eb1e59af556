"""Conditional Gaussian entropy model of the scale and mean-scale
hyperpriors (counterpart of `sc2bench_tpu/ops/entropy/gaussian.py`).

The model has no learned parameters. `likelihood` is the probability of
the unit-width bin around each value under N(means, scales^2), with the
scales and the result floored by `lower_bound` (pass-through gradients).
The forward quantizes as the factorized prior does:
  'noise'      training: x + U(-0.5, 0.5), the noise from a generator
  'dequantize' fine-tune: round(x - means) + means
`build_indexes` maps each predicted scale to its row of the 64-entry
log-spaced scale table, the row the Gaussian coding tables code it with.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..math import lower_bound, quantize_noise

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def get_scale_table(minimum: float = SCALES_MIN, maximum: float = SCALES_MAX,
                    levels: int = SCALES_LEVELS) -> np.ndarray:
    """Log-spaced scale table (host-side numpy)."""
    return np.exp(np.linspace(np.log(minimum), np.log(maximum), levels))


def _standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF through the complementary error function."""
    return 0.5 * torch.special.erfc(-(2.0 ** -0.5) * x)


class GaussianConditional(nn.Module):
    """Stateless; `scale_bound` floors the predicted scales."""

    def __init__(self, scale_bound: float = SCALES_MIN,
                 tail_mass: float = 1e-9, likelihood_bound: float = 1e-9):
        super().__init__()
        self.scale_bound = float(scale_bound)
        self.tail_mass = float(tail_mass)
        self.likelihood_bound = float(likelihood_bound)

    def likelihood(self, x: torch.Tensor, scales: torch.Tensor,
                   means: torch.Tensor | None = None) -> torch.Tensor:
        """P(round(x)) under N(means, scales^2) with unit-width bins."""
        if means is not None:
            x = x - means
        scales = lower_bound(scales, self.scale_bound)
        values = torch.abs(x)
        upper = _standardized_cumulative((0.5 - values) / scales)
        lower = _standardized_cumulative((-0.5 - values) / scales)
        return lower_bound(upper - lower, self.likelihood_bound)

    def forward(self, x: torch.Tensor, scales: torch.Tensor,
                means: torch.Tensor | None = None, mode: str = 'noise',
                generator: torch.Generator | None = None):
        """(y_hat, likelihoods), both shaped like `x`."""
        if mode == 'noise':
            if generator is None:
                raise ValueError("the 'noise' mode needs a torch.Generator")
            y_hat = quantize_noise(x, generator)
        elif mode == 'dequantize':
            y_hat = torch.round(x) if means is None \
                else torch.round(x - means) + means
        else:
            raise ValueError(f'unknown mode: {mode}')
        return y_hat, self.likelihood(y_hat, scales, means)

    def build_indexes(self, scales: torch.Tensor,
                      scale_table: torch.Tensor) -> torch.Tensor:
        """Table row of each scale: the count of table entries (the last
        excluded) strictly below it, int32."""
        scales = torch.clamp_min(scales, self.scale_bound)
        table = scale_table[:-1].to(scales.dtype)
        return (scales[..., None] > table).sum(dim=-1).to(torch.int32)
