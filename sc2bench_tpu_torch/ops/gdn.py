"""GDN / IGDN normalization over NCHW (counterpart of
`sc2bench_tpu/ops/gdn.py:GDN1`).

The channel mix `norm_i = beta_i + sum_j gamma[i, j] |x_j|` is a 1x1
convolution of |x| with weight gamma and bias beta (CompressAI's layout).

Parameterization matches CompressAI's `NonNegativeParametrizer`:
stored = sqrt(max(value + pedestal, pedestal)); effective =
lower_bound(stored, bound)^2 - pedestal, with pedestal = 2**-18 and
bound = sqrt(minimum + pedestal).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .math import lower_bound

_PEDESTAL = 2.0 ** -18


def nonneg_init(value: np.ndarray) -> np.ndarray:
    """Transform an initial non-negative value into stored (sqrt) space."""
    return np.sqrt(np.maximum(value + _PEDESTAL, _PEDESTAL))


def nonneg_forward(stored: torch.Tensor, minimum: float) -> torch.Tensor:
    bound = (minimum + _PEDESTAL) ** 0.5
    return lower_bound(stored, bound, replicated=True) ** 2 - _PEDESTAL


class GDN1(nn.Module):
    """Simplified GDN: y = x / (beta + sum_j gamma_ij |x_j|); the inverse
    multiplies instead of divides. Input layout NCHW."""

    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.beta_min = beta_min
        self.beta = nn.Parameter(torch.as_tensor(
            nonneg_init(np.ones(channels)), dtype=torch.float32))
        self.gamma = nn.Parameter(torch.as_tensor(
            nonneg_init(gamma_init * np.eye(channels)), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = nonneg_forward(self.beta, self.beta_min)
        gamma = nonneg_forward(self.gamma, 0.0)
        norm = F.conv2d(torch.abs(x), gamma[:, :, None, None], beta)
        return x * norm if self.inverse else x / norm
