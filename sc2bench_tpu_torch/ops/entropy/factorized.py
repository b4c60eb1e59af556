"""Factorized-prior entropy bottleneck (counterpart of
`sc2bench_tpu/ops/entropy/factorized.py:EntropyBottleneck`).

Deploy needs the learned density's parameters, the medians and the table
construction (`tables.py`); the fine-tune forward needs the 'dequantize'
mode. The noise and likelihood modes come with the training slice.
Parameter names and shapes are CompressAI's:
`_matrix{i}` (C, r, d), `_bias{i}` and `_factor{i}` (C, r, 1),
`quantiles` (C, 1, 3).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..math import softplus_inv


class EntropyBottleneck(nn.Module):
    """Learned factorized prior over the channel axis."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3),
                 init_scale: float = 10.0):
        super().__init__()
        dims = (1,) + tuple(filters) + (1,)
        k = len(filters) + 1
        scale = init_scale ** (1.0 / k)
        for i in range(k):
            init = softplus_inv(1.0 / scale / dims[i + 1])
            self.register_parameter(f'_matrix{i}', nn.Parameter(torch.full(
                (channels, dims[i + 1], dims[i]), init, dtype=torch.float32)))
            self.register_parameter(f'_bias{i}', nn.Parameter(
                torch.empty(channels, dims[i + 1], 1).uniform_(-0.5, 0.5)))
            if i < len(filters):
                self.register_parameter(f'_factor{i}', nn.Parameter(
                    torch.zeros(channels, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.tensor(
            [[-init_scale, 0.0, init_scale]],
            dtype=torch.float32).repeat(channels, 1, 1))

    def medians(self) -> torch.Tensor:
        """Per-channel medians of the learned density, shape (C,)."""
        return self.quantiles[:, 0, 1]

    def forward(self, x: torch.Tensor, mode: str = 'dequantize'
                ) -> torch.Tensor:
        """Quantized latent y_hat of an NCHW latent. 'dequantize' (the
        post-update fine-tune forward): round(y - median) + median."""
        if mode == 'noise':
            raise NotImplementedError(
                "the 'noise' mode and the likelihoods come with the "
                'training slice (ROADMAP Queue A item 6)')
        if mode != 'dequantize':
            raise ValueError(f'unknown mode: {mode}')
        medians = self.medians().detach()[:, None, None]
        return torch.round(x - medians) + medians

    def numpy_params(self) -> dict:
        """The density parameters as host float32 arrays under the JAX
        package's names (`matrix_i`, `bias_i`, `factor_i`, `quantiles`),
        the input of `tables.build_factorized_tables`."""
        out = {}
        for name, p in self.named_parameters():
            key = name.lstrip('_')
            for kind in ('matrix', 'bias', 'factor'):
                if key.startswith(kind):
                    key = f'{kind}_{key[len(kind):]}'
            out[key] = p.detach().cpu().numpy().astype(np.float32)
        return out
