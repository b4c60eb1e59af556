"""Factorized-prior entropy bottleneck (counterpart of
`sc2bench_tpu/ops/entropy/factorized.py:EntropyBottleneck`).

The learned univariate CDF is a per-channel composition of K monotone
affine+gating stages, evaluated with channels leading, (C, 1, M). The
forward takes an NCHW latent and returns (y_hat, likelihoods):
  'noise'      training: y + U(-0.5, 0.5), the noise from a generator
  'dequantize' fine-tune: round(y - median) + median
Deploy needs the medians and the table construction (`tables.py`).
Parameter names and shapes are CompressAI's: `_matrix{i}` (C, r, d),
`_bias{i}` and `_factor{i}` (C, r, 1), `quantiles` (C, 1, 3).

Training memory: autograd keeps every (C, r, 2M) intermediate of the
density, 61 GB for the 256-channel layer1 feature of the fine-tuning
family at batch 256. When the intermediates would exceed `CHUNK_ELEMS`
and a gradient is wanted, the likelihood is evaluated in channel chunks
under activation checkpointing: each chunk keeps only its input and is
recomputed in the backward pass, one chunk at a time. Each channel's
density is independent of the others: the values are the whole pass's up
to the rounding of the batched products.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..math import lower_bound, quantize_noise, softplus_inv

# elements of one (C, r, 2M) density intermediate above which the
# likelihood's backward is checkpointed in channel chunks
CHUNK_ELEMS = 2 ** 27


class EntropyBottleneck(nn.Module):
    """Learned factorized prior over the channel axis."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9,
                 likelihood_bound: float = 1e-9):
        super().__init__()
        self.tail_mass = tail_mass
        self.likelihood_bound = likelihood_bound
        dims = (1,) + tuple(filters) + (1,)
        self._stages = len(filters) + 1
        self._width = max(filters)
        scale = init_scale ** (1.0 / self._stages)
        for i in range(self._stages):
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

    # ---- density model -------------------------------------------------
    def logits_cumulative(self, inputs: torch.Tensor,
                          stop_gradient: bool = False,
                          rows: slice = slice(None)) -> torch.Tensor:
        """c(x) logits of `inputs` (C, 1, M), or of the channels `rows` of
        the density for inputs of those channels; sigmoid(c(x)) is the
        CDF. `stop_gradient` detaches the density parameters."""
        logits = inputs
        for i in range(self._stages):
            m = F.softplus(getattr(self, f'_matrix{i}')[rows])
            b = getattr(self, f'_bias{i}')[rows]
            if stop_gradient:
                m, b = m.detach(), b.detach()
            logits = torch.matmul(m, logits) + b
            if i < self._stages - 1:
                f = torch.tanh(getattr(self, f'_factor{i}')[rows])
                if stop_gradient:
                    f = f.detach()
                logits = logits + f * torch.tanh(logits)
        return logits

    def _likelihood(self, inputs: torch.Tensor) -> torch.Tensor:
        """P(y_hat) = c(y+.5) - c(y-.5) of `inputs` (C, 1, M), with the sign
        trick for the tails (the sign carries no gradient); both edges in
        one pass of the density. Checkpointed in channel chunks when the
        intermediates are large and a gradient is wanted (module doc)."""
        c, _, m = inputs.shape
        rows = max(CHUNK_ELEMS // (self._width * 2 * m), 1)
        if c <= rows or not torch.is_grad_enabled():
            return self._likelihood_rows(inputs, slice(None))
        return torch.cat([
            checkpoint(self._likelihood_rows, inputs[lo:lo + rows],
                       slice(lo, lo + rows), use_reentrant=False)
            for lo in range(0, c, rows)])

    def _likelihood_rows(self, inputs: torch.Tensor,
                         rows: slice) -> torch.Tensor:
        m = inputs.shape[-1]
        both = self.logits_cumulative(
            torch.cat([inputs - 0.5, inputs + 0.5], dim=-1), rows=rows)
        lower, upper = both[..., :m], both[..., m:]
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper)
                         - torch.sigmoid(sign * lower))

    # ---- forward -------------------------------------------------------
    def quantize(self, x: torch.Tensor, mode: str,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """y_hat of an NCHW latent alone ('noise' draws its noise from
        `generator`, which it needs)."""
        if mode == 'noise':
            if generator is None:
                raise ValueError("the 'noise' mode needs a torch.Generator")
            return quantize_noise(x, generator)
        if mode == 'dequantize':
            medians = self.medians().detach()[:, None, None]
            return torch.round(x - medians) + medians
        raise ValueError(f'unknown mode: {mode}')

    def forward(self, x: torch.Tensor, mode: str = 'noise',
                generator: torch.Generator | None = None):
        """(y_hat, likelihoods) of an NCHW latent, both shaped like `x`."""
        n, c, h, w = x.shape
        y_hat = self.quantize(x, mode, generator)
        # (N, C, H, W) -> (C, 1, N*H*W) for the channelwise density model
        flat = y_hat.permute(1, 0, 2, 3).reshape(c, 1, -1)
        likelihood = lower_bound(self._likelihood(flat),
                                 self.likelihood_bound)
        likelihood = likelihood.reshape(c, n, h, w).permute(1, 0, 2, 3)
        return y_hat, likelihood

    def aux_loss(self) -> torch.Tensor:
        """Quantile loss of the aux optimizer: only `quantiles` get a
        gradient (the density parameters are detached)."""
        logits = self.logits_cumulative(self.quantiles, stop_gradient=True)
        t = float(np.log(2.0 / self.tail_mass - 1.0))
        target = torch.tensor([[-t, 0.0, t]], dtype=logits.dtype,
                              device=logits.device)
        return torch.sum(torch.abs(logits - target))

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
