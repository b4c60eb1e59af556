"""Split-point bottleneck layers over NCHW (counterpart of
`sc2bench_tpu/models/layer.py`).

The deploy path uses `encode_ops` (latent -> integer symbols
round(y - median)) and `decode_ops` (symbols -> decoded feature). Symbols
stay NCHW here; the runtime flattens them channels-last before coding.
`forward(x, mode='train', generator=...)` is the training forward (noisy
latent, likelihoods for the rate loss); `forward(x, mode='finetune')` the
deterministic forward without a bitstream. Layers register under the
'layer' namespace of `registry.py`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.entropy.factorized import EntropyBottleneck
from ..ops.gdn import GDN1
from ..registry import get, register_layer


@register_layer
class FPBasedResNetBottleneck(nn.Module):
    """Factorized-prior bottleneck replacing ResNet stem+layer1: 3-conv GDN
    encoder (stride 4 total), entropy bottleneck over the latent, 3-conv
    IGDN decoder. CompressAI key space (`encoder.0` ... `decoder.4`,
    `entropy_bottleneck`)."""

    def __init__(self, num_input_channels: int = 3,
                 num_bottleneck_channels: int = 24,
                 num_target_channels: int = 256):
        super().__init__()
        enc = [num_input_channels, num_bottleneck_channels * 4,
               num_bottleneck_channels * 2, num_bottleneck_channels]
        dec = [enc[-1], num_target_channels * 2, num_target_channels,
               num_target_channels]
        self.encoder = nn.Sequential(
            nn.Conv2d(enc[0], enc[1], 5, stride=2, padding=2, bias=False),
            GDN1(enc[1]),
            nn.Conv2d(enc[1], enc[2], 5, stride=2, padding=2, bias=False),
            GDN1(enc[2]),
            nn.Conv2d(enc[2], enc[3], 2, stride=1, padding=0, bias=False))
        self.decoder = nn.Sequential(
            nn.Conv2d(dec[0], dec[1], 2, stride=1, padding=1, bias=False),
            GDN1(dec[1], inverse=True),
            nn.Conv2d(dec[1], dec[2], 2, stride=1, padding=0, bias=False),
            GDN1(dec[2], inverse=True),
            nn.Conv2d(dec[2], dec[3], 2, stride=1, padding=1, bias=False))
        self.entropy_bottleneck = EntropyBottleneck(enc[3])
        self.out_channels = dec[3]

    def latent_shape(self, height: int, width: int) -> tuple:
        """(h, w, c) of the latent for an input of height x width."""
        for m in self.encoder:
            if isinstance(m, nn.Conv2d):
                (k, _), (s, _), (p, _) = m.kernel_size, m.stride, m.padding
                height = (height + 2 * p - k) // s + 1
                width = (width + 2 * p - k) // s + 1
        return height, width, self.encoder[-1].out_channels

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """Encoder, quantization, decoder. 'train' (before `update()`): the
        latent plus uniform noise from `generator`, and `io['eb_out'] =
        (y_hat, likelihoods)` for the rate loss when `io` is given.
        'finetune' (after it): the latent dequantized with the medians,
        round(y - median) + median, carrying no gradient."""
        y = self.encoder(x)
        if mode == 'train':
            y_hat, likelihoods = self.entropy_bottleneck(
                y, mode='noise', generator=generator)
            if io is not None:
                io['eb_out'] = (y_hat, likelihoods)
        elif mode == 'finetune':
            # the likelihoods are not needed: the quantized latent alone
            y_hat = self.entropy_bottleneck.quantize(y, 'dequantize')
            y_hat = y_hat.detach()
        else:
            raise ValueError(f'unknown mode {mode} (deploy uses encode_ops)')
        return self.decoder(y_hat)

    def encode_ops(self, x: torch.Tensor, medians: torch.Tensor) -> dict:
        """Latent integer symbols round(y - median), NCHW int32."""
        y = self.encoder(x)
        symbols = torch.round(y - medians[:, None, None]).to(torch.int32)
        return {'symbols': symbols}

    def decode_ops(self, symbols: torch.Tensor,
                   medians: torch.Tensor) -> torch.Tensor:
        y_hat = symbols.to(torch.float32) + medians[:, None, None]
        return self.decoder(y_hat)


def get_layer(key: str, **kwargs) -> nn.Module:
    """Bottleneck layer by registry name; `KeyError` names the registered
    ones when `key` is not among them."""
    return get('layer', key)(**kwargs)
