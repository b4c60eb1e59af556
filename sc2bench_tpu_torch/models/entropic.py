"""EntropicClassifier module (counterpart of `sc2bench_tpu/models/entropic.py`):
a ResNet split after one of its layers, with a factorized-prior entropy
bottleneck over the feature at the split, the fine-tuning config family
(`configs/ilsvrc2012/supervised_compression/fine-tuning/`).

The head (stem up to the split) and the tail (the rest up to fc) are the
base ResNet's own layers, so the key space is the base's under `base.`
plus `entropy_bottleneck.*`. At the 'avgpool' split the feature is the
pooled layer4 output, kept as (n, 2048, 1, 1) for the coder: one symbol
per channel.

The runtime reads the module-level deploy ops: `encode_ops(x, medians)`
gives the NCHW int32 symbols round(z - median), and
`decode_ops_to_logits(symbols, medians)` the tail's logits from them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops.entropy.factorized import EntropyBottleneck
from ..registry import register_model
from .resnet import RESNET_BUILDERS, ResNet

SPLIT_CHANNELS = {'stem': 64, 'layer1': 256, 'layer2': 512,
                  'layer3': 1024, 'layer4': 2048, 'avgpool': 2048}


class EntropicClassifierModule(nn.Module):
    """base head -> EntropyBottleneck -> base tail."""

    def __init__(self, base: ResNet, split_layer: str = 'layer1'):
        super().__init__()
        if split_layer not in SPLIT_CHANNELS:
            raise ValueError(f'unknown split layer {split_layer}')
        self.base = base
        self.split_layer = split_layer
        self.entropy_bottleneck = EntropyBottleneck(
            SPLIT_CHANNELS[split_layer])

    def _feature(self, x: torch.Tensor) -> torch.Tensor:
        if self.split_layer == 'avgpool':
            z = self.base.forward_until(x, 'layer4')
            return torch.mean(z, dim=(2, 3), keepdim=True)
        return self.base.forward_until(x, self.split_layer)

    def _tail(self, z_hat: torch.Tensor) -> torch.Tensor:
        if self.split_layer == 'avgpool':
            return self.base.forward_from(z_hat[:, :, 0, 0], 'avgpool')
        return self.base.forward_from(z_hat, self.split_layer)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """Logits without a bitstream. 'train': the feature plus noise from
        `generator`; any other mode: round(z - median) + median, which
        'finetune' detaches. With `io`, `io['eb_out'] = (z_hat,
        likelihoods)` for the rate loss (the likelihoods are computed only
        then)."""
        z = self._feature(x)
        eb_mode = 'noise' if mode == 'train' else 'dequantize'
        if io is None:
            z_hat = self.entropy_bottleneck.quantize(z, eb_mode, generator)
        else:
            z_hat, likelihoods = self.entropy_bottleneck(
                z, mode=eb_mode, generator=generator)
            io['eb_out'] = (z_hat, likelihoods)
        if mode == 'finetune':
            z_hat = z_hat.detach()
        return self._tail(z_hat)

    # ---- module-level deploy ops (the runtime's duck typing) -------------
    def encode_ops(self, x: torch.Tensor, medians: torch.Tensor) -> dict:
        z = self._feature(x)
        return {'symbols': torch.round(z - medians[:, None, None])
                .to(torch.int32)}

    def decode_ops_to_logits(self, symbols: torch.Tensor,
                             medians: torch.Tensor) -> torch.Tensor:
        return self._tail(symbols.to(torch.float32)
                          + medians[:, None, None])


@register_model
def entropic_classifier(base_name='resnet50', split_layer='layer1',
                        num_classes=1000, device=None, **kwargs
                        ) -> EntropicClassifierModule:
    """Builder of the fine-tuning family's configs, placed on `device`
    (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    base = RESNET_BUILDERS[base_name](num_classes=num_classes)
    return EntropicClassifierModule(base, split_layer).to(dev)
