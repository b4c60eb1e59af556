"""Wrapper runtimes selected by a config's `key` (counterpart of the
`EntropicClassifier`, `SplitClassifier` and `wrap_model` of
`sc2bench_tpu/models/wrapper.py`), registered under 'wrapper'.

  EntropicClassifier  the runtime of an `EntropicClassifierModule` (the
                      fine-tuning family): the host wire over its
                      module-level deploy ops
  SplitClassifier     a `SplittableResNet` with a `SimpleBottleneck` (the
                      CR+BQ family): in eval, encoder -> compressor (a host
                      transform such as `SimpleQuantizer`) -> data size
                      -> decompressor -> decoder -> tail

The codec wrappers (input and feature compression) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import transforms  # noqa: F401  (fills the transform registry)
from ..registry import get as registry_get
from ..registry import register_wrapper
from .runtime import SplitClassifierRuntime


def _build_transform(cfg):
    """A registered transform from `{key, kwargs}`, a chain of them from a
    list, or None."""
    if cfg is None:
        return None
    if isinstance(cfg, (list, tuple)):
        transforms = [_build_transform(c) for c in cfg]

        def chain(x):
            for t in transforms:
                x = t(x)
            return x
        return chain
    return registry_get('transform', cfg['key'])(**cfg.get('kwargs', {}))


@register_wrapper
class EntropicClassifier(SplitClassifierRuntime):
    """Split classifier with an entropy bottleneck at a configurable split
    point, over an `EntropicClassifierModule`."""

    def __init__(self, module, analyzer_configs=None, device=None, **kwargs):
        super().__init__(module, analyzer_configs, device=device)


@register_wrapper
class SplitClassifier(SplitClassifierRuntime):
    """Naive split with a tensor quantizer pair as the compression: the
    latent of the `SimpleBottleneck` goes to the host, where `compressor`
    makes the object whose pickled size is accounted and `decompressor`
    restores it."""

    def __init__(self, module, analyzer_configs=None, compressor=None,
                 decompressor=None, device=None, **kwargs):
        super().__init__(module, analyzer_configs, device=device)
        self.compressor = _build_transform(compressor)
        self.decompressor = _build_transform(decompressor)

    @torch.no_grad()
    def __call__(self, x, generator: torch.Generator | None = None):
        """In training mode the runtime's forward; in eval the split path
        with the host transforms. Returns logits (n, K)."""
        if self.training:
            return super().__call__(x, generator)
        z = self._bneck.encode_latent(self._prep_input(x)).cpu().numpy()
        compressed = self.compressor(z) if self.compressor else z
        self.analyze(compressed)
        z = self.decompressor(compressed) if self.decompressor \
            else compressed
        z = torch.from_numpy(np.asarray(z, np.float32)).to(self.device)
        return self.module.forward_tail(
            self._bneck.decode_latent(z)).to(torch.float32)


def wrap_model(wrapper_model_config, model, **kwargs):
    """The wrapper of `wrapper_model_config['key']` around `model`, with
    the config's kwargs."""
    cls = registry_get('wrapper', wrapper_model_config['key'])
    return cls(model, **wrapper_model_config.get('kwargs', {}), **kwargs)
