"""Model name -> module resolution (counterpart of
`sc2bench_tpu/models/registry.py`): the builtin ResNet classifiers first,
then the 'model' registry."""
from __future__ import annotations

from ..device import resolve_device
from ..registry import lookup, names
from .resnet import RESNET_BUILDERS


def load_classification_model(model_config, num_classes=1000, device=None):
    """A classifier built from its config (`key` and `kwargs`), with fresh
    weights, on `device` (CUDA unless asked otherwise); loading a
    checkpoint is the caller's job."""
    key = model_config.get('key', model_config.get('name'))
    kwargs = dict(model_config.get('kwargs', {}))
    kwargs.setdefault('num_classes', num_classes)
    if key in RESNET_BUILDERS:
        dev = resolve_device(device)
        return RESNET_BUILDERS[key](
            num_classes=kwargs.get('num_classes', 1000)).to(dev)
    entry = lookup('model', key)
    if entry is not None:
        return entry(device=device, **kwargs)
    raise KeyError(f'model `{key}` not found (builtin: '
                   f'{sorted(RESNET_BUILDERS)}; registry: '
                   f"{names('model')})")
