"""Model name -> module resolution (counterpart of
`sc2bench_tpu/models/registry.py`): the builtin ResNet classifiers first,
then the 'model' registry; and the neural image codecs of the
input-compression family (`get_compression_model`, the zoo of
`zoo.py`/`zoo_jahp.py`)."""
from __future__ import annotations

import inspect

from ..device import resolve_device
from ..registry import lookup, names
from .backbone import get_backbone  # noqa: F401  (JAX's registry has it)
from .resnet import RESNET_BUILDERS

# the codec names a `compression_model` block may give (CompressAI's zoo
# names beside the reference's); the JAX package's tuple leaves out the
# joint autoregressive names, which its zoo registers all the same
COMPRESSION_MODEL_FAMILIES = (
    'factorized_prior', 'bmshj2018_factorized',
    'scale_hyperprior', 'bmshj2018_hyperprior',
    'mean_scale_hyperprior', 'mbt2018_mean',
    'joint_autoregressive_hierarchical_prior', 'mbt2018',
)


def get_compression_model(compression_model_config, device=None):
    """The runtime of the neural image codec of a `compression_model`
    block (`key` one of `COMPRESSION_MODEL_FAMILIES`, `kwargs` such as
    quality, `ckpt`), tables built, on `device` (CUDA unless asked
    otherwise)."""
    from .zoo import build_image_codec
    key = compression_model_config['key']
    if key not in COMPRESSION_MODEL_FAMILIES:
        raise KeyError(f'compression model `{key}` is not a neural image '
                       f'codec: {COMPRESSION_MODEL_FAMILIES}')
    return build_image_codec(key,
                             ckpt=compression_model_config.get('ckpt'),
                             device=device,
                             **compression_model_config.get('kwargs', {}))


def load_classification_model(model_config, num_classes=1000, device=None,
                              image_size=None):
    """A classifier built from its config (`key` and `kwargs`), with fresh
    weights, on `device` (CUDA unless asked otherwise); loading a
    checkpoint is the caller's job. A builder that takes `image_size` (the
    hybrid ViT's, whose position embedding has one token per patch) gets
    `image_size` unless the config sets it."""
    key = model_config.get('key', model_config.get('name'))
    kwargs = dict(model_config.get('kwargs', {}))
    kwargs.setdefault('num_classes', num_classes)
    if key in RESNET_BUILDERS:
        dev = resolve_device(device)
        return RESNET_BUILDERS[key](
            num_classes=kwargs.get('num_classes', 1000)).to(dev)
    entry = lookup('model', key)
    if entry is not None:
        if image_size is not None \
                and 'image_size' in inspect.signature(entry).parameters:
            kwargs.setdefault('image_size', tuple(image_size))
        return entry(device=device, **kwargs)
    raise KeyError(f'model `{key}` not found (builtin: '
                   f'{sorted(RESNET_BUILDERS)}; registry: '
                   f"{names('model')})")
