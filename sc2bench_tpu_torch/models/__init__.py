"""Importing this package fills the 'layer', 'model' and 'wrapper'
registries (the config's `dependencies` import it)."""
from . import (backbone, detection, efficientnet, entropic,  # noqa: F401
               hybrid_vit, inception, layer, regnet, registry, resnest,
               resnet, segmentation, wrapper, zoo, zoo_jahp)
