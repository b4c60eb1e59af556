"""Importing this package fills the 'layer', 'model' and 'wrapper'
registries (the config's `dependencies` import it)."""
from . import (backbone, efficientnet, entropic, hybrid_vit,  # noqa: F401
               layer, regnet, registry, resnet, segmentation, wrapper, zoo,
               zoo_jahp)
