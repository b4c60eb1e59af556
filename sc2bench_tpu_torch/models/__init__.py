"""Importing this package fills the 'layer', 'model' and 'wrapper'
registries (the config's `dependencies` import it)."""
from . import (backbone, entropic, layer, registry, resnet,  # noqa: F401
               wrapper, zoo, zoo_jahp)
