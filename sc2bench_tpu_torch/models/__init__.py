"""Importing this package fills the 'layer' and 'model' registries (the
config's `dependencies` import it)."""
from . import backbone, layer, registry, resnet  # noqa: F401
