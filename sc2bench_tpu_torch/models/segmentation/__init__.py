"""Semantic segmentation (counterpart of `sc2bench_tpu/models/segmentation`):
DeepLabv3 over the dilated, optionally splittable ResNet, its split
runtime and the input-compression wrappers. Importing it fills the
'model' and 'wrapper' registries."""
from . import base, deeplabv3, registry, wrapper  # noqa: F401
