"""Importing this package fills the 'dataset' registry."""
from . import coco, image, voc  # noqa: F401
