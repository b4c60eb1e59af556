"""Importing this package fills the 'dataset' registry."""
from . import image, voc  # noqa: F401
