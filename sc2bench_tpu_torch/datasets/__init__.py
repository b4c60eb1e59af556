"""Importing this package fills the 'dataset' registry."""
from . import image  # noqa: F401
