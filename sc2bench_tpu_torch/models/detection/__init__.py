"""Object detection (counterpart of `sc2bench_tpu/models/detection`):
Faster R-CNN + FPN over the (splittable) ResNet, its input transform and
its split runtime. Importing it fills the 'model' registry."""
from . import base, fpn, rcnn, registry, transform, wrapper  # noqa: F401
