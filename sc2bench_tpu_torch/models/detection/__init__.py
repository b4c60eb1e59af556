"""Object detection (counterpart of `sc2bench_tpu/models/detection`):
Faster, Mask and Keypoint R-CNN + FPN and RetinaNet over the (splittable)
ResNet, their heads, the input transform and the split runtime.
Importing it fills the 'model' registry."""
from . import (base, fpn, heads, rcnn, registry, retinanet,  # noqa: F401
               transform, wrapper)
