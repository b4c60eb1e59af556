"""sc2bench_tpu_torch: the PyTorch/CUDA port of `sc2bench_tpu`.

The module paths and class names mirror the JAX package so that each
counterpart is easy to find; inside, the code is PyTorch (NCHW convs,
`nn.Module`s, an explicit `device`). The package imports nothing of JAX
and nothing of `sc2bench_tpu`: where it needs code from there it keeps its
own copy.

Ported so far:
  device.py            default-device helper (CUDA unless asked)
  ops/                 GDN, factorized entropy bottleneck, Gaussian
                       conditional, coding tables, the rANS codecs and
                       their CUDA kernels, the host coder
  models/              ResNet (dilated stages too), the FP/SHP/MSHP and
                       CR+BQ bottlenecks, SplittableResNet, RegNetY, the
                       hybrid ViT, EfficientNet, the fine-tuning family's
                       EntropicClassifierModule, the image-codec zoo, the
                       deploy runtime and the wrappers; segmentation/:
                       DeepLabv3, its split runtime and the VOC wrappers;
                       detection/: Faster, Mask and Keypoint R-CNN +
                       FPN, RetinaNet and the split runtime (box ops,
                       NMS and RoIAlign in ops/); the
                       batch-1 serving pool over several cards
  datasets/            image folders, VOC, COCO and the synthetic stand-ins
  transforms/          the codec transforms, quantizers and collators
  train/, loss.py      the training boxes, losses, optimizers and the
                       classification, segmentation and detection engines
  tasks/               the classification, segmentation and detection CLIs
  analysis.py          data-size accounting
  parallel/            data parallelism over torch.distributed (the
                       process group, gradient all-reduce, the global
                       batch's noise)
  utils/               Flax variables -> this package's state_dict,
                       checkpoints, metrics, the segmentation and COCO
                       bbox, segm and keypoint evaluators, the profiler
                       trace
  csrc/                hand-written CUDA sources, built at first use
"""

__version__ = '0.1.0'
