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
  models/              ResNet, the FP/SHP/MSHP and CR+BQ bottlenecks,
                       SplittableResNet, the fine-tuning family's
                       EntropicClassifierModule, the deploy runtime and
                       the EntropicClassifier/SplitClassifier wrappers
  transforms/          the CR+BQ tensor quantizers
  train/, loss.py      the training boxes, losses and optimizers
  tasks/               the classification CLI
  analysis.py          data-size accounting
  utils/convert.py     Flax variables -> this package's state_dict
  csrc/                hand-written CUDA sources, built at first use
"""

__version__ = '0.1.0'
