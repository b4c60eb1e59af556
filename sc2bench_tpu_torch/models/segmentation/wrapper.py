"""Segmentation runtimes (counterpart of
`sc2bench_tpu/models/segmentation/wrapper.py`), the wrappers registered
under 'wrapper':

  CodecInputCompressionSegmentationModel   each image through a host codec
                                           transform (JPEG/WebP, BPG, VTM)
                                           and its post-transforms, then
                                           the segmentation model
  NeuralInputCompressionSegmentationModel  each image padded to a multiple
                                           of `factor` (64), through a
                                           neural codec's `compress`/
                                           `decompress`, cropped back to
                                           its size, then the model

and `SplitSegmentationRuntime`, the deploy runtime of a splittable
DeepLabv3 (an FP bottleneck in place of the stem and layer1): the
classification runtime's host and device wires, with the segmentation
decode tail (bottleneck decoder, dilated layer2-4, DeepLab head,
upsampling to the input's (h, w), which travels with each image's ops).

The wrappers take a batch as a list of HWC images and return the model's
{'out'[, 'aux']} logits, NCHW, on the batch stacked once (images of one
size, as the batch-1 test protocol gives them).
"""
from __future__ import annotations

import numpy as np
import torch

from ...analysis import AnalyzerHolder
from ...device import resolve_device
from ...registry import get as registry_get
from ...registry import register_wrapper
from ...transforms.misc import AdaptivePad
from ..registry import get_compression_model
from ..runtime import SplitClassifierRuntime, _nchw
from ..wrapper import _build_transform, _nchw_batch, to_pil
from .registry import load_segmentation_model


@register_wrapper
class CodecInputCompressionSegmentationModel(AnalyzerHolder):
    """Each image through `codec_encoder_decoder` (a transform returning
    the reconstruction, or (reconstruction, file size) whose size is
    analyzed) and `post_transform`, then the model's 'finetune'
    forward."""

    def __init__(self, segmentation_model, codec_encoder_decoder=None,
                 post_transform=None, analysis_config=None, device=None,
                 **kwargs):
        super().__init__((analysis_config or {}).get('analyzer_configs', []))
        self.device = resolve_device(device)
        self.codec = _build_transform(codec_encoder_decoder)
        self.post_transform = _build_transform(post_transform)
        self.module = segmentation_model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, images) -> dict:
        batch = []
        for img in images:
            if self.codec is not None:
                out = self.codec(to_pil(img))
                if isinstance(out, tuple):
                    img, file_size = out
                    self.analyze(file_size)
                else:
                    img = out
            if self.post_transform is not None:
                img = self.post_transform(img)
            batch.append(img)
        return self.module(_nchw_batch(batch, self.device), mode='finetune')


@register_wrapper
class NeuralInputCompressionSegmentationModel(AnalyzerHolder):
    """Each image through `pre_transform`, padded at the bottom and right
    to a multiple of `adaptive_pad_kwargs['factor']` (64 by default), the
    neural codec's `compress` (the compressed object analyzed when
    `analyzes_after_compress` or the analysis is active) and `decompress`
    on the device, cropped back to its size, and `post_transform`; then
    the model's 'finetune' forward."""

    def __init__(self, segmentation_model, compression_model=None,
                 pre_transform=None, post_transform=None,
                 analysis_config=None, adaptive_pad_kwargs=None,
                 device=None, **kwargs):
        analysis_config = analysis_config or {}
        super().__init__(analysis_config.get('analyzer_configs', []))
        self.device = resolve_device(device)
        self.analyzes_after_compress = analysis_config.get(
            'analyzes_after_compress', False)
        self.compression_model = compression_model
        self.pre_transform = _build_transform(pre_transform)
        self.post_transform = _build_transform(post_transform)
        self.adaptive_pad = AdaptivePad(
            **(adaptive_pad_kwargs or {'factor': 64}),
            returns_org_patch_size=True)
        self.module = segmentation_model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, images) -> dict:
        batch = []
        for img in images:
            if self.pre_transform is not None:
                img = self.pre_transform(img)
            img = np.asarray(img, np.float32)
            if self.compression_model is None:
                x = _nchw_batch([img], self.device)
            else:
                padded, (h, w) = self.adaptive_pad(img)
                compressed = self.compression_model.compress(
                    _nchw_batch([padded], self.device))
                if self.analyzes_after_compress or self.activated_analysis:
                    self.analyze(compressed)
                x = self.compression_model.decompress(
                    **compressed)[:, :, :h, :w]
            if self.post_transform is not None:
                x = _nchw_batch([self.post_transform(
                    x[0].permute(1, 2, 0).cpu().numpy())], self.device)
            batch.append(x.to(torch.float32))
        return self.module(torch.cat(batch), mode='finetune')


def get_wrapped_segmentation_model(wrapper_model_config, device=None,
                                   **kwargs):
    """The wrapper of a `models.wrapper` config on `device` (CUDA unless
    asked otherwise): its `segmentation_model` (`load_segmentation_model`)
    and, for a `compression_model` block, the neural codec's runtime
    (unless `compression_model` is given in `kwargs`)."""
    dev = resolve_device(device)
    model_config = wrapper_model_config.get(
        'segmentation_model', wrapper_model_config.get('model'))
    module = load_segmentation_model(model_config, device=dev)
    cm_cfg = wrapper_model_config.get('compression_model')
    if cm_cfg is not None and 'compression_model' not in kwargs:
        kwargs['compression_model'] = get_compression_model(cm_cfg,
                                                            device=dev)
    cls = registry_get('wrapper', wrapper_model_config['key'])
    return cls(module, **wrapper_model_config.get('kwargs', {}), device=dev,
               **kwargs)


class SplitSegmentationRuntime(SplitClassifierRuntime):
    """The deploy runtime of a splittable DeepLabv3 (`deeplabv3_model`
    with a `bottleneck_config`): `update()`, the host wire
    (`stream_deploy`), the device-rANS wire (`stream_deploy_device`, batch
    1 or `wire_batch=k` groups of one image shape, lanes per shape) and
    the data-size analysis, each image's output the main head's logits
    (1, K, H, W) at its own size.

    As in the JAX package, `__call__` codes on the host wire (the cyclic
    int16 coder) once the tables are built and the runtime is in eval
    mode, and is otherwise the 'train' forward (its noise from a generator
    seeded with 0 unless given), which returns {'out'[, 'aux']}; an image
    that escapes the device wire (`ok=False` or `valid=False`) is re-coded
    on that host wire and accounted with its bytes. A bottleneck without
    an entropy model (CR+BQ's `SimpleBottleneck`) has no codec: `update()`
    returns False and `__call__` is the 'train' forward. A hyperprior
    bottleneck, which no VOC config uses and the JAX runtime does not
    serve, raises."""

    def __init__(self, module, analyzer_configs=None, device=None):
        super().__init__(module, analyzer_configs, device=device)
        if self.hyper:
            raise ValueError('SplitSegmentationRuntime serves factorized-'
                             'prior bottlenecks (and entropy-free ones); '
                             f'got {type(self._bneck).__name__}')

    @staticmethod
    def _split_bottleneck(module):
        return module.backbone.bottleneck_layer

    def _decode_tail(self, flat, shape, input_hw=None, module=None):
        if input_hw is None:
            raise ValueError('the segmentation decode tail needs the input '
                             "image's (h, w)")
        h, w, c = shape
        # contiguous NCHW, as the model trains: the permuted view would
        # carry a channels-last layout down the tail, where cuDNN runs
        # ASPP's dilated convolutions at batch 8 with a direct kernel
        # about 80x slower than at batch 4
        sym = _nchw(flat.reshape(-1, h, w, c))
        m = self.module if module is None else module
        return m.decode_ops_to_output(
            sym, self._medians, input_hw).to(torch.float32)

    @torch.no_grad()
    def __call__(self, x, generator: torch.Generator | None = None):
        if self.bottleneck_updated and not self.training:
            return self._recode_on_host(x)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = self.module(self._prep_input(x), mode='train',
                          generator=generator)
        return {k: v.to(torch.float32) for k, v in out.items()}

    _recode_on_host = SplitClassifierRuntime._recode_on_host_wire
