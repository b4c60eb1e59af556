"""Detection runtimes (counterpart of
`sc2bench_tpu/models/detection/wrapper.py`).

`DetectionRuntime` runs a detector on a list of HWC images: the host
transform (resize, normalize, pad to the square canvas), the 'finetune'
forward and `postprocess_detections` on the device, and each image's
valid detections scaled back to its own coordinates ({'boxes', 'scores',
'labels'}, numpy). `InputCompressionDetectionModel`, registered under
'wrapper', is that runtime with a compressing transform
(`RCNNTransformWithCompression`): each image through a host codec
(JPEG/WebP, BPG) or a neural codec's `compress`/`decompress` (the zoo's
runtimes on their host wire) before the detector, its size accounted.
`get_wrapped_detection_model` builds it from a `models.wrapper` config.

`SplitDetectionRuntime` serves a `faster_rcnn_model` whose backbone body
has an FP bottleneck on the classification runtime's two wires: the host
wire (`stream_detect`, and `detect` for one batch: the encoder's int16
symbols coded on the host's cyclic coder) and the device-rANS wire
(`stream_detect_device`, batch 1 or `wire_batch=k` groups of one canvas
shape, lanes per shape). Each image's output is the JAX package's dense
dict on its canvas: {'boxes' (1, 100, 4), 'scores', 'labels', 'valid'
(1, 100)}. The decode tail (bottleneck decoder, layer2-4, FPN, RPN, box
head, `postprocess_detections`) runs on contiguous NCHW. An image that
escapes the device wire is re-coded on the host wire and accounted with
those bytes. Each image is accounted as {'strings': [[bytes]], 'shape':
the latent's (h, w)}, as in JAX.

A bottleneck without an entropy model (CR+BQ's `SimpleBottleneck`) has no
codec: `update()` returns False and the engine tests the plain forward
with no data size, as the JAX engine does.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import transforms  # noqa: F401  (fills the transform registry)
from ...analysis import AnalyzerHolder
from ...device import resolve_device
from ...registry import get as registry_get
from ...registry import register_wrapper
from ..registry import get_compression_model
from ..runtime import SplitClassifierRuntime, _nchw
from .rcnn import postprocess_detections
from .registry import load_detection_model
from .transform import RCNNTransform, RCNNTransformWithCompression


class DetectionRuntime(AnalyzerHolder):
    """Transform on the host, the detector's 'finetune' forward and
    `postprocess_detections` on `device` (CUDA unless asked otherwise);
    per image, its valid detections divided by its resize scale."""

    def __init__(self, module, transform=None, analyzer_configs=None,
                 device=None):
        super().__init__(analyzer_configs or [])
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.transform = transform or RCNNTransform()

    @torch.no_grad()
    def __call__(self, images) -> list:
        batch, scales, _ = self.transform(list(images))
        x = torch.from_numpy(np.ascontiguousarray(
            batch.transpose(0, 3, 1, 2))).to(self.device)
        dets = {k: v.cpu().numpy() for k, v in postprocess_detections(
            self.module(x, mode='finetune')).items()}
        results = []
        for i in range(len(batch)):
            valid = dets['valid'][i]
            results.append({'boxes': dets['boxes'][i][valid] / scales[i],
                            'scores': dets['scores'][i][valid],
                            'labels': dets['labels'][i][valid]})
        return results


@register_wrapper
class InputCompressionDetectionModel(DetectionRuntime):
    """A detector whose transform compresses each input: `codec_config`
    (a registered transform, built with `returns_file_size=True`) or
    `compression_model` (a neural codec runtime). The first analyzer of
    `analysis_config` receives every image's size; by default a
    `FileSizeAccumulator` in KB of the codec's file sizes, or with a
    neural codec a `FileSizeAnalyzer` in KB of its compressed objects (the
    JAX package's default accumulator cannot take an object).
    `transform_kwargs` go to `RCNNTransformWithCompression` (min_size,
    max_size, ...)."""

    def __init__(self, detection_module, codec_config=None,
                 compression_model=None, analysis_config=None,
                 transform_kwargs=None, device=None, **kwargs):
        key = 'FileSizeAnalyzer' if compression_model is not None \
            and codec_config is None else 'FileSizeAccumulator'
        analyzer_configs = (analysis_config or {}).get(
            'analyzer_configs', [{'key': key, 'kwargs': {'unit': 'KB'}}])
        super().__init__(detection_module, analyzer_configs=analyzer_configs,
                         device=device)
        compressor = None
        if codec_config:
            compressor = registry_get('transform', codec_config['key'])(
                **codec_config.get('kwargs', {}), returns_file_size=True)
        self.transform = RCNNTransformWithCompression(
            compressor=compressor, compression_model=compression_model,
            analyzer=self.analyzers[0] if self.analyzers else None,
            **(transform_kwargs or {}))


def get_wrapped_detection_model(wrapper_model_config, device=None,
                                **kwargs):
    """The wrapper of a `models.wrapper` config on `device` (CUDA unless
    asked otherwise): its `detection_model` (or `model`) built by
    `load_detection_model` (a missing ckpt keeps the seeded weights, with a
    warning) and, for a `compression_model` block, the neural codec's
    runtime from the zoo (unless `compression_model` is given in
    `kwargs`)."""
    dev = resolve_device(device)
    model_config = wrapper_model_config.get(
        'detection_model', wrapper_model_config.get('model'))
    module = load_detection_model(model_config, device=dev)
    cm_cfg = wrapper_model_config.get('compression_model')
    if cm_cfg is not None and 'compression_model' not in kwargs:
        kwargs['compression_model'] = get_compression_model(cm_cfg,
                                                            device=dev)
    cls = registry_get('wrapper', wrapper_model_config['key'])
    return cls(module, **wrapper_model_config.get('kwargs', {}), device=dev,
               **kwargs)


class SplitDetectionRuntime(SplitClassifierRuntime):
    """The deploy runtime of a splittable Faster R-CNN: `update()`, the
    host and device wires, and the data-size analysis. A hyperprior
    bottleneck, which no COCO config uses, raises."""

    def __init__(self, module, analyzer_configs=None, device=None):
        super().__init__(module, analyzer_configs, device=device)
        if self.hyper:
            raise ValueError('SplitDetectionRuntime serves factorized-prior '
                             'bottlenecks (and entropy-free ones); got '
                             f'{type(self._bneck).__name__}')

    @staticmethod
    def _split_bottleneck(module):
        return module.backbone.body.bottleneck_layer

    def _decode_tail(self, flat, shape, input_hw=None, module=None):
        if input_hw is None:
            raise ValueError('the detection decode tail needs the canvas '
                             '(h, w)')
        h, w, c = shape
        m = self.module if module is None else module
        return m.decode_ops_to_detections(
            _nchw(flat.reshape(-1, h, w, c)), self._medians, input_hw)

    _recode_on_host = SplitClassifierRuntime._recode_on_host_wire

    def detect(self, x):
        """Detections of an NCHW canvas batch through the host wire, its
        size accounted."""
        return self._recode_on_host(x)

    __call__ = detect

    def stream_detect(self, images, depth: int = 4, workers: int = 4,
                      timings: dict | None = None):
        """The host wire over a stream of canvas images (`stream_deploy`);
        `workers` is accepted for signature parity with the JAX runtime."""
        del workers
        return self.stream_deploy(images, depth=depth, timings=timings)

    def stream_detect_device(self, images, depth: int = 8, workers: int = 4,
                             num_lanes: int | None = None,
                             wire_batch: int | None = None,
                             timings: dict | None = None):
        """The device-rANS wire over a stream of canvas images
        (`stream_deploy_device`)."""
        return self.stream_deploy_device(images, depth=depth,
                                         workers=workers,
                                         num_lanes=num_lanes,
                                         wire_batch=wire_batch,
                                         timings=timings)
