"""The split deploy runtime of Faster R-CNN (counterpart of
`SplitDetectionRuntime` in `sc2bench_tpu/models/detection/wrapper.py`).

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

from ..runtime import SplitClassifierRuntime, _nchw


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

    def _decode_tail(self, flat, shape, input_hw=None):
        if input_hw is None:
            raise ValueError('the detection decode tail needs the canvas '
                             '(h, w)')
        h, w, c = shape
        return self.module.decode_ops_to_detections(
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
