"""Wrapper runtimes selected by a config's `key` (counterpart of
`sc2bench_tpu/models/wrapper.py`), registered under 'wrapper'.

  CodecInputCompressionClassifier   each image through a host codec
                                    transform (JPEG/WebP, BPG, VTM) and its
                                    post-transforms, then the classifier
  NeuralInputCompressionClassifier  each image through a neural codec's
                                    `compress`/`decompress` (`zoo.py`,
                                    `zoo_jahp.py`), or with
                                    `wire='device'` its device wire
                                    (`zoo_jahp_device.py`), then the
                                    classifier
  CodecFeatureCompressionClassifier the classifier up to `split_layer`,
                                    the feature through a codec transform
                                    on the host, then the rest
  EntropicClassifier  the runtime of an `EntropicClassifierModule` (the
                      fine-tuning family): the host wire over its
                      module-level deploy ops
  SplitClassifier     a `SplittableResNet` with a `SimpleBottleneck` (the
                      CR+BQ family): in eval, encoder -> compressor (a host
                      transform such as `SimpleQuantizer`) -> data size
                      -> decompressor -> decoder -> tail

The codec wrappers take a batch as a list of HWC images (numpy, or PIL
for the host codecs), as the JAX package's do, code each image on its
own, and run the classifier NCHW on the device, the batch transposed
once. Their analyzers account each image's size: the codec transform's
byte count (`FileSizeAccumulator`) or the pickled compressed object
(`FileSizeAnalyzer`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import transforms  # noqa: F401  (fills the transform registry)
from ..analysis import AnalyzerHolder
from ..device import resolve_device
from ..registry import get as registry_get
from ..registry import register_wrapper
from ..utils.profiling import count, span
from .registry import get_compression_model, load_classification_model
from .runtime import SplitClassifierRuntime


def to_pil(img):
    """An HWC array as a PIL image for the host codecs: uint8 as it is,
    floats in [0, 1] times 255 and rounded, other floats min/max-scaled to
    8 bits; a PIL image passes through."""
    from PIL import Image
    if isinstance(img, Image.Image):
        return img
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        lo, hi = float(arr.min()), float(arr.max())
        if lo >= 0.0 and hi <= 1.0:
            arr = (arr * 255.0).round()
        else:
            arr = (arr - lo) / max(hi - lo, 1e-12) * 255.0
        arr = arr.astype(np.uint8)
    return Image.fromarray(arr)


def _build_transform(cfg):
    """A registered transform from `{key, kwargs}`, a chain of them from a
    list, or None."""
    if cfg is None:
        return None
    if isinstance(cfg, (list, tuple)):
        transforms = [_build_transform(c) for c in cfg]

        def chain(x):
            for t in transforms:
                x = t(x)
            return x
        return chain
    return registry_get('transform', cfg['key'])(**cfg.get('kwargs', {}))


def _nchw_batch(images, device) -> torch.Tensor:
    """A list of HWC images (or an NHWC array) as one float32 NCHW tensor
    on `device`."""
    batch = np.stack([np.asarray(img, np.float32) for img in images])
    return torch.from_numpy(np.ascontiguousarray(
        batch.transpose(0, 3, 1, 2))).to(device)


@register_wrapper
class CodecInputCompressionClassifier(AnalyzerHolder):
    """Each image through `codec_encoder_decoder` (a transform returning
    the reconstruction, or (reconstruction, file size) whose size is
    analyzed) and `post_transform`, then the classifier."""

    def __init__(self, classifier, codec_encoder_decoder=None,
                 post_transform=None, analysis_config=None, device=None,
                 **kwargs):
        super().__init__((analysis_config or {}).get('analyzer_configs', []))
        self.device = resolve_device(device)
        self.codec = _build_transform(codec_encoder_decoder)
        self.post_transform = _build_transform(post_transform)
        self.classifier = classifier.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
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
        return self.classifier(_nchw_batch(batch, self.device)).to(
            torch.float32)


def _device_pads(cfg):
    """The `AdaptivePad` transforms of a `pre_transform` config, which the
    device wire applies to a tensor on the device; any other transform
    raises."""
    cfgs = [] if cfg is None else cfg if isinstance(cfg, (list, tuple)) \
        else [cfg]
    other = [c['key'] for c in cfgs if c['key'] != 'AdaptivePad']
    if other:
        raise ValueError(f"wire='device' pads on the device and takes no "
                         f"other pre_transform: {other}")
    return [_build_transform(c) for c in cfgs]


@register_wrapper
class NeuralInputCompressionClassifier(AnalyzerHolder):
    """Each image through `pre_transform`, the neural codec's `compress`
    (the compressed object analyzed when `analyzes_after_compress` or the
    analysis is active) and `decompress` on the device, and
    `post_transform`, then the classifier on the reconstructions.

    `wire='device'` codes each image on the codec's device wire instead
    (`encode_device_wire`/`decode_device_wire`; today the joint
    autoregressive codec's, `zoo_jahp_device.py`; another codec raises):
    an image is a (1, 3, h, w) tensor or an HWC array, padded on the
    device by the `AdaptivePad` of `pre_transform`; its wire size
    (`nbytes`) is analyzed. That size is the lane format's, states and
    lengths of every lane included, and is not comparable with the host
    wire's sizes (the paper's data size): about 29 % more at quality 8 on
    224 px images. The request's flags and sizes cross to the
    host once, after the classifier is queued: an image whose symbols
    left the tables' support (`ok` false) is re-coded on the host wire and
    counted in `escapes['ok']` (the classifier then runs again), and a
    decode that did not return to its initial state (`valid` false) is
    counted in `invalid`. While a profiler runs, `codec.classify` is a
    span and `codec.images` and `codec.escapes` count."""

    def __init__(self, classifier, compression_model=None,
                 pre_transform=None, post_transform=None,
                 analysis_config=None, device=None, wire='host', **kwargs):
        analysis_config = analysis_config or {}
        super().__init__(analysis_config.get('analyzer_configs', []))
        self.device = resolve_device(device)
        self.analyzes_after_compress = analysis_config.get(
            'analyzes_after_compress', False)
        self.compression_model = compression_model
        self.pre_transform = _build_transform(pre_transform)
        self.post_transform = _build_transform(post_transform)
        self.classifier = classifier.to(self.device).eval()
        if wire not in ('host', 'device'):
            raise ValueError(f"wire must be 'host' or 'device', not {wire!r}")
        self.wire = wire
        self.escapes = {'ok': 0}
        self.invalid = 0
        if wire == 'device':
            if not hasattr(compression_model, 'encode_device_wire'):
                raise ValueError(
                    f"wire='device' needs a codec with a device wire "
                    f"(encode_device_wire/decode_device_wire, the joint "
                    f"autoregressive codec's); "
                    f"{type(compression_model).__name__} has none")
            self._pads = _device_pads(pre_transform)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        if self.wire == 'device':
            return self._call_device_wire(images)
        batch = []
        for img in images:
            if self.pre_transform is not None:
                img = self.pre_transform(img)
            x = _nchw_batch([img], self.device)
            if self.compression_model is not None:
                compressed = self.compression_model.compress(x)
                self._account(compressed)
                x = self.compression_model.decompress(**compressed)
            batch.append(self._post(x))
        return self.classifier(torch.cat(batch)).to(torch.float32)

    def _account(self, compressed):
        if self.analyzes_after_compress or self.activated_analysis:
            self.analyze(compressed)

    def _post(self, x):
        if self.post_transform is not None:
            x = _nchw_batch([self.post_transform(
                x[0].permute(1, 2, 0).cpu().numpy())], self.device)
        return x.to(torch.float32)

    def _device_input(self, img) -> torch.Tensor:
        """A (1, 3, h, w) float32 tensor on the device, padded."""
        if isinstance(img, torch.Tensor) and img.ndim == 4:
            x = img.to(self.device, torch.float32)
        else:
            x = _nchw_batch([img], self.device)
        for pad in self._pads:
            h, w = x.shape[-2:]
            ph, pw = pad.padded_size(h, w)
            dh, dw = ph - h, pw - w
            top, left = (dh // 2, dw // 2) if pad.centered else (0, 0)
            x = F.pad(x, (left, dw - left, top, dh - top), value=pad.fill)
        return x

    def _classify(self, recon):
        with span('codec.classify'):
            return self.classifier(torch.cat(recon)).to(torch.float32)

    def _call_device_wire(self, images):
        cm = self.compression_model
        xs = [self._device_input(img) for img in images]
        count('codec.images', len(xs))
        recon, flags = [], []
        for x in xs:
            ops = cm.encode_device_wire(x)
            img, valid = cm.decode_device_wire(ops)
            recon.append(self._post(img))
            flags.append(torch.stack([ops['ok'].to(torch.int64),
                                      valid.to(torch.int64),
                                      ops['nbytes'].to(torch.int64)]))
        logits = self._classify(recon)
        escaped = False
        for i, (ok, valid, nbytes) in enumerate(
                torch.stack(flags).tolist()):
            if not ok:
                self.escapes['ok'] += 1
                count('codec.escapes')
                compressed = cm.compress(xs[i])
                self._account(compressed)
                recon[i] = self._post(cm.decompress(**compressed))
                escaped = True
                continue
            self.invalid += int(not valid)
            self._account({'strings': [[bytes(nbytes)]]})
        return self._classify(recon) if escaped else logits


@register_wrapper
class CodecFeatureCompressionClassifier(AnalyzerHolder):
    """The classifier split at `split_layer` (its `forward_until` and
    `forward_from`): the head on the device, each feature as HWC on the
    host through `compression_transform` (its file size analyzed) and
    `decompression_transform`, then the tail on the device."""

    def __init__(self, classifier, split_layer='layer2',
                 compression_transform=None, decompression_transform=None,
                 analysis_config=None, device=None, **kwargs):
        super().__init__((analysis_config or {}).get('analyzer_configs', []))
        self.device = resolve_device(device)
        self.module = classifier.to(self.device).eval()
        self.split_layer = split_layer
        self.compress = _build_transform(compression_transform)
        self.decompress = _build_transform(decompression_transform)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        x = _nchw_batch(images, self.device)
        feature = self.module.forward_until(x, self.split_layer)
        out = []
        for f in feature.permute(0, 2, 3, 1).cpu().numpy():
            if self.compress is not None:
                comp = self.compress(f)
                if isinstance(comp, tuple):
                    comp, file_size = comp
                    self.analyze(file_size)
                f = self.decompress(comp) if self.decompress else comp
            out.append(f)
        return self.module.forward_from(
            _nchw_batch(out, self.device), self.split_layer).to(torch.float32)


@register_wrapper
class EntropicClassifier(SplitClassifierRuntime):
    """Split classifier with an entropy bottleneck at a configurable split
    point, over an `EntropicClassifierModule`."""

    def __init__(self, module, analyzer_configs=None, device=None, **kwargs):
        super().__init__(module, analyzer_configs, device=device)


@register_wrapper
class SplitClassifier(SplitClassifierRuntime):
    """Naive split with a tensor quantizer pair as the compression: the
    latent of the `SimpleBottleneck` goes to the host, where `compressor`
    makes the object whose pickled size is accounted and `decompressor`
    restores it."""

    def __init__(self, module, analyzer_configs=None, compressor=None,
                 decompressor=None, device=None, **kwargs):
        super().__init__(module, analyzer_configs, device=device)
        self.compressor = _build_transform(compressor)
        self.decompressor = _build_transform(decompressor)

    @torch.no_grad()
    def __call__(self, x, generator: torch.Generator | None = None):
        """In training mode the runtime's forward; in eval the split path
        with the host transforms. Returns logits (n, K)."""
        if self.training:
            return super().__call__(x, generator)
        z = self._bneck.encode_latent(self._prep_input(x)).cpu().numpy()
        compressed = self.compressor(z) if self.compressor else z
        self.analyze(compressed)
        z = self.decompressor(compressed) if self.decompressor \
            else compressed
        z = torch.from_numpy(np.asarray(z, np.float32)).to(self.device)
        return self.module.forward_tail(
            self._bneck.decode_latent(z)).to(torch.float32)


def wrap_model(wrapper_model_config, model, **kwargs):
    """The wrapper of `wrapper_model_config['key']` around `model`, with
    the config's kwargs."""
    cls = registry_get('wrapper', wrapper_model_config['key'])
    return cls(model, **wrapper_model_config.get('kwargs', {}), **kwargs)


def get_wrapped_classification_model(wrapper_model_config, device=None,
                                     **kwargs):
    """The wrapper of a `models.wrapper` config on `device` (CUDA unless
    asked otherwise): its `classification_model` and, for a
    `compression_model` block, the neural codec's runtime (unless
    `compression_model` is given in `kwargs`)."""
    dev = resolve_device(device)
    model_config = wrapper_model_config.get(
        'classification_model', wrapper_model_config.get('model'))
    classifier = load_classification_model(model_config, device=dev)
    cm_cfg = wrapper_model_config.get('compression_model')
    if cm_cfg is not None and 'compression_model' not in kwargs:
        kwargs['compression_model'] = get_compression_model(cm_cfg,
                                                            device=dev)
    return wrap_model(wrapper_model_config, classifier, device=dev, **kwargs)
