"""Detection input transform (counterpart of `RCNNTransform` in
`sc2bench_tpu/models/detection/transform.py`), on the host in numpy and
PIL.

Each image's shorter side is resized to `min_size` (the longer capped at
`max_size`), normalized with the ImageNet mean and std, and padded at the
bottom and right to a canvas: the smallest (by area) of the canvas
buckets that fits every image of the batch, or the square
`max_size` rounded up to `size_divisible`. Anchors, clipping and the
bottleneck's latent all live on the canvas, so the canvas decides the
bytes on the wire.

`RCNNTransformWithCompression` adds the input-compression stage between
the resize and the normalization: each resized image goes through a host
codec transform (JPEG/WebP: clipped to [0, 1], taken to uint8, its file
size given to the analyzer) or a neural codec's `compress`/`decompress`
(padded to a multiple of 64 first, the compressed object given to the
analyzer, the reconstruction cropped back), and onto the square canvas.
"""
from __future__ import annotations

import numpy as np
import torch

from ...transforms.misc import AdaptivePad

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class RCNNTransform:
    """Resize, normalize and pad to a canvas. `canvas_buckets` True selects
    the landscape / portrait / square triple of (min_size, max_size)."""

    def __init__(self, min_size=800, max_size=1333, image_mean=None,
                 image_std=None, size_divisible=32, canvas_buckets=None):
        self.min_size = min_size
        self.max_size = max_size
        self.image_mean = np.asarray(image_mean or IMAGENET_MEAN, np.float32)
        self.image_std = np.asarray(image_std or IMAGENET_STD, np.float32)
        self.size_divisible = size_divisible
        if canvas_buckets is True:
            canvas_buckets = self.default_buckets()
        self.canvas_buckets = [tuple(b) for b in canvas_buckets] \
            if canvas_buckets else None

    def resize(self, img: np.ndarray):
        """(resized HWC float32 in [0, 1], scale) by PIL's bilinear."""
        from PIL import Image
        h, w = img.shape[:2]
        scale = min(self.min_size / min(h, w), self.max_size / max(h, w))
        nh, nw = int(round(h * scale)), int(round(w * scale))
        pil = Image.fromarray(img) if img.dtype == np.uint8 else \
            Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        resized = np.asarray(pil.resize((nw, nh), Image.BILINEAR),
                             np.float32) / 255.0
        return resized, scale

    def _round_div(self, v):
        d = self.size_divisible
        return -(-v // d) * d

    def canvas_hw(self):
        m = self._round_div(self.max_size)
        return (m, m)

    def default_buckets(self):
        mn, mx = self._round_div(self.min_size), self._round_div(self.max_size)
        return [(mn, mx), (mx, mn), (mx, mx)]

    def _select_canvas(self, shapes):
        """The smallest bucket (by area) that fits every resized image."""
        if not self.canvas_buckets:
            return self.canvas_hw()
        need_h = max(s[0] for s in shapes)
        need_w = max(s[1] for s in shapes)
        fitting = [b for b in self.canvas_buckets
                   if b[0] >= need_h and b[1] >= need_w]
        if not fitting:
            return self.canvas_hw()
        return min(fitting, key=lambda b: b[0] * b[1])

    def __call__(self, images):
        """images: HWC arrays (uint8, or float in [0, 1]). Returns (NHWC
        float32 canvas batch, scales, original (h, w) sizes)."""
        resized_all, scales, orig = [], [], []
        for img in images:
            img = np.asarray(img)
            orig.append(img.shape[:2])
            resized, scale = self.resize(img)
            resized_all.append(resized)
            scales.append(scale)
        ch, cw = self._select_canvas([r.shape[:2] for r in resized_all])
        out = np.zeros((len(resized_all), ch, cw, 3), np.float32)
        for i, resized in enumerate(resized_all):
            out[i, :resized.shape[0], :resized.shape[1]] = \
                (resized - self.image_mean) / self.image_std
        return out, np.asarray(scales, np.float32), orig


class RCNNTransformWithCompression(RCNNTransform):
    """`RCNNTransform` with a compression stage after the resize:
    `compressor` (a transform returning (PIL image, file size), or the
    image alone) or `compression_model` (a neural codec runtime:
    `compress(NCHW)` / `decompress(**compressed)`); `analyzer` receives
    the file size or the compressed object. Every image goes onto the
    square canvas of `max_size`."""

    def __init__(self, compressor=None, compression_model=None,
                 analyzer=None, adaptive_pad_factor=64, **kwargs):
        super().__init__(**kwargs)
        self.compressor = compressor
        self.compression_model = compression_model
        self.analyzer = analyzer
        self.adaptive_pad = AdaptivePad(factor=adaptive_pad_factor,
                                        returns_org_patch_size=True)

    @torch.no_grad()
    def compress_image(self, resized: np.ndarray) -> np.ndarray:
        """The reconstruction (HWC float32 in [0, 1]) of one resized
        image after the compression stage."""
        from PIL import Image
        h, w = resized.shape[:2]
        if self.compressor is not None:
            pil = Image.fromarray(
                (np.clip(resized, 0, 1) * 255).astype(np.uint8))
            out = self.compressor(pil)
            if isinstance(out, tuple):
                pil, file_size = out
                if self.analyzer is not None:
                    self.analyzer.analyze(file_size)
            else:
                pil = out
            rec = np.asarray(pil, np.float32) / 255.0
        elif self.compression_model is not None:
            padded, (oh, ow) = self.adaptive_pad(resized)
            compressed = self.compression_model.compress(torch.from_numpy(
                np.ascontiguousarray(padded.transpose(2, 0, 1)[None])))
            if self.analyzer is not None:
                self.analyzer.analyze(compressed)
            rec = self.compression_model.decompress(**compressed)[0]
            rec = rec.permute(1, 2, 0)[:oh, :ow].cpu().numpy()
        else:
            return resized
        assert rec.shape[:2] == (h, w), \
            f'compression changed the shape {rec.shape[:2]} != {(h, w)}'
        return rec

    def __call__(self, images):
        ch, cw = self.canvas_hw()
        out = np.zeros((len(images), ch, cw, 3), np.float32)
        scales, orig = [], []
        for i, img in enumerate(images):
            img = np.asarray(img)
            orig.append(img.shape[:2])
            resized, scale = self.resize(img)
            resized = self.compress_image(resized)
            out[i, :resized.shape[0], :resized.shape[1]] = \
                (resized - self.image_mean) / self.image_std
            scales.append(scale)
        return out, np.asarray(scales, np.float32), orig
