"""Codec round-trip transforms on the host (counterpart of
`sc2bench_tpu/transforms/codec.py`).

Each module codes an image (or a feature tensor) with a real codec and
decodes it again, returning `(reconstruction, file size in bytes)` with
`returns_file_size`. They are the input-compression baselines, and run on
the host feeding the card:

  PILImageModule    JPEG/WebP (any PIL format) of a PIL image
  PILTensorModule   an HWC float feature, coded as 8-bit images of at most
                    three channels each, with its normalization parameters
                    accounted (the feature-compression family)
  BPGModule         bpgenc/bpgdec, run as subprocesses
  VTMModule         the VVC test model's EncoderApp/DecoderApp
  WrappedResize, WrappedRandomResizedCrop
                    PIL resizes with the interpolation named by a string

PIL is imported where it is used, not when this module is imported. BPG
and VTM need their binaries and raise `FileNotFoundError` when one is
missing.
"""
from __future__ import annotations

import io
import pickle
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..registry import register_transform

_INTERPOLATIONS = ('nearest', 'bilinear', 'bicubic', 'lanczos', 'box',
                   'hamming')


def _interpolation(name: str):
    """PIL's resampling filter of `name`."""
    from PIL import Image
    if name not in _INTERPOLATIONS:
        raise KeyError(f'unknown interpolation {name!r}; known: '
                       f'{_INTERPOLATIONS}')
    return getattr(Image, name.upper())


@register_transform
class WrappedResize:
    """Resize with a string-named interpolation; an int `size` sets the
    shorter side and keeps the aspect ratio."""

    def __init__(self, size, interpolation='bilinear', **kwargs):
        self.size = size
        self.interpolation = _interpolation(interpolation)

    def __call__(self, img):
        size = self.size
        if isinstance(size, int):
            w, h = img.size
            if w < h:
                size = (int(size * h / w), size)
            else:
                size = (size, int(size * w / h))
        return img.resize((size[1], size[0]), self.interpolation)


@register_transform
class WrappedRandomResizedCrop:
    """RandomResizedCrop with a string-named interpolation; its draws come
    from `rng` (a numpy Generator, by default a fresh one)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation='bilinear', rng=None, **kwargs):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = _interpolation(interpolation)
        self.rng = rng if rng is not None else np.random.default_rng()

    def __call__(self, img):
        w, h = img.size
        area = w * h
        for _ in range(10):
            target_area = self.rng.uniform(*self.scale) * area
            aspect = np.exp(self.rng.uniform(*np.log(self.ratio)))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(self.rng.integers(0, w - cw + 1))
                top = int(self.rng.integers(0, h - ch + 1))
                crop = img.crop((left, top, left + cw, top + ch))
                return crop.resize(self.size[::-1], self.interpolation)
        return img.resize(self.size[::-1], self.interpolation)


@register_transform
class PILImageModule:
    """Round trip of a PIL image through an in-memory file of a PIL format
    (`format='JPEG'`, `quality=...`: PIL's save arguments); the file size
    is the buffer's length."""

    def __init__(self, returns_file_size=False, open_format=None, **kwargs):
        self.returns_file_size = returns_file_size
        self.open_format = open_format
        self.save_kwargs = kwargs

    def __call__(self, img):
        from PIL import Image
        buf = io.BytesIO()
        img.save(buf, **self.save_kwargs)
        file_size = buf.tell()
        buf.seek(0)
        reconstructed = Image.open(buf).convert('RGB')
        if self.returns_file_size:
            return reconstructed, file_size
        return reconstructed


@register_transform
class PILTensorModule:
    """Round trip of an HWC float feature: its channels in groups of at
    most three (in channel order), each group min/max-normalized to uint8
    and coded as an image with PIL's save arguments. The file size is the
    images' bytes plus the pickled size of the (min, max) list."""

    def __init__(self, returns_file_size=False, **kwargs):
        self.returns_file_size = returns_file_size
        self.save_kwargs = kwargs

    def __call__(self, z):
        from PIL import Image
        z = np.asarray(z, np.float32)
        h, w, c = z.shape
        recon = np.empty_like(z)
        total_size = 0
        norm_params = []
        for gi in range(0, c, 3):
            g = z[..., gi:gi + 3]
            mn, mx = float(g.min()), float(g.max())
            scale = (mx - mn) or 1.0
            q = np.round((g - mn) / scale * 255).astype(np.uint8)
            gc = g.shape[-1]
            if gc == 1:
                pil = Image.fromarray(q[..., 0], mode='L')
            else:
                if gc == 2:
                    q = np.concatenate([q, np.zeros((h, w, 1), np.uint8)], -1)
                pil = Image.fromarray(q, mode='RGB')
            buf = io.BytesIO()
            pil.save(buf, **self.save_kwargs)
            total_size += buf.tell()
            buf.seek(0)
            dec = np.asarray(Image.open(buf), np.float32)
            if dec.ndim == 2:
                dec = dec[..., None]
            recon[..., gi:gi + gc] = dec[..., :gc] / 255.0 * scale + mn
            norm_params.append((mn, mx))
        total_size += len(pickle.dumps(norm_params))
        if self.returns_file_size:
            return recon, total_size
        return recon


class _SubprocessCodec:
    """An external encoder/decoder pair run as subprocesses."""

    def __init__(self, encoder_path, decoder_path):
        self.encoder_path = encoder_path
        self.decoder_path = decoder_path

    def check(self):
        for p in (self.encoder_path, self.decoder_path):
            if not (shutil.which(p) or Path(p).exists()):
                raise FileNotFoundError(
                    f'codec binary `{p}` not found; install it (the '
                    'reference installers: script/software/install_bpg.sh '
                    '/ install_vtm.sh) or use JPEG/WebP/neural codecs')

    def run(self, cmd):
        subprocess.run(cmd, check=True, capture_output=True)


@register_transform
class BPGModule(_SubprocessCodec):
    """BPG (HEVC still image) round trip through bpgenc/bpgdec; the file
    size is the .bpg file's."""

    def __init__(self, encoder_path='bpgenc', decoder_path='bpgdec',
                 color_mode='ycbcr', encoder='x265', subsampling_mode='444',
                 bit_depth='8', quality=50, returns_file_size=False, **kwargs):
        super().__init__(encoder_path, decoder_path)
        self.color_mode = color_mode
        self.encoder = encoder
        self.subsampling_mode = str(subsampling_mode)
        self.bit_depth = str(bit_depth)
        self.quality = quality
        self.returns_file_size = returns_file_size

    def __call__(self, img):
        from PIL import Image
        self.check()
        with tempfile.TemporaryDirectory() as td:
            src = Path(td) / 'in.png'
            bpg = Path(td) / 'out.bpg'
            dst = Path(td) / 'out.png'
            img.save(src, format='PNG')
            self.run([self.encoder_path, '-o', str(bpg), '-q',
                      str(self.quality), '-f', self.subsampling_mode, '-e',
                      self.encoder, '-c', self.color_mode, '-b',
                      self.bit_depth, str(src)])
            file_size = bpg.stat().st_size
            self.run([self.decoder_path, '-o', str(dst), str(bpg)])
            rec = Image.open(dst).convert('RGB')
            rec.load()
        if self.returns_file_size:
            return rec, file_size
        return rec


@register_transform
class VTMModule(_SubprocessCodec):
    """VTM (VVC test model) round trip: RGB -> 10-bit YCbCr 4:4:4 planes,
    EncoderApp, DecoderApp, back to RGB; the file size is the bitstream's."""

    def __init__(self, encoder_path='EncoderApp', decoder_path='DecoderApp',
                 config_path=None, color_mode='ycbcr', quality=63,
                 returns_file_size=False, **kwargs):
        super().__init__(encoder_path, decoder_path)
        self.config_path = config_path
        self.quality = quality
        self.returns_file_size = returns_file_size

    @staticmethod
    def _rgb2ycbcr(rgb: np.ndarray) -> np.ndarray:
        m = np.array([[0.299, 0.587, 0.114],
                      [-0.168736, -0.331264, 0.5],
                      [0.5, -0.418688, -0.081312]], np.float32)
        ycbcr = rgb @ m.T
        ycbcr[..., 1:] += 0.5
        return ycbcr

    @staticmethod
    def _ycbcr2rgb(ycbcr: np.ndarray) -> np.ndarray:
        y = ycbcr.copy()
        y[..., 1:] -= 0.5
        m = np.array([[1.0, 0.0, 1.402],
                      [1.0, -0.344136, -0.714136],
                      [1.0, 1.772, 0.0]], np.float32)
        return y @ m.T

    def __call__(self, img):
        from PIL import Image
        self.check()
        rgb = np.asarray(img, np.float32) / 255.0
        h, w = rgb.shape[:2]
        ycbcr = np.clip(self._rgb2ycbcr(rgb), 0, 1)
        yuv10 = np.round(ycbcr * 1023).astype('<u2')
        with tempfile.TemporaryDirectory() as td:
            yuv = Path(td) / 'in.yuv'
            bin_ = Path(td) / 'out.bin'
            rec_yuv = Path(td) / 'rec.yuv'
            with open(yuv, 'wb') as f:
                for ch in range(3):
                    f.write(yuv10[..., ch].tobytes())
            cmd = [self.encoder_path, '-i', str(yuv), '-b', str(bin_),
                   '-o', str(rec_yuv), '-wdt', str(w), '-hgt', str(h),
                   '-q', str(self.quality), '--InputChromaFormat=444',
                   '--InputBitDepth=10', '--FrameRate=1',
                   '--FramesToBeEncoded=1', '--ConformanceWindowMode=1']
            if self.config_path:
                cmd += ['-c', str(self.config_path)]
            self.run(cmd)
            file_size = bin_.stat().st_size
            self.run([self.decoder_path, '-b', str(bin_), '-o', str(rec_yuv),
                      '-d', '10'])
            raw = np.frombuffer(rec_yuv.read_bytes(), '<u2')
            dec = raw[:h * w * 3].reshape(3, h, w).transpose(1, 2, 0)
            rgb_rec = np.clip(
                self._ycbcr2rgb(dec.astype(np.float32) / 1023), 0, 1)
            rec = Image.fromarray((rgb_rec * 255).round().astype(np.uint8))
        if self.returns_file_size:
            return rec, file_size
        return rec
