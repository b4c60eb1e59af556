"""Neural image codecs of the input-compression baselines (counterpart of
`sc2bench_tpu/models/zoo.py`), NCHW, in CompressAI's key space.

  factorized_prior (bmshj2018_factorized)     g_a/g_s + factorized prior
  scale_hyperprior (bmshj2018_hyperprior)     + h_a/h_s, Gaussian scales
  mean_scale_hyperprior (mbt2018_mean)        + Gaussian means
  joint_autoregressive_hierarchical_prior (mbt2018)
                                              `zoo_jahp.py`

A quality q in 1..8 sets the widths (N, M) as the zoo does: (128, 192) up
to q = 5, else (192, 320); `n`/`m` override them. Transposed convolutions
are torch's `ConvTranspose2d(k, s, padding=k//2, output_padding=s-1)`,
whose output is s times the input; the JAX package's input-dilated
`ConvTranspose` with padding (k-1-k//2, k-1-k//2+s-1) has this kernel
flipped (`utils/convert.py`).

`ImageCodecRuntime` gives a codec the reference's `compress(x)` /
`decompress(strings, shape)`: the analysis and synthesis transforms run on
the runtime's device, the symbols cross to the host and are coded there
(the factorized prior's channel-major coder, the hyperprior's y with the
Gaussian tables in NHWC order), so the strings and their pickled size are
the JAX package's. A hyperprior's y indexes come from h_s of the quantized
z on both sides; on the card h_s runs with cuDNN's deterministic
algorithms so that they are bit-equal.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.entropy.factorized import EntropyBottleneck
from ..ops.entropy.gaussian import GaussianConditional
from ..ops.gdn import GDN1
from ..registry import get as registry_get
from ..registry import register_model
from ..utils.profiling import span
from .runtime import FactorizedCodec, HyperpriorCodec, _exact_cudnn

logger = logging.getLogger(__name__)


def _conv(cin: int, cout: int, k: int, s: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=s, padding=k // 2)


def _deconv(cin: int, cout: int, k: int, s: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, k, stride=s, padding=k // 2,
                              output_padding=s - 1)


def analysis_transform(n: int, m: int) -> nn.Sequential:
    """g_a: four stride-2 5x5 convolutions, GDN between (x -> y, /16)."""
    return nn.Sequential(_conv(3, n, 5, 2), GDN1(n), _conv(n, n, 5, 2),
                         GDN1(n), _conv(n, n, 5, 2), GDN1(n),
                         _conv(n, m, 5, 2))


def synthesis_transform(n: int, m: int) -> nn.Sequential:
    """g_s: four stride-2 5x5 transposed convolutions, IGDN between."""
    return nn.Sequential(_deconv(m, n, 5, 2), GDN1(n, inverse=True),
                         _deconv(n, n, 5, 2), GDN1(n, inverse=True),
                         _deconv(n, n, 5, 2), GDN1(n, inverse=True),
                         _deconv(n, 3, 5, 2))


def _nhwc_numpy(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).cpu().numpy()


def nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW with the standard strides. `contiguous()` keeps a
    permuted tensor's strides where a dimension is 1 (a 1x1 latent), and
    convolutions choose their algorithm by the strides: encoder and
    decoder must hand h_s (and g_s) the same layout to get the same
    bits."""
    return t.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)


class FactorizedPriorCodec(nn.Module):
    """bmshj2018_factorized: g_a, a factorized prior over y, g_s."""

    def __init__(self, n: int = 128, m: int = 192):
        super().__init__()
        self.n, self.m = n, m
        self.g_a = analysis_transform(n, m)
        self.g_s = synthesis_transform(n, m)
        self.entropy_bottleneck = EntropyBottleneck(m)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """The reconstruction; 'train' adds uniform noise from `generator`,
        any other mode dequantizes with the medians. `io['eb_out']` gets
        (y_hat, likelihoods) when `io` is given."""
        y = self.g_a(x)
        eb_mode = 'noise' if mode == 'train' else 'dequantize'
        y_hat, y_lik = self.entropy_bottleneck(y, mode=eb_mode,
                                               generator=generator)
        if io is not None:
            io['eb_out'] = (y_hat, y_lik)
        return self.g_s(y_hat)

    def encode_ops(self, x: torch.Tensor, medians: torch.Tensor) -> dict:
        """y's symbols round(y - median), NCHW int32."""
        y = self.g_a(x)
        return {'symbols': torch.round(y - medians[:, None, None])
                .to(torch.int32)}

    def decode_ops(self, symbols: torch.Tensor,
                   medians: torch.Tensor) -> torch.Tensor:
        return self.g_s(symbols.to(torch.float32) + medians[:, None, None])


class ScaleHyperpriorCodec(nn.Module):
    """bmshj2018_hyperprior (`mean_scale=False`: h_a over |y|, ReLU, h_s
    ending in a ReLU that gives the scales) or mbt2018_mean
    (`mean_scale=True`: h_a over y, LeakyReLU 0.01, h_s widening N -> M ->
    3M/2 -> 2M into scales and means)."""

    def __init__(self, n: int = 128, m: int = 192, mean_scale: bool = False):
        super().__init__()
        self.n, self.m, self.mean_scale = n, m, mean_scale
        self.g_a = analysis_transform(n, m)
        self.g_s = synthesis_transform(n, m)

        def act():
            return nn.LeakyReLU(0.01) if mean_scale else nn.ReLU()
        self.h_a = nn.Sequential(_conv(m, n, 3, 1), act(), _conv(n, n, 5, 2),
                                 act(), _conv(n, n, 5, 2))
        if mean_scale:
            self.h_s = nn.Sequential(
                _deconv(n, m, 5, 2), act(), _deconv(m, m * 3 // 2, 5, 2),
                act(), _conv(m * 3 // 2, 2 * m, 3, 1))
        else:
            self.h_s = nn.Sequential(
                _deconv(n, n, 5, 2), act(), _deconv(n, n, 5, 2), act(),
                _conv(n, m, 3, 1), nn.ReLU())
        self.entropy_bottleneck = EntropyBottleneck(n)
        self.gaussian_conditional = GaussianConditional()

    def hyper_input(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.mean_scale else torch.abs(y)

    def gaussian_params(self, h: torch.Tensor):
        """(scales, means or None) of h_s's output."""
        if self.mean_scale:
            scales, means = torch.chunk(h, 2, dim=1)
            return scales, means
        return h, None

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """The reconstruction; 'train' adds uniform noise from `generator`
        to z and then y, any other mode dequantizes z with its medians and
        y with the predicted means. `io` gets `eb_out` (z) and `gc_out`
        (y), each (hat, likelihoods)."""
        y = self.g_a(x)
        z = self.h_a(self.hyper_input(y))
        eb_mode = 'noise' if mode == 'train' else 'dequantize'
        z_hat, z_lik = self.entropy_bottleneck(z, mode=eb_mode,
                                               generator=generator)
        scales, means = self.gaussian_params(self.h_s(z_hat))
        y_hat, y_lik = self.gaussian_conditional(
            y, scales, means, mode=eb_mode, generator=generator)
        if io is not None:
            io['eb_out'] = (z_hat, z_lik)
            io['gc_out'] = (y_hat, y_lik)
        return self.g_s(y_hat)

    def encode_ops(self, x: torch.Tensor, z_medians: torch.Tensor,
                   scale_table: torch.Tensor) -> dict:
        """NCHW int32 `y_symbols` (round(y - means)), `y_indexes` (rows of
        the Gaussian tables, from the quantized z as the decoder computes
        them) and `z_symbols` (round(z - medians))."""
        y = self.g_a(x)
        z = self.h_a(self.hyper_input(y))
        z_symbols = torch.round(z - z_medians[:, None, None]).to(torch.int32)
        indexes, means = self.decode_scales(z_symbols, z_medians, scale_table)
        y_symbols = torch.round(y if means is None else y - means)
        return {'y_symbols': y_symbols.to(torch.int32), 'y_indexes': indexes,
                'z_symbols': z_symbols}

    def decode_scales(self, z_symbols: torch.Tensor, z_medians: torch.Tensor,
                      scale_table: torch.Tensor):
        """(y indexes NCHW int32, means or None) from z's symbols."""
        z_hat = z_symbols.to(torch.float32) + z_medians[:, None, None]
        scales, means = self.gaussian_params(self.h_s(z_hat))
        return self.gaussian_conditional.build_indexes(
            scales, scale_table), means

    def decode_ops(self, y_symbols: torch.Tensor,
                   means: torch.Tensor | None) -> torch.Tensor:
        """The reconstruction from y's symbols and `decode_scales`'s
        means."""
        y_hat = y_symbols.to(torch.float32)
        if means is not None:
            y_hat = y_hat + means
        return self.g_s(y_hat)


class ImageCodecRuntime:
    """`compress(x)` / `decompress(strings, shape)` of a factorized or
    (mean-)scale hyperprior codec, on `device` (CUDA unless asked
    otherwise). `x` is an NCHW image batch of one (a tensor, or an array
    taken to the device). `timings` accumulates the seconds of the host
    coder (`host_encode`, `host_decode`)."""

    def __init__(self, module, device=None):
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            # true float32: the symbols and indexes of the reference
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.module = module.to(self.device).eval()
        self.hyper = isinstance(module, ScaleHyperpriorCodec)
        self.codec = HyperpriorCodec() if self.hyper else FactorizedCodec()
        self.timings = {}
        self._medians = None
        self._scale_table = None

    def update(self, scale_table=None):
        """Build the coding tables (and a hyperprior's Gaussian tables of
        `scale_table`, by default the 64-entry one). Returns True."""
        eb = self.module.entropy_bottleneck
        if self.hyper:
            self.codec.update(eb, scale_table)
            self._scale_table = torch.as_tensor(
                self.codec.g_tables.scale_table, dtype=torch.float32,
                device=self.device)
        else:
            self.codec.update(eb)
        self._medians = torch.as_tensor(self.codec.tables.medians,
                                        device=self.device)
        return True

    def _prep(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def forward(self, x, mode: str = 'train',
                generator: torch.Generator | None = None) -> torch.Tensor:
        """The codec module's forward on `x` (the JAX runtime's
        `module.apply`): the reconstruction, 'train' with uniform noise
        from `generator`, any other mode dequantized."""
        return self.module(self._prep(x), mode=mode, generator=generator)

    @torch.no_grad()
    def compress(self, x) -> dict:
        """{'strings': [y's] (factorized) or [y's, z's] (hyperprior),
        'shape': the coded latent's (h, w) (z's for a hyperprior)} of the
        NCHW batch `x`."""
        x = self._prep(x)
        if self.hyper:
            with _exact_cudnn():
                ops = self.module.encode_ops(x, self._medians,
                                             self._scale_table)
            ops = {k: _nhwc_numpy(v) for k, v in ops.items()}
            with span('codec.host_encode', self.timings, 'host_encode'):
                y_strings = self.codec.compress_y(ops['y_symbols'],
                                                  ops['y_indexes'])
                z_strings = self.codec.compress_symbols(ops['z_symbols'])
            return {'strings': [y_strings, z_strings],
                    'shape': tuple(ops['z_symbols'].shape[1:3])}
        symbols = _nhwc_numpy(self.module.encode_ops(
            x, self._medians)['symbols'])
        with span('codec.host_encode', self.timings, 'host_encode'):
            strings = self.codec.compress_symbols(symbols)
        return {'strings': [strings], 'shape': tuple(symbols.shape[1:3])}

    @torch.no_grad()
    def decompress(self, strings, shape) -> torch.Tensor:
        """The NCHW reconstruction of `compress`'s output."""
        if self.hyper:
            with span('codec.host_decode', self.timings, 'host_decode'):
                z_sym = self.codec.decompress_symbols(strings[1], shape,
                                                      self.module.n)
            z = nchw(torch.from_numpy(z_sym).to(self.device))
            with _exact_cudnn():
                y_idx, means = self.module.decode_scales(
                    z, self._medians, self._scale_table)
            y_idx = _nhwc_numpy(y_idx)
            with span('codec.host_decode', self.timings, 'host_decode'):
                y_sym = self.codec.decompress_y(strings[0], y_idx)
            y = nchw(torch.from_numpy(y_sym).to(self.device))
            return self.module.decode_ops(y, means)
        channels = self.codec.tables.medians.shape[0]
        with span('codec.host_decode', self.timings, 'host_decode'):
            symbols = self.codec.decompress_symbols(strings[0], shape,
                                                    channels)
        return self.module.decode_ops(
            nchw(torch.from_numpy(symbols).to(self.device)), self._medians)


def _quality_channels(quality: int):
    return (128, 192) if quality <= 5 else (192, 320)


def _on(module: nn.Module, device) -> nn.Module:
    return module.to(resolve_device(device))


@register_model
def factorized_prior(quality=1, n=None, m=None, device=None, **kwargs):
    qn, qm = _quality_channels(int(quality))
    return _on(FactorizedPriorCodec(n=n or qn, m=m or qm), device)


@register_model
def bmshj2018_factorized(quality=1, **kwargs):
    return factorized_prior(quality, **kwargs)


@register_model
def scale_hyperprior(quality=1, n=None, m=None, device=None, **kwargs):
    qn, qm = _quality_channels(int(quality))
    return _on(ScaleHyperpriorCodec(n=n or qn, m=m or qm, mean_scale=False),
               device)


@register_model
def bmshj2018_hyperprior(quality=1, **kwargs):
    return scale_hyperprior(quality, **kwargs)


@register_model
def mean_scale_hyperprior(quality=1, n=None, m=None, device=None, **kwargs):
    qn, qm = _quality_channels(int(quality))
    return _on(ScaleHyperpriorCodec(n=n or qn, m=m or qm, mean_scale=True),
               device)


@register_model
def mbt2018_mean(quality=1, **kwargs):
    return mean_scale_hyperprior(quality, **kwargs)


def codec_runtime(module, device=None):
    """The runtime of a codec module: the joint autoregressive one for
    mbt2018, else `ImageCodecRuntime`; not updated."""
    from .zoo_jahp import JointAutoregressiveCodec, JointAutoregressiveRuntime
    if isinstance(module, JointAutoregressiveCodec):
        return JointAutoregressiveRuntime(module, device=device)
    return ImageCodecRuntime(module, device=device)


def build_image_codec(key: str, ckpt=None, device=None, **kwargs):
    """The runtime of the codec registered as `key` (quality, n, m in
    `kwargs`), its weights from `ckpt` when that file exists (the port's
    format or the JAX package's), else fresh; tables built."""
    from ..utils.ckpt import load_ckpt
    dev = resolve_device(device)
    kwargs.pop('image_size', None)
    module = registry_get('model', key)(device=dev, **kwargs)
    if ckpt:
        try:
            state_dict, _, _ = load_ckpt(ckpt, module)
            module.load_state_dict(state_dict)
        except FileNotFoundError:
            logger.warning('codec ckpt %s not found; fresh weights', ckpt)
    rt = codec_runtime(module, device=dev)
    rt.update()
    return rt
