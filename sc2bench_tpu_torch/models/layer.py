"""Split-point bottleneck layers over NCHW (counterpart of
`sc2bench_tpu/models/layer.py`).

The deploy path uses `encode_ops` (latent -> integer symbols
round(y - median)) and `decode_ops` (symbols -> decoded feature). Symbols
stay NCHW here; the runtime flattens them channels-last before coding.
`forward(x, mode='train', generator=...)` is the training forward (noisy
latent, likelihoods for the rate loss); `forward(x, mode='finetune')` the
deterministic forward without a bitstream. Layers register under the
'layer' namespace of `registry.py`.

The hyperprior bottlenecks (`SHPBasedResNetBottleneck`,
`MSHPBasedResNetBottleneck`) code two latents: z = h_a(y) with the
factorized prior, and y with a Gaussian whose scales (and, for MSHP,
means) h_s predicts from the quantized z. Their `encode_ops` gives y's
symbols and table indexes and z's symbols; `decode_scales` recomputes the
indexes (and the means) from z's symbols, as the receiver must, and
`decode_ops` takes those means.

The CR+BQ family's `SimpleBottleneck` has no entropy model: an encoder
and a decoder (`LayerSeq` stacks read from a spec list), whose latent the
`SplitClassifier` wrapper quantizes on the host. `EntropyBottleneckLayer`
is a bare factorized prior over its input, the fine-tuning family's
split-point layer.

The FP and SHP/MSHP bottlenecks take a compute `dtype` (float32 by
default, or bfloat16; `models/precision.py`) for their encoder and
decoder convolutions and GDNs (g_a and g_s): the latent goes to the
entropy model, and to the symbols' rounding, in float32, and a
hyperprior's h_a and h_s always run in float32, so that the decoder's
Gaussian indexes equal the encoder's.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.entropy.factorized import EntropyBottleneck
from ..ops.entropy.gaussian import GaussianConditional
from ..ops.gdn import GDN1
from ..registry import get, register_layer
from .precision import compute, resolve_dtype
from .resnet import BatchNorm2d


@register_layer
class FPBasedResNetBottleneck(nn.Module):
    """Factorized-prior bottleneck replacing ResNet stem+layer1: 3-conv GDN
    encoder (stride 4 total), entropy bottleneck over the latent, 3-conv
    IGDN decoder. CompressAI key space (`encoder.0` ... `decoder.4`,
    `entropy_bottleneck`). `encoder_channel_sizes`/`decoder_channel_sizes`
    (four widths each, input first) override the widths derived from the
    bottleneck and target channels; the density has
    `num_bottleneck_channels` channels either way, as in the JAX
    package."""

    def __init__(self, num_input_channels: int = 3,
                 num_bottleneck_channels: int = 24,
                 num_target_channels: int = 256,
                 encoder_channel_sizes=None, decoder_channel_sizes=None,
                 dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        enc = list(encoder_channel_sizes or [
            num_input_channels, num_bottleneck_channels * 4,
            num_bottleneck_channels * 2, num_bottleneck_channels])
        dec = list(decoder_channel_sizes or [
            enc[-1], num_target_channels * 2, num_target_channels,
            num_target_channels])
        self.encoder = nn.Sequential(
            nn.Conv2d(enc[0], enc[1], 5, stride=2, padding=2, bias=False),
            GDN1(enc[1]),
            nn.Conv2d(enc[1], enc[2], 5, stride=2, padding=2, bias=False),
            GDN1(enc[2]),
            nn.Conv2d(enc[2], enc[3], 2, stride=1, padding=0, bias=False))
        self.decoder = nn.Sequential(
            nn.Conv2d(dec[0], dec[1], 2, stride=1, padding=1, bias=False),
            GDN1(dec[1], inverse=True),
            nn.Conv2d(dec[1], dec[2], 2, stride=1, padding=0, bias=False),
            GDN1(dec[2], inverse=True),
            nn.Conv2d(dec[2], dec[3], 2, stride=1, padding=1, bias=False))
        self.entropy_bottleneck = EntropyBottleneck(num_bottleneck_channels)
        self.out_channels = dec[3]

    def latent_shape(self, height: int, width: int) -> tuple:
        """(h, w, c) of the latent for an input of height x width."""
        for m in self.encoder:
            if isinstance(m, nn.Conv2d):
                (k, _), (s, _), (p, _) = m.kernel_size, m.stride, m.padding
                height = (height + 2 * p - k) // s + 1
                width = (width + 2 * p - k) // s + 1
        return height, width, self.encoder[-1].out_channels

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """Encoder, quantization, decoder. 'train' (before `update()`): the
        latent plus uniform noise from `generator`, and `io['eb_out'] =
        (y_hat, likelihoods)` for the rate loss when `io` is given.
        'finetune' (after it): the latent dequantized with the medians,
        round(y - median) + median, carrying no gradient."""
        y = self._encode(x)
        if mode == 'train':
            y_hat, likelihoods = self.entropy_bottleneck(
                y, mode='noise', generator=generator)
            if io is not None:
                io['eb_out'] = (y_hat, likelihoods)
        elif mode == 'finetune':
            # the likelihoods are not needed: the quantized latent alone
            y_hat = self.entropy_bottleneck.quantize(y, 'dequantize')
            y_hat = y_hat.detach()
        else:
            raise ValueError(f'unknown mode {mode} (deploy uses encode_ops)')
        return self._decode(y_hat)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder in the compute dtype; the latent in float32."""
        with compute(self.dtype, x):
            return self.encoder(x).to(torch.float32)

    def _decode(self, y_hat: torch.Tensor) -> torch.Tensor:
        with compute(self.dtype, y_hat):
            return self.decoder(y_hat)

    def encode_ops(self, x: torch.Tensor, medians: torch.Tensor) -> dict:
        """Latent integer symbols round(y - median), NCHW int32."""
        y = self._encode(x)
        symbols = torch.round(y - medians[:, None, None]).to(torch.int32)
        return {'symbols': symbols}

    def decode_ops(self, symbols: torch.Tensor,
                   medians: torch.Tensor) -> torch.Tensor:
        y_hat = symbols.to(torch.float32) + medians[:, None, None]
        return self._decode(y_hat)


def _conv_out(size: int, stack) -> int:
    """Spatial size after the convolutions of `stack` (transposed ones
    included)."""
    for m in stack:
        if isinstance(m, nn.Conv2d):
            (k, _), (s, _), (p, _) = m.kernel_size, m.stride, m.padding
            size = (size + 2 * p - k) // s + 1
        elif isinstance(m, nn.ConvTranspose2d):
            (k, _), (s, _), (p, _) = m.kernel_size, m.stride, m.padding
            size = (size - 1) * s - 2 * p + k
    return size


@register_layer
class SHPBasedResNetBottleneck(nn.Module):
    """Scale-hyperprior bottleneck replacing ResNet stem+layer1: g_a/g_s
    conv+GDN stacks as in the FP bottleneck, the hyper-encoder h_a over
    |y|, and the hyper-decoder h_s, whose output is the per-element scale
    of the Gaussian conditional. Reference key space (`g_a.*`, `g_s.*`,
    `h_a.*`, `h_s.*`, `entropy_bottleneck`).

    h_s upsamples with `ConvTranspose2d(5, stride 2, padding 1)`: size
    2 * in + 1 (14 -> 29 -> 59, then a valid 5x5 convolution gives 55),
    the size of the JAX package's input-dilated `ConvTranspose` with
    padding 3, whose kernel is this one flipped (`utils/convert.py`).

    `g_a_channel_sizes`/`g_s_channel_sizes` (four widths each, input
    first) override the derived widths; y has `g_a_channel_sizes[3]`
    channels, which h_a reads and h_s predicts."""

    def __init__(self, num_input_channels: int = 3,
                 num_latent_channels: int = 16,
                 num_bottleneck_channels: int = 24,
                 num_target_channels: int = 256,
                 g_a_channel_sizes=None, g_s_channel_sizes=None,
                 dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        g_a = list(g_a_channel_sizes or [
            num_input_channels, num_bottleneck_channels * 4,
            num_bottleneck_channels * 2, num_bottleneck_channels])
        g_s = list(g_s_channel_sizes or [
            g_a[-1], num_target_channels * 2, num_target_channels,
            num_target_channels])
        bch, lch = g_a[3], num_latent_channels
        self.num_latent_channels = lch
        self.g_a = nn.Sequential(
            nn.Conv2d(g_a[0], g_a[1], 5, stride=2, padding=2, bias=False),
            GDN1(g_a[1]),
            nn.Conv2d(g_a[1], g_a[2], 5, stride=2, padding=2, bias=False),
            GDN1(g_a[2]),
            nn.Conv2d(g_a[2], g_a[3], 2, stride=1, padding=0, bias=False))
        self.g_s = nn.Sequential(
            nn.Conv2d(g_s[0], g_s[1], 2, stride=1, padding=1, bias=False),
            GDN1(g_s[1], inverse=True),
            nn.Conv2d(g_s[1], g_s[2], 2, stride=1, padding=0, bias=False),
            GDN1(g_s[2], inverse=True),
            nn.Conv2d(g_s[2], g_s[3], 2, stride=1, padding=1, bias=False))
        self.h_a = self.make_h_a(bch, lch)
        self.h_s = self.make_h_s(bch, lch)
        self.entropy_bottleneck = EntropyBottleneck(lch)
        self.gaussian_conditional = GaussianConditional()
        self.out_channels = g_s[3]

    @staticmethod
    def make_h_a(bch: int, lch: int) -> nn.Sequential:
        return nn.Sequential(
            nn.Conv2d(bch, lch, 5, stride=2, padding=1, bias=False),
            nn.ReLU(),
            nn.Conv2d(lch, lch, 5, stride=2, padding=2, bias=False))

    @staticmethod
    def make_h_s(bch: int, lch: int) -> nn.Sequential:
        return nn.Sequential(
            nn.ConvTranspose2d(lch, lch, 5, stride=2, padding=1, bias=False),
            nn.LeakyReLU(0.01),
            nn.ConvTranspose2d(lch, lch, 5, stride=2, padding=1, bias=False),
            nn.LeakyReLU(0.01),
            nn.Conv2d(lch, bch, 5, stride=1, padding=0, bias=False))

    def hyper_input(self, y: torch.Tensor) -> torch.Tensor:
        return torch.abs(y)

    def gaussian_params(self, h_s_out: torch.Tensor):
        """(scales, means): the scale hyperprior predicts scales only."""
        return h_s_out, None

    def latent_shape(self, height: int, width: int) -> tuple:
        """((hy, wy, cy), (hz, wz, cz)) of the y and z latents for an
        input of height x width."""
        hy, wy = _conv_out(height, self.g_a), _conv_out(width, self.g_a)
        return ((hy, wy, self.g_a[-1].out_channels),
                (_conv_out(hy, self.h_a), _conv_out(wy, self.h_a),
                 self.num_latent_channels))

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """g_a, the hyperprior and g_s. 'train' (before `update()`): z and
        then y plus uniform noise, both from `generator`, and
        `io['eb_out'] = (z_hat, z_likelihoods)`, `io['gc_out'] = (y_hat,
        y_likelihoods)` when `io` is given. 'finetune' (after it): z
        dequantized with its medians, y with the predicted means, y_hat
        carrying no gradient."""
        y = self._g_a(x)
        z = self._h_a(y)
        if mode == 'train':
            z_hat, z_lik = self.entropy_bottleneck(z, mode='noise',
                                                   generator=generator)
            scales, means = self.gaussian_params(self._h_s(z_hat))
            y_hat, y_lik = self.gaussian_conditional(
                y, scales, means, mode='noise', generator=generator)
            if io is not None:
                io['eb_out'] = (z_hat, z_lik)
                io['gc_out'] = (y_hat, y_lik)
        elif mode == 'finetune':
            z_hat = self.entropy_bottleneck.quantize(z, 'dequantize')
            _, means = self.gaussian_params(self._h_s(z_hat))
            y_hat = (torch.round(y) if means is None
                     else torch.round(y - means) + means).detach()
        else:
            raise ValueError(f'unknown mode {mode} (deploy uses encode_ops)')
        return self._g_s(y_hat)

    def _g_a(self, x: torch.Tensor) -> torch.Tensor:
        """g_a in the compute dtype; y in float32."""
        with compute(self.dtype, x):
            return self.g_a(x).to(torch.float32)

    def _g_s(self, y_hat: torch.Tensor) -> torch.Tensor:
        with compute(self.dtype, y_hat):
            return self.g_s(y_hat)

    def _h_a(self, y: torch.Tensor) -> torch.Tensor:
        with compute(torch.float32, y):
            return self.h_a(self.hyper_input(y))

    def _h_s(self, z_hat: torch.Tensor) -> torch.Tensor:
        with compute(torch.float32, z_hat):
            return self.h_s(z_hat)

    # ---- deploy path -------------------------------------------------------
    def encode_ops(self, x: torch.Tensor, z_medians: torch.Tensor,
                   scale_table: torch.Tensor) -> dict:
        """NCHW int32 `y_symbols` (round(y - means)), `y_indexes` (the
        Gaussian table rows) and `z_symbols` (round(z - medians)). The
        indexes come from z's symbols, as the decoder will compute them."""
        y = self._g_a(x)
        z = self._h_a(y)
        z_symbols = torch.round(z - z_medians[:, None, None]).to(torch.int32)
        indexes, means = self.decode_scales(z_symbols, z_medians,
                                            scale_table)
        y_symbols = torch.round(y if means is None else y - means)
        return {'y_symbols': y_symbols.to(torch.int32),
                'y_indexes': indexes, 'z_symbols': z_symbols}

    def decode_scales(self, z_symbols: torch.Tensor, z_medians: torch.Tensor,
                      scale_table: torch.Tensor):
        """(y indexes NCHW int32, means or None) from z's symbols."""
        z_hat = z_symbols.to(torch.float32) + z_medians[:, None, None]
        scales, means = self.gaussian_params(self._h_s(z_hat))
        return self.gaussian_conditional.build_indexes(
            scales, scale_table), means

    def decode_ops(self, y_symbols: torch.Tensor,
                   means: torch.Tensor | None) -> torch.Tensor:
        """The decoded feature: g_s of y's symbols plus the means that
        `decode_scales` gave with y's indexes (MSHP; None for SHP)."""
        y_hat = y_symbols.to(torch.float32)
        if means is not None:
            y_hat = y_hat + means
        return self._g_s(y_hat)


@register_layer
class MSHPBasedResNetBottleneck(SHPBasedResNetBottleneck):
    """Mean-scale hyperprior: h_a sees y itself (LeakyReLU in place of
    ReLU); h_s emits twice the bottleneck channels, split into scales and
    means along the channels."""

    @staticmethod
    def make_h_a(bch: int, lch: int) -> nn.Sequential:
        return nn.Sequential(
            nn.Conv2d(bch, lch, 5, stride=2, padding=1, bias=False),
            nn.LeakyReLU(0.01),
            nn.Conv2d(lch, lch, 5, stride=2, padding=2, bias=False))

    @staticmethod
    def make_h_s(bch: int, lch: int) -> nn.Sequential:
        return nn.Sequential(
            nn.ConvTranspose2d(lch, lch, 5, stride=2, padding=1, bias=False),
            nn.LeakyReLU(0.01),
            nn.ConvTranspose2d(lch, lch * 3 // 2, 5, stride=2, padding=1,
                               bias=False),
            nn.LeakyReLU(0.01),
            nn.Conv2d(lch * 3 // 2, bch * 2, 5, stride=1, padding=0,
                      bias=False))

    def hyper_input(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def gaussian_params(self, h_s_out: torch.Tensor):
        scales, means = torch.chunk(h_s_out, 2, dim=1)
        return scales, means


class LayerSeq(nn.Sequential):
    """A stack read from a spec list, one module per spec (the reference
    torch key space `{i}.*`, the JAX package's `layer{i}`):
      ('conv', out_ch, kernel, stride, padding)   bias-free Conv2d
      ('deconv', out_ch, kernel, stride)          bias-free ConvTranspose2d
      ('bn',), ('relu',), ('maxpool', k, s, p), ('avgpool', k, s)
    BatchNorm has eps 1e-5 and Flax's running-variance rule. A 'deconv' is
    the JAX package's `ConvTranspose(padding='SAME')`, whose output is
    `stride` times its input; torch's with padding 0 gives that size only
    when the kernel equals the stride, the one case the configs use."""

    def __init__(self, specs, in_channels: int):
        modules, c = [], in_channels
        for spec in specs:
            kind = spec[0]
            if kind == 'conv':
                _, out, k, stride, pad = spec
                modules.append(nn.Conv2d(c, out, k, stride=stride,
                                         padding=pad, bias=False))
                c = out
            elif kind == 'deconv':
                _, out, k, stride = spec
                if k != stride:
                    raise ValueError(f'deconv with kernel {k} != stride '
                                     f'{stride} is not supported')
                modules.append(nn.ConvTranspose2d(c, out, k, stride=stride,
                                                  bias=False))
                c = out
            elif kind == 'bn':
                modules.append(BatchNorm2d(c, eps=1e-5))
            elif kind == 'relu':
                modules.append(nn.ReLU())
            elif kind == 'maxpool':
                _, k, stride, pad = spec
                modules.append(nn.MaxPool2d(k, stride=stride, padding=pad))
            elif kind == 'avgpool':
                _, k, stride = spec
                modules.append(nn.AvgPool2d(k, stride=stride))
            else:
                raise ValueError(f'unknown spec {spec}')
        super().__init__(*modules)
        self.out_channels = c


@register_layer
class SimpleBottleneck(nn.Module):
    """Encoder -> decoder with no entropy model, the CR+BQ family's
    bottleneck: the forward is encoder then decoder in every mode, and
    records the latent as `io['bottleneck_out']`. The `SplitClassifier`
    wrapper quantizes the latent between the two on the host."""

    def __init__(self, encoder_specs, decoder_specs):
        super().__init__()
        self.encoder = LayerSeq(encoder_specs, 3)
        self.decoder = LayerSeq(decoder_specs, self.encoder.out_channels)
        self.out_channels = self.decoder.out_channels

    def encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        z = self.encoder(x)
        if io is not None:
            io['bottleneck_out'] = z
        return self.decoder(z)


def _stem_specs():
    """conv7s2 + BN + ReLU + maxpool3s2 front of the CR+BQ encoders."""
    return [('conv', 64, 7, 2, 3), ('bn',), ('relu',), ('maxpool', 3, 2, 1),
            ('bn',), ('relu',)]


@register_layer
def larger_resnet_bottleneck(bottleneck_channel=12, bottleneck_idx=7,
                             output_channel=256, **kwargs):
    """GHND bottleneck for ResNet-50/101/152: the encoder is the specs
    before `bottleneck_idx` (a stride-8 latent of `bottleneck_channel`
    channels), the decoder upsamples it to `output_channel` channels at
    stride 4, the input of layer2. Other kwargs (the reference's
    `compressor`/`decompressor`) are accepted and unused: the wrapper
    takes its transforms from its own config."""
    specs = _stem_specs() + [
        ('conv', bottleneck_channel, 2, 2, 0), ('bn',), ('relu',),
        ('conv', 512, 2, 1, 1), ('bn',), ('relu',),
        ('conv', 512, 2, 1, 0), ('bn',), ('relu',),
        ('deconv', 256, 2, 2), ('bn',), ('relu',),
        ('conv', output_channel, 2, 1, 1), ('bn',), ('relu',),
        ('conv', output_channel, 2, 1, 0),
    ]
    return SimpleBottleneck(specs[:bottleneck_idx], specs[bottleneck_idx:])


@register_layer
def larger_densenet_bottleneck(bottleneck_channel=12, bottleneck_idx=8,
                               **kwargs):
    """GHND bottleneck for DenseNet-169/201: a 256-channel feature at
    stride 16 (14x14 on 224 px), the input of denseblock3."""
    specs = _stem_specs() + [
        ('conv', bottleneck_channel, 2, 2, 1), ('bn',), ('relu',),
        ('conv', 512, 2, 1, 1), ('bn',), ('relu',),
        ('conv', 512, 2, 1, 1), ('bn',), ('relu',),
        ('conv', 256, 2, 1, 0), ('bn',), ('relu',),
        ('conv', 256, 2, 1, 0), ('bn',), ('relu',),
        ('conv', 256, 2, 1, 0), ('avgpool', 2, 2),
    ]
    return SimpleBottleneck(specs[:bottleneck_idx], specs[bottleneck_idx:])


@register_layer
def inception_v3_bottleneck(bottleneck_channel=12, bottleneck_idx=7,
                            **kwargs):
    """GHND bottleneck for Inception-v3: an unpadded 7x7/2 stem and max
    pool, and a 192-channel feature (35x35 on 299 px), the input of
    Mixed_5b."""
    specs = [
        ('conv', 64, 7, 2, 0), ('bn',), ('relu',), ('maxpool', 3, 2, 0),
        ('bn',), ('relu',),
        ('conv', bottleneck_channel, 2, 2, 1), ('bn',), ('relu',),
        ('conv', 256, 2, 1, 1), ('bn',), ('relu',),
        ('conv', 256, 2, 1, 0), ('bn',), ('relu',),
        ('conv', 192, 2, 1, 0), ('avgpool', 2, 1),
    ]
    return SimpleBottleneck(specs[:bottleneck_idx], specs[bottleneck_idx:])


def _layer1_specs(bottleneck_channel, head_channels):
    """The layer1-replacing bottlenecks: every conv at stride 1, so the
    feature keeps the input's size; `head_channels` are the last four
    convs' widths (the smaller variant's for ResNet-18/34, the larger's
    for ResNet-50 and deeper)."""
    c1, c2, c3, c4 = head_channels
    return [
        ('conv', 64, 2, 1, 1), ('bn',),
        ('conv', 256, 2, 1, 1), ('bn',), ('relu',),
        ('conv', 64, 2, 1, 1), ('bn',),
        ('conv', bottleneck_channel, 2, 1, 1), ('bn',), ('relu',),
        ('conv', c1, 2, 1, 0), ('bn',),
        ('conv', c2, 2, 1, 0), ('bn',), ('relu',),
        ('conv', c3, 2, 1, 0), ('bn',),
        ('conv', c4, 2, 1, 0), ('bn',), ('relu',),
    ]


@register_layer
def smaller_resnet_layer1_bottleneck(bottleneck_channel=12, bottleneck_idx=8,
                                     **kwargs):
    specs = _layer1_specs(bottleneck_channel, (64, 128, 64, 64))
    return SimpleBottleneck(specs[:bottleneck_idx], specs[bottleneck_idx:])


@register_layer
def larger_resnet_layer1_bottleneck(bottleneck_channel=12, bottleneck_idx=8,
                                    **kwargs):
    specs = _layer1_specs(bottleneck_channel, (64, 128, 256, 256))
    return SimpleBottleneck(specs[:bottleneck_idx], specs[bottleneck_idx:])


@register_layer
class EntropyBottleneckLayer(nn.Module):
    """A bare factorized prior over its NCHW input. 'train': y + noise
    from `generator`; any other mode: round(y - median) + median, which
    'finetune' detaches. `io['eb_out'] = (y_hat, likelihoods)`."""

    def __init__(self, channels: int):
        super().__init__()
        self.entropy_bottleneck = EntropyBottleneck(channels)
        self.out_channels = channels

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        y_hat, likelihoods = self.entropy_bottleneck(
            x, mode='noise' if mode == 'train' else 'dequantize',
            generator=generator)
        if io is not None:
            io['eb_out'] = (y_hat, likelihoods)
        return y_hat.detach() if mode == 'finetune' else y_hat

    def encode_ops(self, x: torch.Tensor, medians: torch.Tensor) -> dict:
        return {'symbols': torch.round(x - medians[:, None, None])
                .to(torch.int32)}

    def decode_ops(self, symbols: torch.Tensor,
                   medians: torch.Tensor) -> torch.Tensor:
        return symbols.to(torch.float32) + medians[:, None, None]


def get_layer(key: str, **kwargs) -> nn.Module:
    """Bottleneck layer by registry name; `KeyError` names the registered
    ones when `key` is not among them."""
    return get('layer', key)(**kwargs)
