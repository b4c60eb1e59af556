"""Plain reference of the Entropic Student's ResNet-50 + factorized-prior
(FP) bottleneck, and of the ResNet-50 teacher.

Written from the published model (sc2-benchmark's
`FPBasedResNetBottleneck`, CompressAI's `EntropyBottleneck` and GDN,
torchvision's ResNet-50) over a flat state dict in torchvision's key
space, with `torch.nn.functional` calls and no module of the program:

    encoder   conv 5x5/2 -> GDN -> conv 5x5/2 -> GDN -> conv 2x2/1
    symbols   round(y - median), the medians the density's quantiles'
    decoder   conv 2x2 (pad 1) -> IGDN -> conv 2x2 -> IGDN -> conv 2x2
              (pad 1)
    tail      layer2-4 of ResNet-50 (BatchNorm on its running statistics),
              global average pool, fc

`param_specs` lists every tensor of the state dict with its shape and how
the benchmark draws it (`portbench/weights.py`). The density model, the
GDN parameterization and the bounds with their pass-through gradients
follow CompressAI, so that the training reference
(`reference/train_stage1.py`) gets the same gradients.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PEDESTAL = 2.0 ** -18
BN_EPS = 1e-5
EB_FILTERS = (3, 3, 3, 3)
EB_INIT_SCALE = 10.0
LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9
STAGES = ((2, 128, 4), (3, 256, 6), (4, 512, 3))   # (layer, width, blocks)

# how the benchmark draws each kind of tensor (portbench/weights.py):
# ('normal', std), ('uniform', lo, hi), ('const', value) or ('eye', ...)
BN_INIT = {'weight': ('uniform', 0.2, 0.6), 'bias': ('uniform', -0.1, 0.1),
           'running_mean': ('uniform', -0.1, 0.1),
           'running_var': ('uniform', 0.5, 1.5)}


def _he(shape, scale=1.0):
    fan_in = shape[1] * shape[2] * shape[3]
    return ('normal', scale * math.sqrt(2.0 / fan_in))


def _bn_specs(prefix, c):
    out = [(f'{prefix}.{k}', (c,), init) for k, init in BN_INIT.items()]
    out.append((f'{prefix}.num_batches_tracked', (), ('count',)))
    return out


def _conv_spec(name, cout, cin, k, scale=1.0):
    shape = (cout, cin, k, k)
    return [(name, shape, _he(shape, scale))]


def _gdn_specs(prefix, c):
    # CompressAI's fresh GDN: beta 1, gamma 0.1 * I, stored as
    # sqrt(value + pedestal)
    return [(f'{prefix}.beta', (c,), ('const', math.sqrt(1.0 + PEDESTAL))),
            (f'{prefix}.gamma', (c, c),
             ('eye', math.sqrt(0.1 + PEDESTAL), math.sqrt(PEDESTAL)))]


def _softplus_inv(y):
    return math.log(math.expm1(y))


def entropy_bottleneck_specs(prefix, channels):
    """CompressAI's fresh `EntropyBottleneck`: constant matrices, uniform
    biases in [-0.5, 0.5], zero factors, quantiles (-10, 0, 10)."""
    dims = (1,) + EB_FILTERS + (1,)
    scale = EB_INIT_SCALE ** (1.0 / (len(EB_FILTERS) + 1))
    out = []
    for i in range(len(EB_FILTERS) + 1):
        out.append((f'{prefix}._matrix{i}', (channels, dims[i + 1], dims[i]),
                    ('const', _softplus_inv(1.0 / scale / dims[i + 1]))))
        out.append((f'{prefix}._bias{i}', (channels, dims[i + 1], 1),
                    ('uniform', -0.5, 0.5)))
        if i < len(EB_FILTERS):
            out.append((f'{prefix}._factor{i}', (channels, dims[i + 1], 1),
                        ('const', 0.0)))
    out.append((f'{prefix}.quantiles', (channels, 1, 3),
                ('quantiles', EB_INIT_SCALE)))
    return out


def bottleneck_specs(prefix, channels, target, halve_last=True):
    """The FP bottleneck's tensors; `halve_last` halves the last encoder
    convolution's draw (the configs' `assumed` list says why)."""
    enc = (3, channels * 4, channels * 2, channels)
    dec = (channels, target * 2, target, target)
    p = f'{prefix}.encoder'
    out = (_conv_spec(f'{p}.0.weight', enc[1], enc[0], 5)
           + _gdn_specs(f'{p}.1', enc[1])
           + _conv_spec(f'{p}.2.weight', enc[2], enc[1], 5)
           + _gdn_specs(f'{p}.3', enc[2])
           + _conv_spec(f'{p}.4.weight', enc[3], enc[2], 2,
                        0.5 if halve_last else 1.0))
    p = f'{prefix}.decoder'
    out += (_conv_spec(f'{p}.0.weight', dec[1], dec[0], 2)
            + _gdn_specs(f'{p}.1', dec[1])
            + _conv_spec(f'{p}.2.weight', dec[2], dec[1], 2)
            + _gdn_specs(f'{p}.3', dec[2])
            + _conv_spec(f'{p}.4.weight', dec[3], dec[2], 2))
    return out + entropy_bottleneck_specs(f'{prefix}.entropy_bottleneck',
                                          channels)


def stage_specs(prefix, cin, width, blocks):
    out = []
    for b in range(blocks):
        p = f'{prefix}.{b}'
        out += _conv_spec(f'{p}.conv1.weight', width, cin, 1)
        out += _bn_specs(f'{p}.bn1', width)
        out += _conv_spec(f'{p}.conv2.weight', width, width, 3)
        out += _bn_specs(f'{p}.bn2', width)
        out += _conv_spec(f'{p}.conv3.weight', 4 * width, width, 1)
        out += _bn_specs(f'{p}.bn3', 4 * width)
        if b == 0:
            out += _conv_spec(f'{p}.downsample.0.weight', 4 * width, cin, 1)
            out += _bn_specs(f'{p}.downsample.1', 4 * width)
        cin = 4 * width
    return out


def fc_specs(prefix, cin, classes):
    bound = 1.0 / math.sqrt(cin)
    return [(f'{prefix}.weight', (classes, cin), ('normal', bound)),
            (f'{prefix}.bias', (classes,), ('uniform', -bound, bound))]


def tail_specs(prefix='', cin=256):
    out = []
    for layer, width, blocks in STAGES:
        out += stage_specs(f'{prefix}layer{layer}', cin, width, blocks)
        cin = 4 * width
    return out


def student_specs(cfg):
    """The splittable ResNet-50 + FP bottleneck of `cfg` (its
    `bottleneck_channels`, `target_channels` and `num_classes`)."""
    return (bottleneck_specs('bottleneck_layer', cfg['bottleneck_channels'],
                             cfg['target_channels'])
            + tail_specs('', cfg['target_channels'])
            + fc_specs('fc', 2048, cfg['num_classes']))


def teacher_specs(cfg):
    """torchvision's ResNet-50 with `cfg['num_classes']` outputs."""
    return (_conv_spec('conv1.weight', 64, 3, 7) + _bn_specs('bn1', 64)
            + stage_specs('layer1', 64, 64, 3) + tail_specs('', 256)
            + fc_specs('fc', 2048, cfg['num_classes']))


# ---- forward ----------------------------------------------------------------

class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes x upward (CompressAI's `LowerBound`)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g,
                           torch.zeros_like(g)), None


def lower_bound(x, bound):
    return _LowerBound.apply(x, bound)


def _nonneg(stored, minimum):
    return lower_bound(stored, (minimum + PEDESTAL) ** 0.5) ** 2 - PEDESTAL


def gdn(x, sd, prefix, inverse):
    """x / (beta + gamma |x|), or times it for the inverse (CompressAI's
    simplified GDN)."""
    beta = _nonneg(sd[f'{prefix}.beta'], 1e-6)
    gamma = _nonneg(sd[f'{prefix}.gamma'], 0.0)
    norm = F.conv2d(torch.abs(x), gamma[:, :, None, None], beta)
    return x * norm if inverse else x / norm


def encode(sd, x, prefix='bottleneck_layer'):
    """The latent y (NCHW float32) of images x."""
    p = f'{prefix}.encoder'
    y = gdn(F.conv2d(x, sd[f'{p}.0.weight'], stride=2, padding=2), sd,
            f'{p}.1', False)
    y = gdn(F.conv2d(y, sd[f'{p}.2.weight'], stride=2, padding=2), sd,
            f'{p}.3', False)
    return F.conv2d(y, sd[f'{p}.4.weight'])


def decode(sd, y_hat, prefix='bottleneck_layer'):
    p = f'{prefix}.decoder'
    z = gdn(F.conv2d(y_hat, sd[f'{p}.0.weight'], padding=1), sd, f'{p}.1',
            True)
    z = gdn(F.conv2d(z, sd[f'{p}.2.weight']), sd, f'{p}.3', True)
    return F.conv2d(z, sd[f'{p}.4.weight'], padding=1)


def medians(sd, prefix='bottleneck_layer'):
    return sd[f'{prefix}.entropy_bottleneck.quantiles'][:, 0, 1]


def symbols(sd, x, prefix='bottleneck_layer'):
    """round(y - median), NCHW int32."""
    y = encode(sd, x, prefix)
    return torch.round(y - medians(sd, prefix)[:, None, None]).to(
        torch.int32)


def dequantize(sd, sym, prefix='bottleneck_layer'):
    return sym.to(torch.float32) + medians(sd, prefix)[:, None, None]


def bn(x, sd, prefix):
    return F.batch_norm(x, sd[f'{prefix}.running_mean'],
                        sd[f'{prefix}.running_var'], sd[f'{prefix}.weight'],
                        sd[f'{prefix}.bias'], False, 0.0, BN_EPS)


def block(x, sd, prefix, stride):
    y = F.relu(bn(F.conv2d(x, sd[f'{prefix}.conv1.weight']), sd,
                  f'{prefix}.bn1'))
    y = F.relu(bn(F.conv2d(y, sd[f'{prefix}.conv2.weight'], stride=stride,
                           padding=1), sd, f'{prefix}.bn2'))
    y = bn(F.conv2d(y, sd[f'{prefix}.conv3.weight']), sd, f'{prefix}.bn3')
    if f'{prefix}.downsample.0.weight' in sd:
        x = bn(F.conv2d(x, sd[f'{prefix}.downsample.0.weight'],
                        stride=stride), sd, f'{prefix}.downsample.1')
    return F.relu(y + x)


def stage(x, sd, prefix, blocks, stride):
    for b in range(blocks):
        x = block(x, sd, f'{prefix}.{b}', stride if b == 0 else 1)
    return x


def tail(sd, feat, io=None, prefix=''):
    """layer2-4 from the decoded feature; `io` gets `layer{i}_out`.
    Returns the layer4 feature."""
    for layer, _, blocks in STAGES:
        feat = stage(feat, sd, f'{prefix}layer{layer}', blocks, 2)
        if io is not None:
            io[f'layer{layer}_out'] = feat
    return feat


def head(sd, feat, prefix='fc'):
    return F.linear(feat.mean(dim=(2, 3)), sd[f'{prefix}.weight'],
                    sd[f'{prefix}.bias'])


def logits_from_symbols(sd, sym):
    """Logits (n, classes) from NCHW symbols: dequantize, decoder, tail,
    pool, fc."""
    return head(sd, tail(sd, decode(sd, dequantize(sd, sym))))


def teacher_forward(sd, x, io):
    """ResNet-50: the stem, layer1-4 into `io`, logits."""
    x = F.max_pool2d(F.relu(bn(F.conv2d(x, sd['conv1.weight'], stride=2,
                                        padding=3), sd, 'bn1')), 3, 2, 1)
    x = stage(x, sd, 'layer1', 3, 1)
    io['layer1_out'] = x
    x = tail(sd, x, io)
    return head(sd, x)


# ---- the factorized prior -------------------------------------------------

def logits_cumulative(sd, inputs, prefix, stop_gradient=False):
    """The density's CDF logits of inputs (C, 1, M)."""
    logits = inputs
    n = len(EB_FILTERS) + 1
    for i in range(n):
        m = F.softplus(sd[f'{prefix}._matrix{i}'])
        b = sd[f'{prefix}._bias{i}']
        if stop_gradient:
            m, b = m.detach(), b.detach()
        logits = torch.matmul(m, logits) + b
        if i < n - 1:
            f = torch.tanh(sd[f'{prefix}._factor{i}'])
            if stop_gradient:
                f = f.detach()
            logits = logits + f * torch.tanh(logits)
    return logits


def likelihoods(sd, y_hat, prefix='bottleneck_layer.entropy_bottleneck'):
    """P(y_hat) = c(y + 0.5) - c(y - 0.5) per element (NCHW), with the
    sign trick in the tails and the lower bound 1e-9."""
    n, c, h, w = y_hat.shape
    flat = y_hat.permute(1, 0, 2, 3).reshape(c, 1, -1)
    m = flat.shape[-1]
    both = logits_cumulative(sd, torch.cat([flat - 0.5, flat + 0.5], -1),
                             prefix)
    lower, upper = both[..., :m], both[..., m:]
    sign = -torch.sign(lower + upper).detach()
    lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    lik = lower_bound(lik, LIKELIHOOD_BOUND)
    return lik.reshape(c, n, h, w).permute(1, 0, 2, 3)


def aux_loss(sd, prefix='bottleneck_layer.entropy_bottleneck'):
    """The quantile loss: only `quantiles` get its gradient."""
    q = sd[f'{prefix}.quantiles']
    logits = logits_cumulative(sd, q, prefix, stop_gradient=True)
    t = math.log(2.0 / TAIL_MASS - 1.0)
    target = torch.tensor([[-t, 0.0, t]], dtype=q.dtype, device=q.device)
    return torch.sum(torch.abs(logits - target))
