"""Plain reference of the joint autoregressive and hierarchical prior codec
(mbt2018: Minnen, Balle and Toderici, NeurIPS 2018, arXiv:1809.02736, as
CompressAI's `mbt2018`) in front of ResNet-50, its Gaussian conditional's
coding tables and the byte count of its lane wire ("jahp-lane-v1").

Written from the paper and CompressAI over a flat state dict in
CompressAI's key space, with `torch.nn.functional` calls and no module of
the program:

    g_a      four 5x5/2 convolutions, GDN between (x -> y, /16)
    h_a      conv 3x3/1, LeakyReLU, conv 5x5/2, LeakyReLU, conv 5x5/2
    z_hat    round(z - median) + median, the medians the density's
    h_s      deconv 5x5/2, LeakyReLU, deconv 5x5/2 (3M/2), LeakyReLU,
             conv 3x3/1 (2M): the hyper feature
    context  one 5x5 convolution with the 'A' mask (the 12 positions before
             the centre in raster order) over the whole quantized latent
    params   three 1x1 convolutions over [hyper, context], LeakyReLU 0.01
             between: 2M channels, the Gaussian scales then the means
    g_s      four 5x5/2 transposed convolutions, inverse GDN between
    tail     ResNet-50 (`resnet_fp.teacher_forward`) on the reconstruction

The context model here is teacher-forced: given a decoded latent, one pass
gives every position's mean and scale, as a full forward pass is held
against a cached decode. `serial_latent` instead quantizes front after
front with that same pass, the autoregressive definition, for the images
whose symbols the benchmark needs without a decoded latent.

Departures from the paper and CompressAI, each because the program under
test computes it so:
  - GDN is the simplified form x / (beta + gamma |x|) (`resnet_fp.gdn`),
    not CompressAI's x / sqrt(beta + gamma x^2);
  - a scale's table row counts the entries of the 64-scale table, taken
    in float64, strictly below max(scale, 0.11) (CompressAI compares in
    float32);
  - the Gaussian tables evaluate the normal CDF in float64 and round to
    float32 (CompressAI evaluates erfc in float32);
  - y's symbols are coded on lanes, one lane a (slot, channel) of the
    anti-diagonal fronts 3i + j = d, in place of one range-coder stream.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import rans
from . import resnet_fp as R

SCALES_MIN, SCALES_MAX, SCALES_LEVELS = 0.11, 256.0, 64
TAIL_MASS = 1e-9
KERNEL = 5
SLOPE = 0.01
EB = 'entropy_bottleneck'


# ---- the tensors and how the benchmark draws them -------------------------

def _he_normal(fan_in, scale=1.0):
    return ('normal', scale * math.sqrt(2.0 / fan_in))


def _conv(name, cout, cin, k, scale=1.0):
    fan = cin * k * k
    b = 1.0 / math.sqrt(fan)
    return [(f'{name}.weight', (cout, cin, k, k),
             _he_normal(fan, scale)),
            (f'{name}.bias', (cout,), ('uniform', -b, b))]


def _deconv(name, cin, cout, k):
    fan = cin * k * k
    b = 1.0 / math.sqrt(fan)
    return [(f'{name}.weight', (cin, cout, k, k), _he_normal(fan)),
            (f'{name}.bias', (cout,), ('uniform', -b, b))]


def codec_specs(n, m):
    """(name, shape, init) of every drawn tensor of the codec at widths
    (N, M): He-normal convolutions (fan-in), the last g_a convolution's
    draw halved, biases uniform in +-1/sqrt(fan-in), fresh GDN and
    entropy bottleneck. `spread_scales` then fixes the scales' layer;
    `codec_state` adds the context kernel's mask."""
    out = []
    chans = (3, n, n, n, m)
    for i in range(4):
        out += _conv(f'g_a.{2 * i}', chans[i + 1], chans[i], 5,
                     0.5 if i == 3 else 1.0)
        if i < 3:
            out += R._gdn_specs(f'g_a.{2 * i + 1}', chans[i + 1])
    chans = (m, n, n, n, 3)
    for i in range(4):
        out += _deconv(f'g_s.{2 * i}', chans[i], chans[i + 1], 5)
        if i < 3:
            out += R._gdn_specs(f'g_s.{2 * i + 1}', chans[i + 1])
    out += _conv('h_a.0', n, m, 3) + _conv('h_a.2', n, n, 5) \
        + _conv('h_a.4', n, n, 5)
    out += _deconv('h_s.0', n, m, 5) + _deconv('h_s.2', m, m * 3 // 2, 5) \
        + _conv('h_s.4', 2 * m, m * 3 // 2, 3)
    out += _conv('context_prediction', 2 * m, m, KERNEL)
    widths = (4 * m, m * 10 // 3, m * 8 // 3, 2 * m)
    for i in range(3):
        out += _conv(f'entropy_parameters.{2 * i}', widths[i + 1],
                     widths[i], 1)
    return out + R.entropy_bottleneck_specs(EB, n)


def causal_mask(k=KERNEL):
    """(k, k) 'A' mask: 1 at the positions strictly before the centre in
    raster order."""
    mask = torch.ones((k, k))
    mask[k // 2, k // 2:] = 0
    mask[k // 2 + 1:] = 0
    return mask


def codec_state(drawn, m):
    """The codec's state dict: the drawn tensors and the context kernel's
    mask buffer."""
    sd = dict(drawn)
    w = sd['context_prediction.weight']
    sd['context_prediction.mask'] = causal_mask().to(w.device).expand(
        w.shape).contiguous()
    return sd


@torch.no_grad()
def spread_scales(sd, m, image, median=4.0):
    """Seeded weights that code as a trained codec's do: the layer that
    gives the scales made positive (|w|, bias 0) and scaled so that their
    median over `image` (1, 3, h, w) is `median`, the means' half damped
    (x 0.1). Every symbol then lies inside its row's support. In place."""
    w = sd['entropy_parameters.4.weight']
    w[:m] = w[:m].abs()
    w[m:] *= 0.1
    sd['entropy_parameters.4.bias'].zero_()
    y = analysis(sd, image)
    feat = torch.cat([hyper_feature(sd, torch.round(h_a(sd, y))),
                      context(sd, torch.round(y))], dim=1)
    scales = entropy_parameters(sd, feat)[:, :m]
    w[:m] *= median / float(scales.median())


# ---- the transforms ---------------------------------------------------------

def _leaky(x):
    return F.leaky_relu(x, SLOPE)


def analysis(sd, x):
    """g_a: y (n, M, h/16, w/16)."""
    for i in range(4):
        x = F.conv2d(x, sd[f'g_a.{2 * i}.weight'], sd[f'g_a.{2 * i}.bias'],
                     stride=2, padding=2)
        if i < 3:
            x = R.gdn(x, sd, f'g_a.{2 * i + 1}', False)
    return x


def synthesis(sd, y_hat):
    """g_s: the reconstruction (n, 3, 16h, 16w)."""
    x = y_hat
    for i in range(4):
        x = F.conv_transpose2d(x, sd[f'g_s.{2 * i}.weight'],
                               sd[f'g_s.{2 * i}.bias'], stride=2, padding=2,
                               output_padding=1)
        if i < 3:
            x = R.gdn(x, sd, f'g_s.{2 * i + 1}', True)
    return x


def h_a(sd, y):
    z = _leaky(F.conv2d(y, sd['h_a.0.weight'], sd['h_a.0.bias'], padding=1))
    z = _leaky(F.conv2d(z, sd['h_a.2.weight'], sd['h_a.2.bias'], stride=2,
                        padding=2))
    return F.conv2d(z, sd['h_a.4.weight'], sd['h_a.4.bias'], stride=2,
                    padding=2)


def hyper_feature(sd, z_hat):
    """h_s: (n, 2M, h, w)."""
    x = _leaky(F.conv_transpose2d(z_hat, sd['h_s.0.weight'],
                                  sd['h_s.0.bias'], stride=2, padding=2,
                                  output_padding=1))
    x = _leaky(F.conv_transpose2d(x, sd['h_s.2.weight'], sd['h_s.2.bias'],
                                  stride=2, padding=2, output_padding=1))
    return F.conv2d(x, sd['h_s.4.weight'], sd['h_s.4.bias'], padding=1)


def context(sd, y_hat):
    """The masked 5x5 convolution over the whole quantized latent."""
    w = sd['context_prediction.weight'] * sd['context_prediction.mask']
    return F.conv2d(y_hat, w, sd['context_prediction.bias'],
                    padding=KERNEL // 2)


def entropy_parameters(sd, feat):
    for i in range(3):
        feat = F.conv2d(feat, sd[f'entropy_parameters.{2 * i}.weight'],
                        sd[f'entropy_parameters.{2 * i}.bias'])
        if i < 2:
            feat = _leaky(feat)
    return feat


def medians(sd):
    return sd[f'{EB}.quantiles'][:, 0, 1]


def z_symbols(sd, y):
    """round(h_a(y) - median), int32."""
    return torch.round(h_a(sd, y) - medians(sd)[:, None, None]).to(
        torch.int32)


def hyper_from_symbols(sd, z_sym):
    return hyper_feature(sd, z_sym.to(torch.float32)
                         + medians(sd)[:, None, None])


def gaussian_params(sd, hyper, y_hat):
    """(scales, means), each (n, M, h, w), of every position, the context
    model teacher-forced on `y_hat`."""
    params = entropy_parameters(sd, torch.cat([hyper, context(sd, y_hat)],
                                              dim=1))
    m = params.shape[1] // 2
    return params[:, :m], params[:, m:]


def pad(x, factor=64):
    """Zeros at the bottom and right up to a multiple of `factor` (the
    configs' `AdaptivePad`)."""
    h, w = x.shape[-2:]
    return F.pad(x, (0, -(-w // factor) * factor - w,
                     0, -(-h // factor) * factor - h))


def logits(tsd, image):
    """ResNet-50 (BatchNorm on running statistics) on a reconstruction."""
    return R.teacher_forward(tsd, image, {})


# ---- the scale table and the Gaussian tables --------------------------------

def scale_table():
    """CompressAI's 64 scales, log-spaced from 0.11 to 256 (float64)."""
    return np.exp(np.linspace(np.log(SCALES_MIN), np.log(SCALES_MAX),
                              SCALES_LEVELS))


def scale_indexes(scales):
    """The table row of each scale: the count of the table's entries but
    the last strictly below max(scale, 0.11)."""
    table = torch.as_tensor(scale_table()[:-1], dtype=torch.float64,
                            device=scales.device)
    s = scales.clamp_min(SCALES_MIN).to(torch.float64)
    return (s[..., None] > table).sum(dim=-1).to(torch.int32)


def _normal_cdf(x):
    from scipy.special import erfc
    return (0.5 * erfc(-(2.0 ** -0.5) * np.asarray(x, np.float64))).astype(
        np.float32)


def gaussian_tables():
    """{quantized_cdf (64, cols), cdf_length (64,), offset (64,)}: row i
    codes N(0, scale_i^2) quantized to the integers in [-c_i, c_i], c_i =
    ceil(scale_i * Phi^-1(1 - tail / 2)), the tail mass 1e-9 as the last
    symbol, 16-bit precision (CompressAI's `GaussianConditional.update`)."""
    from scipy.stats import norm
    table = scale_table().astype(np.float32)
    multiplier = np.float32(-norm.ppf(TAIL_MASS / 2))
    center = np.ceil(table * multiplier).astype(np.int32)
    length = 2 * center + 1
    samples = np.abs(np.arange(int(length.max()), dtype=np.int32)[None, :]
                     - center[:, None]).astype(np.float32)
    upper = _normal_cdf(((np.float32(0.5) - samples) / table[:, None])
                        .astype(np.float32))
    lower = _normal_cdf(((np.float32(-0.5) - samples) / table[:, None])
                        .astype(np.float32))
    pmf = (upper - lower).astype(np.float32)
    tail = (2 * lower[:, 0]).astype(np.float32)
    cdf = np.zeros((len(table), int(length.max()) + 2), np.int32)
    for i in range(len(table)):
        row = rans.pmf_to_quantized_cdf(
            np.concatenate([pmf[i][:length[i]], [tail[i]]]))
        cdf[i, :len(row)] = row
    return {'quantized_cdf': cdf, 'cdf_length': length + 2,
            'offset': -center}


# ---- the fronts and the lane wire -------------------------------------------

def fronts(h, w, k=KERNEL):
    """The positions (i, j) of each anti-diagonal front d = a i + j, a =
    k // 2 + 1, in order of i: every position the masked kernel reads lies
    in an earlier front."""
    a = k // 2 + 1
    out = [[] for _ in range(a * (h - 1) + w)]
    for i in range(h):
        for j in range(w):
            out[a * i + j].append((i, j))
    return [f for f in out if f]


def lane_layout(h, w):
    """(rows (T, F) long, cols (T, F) long, active (T, F) bool): slot s of
    front t holds position (rows, cols) where active (0, 0 elsewhere)."""
    fs = fronts(h, w)
    width = max(len(f) for f in fs)
    rows = torch.zeros((len(fs), width), dtype=torch.long)
    cols = torch.zeros_like(rows)
    act = torch.zeros((len(fs), width), dtype=torch.bool)
    for t, f in enumerate(fs):
        for s, (i, j) in enumerate(f):
            rows[t, s], cols[t, s], act[t, s] = i, j, True
    return rows, cols, act


def on_lanes(t_nchw, layout):
    """An (M, h, w) tensor laid out as (T, F, M) by front and slot."""
    rows, cols, _ = layout
    return t_nchw[:, rows.to(t_nchw.device), cols.to(t_nchw.device)] \
        .permute(1, 2, 0)


def y_in_support(sym, idx, tables):
    """Every symbol inside its row's coded support (the last entry is the
    escape slot, outside it)."""
    dev = sym.device
    off = torch.as_tensor(tables['offset'], device=dev).to(torch.int64)
    top = torch.as_tensor(tables['cdf_length'], device=dev).to(
        torch.int64) - 2
    v = sym.to(torch.int64) - off[idx.long()]
    return bool(((v >= 0) & (v < top[idx.long()])).all())


def y_lane_nbytes(sym, idx, act, tables):
    """Bytes of y on the masked lanes: symbols and rows (T, F, M), slot s
    of front t coded where act[t, s]. Lane (s, c) codes its symbols of
    fronts T-1 ... 0 into a 32-bit state from 2^16, emitting 16 bits each
    time the state would overflow; a symbol outside its row's support is
    clamped into it. 4 bytes of head, 6 a lane (length and state), 2 a
    chunk."""
    dev = sym.device
    cdf = torch.as_tensor(tables['quantized_cdf'], device=dev).to(
        torch.int64)
    off = torch.as_tensor(tables['offset'], device=dev).to(torch.int64)
    top = torch.as_tensor(tables['cdf_length'], device=dev).to(
        torch.int64) - 3
    T, F_, M = sym.shape
    rows = idx.to(torch.int64).reshape(T, -1)
    v = torch.minimum((sym.to(torch.int64).reshape(T, -1) - off[rows])
                      .clamp_min(0), top[rows])
    start = cdf[rows, v]
    freq = (cdf[rows, v + 1] - start).clamp_min(1)
    live = act.to(dev).repeat_interleave(M, dim=1)
    x = torch.full((F_ * M,), rans.RANS_L, dtype=torch.int64, device=dev)
    chunks = torch.zeros_like(x)
    for t in range(T - 1, -1, -1):
        a = live[t]
        renorm = a & (x >= (freq[t] << 16))
        chunks += renorm
        x = torch.where(renorm, x >> 16, x)
        x = torch.where(a, (x // freq[t] << rans.PRECISION) + x % freq[t]
                        + start[t], x)
    return 4 + 6 * F_ * M + 2 * int(chunks.sum())


def z_nbytes(z_sym, z_tables):
    """Bytes of z on its cyclic lanes (`rans.wire_nbytes`), z (1, N, h, w)
    channels last."""
    flat = z_sym.permute(0, 2, 3, 1).reshape(1, -1)
    n = z_sym.shape[1]
    return int(rans.wire_nbytes(flat, z_tables,
                                rans.auto_lanes(flat.shape[1], n))[0])


# ---- the serial definition --------------------------------------------------

def serial_latent(sd, y, hyper):
    """The quantized latent and its symbols and rows (each (n, M, h, w)),
    front after front: each front's Gaussian parameters come from the
    teacher-forced pass over the fronts quantized before it."""
    n, m, h, w = y.shape
    y_hat = torch.zeros_like(y)
    sym = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    idx = torch.zeros_like(sym)
    for f in fronts(h, w):
        ii = torch.tensor([p[0] for p in f], device=y.device)
        jj = torch.tensor([p[1] for p in f], device=y.device)
        scales, means = gaussian_params(sd, hyper, y_hat)
        mu = means[:, :, ii, jj]
        q = torch.round(y[:, :, ii, jj] - mu)
        y_hat[:, :, ii, jj] = q + mu
        sym[:, :, ii, jj] = q.to(torch.int32)
        idx[:, :, ii, jj] = scale_indexes(scales[:, :, ii, jj])
    return y_hat, sym, idx


def flops_of_image(sd, tsd, x):
    """One image's forward for FLOP counting on meta tensors: g_a, h_a,
    h_s, the context model and entropy parameters at every position once,
    g_s and ResNet-50 on the reconstruction."""
    y = analysis(sd, x)
    hyper = hyper_feature(sd, h_a(sd, y))
    gaussian_params(sd, hyper, y)
    logits(tsd, synthesis(sd, y))
