"""Plain reference of the entropy coder's tables and wire size.

A frozen copy of the coding-table construction (CompressAI's
`EntropyBottleneck.update()`: the pmf over each channel's quantile
support, quantized to a 16-bit CDF) and of the lane-interleaved rANS
wire's size ("tpu-lane-v1": a 4-byte head, 6 bytes a lane, 2 bytes a
renormalization chunk). The coder below counts each lane's chunks with
the same state arithmetic as the numpy oracle of the format, vectorized
over images and lanes in torch, so that every image of a request can be
sized; it needs no stream content.
"""
from __future__ import annotations

import numpy as np
import torch

PRECISION = 16
RANS_L = 1 << 16


# ---- tables (numpy, float32 with correctly rounded transcendentals) --------

def _softplus(x):
    return np.logaddexp(0.0, np.asarray(x, np.float64)).astype(np.float32)


def _tanh(x):
    return np.tanh(np.asarray(x, np.float64)).astype(np.float32)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))).astype(
        np.float32)


def _logits_cumulative(params, inputs):
    logits = np.asarray(inputs, np.float32)
    i = 0
    while f'_matrix{i}' in params:
        m = _softplus(params[f'_matrix{i}'])
        logits = np.einsum('cij,cjm->cim', m.astype(np.float64),
                           logits.astype(np.float64)).astype(np.float32)
        logits = logits + params[f'_bias{i}']
        if f'_factor{i}' in params:
            logits = logits + _tanh(params[f'_factor{i}']) * _tanh(logits)
        i += 1
    return logits


def pmf_to_quantized_cdf(pmf, precision=PRECISION):
    """CompressAI's `pmf_to_quantized_cdf`: round(p * 2^precision) in
    float32, integer renormalization, zero intervals widened by taking one
    count from the lowest frequency above one."""
    pmf32 = np.asarray(pmf, np.float32)
    total_mass = 1 << precision
    freqs = np.round(pmf32 * np.float32(total_mass)).astype(np.uint64)
    freqs = (np.uint64(total_mass) * freqs) // np.uint64(int(freqs.sum()))
    cdf = np.zeros(len(pmf32) + 1, np.int64)
    np.cumsum(freqs, out=cdf[1:])
    cdf[-1] = total_mass
    for i in np.flatnonzero(cdf[:-1] == cdf[1:]):
        f = np.diff(cdf)
        best = int(np.argmin(np.where(f > 1, f, np.iinfo(np.int64).max)))
        if best < i:
            cdf[best + 1:i + 1] -= 1
        else:
            cdf[i + 1:best + 1] += 1
    return cdf.astype(np.int32)


def factorized_tables(params):
    """{quantized_cdf (C, cols), cdf_length (C,), offset (C,), medians
    (C,)} of a factorized prior from its parameters ({'_matrix0': array,
    ..., 'quantiles': (C, 1, 3)}, host float32)."""
    q = np.asarray(params['quantiles'], np.float32)
    med = q[:, 0, 1]
    minima = np.maximum(np.ceil(med - q[:, 0, 0]), 0).astype(np.int32)
    maxima = np.maximum(np.ceil(q[:, 0, 2] - med), 0).astype(np.int32)
    start = (med - minima).astype(np.float32)
    length = (maxima + minima + 1).astype(np.int32)
    samples = (np.arange(int(length.max()), dtype=np.float32)[None, None, :]
               + start[:, None, None]).astype(np.float32)
    lower = _logits_cumulative(params, samples - np.float32(0.5))
    upper = _logits_cumulative(params, samples + np.float32(0.5))
    sign = -np.sign(lower + upper)
    pmf = np.abs(_sigmoid(sign * upper) - _sigmoid(sign * lower))[:, 0, :]
    tail = _sigmoid(lower[:, 0, 0]) + _sigmoid(-upper[:, 0, -1])
    c = len(length)
    cdf = np.zeros((c, int(length.max()) + 2), np.int32)
    cdf_length = np.zeros(c, np.int32)
    for i in range(c):
        row = pmf_to_quantized_cdf(
            np.concatenate([pmf[i][:length[i]], [tail[i]]]))
        cdf[i, :len(row)] = row
        cdf_length[i] = length[i] + 2
    return {'quantized_cdf': cdf, 'cdf_length': cdf_length,
            'offset': -minima, 'medians': med}


def params_of(sd, prefix):
    """The factorized prior's parameters of state dict `sd` as host
    float32 arrays (the input of `factorized_tables`)."""
    return {k[len(prefix) + 1:]: v.detach().float().cpu().numpy()
            for k, v in sd.items() if k.startswith(prefix + '.')}


# ---- the wire -----------------------------------------------------------------

def auto_lanes(n_symbols, channels, target_steps=256, lo=16, hi=4096):
    """The format's cyclic lane count: C * 2^j lanes, about
    `target_steps` symbols a lane."""
    want = max(n_symbols // target_steps, 1)
    k = max(want // channels, 1)
    lanes = channels * (1 << max((k - 1).bit_length(), 0))
    while lanes > hi and lanes > channels:
        lanes //= 2
    return max(min(lanes, hi if hi >= channels else lanes),
               min(lo, lanes))


def in_support(sym, tables):
    """(k,) bool: every symbol of each row of (k, n) channels-last
    symbols lies inside its channel's CDF support."""
    c = len(tables['offset'])
    dev = sym.device
    off = torch.as_tensor(tables['offset'], device=dev).to(torch.int64)
    top = torch.as_tensor(tables['cdf_length'], device=dev).to(
        torch.int64) - 2
    ch = torch.arange(sym.shape[1], device=dev) % c
    v = sym.to(torch.int64) - off[ch]
    return ((v >= 0) & (v < top[ch])).all(dim=1)


def wire_nbytes(sym, tables, lanes=None):
    """Exact wire bytes of each row of (k, n) channels-last int symbols:
    lane j codes positions j, j + N, ... against channel j mod C; a lane
    emits one 16-bit chunk each time its state would overflow. Symbols
    outside the support are clamped into it (such an image leaves the
    device wire, `in_support`)."""
    cdf = torch.as_tensor(tables['quantized_cdf'], device=sym.device).to(
        torch.int64)
    c = cdf.shape[0]
    k, n = sym.shape
    lanes = lanes or auto_lanes(n, c)
    steps = -(-n // lanes)
    ch = torch.arange(lanes, device=sym.device) % c
    off = torch.as_tensor(tables['offset'], device=sym.device).to(
        torch.int64)[ch]
    top = torch.as_tensor(tables['cdf_length'], device=sym.device).to(
        torch.int64)[ch] - 3
    pad = steps * lanes - n
    s = sym.to(torch.int64)
    if pad:
        s = torch.cat([s, off[torch.arange(n, n + pad, device=sym.device)
                               % lanes].expand(k, pad)], dim=1)
    v = torch.minimum(torch.clamp_min(s.reshape(k, steps, lanes) - off, 0),
                      top)
    rows = cdf[ch]                                    # (lanes, cols)
    x = torch.full((k, lanes), RANS_L, dtype=torch.int64, device=sym.device)
    chunks = torch.zeros((k, lanes), dtype=torch.int64, device=sym.device)
    lane_idx = torch.arange(lanes, device=sym.device).expand(k, lanes)
    for t in range(steps - 1, -1, -1):
        st = rows[lane_idx, v[:, t]]
        fr = rows[lane_idx, v[:, t] + 1] - st
        renorm = x >= (fr << 16)
        chunks += renorm
        x = torch.where(renorm, x >> 16, x)
        x = ((x // fr) << PRECISION) + (x % fr) + st
    return 4 + 6 * lanes + 2 * chunks.sum(dim=1)
