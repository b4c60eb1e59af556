"""Coding-table construction, the functional `update()` (counterpart of
`sc2bench_tpu/ops/entropy/tables.py`).

A host-side numpy copy of the JAX package's evaluation: elementwise +/-
stay float32, transcendentals and the tiny per-channel matmul evaluate in
float64 and round to float32. The quantized tables are therefore
bit-identical to the JAX package's for the same parameters: the factorized
prior's (`build_factorized_tables`) and the Gaussian conditional's
(`build_gaussian_tables`, one row per entry of the scale table, with
scipy's normal quantile and erfc).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..math import pmf_to_quantized_cdf
from .gaussian import get_scale_table


@dataclasses.dataclass
class CodingTables:
    """Quantized CDF tables for one entropy model (host-side numpy)."""

    quantized_cdf: np.ndarray   # int32 (num_dists, max_cdf_length)
    cdf_length: np.ndarray      # int32 (num_dists,)
    offset: np.ndarray          # int32 (num_dists,)
    # Per-channel medians (factorized prior only) used to center symbols.
    medians: np.ndarray | None = None
    # The scale of each row (Gaussian conditional only), float32.
    scale_table: np.ndarray | None = None

    def state_dict(self) -> dict:
        """The tables as {name: array}, without the fields that are None."""
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_state_dict(cls, d: dict) -> 'CodingTables':
        return cls(**{k: np.asarray(v) for k, v in d.items()})


def _pack_rows(pmfs, pmf_lengths, tail_masses, precision=16):
    """Quantize each pmf row (+ tail symbol) into a padded int32 CDF matrix
    (CompressAI `EntropyModel._pmf_to_cdf`): row i's cdf has
    pmf_length[i]+2 entries; the matrix is (num_dists, max_pmf_length+2)."""
    n = len(pmf_lengths)
    max_cdf_len = int(max(pmf_lengths)) + 2
    cdf = np.zeros((n, max_cdf_len), np.int32)
    cdf_length = np.zeros(n, np.int32)
    for i in range(n):
        length = int(pmf_lengths[i])
        prob = np.concatenate([pmfs[i][:length], [float(tail_masses[i])]])
        row = pmf_to_quantized_cdf(prob, precision)
        cdf[i, :len(row)] = row
        cdf_length[i] = length + 2
    return cdf, cdf_length


def _softplus_np(x):
    """float32 softplus, correctly rounded via f64."""
    return np.logaddexp(0.0, np.asarray(x, np.float64)).astype(np.float32)


def _tanh32(x):
    """Correctly-rounded float32 tanh (f64 compute, f32 round)."""
    return np.tanh(np.asarray(x, np.float64)).astype(np.float32)


def _sigmoid(x):
    """float32 sigmoid, correctly rounded (f64 compute, f32 round)."""
    return (1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
            ).astype(np.float32)


def _logits_cumulative_np(params, inputs):
    """The factorized prior's logit CDF on host numpy, in CompressAI's op
    order (matmul -> +bias -> +tanh(factor)*tanh(logits))."""
    logits = np.asarray(inputs, np.float32)
    i = 0
    while f'matrix_{i}' in params:
        m = _softplus_np(np.asarray(params[f'matrix_{i}'], np.float32))
        b = np.asarray(params[f'bias_{i}'], np.float32)
        logits = np.einsum('cij,cjm->cim', m.astype(np.float64),
                           logits.astype(np.float64)).astype(np.float32)
        logits = logits + b
        if f'factor_{i}' in params:
            f = _tanh32(np.asarray(params[f'factor_{i}'], np.float32))
            logits = logits + f * _tanh32(logits)
        i += 1
    return logits


def build_factorized_tables(bottleneck, precision: int = 16) -> CodingTables:
    """Tables for an `EntropyBottleneck` module: its pmf support per
    channel spans the learned tail quantiles."""
    params = bottleneck.numpy_params()
    quantiles = params['quantiles']                          # (C, 1, 3)
    medians = quantiles[:, 0, 1]
    minima = np.maximum(np.ceil(medians - quantiles[:, 0, 0]),
                        0).astype(np.int32)
    maxima = np.maximum(np.ceil(quantiles[:, 0, 2] - medians),
                        0).astype(np.int32)
    pmf_start = (medians - minima).astype(np.float32)
    pmf_length = (maxima + minima + 1).astype(np.int32)
    max_length = int(pmf_length.max())

    samples = (np.arange(max_length, dtype=np.float32)[None, None, :]
               + pmf_start[:, None, None]).astype(np.float32)

    lower = _logits_cumulative_np(params, samples - np.float32(0.5))
    upper = _logits_cumulative_np(params, samples + np.float32(0.5))
    sign = -np.sign(lower + upper)
    pmf = np.abs(_sigmoid(sign * upper) - _sigmoid(sign * lower))[:, 0, :]
    tail_mass = _sigmoid(lower[:, 0, 0]) + _sigmoid(-upper[:, 0, -1])

    cdf, cdf_length = _pack_rows(pmf, pmf_length, tail_mass, precision)
    return CodingTables(quantized_cdf=cdf, cdf_length=cdf_length,
                        offset=-minima.astype(np.int32),
                        medians=medians.astype(np.float32))


def _std_cdf(x):
    """Standard normal CDF through erfc, float32 result (CompressAI's
    `_standardized_cumulative`: 0.5 * erfc(-x / sqrt(2)))."""
    from scipy.special import erfc
    const = np.float64(-(2.0 ** -0.5))
    return (0.5 * erfc(const * np.asarray(x, np.float64))
            ).astype(np.float32)


def build_gaussian_tables(scale_table: np.ndarray | None = None,
                          tail_mass: float = 1e-9,
                          precision: int = 16) -> CodingTables:
    """Tables of a `GaussianConditional`: row i codes N(0, scale_i^2) over
    [-c_i, c_i], c_i = ceil(scale_i * Phi^-1(1 - tail_mass / 2)), in
    float32 with CompressAI's operation order."""
    from scipy.stats import norm
    if scale_table is None:
        scale_table = get_scale_table()
    scale_table = np.asarray(scale_table, np.float32)
    multiplier = -norm.ppf(tail_mass / 2)
    pmf_center = np.ceil(scale_table * np.float32(multiplier)).astype(
        np.int32)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())
    samples = np.abs(np.arange(max_length, dtype=np.int32)[None, :]
                     - pmf_center[:, None]).astype(np.float32)
    scales = scale_table[:, None]
    upper = _std_cdf(((np.float32(0.5) - samples) / scales
                      ).astype(np.float32))
    lower = _std_cdf(((np.float32(-0.5) - samples) / scales
                      ).astype(np.float32))
    pmf = (upper - lower).astype(np.float32)
    tail_masses = (2 * lower[:, 0]).astype(np.float32)
    cdf, cdf_length = _pack_rows(pmf, pmf_length, tail_masses, precision)
    return CodingTables(quantized_cdf=cdf, cdf_length=cdf_length,
                        offset=-pmf_center.astype(np.int32),
                        scale_table=scale_table)
