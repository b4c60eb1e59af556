"""The port's host rANS coder and the escape path of `stream_deploy_device`
against the JAX package.

The coder (g++-built `host.cpp` and its pure-Python reference) must give
the JAX `RansCoder`'s bytes on the same symbols, escapes included, and
decode them back. An image whose latent leaves the CDF support (`ok=False`)
is re-coded on the host by both runtimes: per-image sizes and the summary
must be exactly equal, and logits agree within rtol=atol=1e-4 (same
symbols; only float summation order differs, as in
`test_torch_port_model.py`, whose fixture this file shares)."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sc2bench_tpu.ops.rans.coder import RansCoder as JaxRansCoder
from sc2bench_tpu_torch.analysis import get_binary_object_size
from sc2bench_tpu_torch.ops.rans.coder import RansCoder
from test_torch_port_model import _deploy, _nchw, models  # noqa: F401

# x30 puts the fixture's second image outside the tables' support
# (symbols in [-9, 11] against offsets of -8..-10 and cdf_length 19..23)
ESCAPE_SCALE = 30.0


def _tables(num_dists=5, support=12, seed=0):
    rng = np.random.default_rng(seed)
    max_len = support + 2
    cdf = np.zeros((num_dists, max_len + 1), np.int32)
    lengths = rng.integers(support // 2, max_len + 1, num_dists)
    for c in range(num_dists):
        w = rng.uniform(0.05, 1.0, lengths[c] - 1)
        freqs = np.maximum((w / w.sum() * (1 << 16)).astype(np.int64), 1)
        freqs[-1] += (1 << 16) - freqs.sum()
        cdf[c, 1:lengths[c]] = np.cumsum(freqs)
    offset = rng.integers(-6, 0, num_dists).astype(np.int32)
    return cdf, lengths.astype(np.int32), offset


def _symbols(n, num_dists, seed):
    """In-support values plus escapes: negative, just past the top, and
    large magnitudes that need several 4-bit bypass chunks."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(-6, 8, n).astype(np.int32)
    far = rng.choice(n, n // 8, replace=False)
    # |value| < 2^27: from there the JAX package's C++ coder, the reference
    # here, shifts a u32 by 32 and does not terminate
    sym[far] = rng.choice([-1, -40, 9, 77, -3000, 65535, -(1 << 20),
                           (1 << 25) + 3], far.size)
    return sym, (np.arange(n) % num_dists).astype(np.int32)


@pytest.mark.parametrize('use_cpp', [True, False], ids=['cpp', 'python'])
def test_host_coder_bytes_equal_jax(use_cpp):
    cdf, lengths, offset = _tables()
    sym, idx = _symbols(600, cdf.shape[0], seed=3)
    ref = JaxRansCoder(cdf, lengths, offset)
    ours = RansCoder(cdf, lengths, offset, use_cpp=use_cpp)
    data = ours.encode_with_indexes(sym, idx)
    assert data == ref.encode_with_indexes(sym, idx)
    np.testing.assert_array_equal(ours.decode_with_indexes(data, idx), sym)


@pytest.mark.parametrize('use_cpp', [True, False], ids=['cpp', 'python'])
def test_host_coder_codes_every_int32_escape(use_cpp):
    """Escapes of 8 and 9 bypass chunks, up to the int32 limits, give the
    bytes of the JAX package's Python reference (its C++ coder does not
    terminate there) and decode back."""
    cdf, lengths, offset = _tables()
    big = [1 << 27, -(1 << 27), 1 << 30, -(1 << 30), 2 ** 31 - 1, -2 ** 31,
           -2 ** 31 + 1, 0, 3]
    sym = np.asarray(big * 2, np.int32)
    idx = (np.arange(sym.size) % cdf.shape[0]).astype(np.int32)
    ref = JaxRansCoder(cdf, lengths, offset, use_cpp=False)
    ours = RansCoder(cdf, lengths, offset, use_cpp=use_cpp)
    data = ours.encode_with_indexes(sym, idx)
    assert data == ref.encode_with_indexes(sym, idx)
    np.testing.assert_array_equal(ours.decode_with_indexes(data, idx), sym)


def test_host_encode_decode_equal_jax(models):  # noqa: F811
    _, jrt, prt, images = models
    x = images[0] * ESCAPE_SCALE
    j = jrt.encode(jnp.asarray(x))
    p = prt.encode(_nchw(x))
    assert p == j
    np.testing.assert_allclose(np.asarray(prt.decode(**p)),
                               np.asarray(jrt.decode(**j)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('kw', [{}, {'wire_batch': 2}, {'pull_wire': True}],
                         ids=['batch1', 'wire_batch2', 'pull_wire'])
def test_escape_image_equals_jax(models, kw):  # noqa: F811
    """One out-of-support image among in-support ones: both runtimes see
    ok=False for it and re-code it on the host coder."""
    _, jrt, prt, images = models
    stream = [images[0], images[1] * ESCAPE_SCALE, images[2]]
    assert not bool(prt.encode_device_wire(_nchw(stream[1]))['ok'])
    j_logits, j_sizes, j_summary = _deploy(
        jrt, [jnp.asarray(x) for x in stream], depth=2, workers=1, **kw)
    prt.escapes = {'ok': 0, 'valid': 0}
    p_logits, p_sizes, p_summary = _deploy(
        prt, [_nchw(x) for x in stream], depth=2, **kw)
    assert prt.escapes == {'ok': 1, 'valid': 0}
    assert p_sizes == j_sizes
    assert p_summary == j_summary
    assert p_sizes[1] == get_binary_object_size(prt.encode(_nchw(stream[1])))
    assert len(p_logits) == len(j_logits) == len(stream)
    for a, b in zip(j_logits, p_logits):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('wire_batch', [None, 2])
def test_invalid_decode_is_recoded_not_raised(models, wire_batch,  # noqa: F811
                                              monkeypatch, caplog):
    """A corrupted device stream (valid=False) is served from the host
    coder: its size is that of `encode(x)` and its logits those of
    `decode(**encode(x))`; the other images are untouched. The escape is
    counted under `valid` and logged."""
    _, _, prt, images = models
    xs = [_nchw(x) for x in images]
    prt.escapes = {'ok': 0, 'valid': 0}
    clean_logits, clean_sizes, _ = _deploy(prt, xs, wire_batch=wire_batch)
    assert prt.escapes == {'ok': 0, 'valid': 0}

    if wire_batch:
        orig = prt.encode_device_wire_batch

        def corrupt(batch, num_lanes=None):
            ops = orig(batch, num_lanes=num_lanes)
            if len(batch) == 2:                   # first group: image 1
                ops['states'][1, 0] ^= 0x5A5A
            return ops
        monkeypatch.setattr(prt, 'encode_device_wire_batch', corrupt)
    else:
        orig = prt.encode_device_wire
        calls = []

        def corrupt(x, num_lanes=None):
            ops = orig(x, num_lanes=num_lanes)
            if len(calls) == 1:                   # image 1
                ops['states'][0] ^= 0x5A5A
            calls.append(1)
            return ops
        monkeypatch.setattr(prt, 'encode_device_wire', corrupt)

    with caplog.at_level(logging.WARNING):
        logits, sizes, _ = _deploy(prt, xs, wire_batch=wire_batch)
    assert prt.escapes == {'ok': 0, 'valid': 1}
    assert 'image 1: device rANS decode' in caplog.text
    compressed = prt.encode(xs[1])
    assert sizes[1] == get_binary_object_size(compressed) != clean_sizes[1]
    assert sizes[0] == clean_sizes[0] and sizes[2] == clean_sizes[2]
    np.testing.assert_array_equal(logits[1],
                                  prt.decode(**compressed).numpy())
    for i in (0, 2):
        np.testing.assert_array_equal(logits[i], clean_logits[i])
    assert all(tuple(lg.shape) == (1, 10) for lg in logits)
    assert torch.isfinite(torch.as_tensor(np.stack(logits))).all()


@pytest.mark.parametrize('use_cpp', [True, False], ids=['cpp', 'python'])
@pytest.mark.parametrize('num_dists,n', [(1, 97), (3, 600), (5, 601),
                                         (5, 3)])
def test_cyclic_i16_wire_bytes_equal_jax(use_cpp, num_dists, n):
    """The cyclic int16 wire (symbol i coded with distribution
    i mod num_dists; n not always a multiple of it) gives the JAX
    `encode_cyclic_i16` bytes, escapes to the int16 limits included, and
    decodes back to the int16 symbols."""
    cdf, lengths, offset = _tables()
    rng = np.random.default_rng(num_dists * 1000 + n)
    sym = rng.integers(-6, 8, n).astype(np.int16)
    sym[::7] = rng.choice([-1, -40, 9, 77, -3000, 32767, -32768],
                          sym[::7].size)
    ref = JaxRansCoder(cdf, lengths, offset).encode_cyclic_i16(sym, num_dists)
    ours = RansCoder(cdf, lengths, offset, use_cpp=use_cpp)
    data = ours.encode_cyclic_i16(sym, num_dists)
    assert data == ref
    back = ours.decode_cyclic_i16(data, n, num_dists)
    assert back.dtype == np.int16
    np.testing.assert_array_equal(back, sym)


def test_cyclic_i16_wire_rejects_bad_num_dists():
    cdf, lengths, offset = _tables()
    ours = RansCoder(cdf, lengths, offset)
    for bad in (0, cdf.shape[0] + 1):
        with pytest.raises(ValueError, match='num_dists'):
            ours.encode_cyclic_i16(np.zeros(4, np.int16), bad)
        with pytest.raises(ValueError, match='num_dists'):
            ours.decode_cyclic_i16(b'\0' * 8, 4, bad)


def _stream(rt, images, **kw):
    rt.clear_analysis()
    rt.activate_analysis()
    out = rt.stream_deploy(images, **kw)
    sizes = list(rt.analyzers[0].file_size_list)
    summary = rt.summarize()
    rt.deactivate_analysis()
    return [np.asarray(o) for o in out], sizes, summary


@pytest.mark.parametrize('kw', [{}, {'decode_batch': 4}, {'depth': 1}],
                         ids=['batch1', 'decode_batch4', 'depth1'])
def test_stream_deploy_host_wire_equals_jax(models, kw):  # noqa: F811
    """The host-coder deploy loop (cyclic int16 wire), an escaping image
    among the stream: per-image sizes and the summary equal the JAX
    runtime's; logits agree within rtol=atol=1e-4, one (1, K) per image."""
    _, jrt, prt, images = models
    stream = [images[0], images[1] * ESCAPE_SCALE, images[2], images[0]]
    j_logits, j_sizes, j_summary = _stream(
        jrt, [jnp.asarray(x) for x in stream], workers=1, **kw)
    p_logits, p_sizes, p_summary = _stream(
        prt, [_nchw(x) for x in stream], **kw)
    assert p_sizes == j_sizes
    assert p_summary == j_summary
    assert len(p_logits) == len(j_logits) == len(stream)
    for a, b in zip(j_logits, p_logits):
        assert a.shape == b.shape == (1, 10)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    # the wire carries the device's int16 symbols
    sym = prt.encode_device(_nchw(images[0]))['symbols']
    assert sym.dtype == torch.int16 and tuple(sym.shape[1:]) == (15, 15, 8)
