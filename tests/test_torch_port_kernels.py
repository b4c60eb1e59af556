"""The four cyclic-lane rANS CUDA kernels against their plain PyTorch
versions.

This file imports neither JAX nor `sc2bench_tpu`, so it also runs where
only the port is installed. The `cuda` tests need a card and skip without
one; on a machine with a card run them with
`python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest`
(the suite's conftest configures JAX). The CPU tests pin the plain
versions themselves against the numpy oracle on edge-case tables."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from sc2bench_tpu_torch.ops.rans import device as td
from sc2bench_tpu_torch.ops.rans import kernels


def _tables(num_dists, support, seed):
    rng = np.random.default_rng(seed)
    max_len = support + 2
    cdf = np.zeros((num_dists, max_len + 1), np.int32)
    cdf_length = np.full(num_dists, max_len + 1, np.int32)
    offset = rng.integers(-20, -5, num_dists).astype(np.int32)
    for c in range(num_dists):
        w = rng.uniform(0.05, 1.0, max_len)
        freqs = np.maximum((w / w.sum() * (1 << 16)).astype(np.int64), 1)
        freqs[-1] += (1 << 16) - freqs.sum()
        cdf[c, 1:] = np.cumsum(freqs)
    return cdf, cdf_length, offset


def _symbols(cdf, cdf_length, offset, n, seed):
    """Cyclic symbols drawn from each row's distribution, in support."""
    c = cdf.shape[0]
    rng = np.random.default_rng(seed)
    idx = np.arange(n) % c
    u = rng.integers(0, 1 << 16, n)
    sym = np.empty(n, np.int32)
    for ch in range(c):
        m = idx == ch
        row = cdf[ch][:cdf_length[ch]]
        v = np.clip(np.searchsorted(row, u[m], side='right') - 1,
                    0, cdf_length[ch] - 3)
        sym[m] = v + offset[ch]
    return sym


def _skewed_tables():
    """Rows at the edges of the 16-bit arithmetic: a symbol of frequency
    65534 (renormalizes at the top of the state range), a uniform row,
    and ragged cdf_length with zero padding past it."""
    cdf = np.zeros((3, 9), np.int32)
    cdf[0, :4] = [0, 65534, 65535, 65536]
    cdf[1, :9] = np.linspace(0, 65536, 9).astype(np.int32)
    cdf[2, :5] = [0, 1, 2, 65535, 65536]
    return cdf, np.asarray([4, 9, 5], np.int32), \
        np.asarray([0, -3, 7], np.int32)


def _wide_tables():
    """Two 225-entry rows with many frequency-2 symbols (a coarse decode
    bucket of 256 slots then holds up to ~20 symbols) and a row of the
    flagship's width with a frequency-1 symbol at value 1."""
    rng = np.random.default_rng(12)
    cdf = np.zeros((3, 225), np.int32)
    for c, width in ((0, 225), (1, 225), (2, 23)):
        w = rng.uniform(0.05, 1.0, width - 1) ** 24
        freqs = np.maximum((w / w.sum() * (1 << 16)).astype(np.int64), 2)
        if c == 2:
            freqs[1] = 1
        freqs[np.argmax(freqs)] += (1 << 16) - freqs.sum()
        cdf[c, 1:width] = np.cumsum(freqs)
    return cdf, np.asarray([225, 225, 23], np.int32), \
        np.asarray([-100, -3, -9], np.int32)


# (channels, lanes, n): lane counts not multiples of 32 or 128, n not a
# multiple of the lane count, the flagship 384 x 190 shape, and 600 steps
# (many staging tiles of the batch-1 kernels)
CASES = [(8, 48, 400), (24, 72, 5000), (24, 384, 72600), (6, 6, 97),
         (24, 168, 168 * 77 + 5), (24, 384, 384 * 600)]


def test_reciprocal_division_is_exact_at_boundary_states():
    """The batch-1 encoder divides a state x < fr * 2^16 by fr as
    (x * m) >> 48 with m = ceil(2^48 / fr), m computed on the card as
    ceil of the upward-rounded double quotient. Checked in Python ints for
    every frequency at the states where a floor goes wrong first: either
    side of each multiple of fr near 0 and near the top of the range."""
    for fr in range(1, (1 << 16) + 1):
        m = -(-(1 << 48) // fr)
        d = (1 << 48) / fr                       # round to nearest
        if Fraction(d) * fr < (1 << 48):         # round up instead
            d = math.nextafter(d, math.inf)
        assert math.ceil(d) == m
        top = fr << 16
        for x in (0, 1, fr - 1, fr, fr + 1, 2 * fr - 1, top - fr - 1,
                  top - fr, top - 2, top - 1):
            if 0 <= x < top:
                assert x * m < 1 << 64
                assert (x * m) >> 48 == x // fr, (fr, x)


@pytest.mark.parametrize('aligned', [False, True])
@pytest.mark.parametrize('tables', ['random', 'skewed'])
def test_plain_versions_equal_numpy_oracle(tables, aligned):
    if tables == 'random':
        cdf, cdf_length, offset = _tables(6, 19, seed=4)
    else:
        cdf, cdf_length, offset = _skewed_tables()
    c, lanes, n = cdf.shape[0], 3 * cdf.shape[0], 701
    sym = _symbols(cdf, cdf_length, offset, n, seed=9)
    enc = td.device_rans_encode(torch.from_numpy(sym), cdf, cdf_length,
                                offset, num_lanes=lanes, cyclic_channels=c,
                                aligned=aligned, want_masks=aligned)
    assert bool(enc['ok'])
    o_streams, o_states = td.numpy_oracle_encode(
        sym, np.arange(n) % c, cdf, cdf_length, offset, num_lanes=lanes,
        cyclic_channels=c)
    np.testing.assert_array_equal(enc['states'].numpy(), o_states)
    wire = td.pack_stream_aligned(enc) if aligned else td.pack_stream(enc)
    streams, _ = td.unpack_stream(wire)
    assert [list(streams[j, :len(s)]) for j, s in enumerate(o_streams)] \
        == o_streams
    dec, valid = td.device_rans_decode(
        enc['streams'], enc['states'], cdf, cdf_length, offset, n_symbols=n,
        num_lanes=lanes, cyclic_channels=c, aligned=aligned)
    assert bool(valid)
    np.testing.assert_array_equal(dec.numpy(), sym)


def test_compacted_decode_reads_zero_past_the_row():
    """A stream row cut short decodes as if padded with zeros (the
    reference kernel's one-hot read), so the result is not valid."""
    cdf, cdf_length, offset = _tables(8, 21, seed=1)
    sym = _symbols(cdf, cdf_length, offset, 960, seed=2)
    enc = td.device_rans_encode(torch.from_numpy(sym), cdf, cdf_length,
                                offset, num_lanes=48, cyclic_channels=8)
    width = int(enc['lengths'].max())
    cut = enc['streams'][:, :width - 1].contiguous()
    padded = torch.cat([cut, torch.zeros((48, 5), dtype=torch.int32)], 1)
    a = td.device_rans_decode(cut, enc['states'], cdf, cdf_length, offset,
                              n_symbols=960, num_lanes=48,
                              cyclic_channels=8)
    b = td.device_rans_decode(padded, enc['states'], cdf, cdf_length,
                              offset, n_symbols=960, num_lanes=48,
                              cyclic_channels=8)
    assert torch.equal(a[0], b[0]) and not bool(a[1]) and not bool(b[1])


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('C,lanes,n', CASES)
def test_kernels_equal_plain_versions_on_the_card(C, lanes, n):
    dev = _card()
    cdf, cdf_length, offset = _tables(C, 21, seed=C)
    rows = np.stack([_symbols(cdf, cdf_length, offset, n, seed=s)
                     for s in (1, 2)])
    cdf_lane, len_lane, off_lane = td.lane_tables(
        cdf, cdf_length, offset, lanes, C, dev)
    sym3, _, _ = td._blocks(torch.from_numpy(rows).to(dev), lanes,
                            off_lane)
    vc = (sym3 - off_lane).contiguous()
    steps = vc.shape[1]
    kernels.reset_launches()
    for aligned in (False, True):
        plain = td.cyclic_encode_plain(cdf_lane, vc, aligned=aligned,
                                       want_masks=aligned)
        got = (kernels.cyclic_encode_aligned(cdf_lane, vc, True) if aligned
               else kernels.cyclic_encode(cdf_lane, vc))
        for a, b in zip(plain, got):
            assert torch.equal(a, b)
        dec = kernels.cyclic_decode_aligned if aligned \
            else kernels.cyclic_decode
        out, xend = dec(got[0], got[2], cdf_lane, len_lane, off_lane, steps)
        pout, pxend = td.cyclic_decode_plain(got[0], got[2], cdf_lane,
                                             len_lane, off_lane, steps,
                                             aligned=aligned)
        torch.cuda.synchronize()
        assert torch.equal(out, pout) and torch.equal(xend, pxend)
        assert bool((xend == td.RANS_L).all())
        flat = out.reshape(2, -1)[:, :n].cpu().numpy()
        np.testing.assert_array_equal(flat, rows)
    assert {kernels.LAUNCHES[k] for k in kernels.KERNELS} == {1}


@pytest.mark.cuda
def test_skewed_tables_on_the_card():
    dev = _card()
    cdf, cdf_length, offset = _skewed_tables()
    sym = _symbols(cdf, cdf_length, offset, 701, seed=9)
    kernels.reset_launches()
    for aligned in (False, True):
        ref = td.device_rans_encode(torch.from_numpy(sym), cdf, cdf_length,
                                    offset, num_lanes=9, cyclic_channels=3,
                                    aligned=aligned)
        got = td.device_rans_encode(torch.from_numpy(sym).to(dev), cdf,
                                    cdf_length, offset, num_lanes=9,
                                    cyclic_channels=3, aligned=aligned)
        for k in ('streams', 'lengths', 'states', 'nbytes'):
            assert torch.equal(ref[k], got[k].cpu()), k
        dec, valid = td.device_rans_decode(
            got['streams'], got['states'], cdf, cdf_length, offset,
            n_symbols=701, num_lanes=9, cyclic_channels=3, aligned=aligned)
        assert bool(valid)
        np.testing.assert_array_equal(dec.cpu().numpy(), sym)
    assert {kernels.LAUNCHES[k] for k in kernels.KERNELS} == {1}


@pytest.mark.cuda
def test_batch1_kernels_on_wide_and_frequency_1_rows_on_the_card():
    """The batch-1 kernels on rows where a coarse decode bucket holds many symbols, and on a
    frequency-1 symbol coded every seventh position, k=3: bit-equal to
    the plain versions, valid on the round trip, invalid when a state is
    corrupted."""
    dev = _card()
    cdf, cdf_length, offset = _wide_tables()
    c, lanes, n = 3, 45, 45 * 60 - 7
    rows = np.stack([_symbols(cdf, cdf_length, offset, n, seed=s)
                     for s in (1, 2, 3)])
    rare = np.arange(n) % c == 2
    rows[:, rare & (np.arange(n) % 7 == 0)] = 1 + offset[2]
    cdf_lane, len_lane, off_lane = td.lane_tables(
        cdf, cdf_length, offset, lanes, c, dev)
    sym3, _, _ = td._blocks(torch.from_numpy(rows).to(dev), lanes,
                            off_lane)
    vc = (sym3 - off_lane).contiguous()
    steps = vc.shape[1]
    plain = td.cyclic_encode_plain(cdf_lane, vc)
    for a, b in zip(plain, kernels.cyclic_encode(cdf_lane, vc)):
        assert torch.equal(a, b)
    streams, _, states = plain
    out, xend = kernels.cyclic_decode(streams, states, cdf_lane, len_lane,
                                      off_lane, steps)
    pout, pxend = td.cyclic_decode_plain(streams, states, cdf_lane,
                                         len_lane, off_lane, steps)
    assert torch.equal(out, pout) and torch.equal(xend, pxend)
    assert bool((xend == td.RANS_L).all())
    np.testing.assert_array_equal(out.reshape(3, -1)[:, :n].cpu().numpy(),
                                  rows)
    bad = states.clone()
    bad[1, 7] ^= 0x5A5A
    out, xend = kernels.cyclic_decode(streams, bad, cdf_lane, len_lane,
                                      off_lane, steps)
    pout, pxend = td.cyclic_decode_plain(streams, bad, cdf_lane, len_lane,
                                         off_lane, steps)
    assert torch.equal(out, pout) and torch.equal(xend, pxend)
    assert not bool((xend[1] == td.RANS_L).all())


@pytest.mark.cuda
def test_batch1_kernels_refuse_steps_beyond_shared_memory_on_the_card():
    dev = _card()
    cols = 23
    limit = kernels.max_steps(False, dev)
    assert limit >= 2048
    cdf_lane = torch.zeros((32, cols), dtype=torch.int32, device=dev)
    vc = torch.zeros((1, limit + 1, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='at most'):
        kernels.cyclic_encode(cdf_lane, vc)


def _aligned_check(dev, tables, lanes, n, k, rare=False):
    """The aligned pair against the plain versions, masks included:
    bit-equal, the symbols back with valid=True, and valid=False with the
    plain version's outputs after a state is corrupted. With
    `rare=True` value 1 of channel 2 (frequency 1 in `_wide_tables`) is
    coded at every seventh position."""
    cdf, cdf_length, offset = tables
    c = cdf.shape[0]
    rows = np.stack([_symbols(cdf, cdf_length, offset, n, seed=s)
                     for s in range(k)])
    if rare:
        pos = np.arange(n)
        rows[:, (pos % c == 2) & (pos % 7 == 0)] = 1 + offset[2]
    cdf_lane, len_lane, off_lane = td.lane_tables(
        cdf, cdf_length, offset, lanes, c, dev)
    sym3, _, _ = td._blocks(torch.from_numpy(rows).to(dev), lanes,
                            off_lane)
    vc = (sym3 - off_lane).contiguous()
    steps = vc.shape[1]
    plain = td.cyclic_encode_plain(cdf_lane, vc, aligned=True,
                                   want_masks=True)
    streams, _, states, _ = plain
    bad = states.clone()
    bad[k - 1, lanes // 3] ^= 0x5A5A
    ref = td.cyclic_decode_plain(streams, states, cdf_lane, len_lane,
                                 off_lane, steps, aligned=True)
    ref_bad = td.cyclic_decode_plain(streams, bad, cdf_lane, len_lane,
                                     off_lane, steps, aligned=True)
    got = kernels.cyclic_encode_aligned(cdf_lane, vc, True)
    out, xend = kernels.cyclic_decode_aligned(
        streams, states, cdf_lane, len_lane, off_lane, steps)
    out_bad, xend_bad = kernels.cyclic_decode_aligned(
        streams, bad, cdf_lane, len_lane, off_lane, steps)
    torch.cuda.synchronize()
    for a, b in zip(plain, got):
        assert torch.equal(a, b)
    assert torch.equal(out, ref[0]) and torch.equal(xend, ref[1])
    assert torch.equal(out_bad, ref_bad[0])
    assert torch.equal(xend_bad, ref_bad[1])
    assert bool((xend == td.RANS_L).all())
    assert not bool((xend_bad[k - 1] == td.RANS_L).all())
    np.testing.assert_array_equal(
        out.reshape(k, -1)[:, :n].cpu().numpy(), rows)
    return steps


# (k, lanes, n): the flagship 384 x 190 at k not a multiple of the block
# group (4 images a block) and at k = 128 (the throughput mode's
# wire_batch, where the decoder takes 8), lane counts not multiples of 32,
# and 600 steps
ALIGNED_CASES = [(1, 384, 72600), (3, 384, 72600), (5, 384, 72600),
                 (128, 384, 72600), (3, 72, 5000), (3, 168, 168 * 77 + 5),
                 (2, 384, 384 * 600)]


@pytest.mark.cuda
@pytest.mark.parametrize('k,lanes,n', ALIGNED_CASES)
def test_aligned_kernels_equal_plain_versions_on_the_card(k, lanes, n):
    dev = _card()
    if lanes == 384:
        assert kernels.aligned_group(False, k, lanes) == 4
        assert kernels.aligned_group(True, k, lanes) == (8 if k == 128 else 4)
    _aligned_check(dev, _tables(24, 21, seed=k), lanes, n, k)


@pytest.mark.cuda
def test_aligned_kernels_take_steps_beyond_the_batch1_limit_on_the_card():
    """The aligned pair's shared memory does not grow with T: it takes a
    T where the batch-1 pair raises."""
    dev = _card()
    lanes = 48
    steps = kernels.max_steps(False, dev) + 5
    tables = _tables(8, 21, seed=3)
    assert _aligned_check(dev, tables, lanes, lanes * steps - 7, 2) == steps
    cdf_lane = torch.zeros((lanes, 23), dtype=torch.int32, device=dev)
    vc = torch.zeros((1, steps, lanes), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='at most'):
        kernels.cyclic_encode(cdf_lane, vc)


@pytest.mark.cuda
def test_aligned_kernels_on_wide_and_frequency_1_rows_on_the_card():
    dev = _card()
    _aligned_check(dev, _wide_tables(), 45, 45 * 60 - 7, 3, rare=True)


@pytest.mark.cuda
@pytest.mark.parametrize('support', [597, 1197], ids=['600cols', '1200cols'])
@pytest.mark.parametrize('k', [1, 8])
def test_all_kernels_take_wide_rows_on_the_card(support, k):
    """CDF rows of 600 and 1,200 entries on the flagship's 384 lanes,
    beyond the shared-memory plans (all four at 1,200; at 600 the aligned
    decoder's four-image blocks still hold them): those launches read
    their lane tables from a device buffer, and all four kernels stay
    bit-equal to their plain versions, batch 1 and aligned. The aligned
    indexed encoder on the same rows, a row drawn for each symbol, masks
    off and on, equals its plain version too."""
    dev = _card()
    tables = _tables(24, support, seed=support + k)
    cols = tables[0].shape[1]
    lanes, n = 384, 72600
    steps = n // lanes + 1
    for name in kernels.KERNELS:
        wide = kernels.table_bytes(name, cols, steps, steps, k, lanes, dev)
        assert wide > 0 or (cols == 600
                            and name == 'rans_cyclic_decode_aligned'), name
        assert kernels.table_bytes(name, 23, steps, steps, k, lanes,
                                   dev) == 0, name
    kernels.reset_launches()
    assert _aligned_check(dev, tables, lanes, n, k) == steps
    cdf, cdf_length, offset = tables
    rows = np.stack([_symbols(cdf, cdf_length, offset, n, seed=s)
                     for s in range(k)])
    cdf_lane, len_lane, off_lane = td.lane_tables(
        cdf, cdf_length, offset, lanes, 24, dev)
    sym3, _, _ = td._blocks(torch.from_numpy(rows).to(dev), lanes,
                            off_lane)
    vc = (sym3 - off_lane).contiguous()
    plain = td.cyclic_encode_plain(cdf_lane, vc)
    got = kernels.cyclic_encode(cdf_lane, vc)
    out, xend = kernels.cyclic_decode(got[0], got[2], cdf_lane, len_lane,
                                      off_lane, steps)
    pout, pxend = td.cyclic_decode_plain(got[0], got[2], cdf_lane, len_lane,
                                         off_lane, steps)
    torch.cuda.synchronize()
    for a, b in zip(plain, got):
        assert torch.equal(a, b)
    assert torch.equal(out, pout) and torch.equal(xend, pxend)
    np.testing.assert_array_equal(out.reshape(k, -1)[:, :n].cpu().numpy(),
                                  rows)
    assert {kernels.LAUNCHES[name] for name in kernels.KERNELS} == {1, 2}
    # the aligned indexed encoder on the same rows as general tables, each
    # symbol's row drawn at random (its entries gathered from L2)
    from sc2bench_tpu_torch.ops.rans.indexed_tables import \
        prepare_indexed_tables
    rng = np.random.default_rng(support + k)
    ridx = rng.integers(0, 24, vc.shape).astype(np.int32)
    u = rng.integers(0, 1 << 16, vc.shape)
    v = np.empty(vc.shape, np.int64)
    for r in range(24):
        m = ridx == r
        v[m] = np.clip(np.searchsorted(cdf[r][:cdf_length[r]], u[m],
                                       side='right') - 1, 0,
                       cdf_length[r] - 3)
    cdf_t = torch.from_numpy(cdf).to(dev)
    prepared = prepare_indexed_tables(cdf_t, torch.from_numpy(cdf_length),
                                      torch.from_numpy(offset))
    ridx = torch.from_numpy(ridx).to(dev)
    v = torch.from_numpy(v.astype(np.int32)).to(dev)
    for want_masks in (False, True):
        got = kernels.indexed_encode_aligned(cdf_t, v, ridx, want_masks,
                                             prepared=prepared)
        plain = td.indexed_encode_plain(cdf_t, v, ridx, aligned=True,
                                        want_masks=want_masks)
        torch.cuda.synchronize()
        for a, b in zip(got, plain):
            assert (a is None and b is None) or torch.equal(a, b)
    assert kernels.LAUNCHES['rans_indexed_encode_aligned'] == 2


@pytest.mark.cuda
def test_wrappers_refuse_bad_arguments_on_the_card():
    dev = _card()
    cdf_lane = torch.zeros((8, 5), dtype=torch.int32, device=dev)
    vc = torch.zeros((1, 4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='dtype'):
        kernels.cyclic_encode(cdf_lane, vc.to(torch.int64))
    with pytest.raises(ValueError, match='contiguous'):
        kernels.cyclic_encode(cdf_lane, vc.transpose(1, 2).contiguous()
                              .transpose(1, 2))
    with pytest.raises(ValueError, match='on'):
        kernels.cyclic_encode(cdf_lane.cpu(), vc)


# ---- the batch-1 routing beyond the cyclic kernels' limit -----------------

def _fp_runtime(bch=4, target=16):
    from sc2bench_tpu_torch.models.backbone import splittable_resnet
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    torch.manual_seed(0)
    model = splittable_resnet(
        {'key': 'FPBasedResNetBottleneck',
         'kwargs': {'num_bottleneck_channels': bch,
                    'num_target_channels': target}},
        stage_sizes=(1, 1, 1, 1), num_classes=5, device='cpu')
    rt = SplitClassifierRuntime(model, device='cpu')
    rt.update()
    return rt.eval()


def test_batch1_latent_beyond_the_limit_is_coded_aligned(monkeypatch):
    """With the batch-1 kernels' limit stubbed at 40 steps, a compacted
    cyclic encode of 50 steps is coded in the aligned layout at k = 1 and
    says so: its packed bytes equal the compacted plain version's and the
    numpy oracle's, and it decodes. A latent within the limit stays
    compacted. The runtime serves such images at batch 1 with the sizes,
    packed wires and logits of an unstubbed run, and no escape."""
    cdf, cdf_length, offset = _tables(8, 21, seed=3)
    lanes, n = 48, 48 * 50 - 5
    sym = _symbols(cdf, cdf_length, offset, n, seed=4)
    ref = td.device_rans_encode(torch.from_numpy(sym), cdf, cdf_length,
                                offset, num_lanes=lanes, cyclic_channels=8)
    assert not ref['aligned']
    rt = _fp_runtime()
    images = [torch.randn((1, 3, 64, 64), generator=torch.Generator()
                          .manual_seed(s)) for s in range(3)]

    def serve(**kw):
        rt.clear_analysis()
        rt.activate_analysis()
        rt.escapes = {'ok': 0, 'valid': 0}
        logits = rt.stream_deploy_device(images, **kw)
        return logits, list(rt.analyzers[0].file_size_list), \
            dict(rt.escapes)

    want_logits, want_sizes, _ = serve()
    want_pulled = serve(pull_wire=True)[1]
    want_wire = rt._pull_device_wire(rt.encode_device_wire(images[0]))
    monkeypatch.setattr(kernels, 'batch1_fits',
                        lambda steps, device: steps <= 40)
    enc = td.device_rans_encode(torch.from_numpy(sym), cdf, cdf_length,
                                offset, num_lanes=lanes, cyclic_channels=8)
    assert enc['aligned'] and enc['masks'].shape == enc['streams'].shape
    o_streams, o_states = td.numpy_oracle_encode(
        sym, np.arange(n) % 8, cdf, cdf_length, offset, num_lanes=lanes,
        cyclic_channels=8)
    oracle = b''.join(
        [np.asarray([lanes, 0], np.uint16).tobytes(),
         np.asarray([len(s) for s in o_streams], np.uint16).tobytes(),
         o_states.astype(np.uint32).tobytes()]
        + [np.asarray(s, np.uint16).tobytes() for s in o_streams])
    assert td.pack_stream_aligned(enc) == td.pack_stream(ref) == oracle
    dec, valid = td.device_rans_decode(
        enc['streams'], enc['states'], cdf, cdf_length, offset, n_symbols=n,
        num_lanes=lanes, cyclic_channels=8, aligned=enc['aligned'])
    assert bool(valid)
    np.testing.assert_array_equal(dec.numpy(), sym)
    short = td.device_rans_encode(torch.from_numpy(sym[:lanes * 40]), cdf,
                                  cdf_length, offset, num_lanes=lanes,
                                  cyclic_channels=8)
    assert not short['aligned'] and 'masks' not in short
    # the runtime: a 16x16x4 latent on its auto lanes is beyond 40 steps
    ops = rt.encode_device_wire(images[0])
    assert ops['aligned'] and rt._pull_device_wire(ops) == want_wire
    logits, sizes, escapes = serve()
    assert sizes == want_sizes and escapes == {'ok': 0, 'valid': 0}
    for a, b in zip(logits, want_logits):
        assert torch.equal(a, b)
    assert serve(pull_wire=True)[1] == want_pulled


# ---- the general per-index kernels ----------------------------------------

def _gaussian_rows(n, seed, tails=False, t=None):
    """Gaussian tables `t` (by default the default ones), rows spread over
    all of them (for the default tables row 0 of 5 entries and row 63 of
    3,133 among them), symbols from each row's distribution; with
    `tails`, every fifth symbol uniform over the row's support, which
    codes many frequency-1 tail symbols."""
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    t = build_gaussian_tables() if t is None else t
    rng = np.random.default_rng(seed)
    rows = t.quantized_cdf.shape[0]
    idx = rng.integers(0, rows, n).astype(np.int32)
    idx[:2] = (0, rows - 1)
    u = rng.integers(0, 1 << 16, n)
    vals = np.empty(n, np.int64)
    for r in np.unique(idx):
        m = idx == r
        row = t.quantized_cdf[r][:t.cdf_length[r]]
        vals[m] = np.clip(np.searchsorted(row, u[m], side='right') - 1, 0,
                          t.cdf_length[r] - 3)
    if tails:
        pick = np.arange(n) % 5 == 0
        vals[pick] = rng.integers(0, t.cdf_length[idx[pick]] - 2)
    return t, idx, (vals + t.offset[idx]).astype(np.int32)


# (k, lanes, n): the flagship y (512 lanes x 142 steps) at k = 1 and 8,
# lanes not a multiple of 32 with n not a multiple of the lanes, and
# T = 4,000 (beyond the batch-1 cyclic limit)
INDEXED_CASES = [(1, 512, 72600), (8, 512, 72600), (3, 100, 2345),
                 (2, 40, 40 * 4000 - 7)]


@pytest.mark.cuda
@pytest.mark.parametrize('k,lanes,n', INDEXED_CASES)
def test_indexed_kernels_equal_plain_versions_on_the_card(k, lanes, n):
    dev = _card()
    cases = [_gaussian_rows(n, seed=s, tails=s % 2 == 1) for s in range(k)]
    t = cases[0][0]
    idx = np.stack([c[1] for c in cases])
    rows = np.stack([c[2] for c in cases])
    cdf, cdf_len, off = (torch.from_numpy(a).to(dev) for a in (
        t.quantized_cdf, t.cdf_length, t.offset))
    sym3, idx3 = td._index_blocks(torch.from_numpy(rows).to(dev),
                                  torch.from_numpy(idx).to(dev), lanes,
                                  off[0])
    vc = (sym3 - off[idx3]).contiguous()
    idx3 = idx3.contiguous()
    steps = vc.shape[1]
    kernels.reset_launches()
    for aligned in (False, True):
        plain = td.indexed_encode_plain(cdf, vc, idx3, aligned=aligned,
                                        want_masks=aligned)
        got = (kernels.indexed_encode_aligned(cdf, vc, idx3, True) if aligned
               else kernels.indexed_encode(cdf, vc, idx3))
        for a, b in zip(plain, got):
            assert torch.equal(a, b)
        dec = kernels.indexed_decode_aligned if aligned \
            else kernels.indexed_decode
        streams, states = got[0], got[2]
        bad = states.clone()
        bad[k - 1, lanes // 3] ^= 0x5A5A
        decoded = []
        for st in (states, bad):
            out, xend = dec(streams, st, cdf, cdf_len, off, idx3, steps)
            pout, pxend = td.indexed_decode_plain(
                streams, st, cdf, cdf_len, off, idx3, steps,
                aligned=aligned)
            torch.cuda.synchronize()
            assert torch.equal(out, pout) and torch.equal(xend, pxend)
            decoded.append((out, xend))
        (out, xend), (_, xbad) = decoded
        assert bool((xend == td.RANS_L).all())
        np.testing.assert_array_equal(
            out.reshape(k, -1)[:, :n].cpu().numpy(), rows)
        assert not bool((xbad[k - 1] == td.RANS_L).all())
        if not aligned:
            for r in range(k):
                o_streams, o_states = td.numpy_oracle_encode(
                    rows[r], idx[r], t.quantized_cdf, t.cdf_length,
                    t.offset, num_lanes=lanes)
                np.testing.assert_array_equal(states[r].cpu().numpy(),
                                              o_states)
                wire = td.pack_stream({'streams': streams[r],
                                       'lengths': got[1][r],
                                       'states': states[r]})
                packed, _ = td.unpack_stream(wire)
                assert [list(packed[j, :len(s)])
                        for j, s in enumerate(o_streams)] == o_streams
    assert [kernels.LAUNCHES[name]
            for name in kernels.INDEXED_KERNELS] == [1, 2, 1, 2]


@pytest.mark.cuda
def test_indexed_wrappers_launch_or_raise_on_the_card():
    dev = _card()
    cdf = torch.zeros((4, 9), dtype=torch.int32, device=dev)
    vc = torch.zeros((1, 4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='dtype'):
        kernels.indexed_encode(cdf, vc, vc.to(torch.int64))
    with pytest.raises(ValueError, match='shape'):
        kernels.indexed_encode(cdf, vc, vc[:, :3].contiguous())
    with pytest.raises(ValueError, match='wide'):
        kernels.indexed_decode_aligned(
            torch.zeros((1, 8, 5), dtype=torch.int32, device=dev),
            torch.zeros((1, 8), dtype=torch.int64, device=dev), cdf,
            torch.zeros(4, dtype=torch.int32, device=dev),
            torch.zeros(4, dtype=torch.int32, device=dev), vc, 4)


# ---- the redesigned batch-1 indexed pair (prepared tables) ----------------

def _prepared_blocks(t, lanes, n, k, seed, dev, tails):
    """k images of `_gaussian_rows` of the tables `t` on `lanes` lanes:
    the tables, their prepared form and the (k, T, lanes) blocks on
    `dev`."""
    from sc2bench_tpu_torch.ops.rans.indexed_tables import \
        prepare_indexed_tables
    draws = [_gaussian_rows(n, seed + i, tails, t)[1:] for i in range(k)]
    cdf, cdf_len, off = (torch.from_numpy(a).to(dev) for a in (
        t.quantized_cdf, t.cdf_length, t.offset))
    sym3, idx3 = td._index_blocks(
        torch.from_numpy(np.stack([d[1] for d in draws])).to(dev),
        torch.from_numpy(np.stack([d[0] for d in draws])).to(dev), lanes,
        off[0])
    vc = (sym3 - off[idx3]).contiguous()
    return (cdf, cdf_len, off), prepare_indexed_tables(cdf, cdf_len, off), \
        vc, idx3.contiguous()


def _check_batch1_pair(tables, prepared, vc, idx3, plans):
    """The batch-1 indexed pair on `prepared` tables: the plans each takes,
    bit-equal to the plain versions (and to the pair without `prepared`),
    a corrupted state decoded as the plain version does and invalid."""
    cdf, cdf_len, off = tables
    k, steps, lanes = vc.shape
    dev = vc.device
    words = prepared.dec.numel()
    assert (kernels.indexed_plan('rans_indexed_encode', steps, words, dev),
            kernels.indexed_plan('rans_indexed_decode', steps, words,
                                 dev)) == plans
    got = kernels.indexed_encode(cdf, vc, idx3, prepared=prepared)
    for a, b, c in zip(got, td.indexed_encode_plain(cdf, vc, idx3),
                       kernels.indexed_encode(cdf, vc, idx3)):
        assert torch.equal(a, b) and torch.equal(a, c)
    streams, states = got[0], got[2]
    bad = states.clone()
    bad[k - 1, lanes // 3] ^= 0x5A5A
    for st in (states, bad):
        out, xend = kernels.indexed_decode(streams, st, cdf, cdf_len, off,
                                           idx3, steps, prepared=prepared)
        pout, pxend = td.indexed_decode_plain(streams, st, cdf, cdf_len,
                                              off, idx3, steps)
        torch.cuda.synchronize()
        assert torch.equal(out, pout) and torch.equal(xend, pxend)
    assert bool((pxend[k - 1] != td.RANS_L).any())
    out, xend = kernels.indexed_decode(streams, states, cdf, cdf_len, off,
                                       idx3, steps, prepared=prepared)
    assert torch.equal(out, (vc + off[idx3]).to(torch.int32))
    assert bool((xend == td.RANS_L).all())


INDEXED_KERNELS_BATCH1 = ('rans_indexed_encode', 'rans_indexed_decode')
# (k, lanes, n, tails): the MSHP y (512 lanes x 142 steps) and the MSHP-64
# students' y (1,024 lanes x 190 steps), lanes not a multiple of 32 with
# frequency-1 tails, and T = 4,000 (the encoder's device-row plan)
BATCH1_INDEXED_CASES = [(1, 512, 55 * 55 * 24, False),
                        (1, 1024, 55 * 55 * 64, False),
                        (3, 100, 2345, True),
                        (2, 40, 40 * 4000 - 7, True)]


@pytest.mark.cuda
@pytest.mark.parametrize('k,lanes,n,tails', BATCH1_INDEXED_CASES)
def test_batch1_indexed_pair_on_prepared_tables_on_the_card(k, lanes, n,
                                                            tails):
    dev = _card()
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    tables, prepared, vc, idx3 = _prepared_blocks(
        build_gaussian_tables(), lanes, n, k, seed=lanes, dev=dev,
        tails=tails)
    encode_plan = 'global' if vc.shape[1] > 3000 else 'shared'
    kernels.reset_launches()
    _check_batch1_pair(tables, prepared, vc, idx3, (encode_plan, 'shared'))
    assert [kernels.LAUNCHES[name] for name in INDEXED_KERNELS_BATCH1] \
        == [2, 3]



@pytest.mark.cuda
def test_batch1_indexed_decoder_reads_large_tables_from_device_memory():
    """Gaussian tables of a custom scale table up to 1,024 (rows of up to
    ~12,500 entries, a prepared decoder pack beyond a block's shared
    memory): the decoder's global-table plan, bit-equal to the plain
    versions at the MSHP y shape with frequency-1 tails."""
    dev = _card()
    from sc2bench_tpu_torch.ops.entropy.gaussian import get_scale_table
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    t = build_gaussian_tables(get_scale_table(0.11, 1024.0, 64))
    tables, prepared, vc, idx3 = _prepared_blocks(
        t, 512, 55 * 55 * 24, 1, seed=7, dev=dev, tails=True)
    assert 4 * prepared.dec.numel() > 232448
    _check_batch1_pair(tables, prepared, vc, idx3, ('shared', 'global'))


@pytest.mark.cuda
def test_batch1_serves_a_latent_beyond_the_kernel_limit_on_the_card():
    """A 320x320 image at num_lanes=24: a 79x79x24 latent of 6,241 steps,
    beyond the batch-1 kernels' limit, served by `stream_deploy_device` at
    batch 1 through the aligned pair at k = 1: the wire equals the plain
    version's and the numpy oracle's, and the logits equal `wire_batch=1`
    and the decoder on the encoder's symbols."""
    dev = _card()
    from sc2bench_tpu_torch.models.backbone import splittable_resnet
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    torch.manual_seed(0)
    model = splittable_resnet(
        {'key': 'FPBasedResNetBottleneck',
         'kwargs': {'num_bottleneck_channels': 24,
                    'num_target_channels': 64}},
        stage_sizes=(1, 1, 1, 1), num_classes=10, device=dev)
    with torch.no_grad():
        model.bottleneck_layer.encoder[-1].weight.mul_(0.5)
    rt = SplitClassifierRuntime(model, device=dev)
    rt.update()
    rt.eval()
    x = torch.randn((1, 3, 320, 320), generator=torch.Generator()
                    .manual_seed(1)).to(dev)
    flat, shape = rt._symbols_nhwc(x)
    assert shape == (79, 79, 24)
    assert not kernels.batch1_fits(79 * 79, dev)
    ops = rt.encode_device_wire(x, num_lanes=24)
    assert ops['aligned'] and bool(ops['ok'])
    t = rt.codec.tables
    tables = (t.quantized_cdf, t.cdf_length, t.offset)
    sym = flat.reshape(-1).cpu()
    plain = td.device_rans_encode(sym, *tables, num_lanes=24,
                                  cyclic_channels=24)
    wire = rt._pull_device_wire(ops)
    assert wire == td.pack_stream(plain)
    o_streams, o_states = td.numpy_oracle_encode(
        sym.numpy(), np.arange(sym.numel()) % 24, *tables, num_lanes=24,
        cyclic_channels=24)
    np.testing.assert_array_equal(plain['states'].numpy(), o_states)
    kernels.reset_launches()
    rt.activate_analysis()
    rt.escapes = {'ok': 0, 'valid': 0}
    logits = rt.stream_deploy_device([x], num_lanes=24)
    assert rt.escapes == {'ok': 0, 'valid': 0}
    assert kernels.LAUNCHES['rans_cyclic_encode_aligned'] == 1
    assert kernels.LAUNCHES['rans_cyclic_decode_aligned'] == 1
    assert kernels.LAUNCHES['rans_cyclic_encode'] == 0
    again = rt.stream_deploy_device([x], num_lanes=24, wire_batch=1)
    assert torch.equal(logits[0], again[0])
    with torch.no_grad():
        direct = rt._decode_tail(flat, shape)
    assert torch.allclose(logits[0], direct, rtol=1e-5, atol=1e-5)


# ---- the redesigned aligned indexed decoder (prepared tables) ---------------

def _check_aligned_decoder(tables, prepared, vc, idx3, plan):
    """The aligned indexed decoder on `prepared` tables: the plan it takes,
    bit-equal to the plain version on the plain encoder's streams, on a
    corrupted state too (decoded as the plain version does, invalid), the
    symbols back. Returns the images a block it used."""
    cdf, cdf_len, off = tables
    k, steps, lanes = vc.shape
    dev = vc.device
    words = prepared.dec.numel()
    assert kernels.indexed_plan('rans_indexed_decode_aligned', steps, words,
                                dev) == plan
    group = kernels.indexed_aligned_group(k, lanes, words, dev)
    assert 1 <= group <= min(k, 16)
    streams, _, states, _ = td.indexed_encode_plain(cdf, vc, idx3,
                                                    aligned=True)
    bad = states.clone()
    bad[k - 1, lanes // 3] ^= 0x5A5A
    for st in (states, bad):
        out, xend = kernels.indexed_decode_aligned(
            streams, st, cdf, cdf_len, off, idx3, steps, prepared=prepared)
        pout, pxend = td.indexed_decode_plain(streams, st, cdf, cdf_len, off,
                                              idx3, steps, aligned=True)
        torch.cuda.synchronize()
        assert torch.equal(out, pout) and torch.equal(xend, pxend)
    assert bool((pxend[k - 1] != td.RANS_L).any())
    out, xend = kernels.indexed_decode_aligned(
        streams, states, cdf, cdf_len, off, idx3, steps, prepared=prepared)
    assert torch.equal(out, (vc + off[idx3]).to(torch.int32))
    assert bool((xend == td.RANS_L).all())
    return group


# (k, lanes, n): k = 1, 3, 8 and 128 at the MSHP y (512 lanes x 142 steps)
# and at the MSHP-64 students' y (1,024 lanes x 190 steps), and T = 4,000
ALIGNED_DECODE_CASES = [(k, lanes, n)
                        for lanes, n in ((512, 55 * 55 * 24),
                                         (1024, 55 * 55 * 64))
                        for k in (1, 3, 8, 128)] + [(2, 40, 40 * 4000 - 7)]


@pytest.mark.cuda
@pytest.mark.parametrize('k,lanes,n', ALIGNED_DECODE_CASES)
def test_aligned_indexed_decoder_on_prepared_tables_on_the_card(k, lanes, n):
    dev = _card()
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    tables, prepared, vc, idx3 = _prepared_blocks(
        build_gaussian_tables(), lanes, n, k, seed=k + lanes, dev=dev,
        tails=True)
    kernels.reset_launches()
    _check_aligned_decoder(tables, prepared, vc, idx3, 'shared')
    assert kernels.LAUNCHES['rans_indexed_decode_aligned'] == 3


# (k, lanes, n): k = 1, 8 and 128 at the MSHP y (512 lanes x 142 steps,
# T not a multiple of the 8-step tile or the 32-column window), 100 lanes
# with n not a multiple of them, and 40 lanes x 4,000 steps
ALIGNED_ENCODE_CASES = [(1, 512, 55 * 55 * 24), (8, 512, 55 * 55 * 24),
                        (128, 512, 55 * 55 * 24), (3, 100, 2345),
                        (2, 40, 40 * 4000 - 7)]


@pytest.mark.cuda
@pytest.mark.parametrize('k,lanes,n', ALIGNED_ENCODE_CASES)
def test_aligned_indexed_encoder_on_prepared_tables_on_the_card(k, lanes, n):
    """The aligned indexed encoder on the prepared entries, masks off and
    on, with `prepared` and without: bit-equal to the plain version, its
    plan 8- or 16-step tiles and 1 to min(k, 8) images a block, one launch
    a call."""
    dev = _card()
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    (cdf, _, _), prepared, vc, idx3 = _prepared_blocks(
        build_gaussian_tables(), lanes, n, k, seed=3 * k + lanes, dev=dev,
        tails=True)
    tile, group = kernels.indexed_encode_aligned_plan(k, lanes, dev)
    assert tile in (8, 16) and 1 <= group <= min(k, 8)
    kernels.reset_launches()
    for want_masks in (False, True):
        plain = td.indexed_encode_plain(cdf, vc, idx3, aligned=True,
                                        want_masks=want_masks)
        for extra in ({'prepared': prepared}, {}):
            got = kernels.indexed_encode_aligned(cdf, vc, idx3, want_masks,
                                                 **extra)
            torch.cuda.synchronize()
            for a, b in zip(got, plain):
                assert (a is None and b is None) or torch.equal(a, b)
    assert kernels.LAUNCHES['rans_indexed_encode_aligned'] == 4


@pytest.mark.cuda
def test_aligned_indexed_decoder_reads_large_tables_from_device_memory():
    """Gaussian tables of a 0.11..1,024 scale table (a prepared pack beyond
    a block's shared memory): the aligned decoder's global-table plan,
    bit-equal to the plain version at the MSHP y shape, k = 3."""
    dev = _card()
    from sc2bench_tpu_torch.ops.entropy.gaussian import get_scale_table
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    t = build_gaussian_tables(get_scale_table(0.11, 1024.0, 64))
    tables, prepared, vc, idx3 = _prepared_blocks(
        t, 512, 55 * 55 * 24, 3, seed=9, dev=dev, tails=True)
    assert 4 * prepared.dec.numel() > 232448
    _check_aligned_decoder(tables, prepared, vc, idx3, 'global')


@pytest.mark.cuda
@pytest.mark.parametrize('h,w,m', [(16, 16, 192), (5, 5, 192)],
                         ids=['jahp_q1_256px', 'jahp_q1_72px'])
def test_masked_front_on_prepared_tables_on_the_card(h, w, m):
    """Every front of the JAHP q1 schedule at 256 px (61 fronts, 1,152
    lanes) and at 72 px (a 5x5 latent, not a multiple of 16) on tables
    prepared once: each front equals the plain version, a corrupted chunk
    leaves a lane off RANS_L; then random states and rows on tables with
    zero-frequency entries, where max(freq, 1) decides."""
    dev = _card()
    from sc2bench_tpu_torch.ops.rans.indexed_tables import \
        prepare_indexed_tables
    from test_torch_port_indexed_tables import \
        _zero_frequency_decoding_tables
    t, idx, vals, act = _masked_case(h, w, m, seed=h + w + m)
    (cdf, cdf_len, off), vc, ix, a = _masked_tensors(t, idx, vals, act, dev)
    prepared = prepare_indexed_tables(cdf, cdf_len, off)
    streams, lengths, states = kernels.masked_encode_aligned(cdf, vc, ix, a,
                                                             m)
    bad = streams.clone()
    lane = int(torch.argmax(lengths))
    bad[lane, int(torch.nonzero(bad[lane])[0, 0])] ^= 0x5A5A
    kernels.reset_launches()
    for s in (streams, bad):
        x = xp = states
        for step in range(vc.shape[0]):
            sym, x = kernels.masked_decode_front(
                s, step, x, cdf, cdf_len, off, ix[step], a[step], m,
                prepared=prepared)
            psym, xp = td.masked_decode_front_plain(
                s, step, xp, cdf, cdf_len, off, ix[step], a[step], m)
            assert torch.equal(sym, psym) and torch.equal(x, xp)
        assert bool((x == td.RANS_L).all()) == (s is streams)
    assert kernels.LAUNCHES['rans_masked_decode_front'] == 2 * vc.shape[0]
    (zcdf, zlen, zoff), _ = _zero_frequency_decoding_tables()
    zcdf, zlen, zoff = (a_.to(dev) for a_ in (zcdf, zlen, zoff))
    zprep = prepare_indexed_tables(zcdf, zlen, zoff)
    rng = np.random.default_rng(h)
    lanes = streams.shape[0]
    rand = torch.from_numpy(rng.integers(0, 1 << 16, (lanes, 4))
                            .astype(np.int32)).to(dev)
    x = xp = torch.from_numpy(rng.integers(1 << 16, 1 << 32, lanes)).to(dev)
    for step in range(4):
        rows = torch.from_numpy(rng.integers(0, zcdf.shape[0], lanes)
                                .astype(np.int32)).to(dev)
        sym, x = kernels.masked_decode_front(rand, step, x, zcdf, zlen, zoff,
                                             rows, a[step], m, prepared=zprep)
        psym, xp = td.masked_decode_front_plain(rand, step, xp, zcdf, zlen,
                                                zoff, rows, a[step], m)
        assert torch.equal(sym, psym) and torch.equal(x, xp)


@pytest.mark.cuda
def test_prepared_decoders_refuse_bad_arguments_on_the_card():
    """The aligned indexed decoder and the masked front decoder raise on a
    `prepared` of another table (of another shape, or of the same shape
    with its rows in another order), a stream width other than T, a front
    outside [0, T) and a wrong dtype, before any launch."""
    dev = _card()
    from sc2bench_tpu_torch.ops.rans.indexed_tables import \
        prepare_indexed_tables
    t, idx, vals, act = _masked_case(5, 5, 8, seed=1)
    (cdf, cdf_len, off), vc, ix, a = _masked_tensors(t, idx, vals, act, dev)
    other = prepare_indexed_tables(cdf[:, :-1].contiguous(), cdf_len, off)
    same_shape = prepare_indexed_tables(cdf.flip(0).contiguous(),
                                        cdf_len.flip(0).contiguous(), off)
    streams, _, states = kernels.masked_encode_aligned(cdf, vc, ix, a, 8)
    kernels.reset_launches()
    for wrong in (other, same_shape):
        with pytest.raises(ValueError, match='prepared tables'):
            kernels.masked_decode_front(streams, 0, states, cdf, cdf_len,
                                        off, ix[0], a[0], 8, prepared=wrong)
    with pytest.raises(ValueError, match='front 99'):
        kernels.masked_decode_front(streams, 99, states, cdf, cdf_len, off,
                                    ix[0], a[0], 8)
    with pytest.raises(ValueError, match='dtype'):
        kernels.masked_decode_front(streams, 0, states.to(torch.int32), cdf,
                                    cdf_len, off, ix[0], a[0], 8)
    k, steps, lanes = 2, 6, 40
    s3 = torch.zeros((k, lanes, steps), dtype=torch.int32, device=dev)
    x3 = torch.full((k, lanes), td.RANS_L, dtype=torch.int64, device=dev)
    i3 = torch.zeros((k, steps, lanes), dtype=torch.int32, device=dev)
    for wrong in (other, same_shape):
        with pytest.raises(ValueError, match='prepared tables'):
            kernels.indexed_decode_aligned(s3, x3, cdf, cdf_len, off, i3,
                                           steps, prepared=wrong)
    with pytest.raises(ValueError, match='wide'):
        kernels.indexed_decode_aligned(s3, x3, cdf, cdf_len, off,
                                       i3[:, :5].contiguous(), 5)
    with pytest.raises(ValueError, match='dtype'):
        kernels.indexed_decode_aligned(s3, x3.to(torch.int32), cdf, cdf_len,
                                       off, i3, steps)
    assert kernels.LAUNCHES['rans_masked_decode_front'] == 0
    assert kernels.LAUNCHES['rans_indexed_decode_aligned'] == 0


# ---- the masked-lane kernels of the joint autoregressive codec ----------------

def _masked_case(h, w, m, seed):
    """The wavefront schedule of an h x w latent (T fronts of at most F
    positions) and, per step, Gaussian rows and in-support values for all
    F * m lanes (pad slots included, as the codec hands them over)."""
    from sc2bench_tpu_torch.models.zoo_jahp import front_arrays, wavefronts
    _, _, act = front_arrays(wavefronts(h, w))
    steps, slots = act.shape
    t, idx, sym = _gaussian_rows(steps * slots * m, seed, tails=True)
    idx = idx.reshape(steps, slots * m)
    vals = (sym.reshape(steps, slots * m) - t.offset[idx]).astype(np.int32)
    return t, idx, vals, act.astype(np.uint8)


def _masked_tensors(t, idx, vals, act, dev):
    return ((torch.from_numpy(a).to(dev) for a in (
        t.quantized_cdf, t.cdf_length, t.offset)),
        torch.from_numpy(vals).to(dev), torch.from_numpy(idx).to(dev),
        torch.from_numpy(act).to(dev))


def test_masked_plain_versions_code_each_lane_as_one_indexed_lane():
    """Masked encode of a 5x7 latent's schedule (25 fronts of at most 3
    positions, m = 5): each lane's state, length and chunks at its active
    steps are those of the indexed (aligned) encoder on that lane's active
    symbols alone, with 0 at its inactive steps (inert), and decoding front by front gives the symbols back with
    every state at RANS_L."""
    m = 5
    t, idx, vals, act = _masked_case(5, 7, m, seed=3)
    (cdf, cdf_len, off), vc, ix, a = _masked_tensors(t, idx, vals, act,
                                                     'cpu')
    streams, lengths, states = kernels.masked_encode_aligned(cdf, vc, ix, a,
                                                             m)
    lane_act = np.repeat(act.astype(bool), m, axis=1)
    for j in range(vc.shape[1]):
        steps = np.nonzero(lane_act[:, j])[0]
        s1, l1, x1, _ = td.indexed_encode_plain(
            cdf, vc[steps, j].reshape(1, -1, 1).contiguous(),
            ix[steps, j].reshape(1, -1, 1).contiguous(), aligned=True)
        assert int(x1[0, 0]) == int(states[j]) and int(l1) == int(lengths[j])
        assert torch.equal(streams[j, steps], s1[0, 0])
        assert not streams[j][~torch.from_numpy(lane_act[:, j])].any()
    x = states
    for step in range(vc.shape[0]):
        sym, x = kernels.masked_decode_front(streams, step, x, cdf, cdf_len,
                                             off, ix[step], a[step], m)
        on = torch.from_numpy(lane_act[step])
        assert torch.equal(sym[on], (vc[step] + off[ix[step]])[on])
        assert not sym[~on].any()
    assert bool((x == td.RANS_L).all())


@pytest.mark.cuda
@pytest.mark.parametrize('h,w,m', [(16, 16, 192), (5, 7, 5)],
                         ids=['jahp_q1_256px', 'odd'])
def test_masked_kernels_equal_plain_versions_on_the_card(h, w, m):
    """The JAHP q1 shape at 256 px (61 fronts, 6 x 192 = 1,152 lanes) and
    a 5x7 latent at m = 5 (105 lanes, not a multiple of 32): the encode's
    streams, lengths and states and each front's decode equal the plain
    versions; a corrupted chunk leaves a lane off RANS_L."""
    dev = _card()
    t, idx, vals, act = _masked_case(h, w, m, seed=h + m)
    (cdf, cdf_len, off), vc, ix, a = _masked_tensors(t, idx, vals, act, dev)
    kernels.reset_launches()
    got = kernels.masked_encode_aligned(cdf, vc, ix, a, m)
    want = td.masked_encode_plain(cdf, vc, ix, a, m)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    streams, _, states = got
    bad = streams.clone()
    lane = int(torch.argmax(got[1]))
    bad[lane, int(torch.nonzero(bad[lane])[0, 0])] ^= 0x5A5A
    for s in (streams, bad):
        x = xp = states
        for step in range(vc.shape[0]):
            sym, x = kernels.masked_decode_front(s, step, x, cdf, cdf_len,
                                                 off, ix[step], a[step], m)
            psym, xp = td.masked_decode_front_plain(
                s, step, xp, cdf, cdf_len, off, ix[step], a[step], m)
            assert torch.equal(sym, psym) and torch.equal(x, xp)
        assert bool((x == td.RANS_L).all()) == (s is streams)
    assert kernels.LAUNCHES['rans_masked_encode_aligned'] == 1
    assert kernels.LAUNCHES['rans_masked_decode_front'] == 2 * vc.shape[0]


@pytest.mark.cuda
def test_masked_encoder_on_zero_frequency_entries_on_the_card():
    """The JAHP q1 schedule at 256 px (61 fronts, 1,152 lanes) on tables
    with zero-frequency entries, each symbol drawn evenly over its row's
    coded support, so active lanes code zero-frequency entries, where
    max(freq, 1) decides: bit-equal to the plain version, with `prepared`
    and without."""
    dev = _card()
    from sc2bench_tpu_torch.models.zoo_jahp import front_arrays, wavefronts
    from sc2bench_tpu_torch.ops.rans.indexed_tables import (
        encode_entries, prepare_indexed_tables)
    from test_torch_port_indexed_tables import \
        _zero_frequency_decoding_tables
    (zcdf, zlen, zoff), _ = _zero_frequency_decoding_tables()
    _, _, act = front_arrays(wavefronts(16, 16))
    steps, slots = act.shape
    m = 192
    rng = np.random.default_rng(7)
    ix = rng.integers(0, zcdf.shape[0], (steps, slots * m)).astype(np.int32)
    vals = rng.integers(0, zlen.numpy()[ix] - 2).astype(np.int32)
    lane_act = np.repeat(act, m, axis=1)
    enc = encode_entries(zcdf).numpy()
    assert (enc[ix, vals, 1][lane_act] == 0).sum() > 100
    vc, ix, a = (torch.from_numpy(x_).to(dev) for x_ in (
        vals, ix, act.astype(np.uint8)))
    zcdf = zcdf.to(dev)
    zprep = prepare_indexed_tables(zcdf, zlen, zoff)
    want = td.masked_encode_plain(zcdf, vc, ix, a, m)
    kernels.reset_launches()
    for extra in ({'prepared': zprep}, {}):
        got = kernels.masked_encode_aligned(zcdf, vc, ix, a, m, **extra)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            assert torch.equal(g, p)
    assert kernels.LAUNCHES['rans_masked_encode_aligned'] == 2


@pytest.mark.cuda
def test_prepared_encoders_refuse_bad_arguments_on_the_card():
    """The aligned indexed encoder and the masked encoder raise on a
    `prepared` of another table, and the masked encoder on an activity map
    beyond a block's shared memory (2,000 fronts x 120 slots), before any
    launch."""
    dev = _card()
    from sc2bench_tpu_torch.ops.rans.indexed_tables import \
        prepare_indexed_tables
    t, idx, vals, act = _masked_case(5, 5, 8, seed=1)
    (cdf, cdf_len, off), vc, ix, a = _masked_tensors(t, idx, vals, act, dev)
    other = prepare_indexed_tables(cdf.flip(0).contiguous(),
                                   cdf_len.flip(0).contiguous(), off)
    kernels.reset_launches()
    with pytest.raises(ValueError, match='prepared tables'):
        kernels.masked_encode_aligned(cdf, vc, ix, a, 8, prepared=other)
    with pytest.raises(ValueError, match='prepared tables'):
        kernels.indexed_encode_aligned(cdf, vc[None], ix[None],
                                       prepared=other)
    steps, slots = 2000, 120
    big = torch.ones((steps, slots), dtype=torch.uint8, device=dev)
    zeros = torch.zeros((steps, slots), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='shared memory'):
        kernels.masked_encode_aligned(cdf, zeros, zeros, big, 1)
    assert kernels.LAUNCHES['rans_masked_encode_aligned'] == 0
    assert kernels.LAUNCHES['rans_indexed_encode_aligned'] == 0


@pytest.mark.cuda
def test_masked_wrappers_refuse_bad_arguments_on_the_card():
    dev = _card()
    cdf = torch.zeros((4, 9), dtype=torch.int32, device=dev)
    vc = torch.zeros((3, 10), dtype=torch.int32, device=dev)
    act = torch.ones((3, 2), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match='F \\* m'):
        kernels.masked_encode_aligned(cdf, vc, vc, act, 4)
    with pytest.raises(ValueError, match='dtype'):
        kernels.masked_encode_aligned(cdf, vc, vc, act.bool(), 5)
    streams = torch.zeros((10, 3), dtype=torch.int32, device=dev)
    states = torch.zeros(10, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match='front 3'):
        kernels.masked_decode_front(streams, 3, states, cdf, cdf[:, 0],
                                    cdf[:, 0], vc[0], act[0], 5)


@pytest.mark.cuda
def test_mask_and_keypoint_heads_on_the_card_equal_the_cpu():
    """The detection heads (no kernel of their own: cuDNN's convolutions
    and deconvolutions, the bilinear upsample and RoIAlign's gathers) on
    the card with TF32 off against the same heads on the CPU: mask logits
    and keypoint heatmaps within 1e-4 of their largest magnitude, and
    `predict_masks` over four FPN levels within 1e-4."""
    from sc2bench_tpu_torch.models.detection.heads import (KeypointHead,
                                                           MaskHead,
                                                           predict_masks)
    dev = _card()
    torch.manual_seed(0)
    mask, keypoint = MaskHead(91).eval(), KeypointHead(17).eval()
    rng = np.random.default_rng(5)
    pooled = torch.from_numpy(rng.normal(0, 1, (24, 256, 14, 14)).astype(
        np.float32))
    feats = [torch.from_numpy(rng.normal(0, 1, (256, s, s + 8)).astype(
        np.float32)) for s in (56, 28, 14, 7)]
    x1 = rng.uniform(0, 150, 24)
    y1 = rng.uniform(0, 150, 24)
    boxes = torch.from_numpy(np.stack([x1, y1, x1 + rng.uniform(8, 120, 24),
                                       y1 + rng.uniform(8, 120, 24)],
                                      1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, 91, 24))
    allow = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = [mask(pooled), keypoint(pooled),
                    predict_masks(mask, feats, boxes, (224, 224), labels)]
            mask.to(dev)
            keypoint.to(dev)
            got = [mask(pooled.to(dev)), keypoint(pooled.to(dev)),
                   predict_masks(mask, [f.to(dev) for f in feats],
                                 boxes.to(dev), (224, 224), labels.to(dev))]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = allow
    assert got[0].is_cuda and tuple(got[1].shape) == (24, 17, 56, 56)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale
