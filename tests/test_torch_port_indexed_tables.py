"""The prepared tables of the per-index rANS kernels, on the CPU.

The three decoders (`rans_indexed_decode`, `rans_indexed_decode_aligned`,
`rans_masked_decode_front`) find a slot's symbol from a coarse bucket
table and a bounded bisection over ragged rows, and `rans_indexed_encode`
divides by a prepared reciprocal, as (since their redesign) the aligned
indexed encoder and the masked encoder do; all read tables that
`prepare_indexed_tables` builds once. These tests hold that lookup and
that division (modelled in torch as the kernels run them,
`bucket_lookup`, `reciprocal_quotient`) against `cdf_bisect` and the exact
quotient, and the kernels' steps built from them against the plain
versions. The kernels themselves are held against the plain versions on
the card (`tests/test_torch_port_kernels.py`). This file imports neither
JAX nor `sc2bench_tpu`."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import numpy as np
import pytest
import torch

from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
from sc2bench_tpu_torch.ops.rans import device as td
from sc2bench_tpu_torch.ops.rans.indexed_tables import (
    BUCKET_STRIDE, bucket_lookup, prepare_indexed_tables,
    reciprocal_quotient)

_MASK32 = (1 << 32) - 1


@pytest.fixture(scope='module')
def gaussian():
    g = build_gaussian_tables()
    return g, prepare_indexed_tables(g.quantized_cdf, g.cdf_length,
                                     g.offset)


def _zero_frequency_tables():
    """Rows with zero-frequency entries (repeated CDF values) at the
    front, in the middle and before the end, a row of frequency-1
    symbols wider than one bucket, a row as wide as the table, and
    padding past each cdf_length."""
    cols = 700
    cdf = np.zeros((4, cols), np.int32)
    cdf[0, :8] = [0, 0, 0, 300, 300, 65000, 65536, 65536]
    cdf[1, :7] = [0, 5, 5, 5, 40000, 40000, 65536]
    cdf[2, :602] = np.concatenate([np.arange(600), [65535, 65536]])
    w = np.random.default_rng(3).uniform(0.0, 1.0, cols - 1) ** 8
    freqs = (w / w.sum() * 65000).astype(np.int64)         # some are 0
    freqs[np.argmax(freqs)] += 65536 - freqs.sum()
    cdf[3, 1:] = np.cumsum(freqs)
    return cdf, np.asarray([7, 7, 602, cols], np.int32), \
        np.asarray([0, -3, -300, 11], np.int32)


def _all_slots(t):
    rows = torch.arange(t.rows).repeat_interleave(1 << 16)
    return rows, torch.arange(1 << 16).repeat(t.rows)


@pytest.mark.parametrize('which', ['default', 'narrow', 'zero_frequency'])
def test_bucket_lookup_equals_cdf_bisect_on_every_slot(which, gaussian):
    """Every row, every slot 0..65535: the bucket's range and the bounded
    bisection inside it give `cdf_bisect`'s index, for the default
    Gaussian tables (rows 0 to 63, up to 3,133 entries), a narrow custom
    `scale_table` and rows with zero-frequency entries."""
    if which == 'default':
        t = gaussian[1]
    elif which == 'narrow':
        g = build_gaussian_tables(np.asarray([0.11, 0.4, 1.5, 6.0]))
        t = prepare_indexed_tables(g.quantized_cdf, g.cdf_length, g.offset)
    else:
        t = prepare_indexed_tables(*_zero_frequency_tables())
    rows, slot = _all_slots(t)
    v, probes = bucket_lookup(t, rows, slot)
    assert torch.equal(v, td.cdf_bisect(t.cdf, t.cdf_len, rows, slot))
    # bounded: the widest bucket range of these tables is 257 entries
    assert int(probes.max()) <= 9


def test_prepared_layout(gaussian):
    """The ragged rows, bucket bounds and row bases sit where the kernel
    reads them, each section 16-byte aligned; the encoder's entries hold
    (start, freq) of every CDF entry and the reciprocal of freq."""
    g, t = gaussian
    lens = np.minimum(g.cdf_length, g.quantized_cdf.shape[1])
    assert int(lens.sum()) == 27256
    dec = t.dec.numpy()
    assert dec.size % 4 == 0 and t.bucket_at % 4 == 0 and t.base_at % 4 == 0
    starts = t.row_start.numpy()
    for r in (0, 31, 63):
        np.testing.assert_array_equal(
            dec[starts[r]:starts[r] + lens[r]], g.quantized_cdf[r][:lens[r]])
        bounds = dec[t.bucket_at + r * BUCKET_STRIDE:][:BUCKET_STRIDE]
        assert bounds[0] == starts[r] and bounds[-1] == starts[r] + lens[r] - 2
        assert np.all(np.diff(bounds) >= 0)
    np.testing.assert_array_equal(dec[t.base_at:t.base_at + 64] + starts,
                                  g.offset)
    enc = t.enc.numpy().astype(np.int64) & _MASK32
    cdf = g.quantized_cdf.astype(np.int64)
    np.testing.assert_array_equal(enc[..., 0], cdf)
    np.testing.assert_array_equal(enc[:, :-1, 1], (cdf[:, 1:] - cdf[:, :-1])
                                  & _MASK32)
    m = enc[..., 2] + (enc[..., 3] << 32)
    fr = enc[..., 1]
    live = (fr > 0) & (fr <= 1 << 16)
    assert np.all(m[live] == -(-(1 << 48) // fr[live]))


def test_reciprocal_division_is_exact_for_every_default_frequency(gaussian):
    """Every frequency of the default Gaussian tables, at the states where
    a floor goes wrong first (either side of the multiples of fr near 0
    and near the top of the divided range x < fr * 2^16): the encoder's
    quotient (umulhi(x, m_lo) + x * m_hi) >> 16 is x // fr, and its folded
    update q * (2^16 - fr) + x + start equals the plain version's."""
    t = gaussian[1]
    enc = t.enc.reshape(-1, 4)
    fr = enc[:, 1].to(torch.int64)
    _, first = np.unique(fr.numpy(), return_index=True)
    pick = torch.from_numpy(first)[fr[first] >= 1]
    entries, fr = enc[pick], fr[pick]
    assert int(fr.min()) == 1 and int(fr.max()) > 60000
    top = fr << 16
    x = torch.stack([torch.zeros_like(fr), torch.ones_like(fr), fr - 1, fr,
                     fr + 1, 2 * fr - 1, top - fr - 1, top - fr, top - 2,
                     top - 1], dim=1)
    x = torch.where((x >= 0) & (x < top[:, None]), x, 0)
    q = reciprocal_quotient(x, entries[:, None, :])
    assert torch.equal(q, x // fr[:, None])
    st = entries[:, None, 0].to(torch.int64)
    folded = (q * ((1 << 16) - fr[:, None]) + x + st) & _MASK32
    assert torch.equal(folded, (((x // fr[:, None]) << 16) + x % fr[:, None]
                                + st) & _MASK32)


def _blocks(g, lanes, n, seed, tails):
    """(vc, idx) blocks (1, T, lanes) of symbols drawn from the rows of
    `g`, rows 0 and the last among them; with `tails` every fifth symbol
    uniform over its row's support (frequency-1 tail symbols)."""
    rng = np.random.default_rng(seed)
    rows = g.quantized_cdf.shape[0]
    idx = rng.integers(0, rows, n).astype(np.int32)
    idx[:2] = (0, rows - 1)
    u = rng.integers(0, 1 << 16, n)
    vals = np.empty(n, np.int64)
    for r in np.unique(idx):
        m = idx == r
        vals[m] = np.clip(np.searchsorted(
            g.quantized_cdf[r][:g.cdf_length[r]], u[m], side='right') - 1,
            0, g.cdf_length[r] - 3)
    if tails:
        pick = np.arange(n) % 5 == 0
        vals[pick] = rng.integers(0, g.cdf_length[idx[pick]] - 2)
    off = torch.from_numpy(g.offset)
    sym3, idx3 = td._index_blocks(
        torch.from_numpy((vals + g.offset[idx]).astype(np.int32))[None],
        torch.from_numpy(idx)[None], lanes, off[0])
    return (sym3 - off[idx3]).contiguous(), idx3.contiguous()


def _encode_model(t, vc, idx, act=None, m=None):
    """The encoders' arithmetic on their prepared entries: renorm test on
    the entry's freq, the reciprocal quotient, the folded update; returns
    the final states and each lane's chunks in emission order (step T-1
    first, -1 where a step emits none). With `act` ((T, F) uint8; `vc` and
    `idx` (T, N), N = F * m) the masked encoder's: a lane whose slot is
    inactive at a step keeps its state and emits nothing, and an entry of
    frequency <= 0 codes with frequency 1 (m = 2^48: m_hi = 2^16)."""
    masked = act is not None
    if masked:
        vc, idx = vc[None], idx[None]
    k, steps, lanes = vc.shape
    e = t.enc.reshape(-1, 4)[(idx.to(torch.int64) * t.cols + vc).reshape(-1)]
    e = e.reshape(k, steps, lanes, 4)
    on = torch.ones((k, steps, lanes), dtype=torch.bool)
    if masked:
        on = act.bool().repeat_interleave(int(m), dim=1)[None]
        low = (e[..., 1] <= 0)[..., None] & torch.tensor([False, True, False,
                                                           True])
        e = torch.where(low, torch.tensor([0, 1, 0, 1 << 16],
                                          dtype=torch.int32), e)
    x = torch.full((k, lanes), 1 << 16, dtype=torch.int64)
    chunks = []
    for s in range(steps - 1, -1, -1):
        a = on[:, s]
        st = e[:, s, :, 0].to(torch.int64)
        fr = e[:, s, :, 1].to(torch.int64) & _MASK32
        renorm = a & (x >= ((fr << 16) & _MASK32))
        chunks.append(torch.where(renorm, x & 0xFFFF, -1))
        xr = torch.where(renorm, x >> 16, x)
        q = reciprocal_quotient(xr, e[:, s])
        x = torch.where(a, (q * ((1 << 16) - fr) + xr + st) & _MASK32, x)
    chunks = torch.stack(chunks, dim=1)
    return (x[0], chunks[0]) if masked else (x, chunks)


def _aligned_layout(chunks):
    """(streams (..., N, T) int32 with step t's chunk at column t, 0 where
    none; masks (..., N, T) bool) of `_encode_model`'s chunks."""
    c = chunks.flip(-2).transpose(-1, -2)
    return torch.where(c >= 0, c, 0).to(torch.int32), c >= 0


def _decode_model(t, streams, states, idx, steps, aligned=False):
    """The indexed decoders' arithmetic on their prepared tables: the
    bucket lookup, then the plain state update, and the chunk at the
    lane's read pointer (batch 1) or at column `step` (`aligned`)."""
    k, lanes, width = streams.shape
    dec = t.dec.to(torch.int64)
    s = torch.cat([streams.to(torch.int64),
                   torch.zeros((k, lanes, 1), dtype=torch.int64)], dim=2)
    x = states.clone()
    ptr = torch.zeros((k, lanes), dtype=torch.int64)
    out = torch.empty((k, steps, lanes), dtype=torch.int32)
    for step in range(steps):
        rows = idx[:, step].to(torch.int64)
        slot = x & 0xFFFF
        v, _ = bucket_lookup(t, rows, slot)
        e = t.row_start.to(torch.int64)[rows] + v
        st, fr = dec[e], dec[e + 1] - dec[e]
        x = (fr * (x >> 16) + slot - st) & _MASK32
        need = x < (1 << 16)
        if aligned:
            chunk = s[:, :, step]
        else:
            chunk = torch.gather(s, 2, ptr.clamp_max(width)[..., None])[..., 0]
            ptr = ptr + need.to(torch.int64)
        x = torch.where(need, ((x << 16) | chunk) & _MASK32, x)
        out[:, step] = (e + dec[t.base_at + rows]).to(torch.int32)
    return out, x


def _masked_front_model(t, streams, front, states, idx, act, m):
    """The masked front decoder's step on the prepared tables: active
    lanes look up their slot, take max(freq, 1) and
    read the chunk at column `front`; inactive lanes keep their state and
    give 0."""
    dec = t.dec.to(torch.int64)
    rows = idx.to(torch.int64)
    x = states.to(torch.int64)
    slot = x & 0xFFFF
    v, _ = bucket_lookup(t, rows, slot)
    e = t.row_start.to(torch.int64)[rows] + v
    st = dec[e]
    fr = torch.clamp_min(dec[e + 1] - st, 1)
    xn = (fr * (x >> 16) + slot - st) & _MASK32
    xn = torch.where(xn < (1 << 16),
                     ((xn << 16) | streams[:, front].to(torch.int64))
                     & _MASK32, xn)
    on = act.bool().repeat_interleave(int(m))
    sym = torch.where(on, e + dec[t.base_at + rows], 0)
    return sym.to(torch.int32), torch.where(on, xn, x)


def _masked_inputs(g, h, w, m, seed):
    """A JAHP schedule of an h x w latent (activity (T, F) uint8) and, per
    front, rows of the tables `g` and in-support values for all F * m
    lanes (frequency-1 tails among them), as torch tensors."""
    from sc2bench_tpu_torch.models.zoo_jahp import front_arrays, wavefronts
    _, _, act = front_arrays(wavefronts(h, w))
    steps, slots = act.shape
    vc, idx = _blocks(g, 1, steps * slots * m, seed, tails=True)
    return (vc.reshape(steps, slots * m).contiguous(),
            idx.reshape(steps, slots * m).contiguous(),
            torch.from_numpy(act.astype(np.uint8)))


def _decoding_tables(cdf, cdf_len, off):
    cdf, cdf_len, off = (torch.as_tensor(a, dtype=torch.int32)
                         for a in (cdf, cdf_len, off))
    return (cdf, cdf_len, off), prepare_indexed_tables(cdf, cdf_len, off)


def _check_batch1(g, t, lanes, n, tails):
    vc, idx = _blocks(g, lanes, n, seed=lanes, tails=tails)
    cdf = torch.from_numpy(g.quantized_cdf)
    streams, lengths, states = td.indexed_encode_plain(cdf, vc, idx)
    x, emitted = _encode_model(t, vc, idx)
    assert torch.equal(x, states)
    for j in (0, lanes // 2, lanes - 1):
        chunks = emitted[0, :, j]
        chunks = chunks[chunks >= 0].flip(0)        # decode order
        assert torch.equal(chunks.to(torch.int32),
                           streams[0, j, :int(lengths[0, j])])
    _check_decoder(t, streams, states, idx, vc.shape[1], aligned=False)


def _check_decoder(t, streams, states, idx, steps, aligned):
    """The decoder's step model equals the plain version on good states
    and on a corrupted one, which ends invalid."""
    bad = states.clone()
    bad[-1, streams.shape[1] // 3] ^= 0x5A5A
    for st in (states, bad):
        want = td.indexed_decode_plain(streams, st, t.cdf, t.cdf_len, t.off,
                                       idx, steps, aligned=aligned)
        got = _decode_model(t, streams, st, idx, steps, aligned=aligned)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[1] != td.RANS_L).any())


def _check_aligned(g, t, lanes, n, k):
    """k images of MSHP rows with frequency-1 tails, aligned layout."""
    blocks = [_blocks(g, lanes, n, seed=lanes + i, tails=True)
              for i in range(k)]
    vc = torch.cat([b[0] for b in blocks]).contiguous()
    idx = torch.cat([b[1] for b in blocks]).contiguous()
    streams, _, states, _ = td.indexed_encode_plain(t.cdf, vc, idx,
                                                    aligned=True)
    out, xend = _decode_model(t, streams, states, idx, vc.shape[1],
                              aligned=True)
    assert torch.equal(out, (vc + t.off[idx]).to(torch.int32))
    assert bool((xend == td.RANS_L).all())
    _check_decoder(t, streams, states, idx, vc.shape[1], aligned=True)


def _check_aligned_encode(g, t, lanes, n, k):
    """k images of MSHP rows with frequency-1 tails: the aligned encoder's
    step model gives the plain version's streams, masks, lengths and
    states."""
    blocks = [_blocks(g, lanes, n, seed=2 * lanes + i, tails=True)
              for i in range(k)]
    vc = torch.cat([b[0] for b in blocks]).contiguous()
    idx = torch.cat([b[1] for b in blocks]).contiguous()
    streams, lengths, states, masks = td.indexed_encode_plain(
        t.cdf, vc, idx, aligned=True, want_masks=True)
    x, chunks = _encode_model(t, vc, idx)
    got_streams, got_masks = _aligned_layout(chunks)
    assert torch.equal(x, states) and torch.equal(got_streams, streams)
    assert torch.equal(got_masks, masks)
    assert torch.equal(got_masks.sum(-1).to(torch.int32), lengths)


def _zero_frequency_values(tab, steps, lanes, seed):
    """(values, rows) (steps, lanes) int32 on the tables `tab`: rows at
    random, each value drawn evenly over its row's coded support [0, len
    - 2), so zero-frequency entries are coded."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, tab.rows, (steps, lanes))
    vals = rng.integers(0, tab.cdf_len.numpy()[rows] - 2)
    return (torch.from_numpy(vals.astype(np.int32)),
            torch.from_numpy(rows.astype(np.int32)))


def _check_masked_encode(g, t, m, hw):
    """Every front of an hw x hw JAHP schedule: the masked encoder's step
    model gives the plain version's streams, lengths and states; then on
    tables with zero-frequency entries coded on active lanes."""
    vc, idx, act = _masked_inputs(g, hw, hw, m, seed=hw + 2 * m)
    (zcdf, _, _), zt = _zero_frequency_decoding_tables()
    zvc, zidx = _zero_frequency_values(zt, *vc.shape, seed=hw)
    lane_act = act.bool().repeat_interleave(m, dim=1)
    zero = zt.enc[zidx.long(), zvc.long(), 1] == 0
    assert int((zero & lane_act).sum()) > 100
    for tab, cdf, v, ix in ((t, t.cdf, vc, idx), (zt, zcdf, zvc, zidx)):
        streams, lengths, states = td.masked_encode_plain(cdf, v, ix, act,
                                                          m)
        x, chunks = _encode_model(tab, v, ix, act, m)
        got_streams, got_masks = _aligned_layout(chunks)
        assert torch.equal(x, states) and torch.equal(got_streams, streams)
        assert torch.equal(got_masks.sum(-1).to(torch.int32), lengths)
        assert not got_masks[~lane_act.t()].any()


def _zero_frequency_decoding_tables():
    """`_zero_frequency_tables` and a row whose last searched entry ends
    below 2^16, so slots above it find a zero-frequency entry: max(freq,
    1) decides the step there."""
    cdf, cdf_len, off = _zero_frequency_tables()
    row = np.zeros((1, cdf.shape[1]), np.int32)
    row[0, :4] = [0, 100, 60000, 60000]
    return _decoding_tables(np.concatenate([cdf, row]),
                            np.append(cdf_len, 4), np.append(off, 2))


def _check_masked(g, t, m, hw):
    """Every front of an hw x hw JAHP schedule (inactive pad slots among
    them), streams of the masked encoder; then random states and rows on
    tables with zero-frequency entries."""
    vc, idx, act = _masked_inputs(g, hw, hw, m, seed=hw + m)
    streams, _, states = td.masked_encode_plain(t.cdf, vc, idx, act, m)
    assert not bool(act.all())
    x = xp = states
    for front in range(vc.shape[0]):
        sym, x = _masked_front_model(t, streams, front, x, idx[front],
                                     act[front], m)
        psym, xp = td.masked_decode_front_plain(
            streams, front, xp, t.cdf, t.cdf_len, t.off, idx[front],
            act[front], m)
        assert torch.equal(sym, psym) and torch.equal(x, xp)
    assert bool((x == td.RANS_L).all())
    (cdf, cdf_len, off), zt = _zero_frequency_decoding_tables()
    rng = np.random.default_rng(5)
    lanes = act.shape[1] * m
    fronts = 8
    rand_streams = torch.from_numpy(
        rng.integers(0, 1 << 16, (lanes, fronts)).astype(np.int32))
    x = xp = torch.from_numpy(rng.integers(1 << 16, 1 << 32, lanes))
    clamped = 0
    for front in range(fronts):
        rows = torch.from_numpy(
            rng.integers(0, cdf.shape[0], lanes).astype(np.int32))
        a = act[front % act.shape[0]]
        # active lanes of the last row whose slot finds its zero-frequency
        # entry (cdf 60000, 60000)
        clamped += int((a.bool().repeat_interleave(m)
                        & (rows == cdf.shape[0] - 1)
                        & ((x & 0xFFFF) >= 60000)).sum())
        sym, x = _masked_front_model(zt, rand_streams, front, x, rows, a, m)
        psym, xp = td.masked_decode_front_plain(
            rand_streams, front, xp, cdf, cdf_len, off, rows, a, m)
        assert torch.equal(sym, psym) and torch.equal(x, xp)
    assert clamped > 0


@pytest.mark.parametrize('kind,lanes,n,tails', [
    pytest.param('batch1', 512, 55 * 55 * 24, False, id='512-72600-False'),
    pytest.param('batch1', 100, 2345, True, id='100-2345-True'),
    pytest.param('batch1', 40, 40 * 150 - 7, True, id='40-5993-True'),
    pytest.param('aligned', 512, 55 * 55 * 24, True, id='aligned-k3'),
    pytest.param('masked', 192, 16, True, id='masked-jahp-16x16x192'),
    pytest.param('aligned_encode', 512, 55 * 55 * 24, True,
                 id='aligned-encode-k3'),
    pytest.param('aligned_encode', 100, 2345, True,
                 id='aligned-encode-100-2345'),
    pytest.param('masked_encode', 192, 16, True,
                 id='masked-encode-jahp-16x16x192')])
def test_kernel_steps_on_prepared_tables_equal_plain_versions(
        kind, lanes, n, tails, gaussian):
    """The kernels' steps, run on the prepared tables, give the plain
    versions' states, chunks and symbols. The batch-1 pair: the MSHP y
    shape (512 lanes x 142 steps), lanes not a multiple of 32, a long
    latent with frequency-1 tails, and a corrupted state that ends invalid.
    The aligned decoder: k = 3 images of MSHP rows with frequency-1 tails
    at 512 lanes, a corrupted state included. The masked front decoder
    (m = 192 lanes a slot): every front of a 16 x 16 JAHP schedule, and
    tables with zero-frequency entries where max(freq, 1) decides. The
    aligned encoder (its chunks at column t, its masks): k = 3 images of
    MSHP rows with frequency-1 tails at 512 lanes, and at 100 lanes with n
    not a multiple of them. The masked encoder: every front of the 16 x
    16 JAHP schedule at m = 192, and zero-frequency entries coded on
    active lanes."""
    g, t = gaussian
    if kind == 'batch1':
        _check_batch1(g, t, lanes, n, tails)
    elif kind == 'aligned':
        _check_aligned(g, t, lanes, n, k=3)
    elif kind == 'aligned_encode':
        _check_aligned_encode(g, t, lanes, n, k=3)
    elif kind == 'masked_encode':
        _check_masked_encode(g, t, m=lanes, hw=n)
    else:
        _check_masked(g, t, m=lanes, hw=n)


def test_prepare_keeps_the_coding_tables_and_their_device(gaussian):
    g, t = gaussian
    for a, b in ((t.cdf, g.quantized_cdf), (t.cdf_len, g.cdf_length),
                 (t.off, g.offset)):
        assert a.dtype == torch.int32 and np.array_equal(a.numpy(), b)
    assert t.rows == 64 and t.cols == 3133
    assert t.enc.shape == (64, 3133, 4) and t.enc.is_contiguous()
    assert {a.device.type for a in (t.enc, t.dec, t.row_start)} == {'cpu'}
