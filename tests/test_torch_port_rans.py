"""The PyTorch port's cyclic-lane rANS codec against the JAX package.

Same inputs (numpy seeds) through `sc2bench_tpu.ops.rans.device` and
`sc2bench_tpu_torch.ops.rans.device`: streams, lengths, states, packed
bytes and decoded symbols must be EQUAL, for the compacted (batch-1) and
time-aligned (wire_batch) layouts, against the XLA scan and the numpy
oracle on every case and against the Pallas kernels in interpret mode on a
tiny case. On the CPU the port runs its kernels' plain versions; the
kernels themselves are held against them on the card
(`tests/test_torch_port_kernels.py`)."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import numpy as np
import pytest
import torch

import jax

from sc2bench_tpu.ops.rans import device as jd
from sc2bench_tpu_torch.ops.rans import device as td
from sc2bench_tpu_torch.ops.rans import kernels


def _tables(num_dists, support=21, seed=0):
    """Random 16-bit CDF tables shaped like the production ones."""
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


def _case(C, n, seed=1):
    """Tables + in-support cyclic symbols (position p codes channel p%C),
    drawn from each row's own distribution."""
    cdf, cdf_length, offset = _tables(C, seed=C)
    rng = np.random.default_rng(seed)
    idx = (np.arange(n) % C).astype(np.int32)
    u = rng.integers(0, 1 << 16, n)
    sym = np.empty(n, np.int32)
    for c in range(C):
        m = idx == c
        row = cdf[c][:cdf_length[c]]
        v = np.clip(np.searchsorted(row, u[m], side='right') - 1,
                    0, cdf_length[c] - 3)
        sym[m] = v + offset[c]
    return cdf, cdf_length, offset, idx, sym


def _jax_encode(sym, idx, tables, lanes, C, backend='xla', aligned=False):
    return jax.device_get(jd.device_rans_encode(
        sym, idx, *tables, num_lanes=lanes, cyclic_channels=C,
        backend=backend, aligned=aligned, want_masks=aligned))


def _port_encode(sym, tables, lanes, C, aligned=False):
    return td.device_rans_encode(torch.from_numpy(sym), *tables,
                                 num_lanes=lanes, cyclic_channels=C,
                                 aligned=aligned, want_masks=aligned)


def _assert_encode_equal(ref, got, aligned):
    keys = ('streams', 'lengths', 'states', 'ok', 'nbytes')
    for k in keys + (('masks',) if aligned else ()):
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=k)


# (channels, lanes, n): lane counts that are not multiples of 32 or 128,
# n not a multiple of the lane count, and the flagship channel count 24
CASES = [(8, 48, 400), (8, 32, 3000), (24, 72, 5000), (24, 384, 7300),
         (6, 6, 97)]


@pytest.mark.parametrize('aligned', [False, True])
@pytest.mark.parametrize('C,lanes,n', CASES)
def test_encode_decode_equal_jax_xla_and_oracle(C, lanes, n, aligned):
    cdf, cdf_length, offset, idx, sym = _case(C, n)
    tables = (cdf, cdf_length, offset)
    ref = _jax_encode(sym, idx, tables, lanes, C, aligned=aligned)
    got = _port_encode(sym, tables, lanes, C, aligned=aligned)
    assert bool(got['ok'])
    _assert_encode_equal(ref, got, aligned)
    wire = td.pack_stream_aligned(got) if aligned else td.pack_stream(got)
    assert wire == (jd.pack_stream_aligned(ref) if aligned
                    else jd.pack_stream(ref))
    assert len(wire) == int(got['nbytes']) == td.wire_nbytes(wire)
    # the numpy oracle pins the per-lane chunk sequences and states
    o_streams, o_states = td.numpy_oracle_encode(
        sym, idx, cdf, cdf_length, offset, num_lanes=lanes,
        cyclic_channels=C)
    np.testing.assert_array_equal(got['states'].numpy(), o_states)
    streams, states = td.unpack_stream(wire)
    for j in range(lanes):
        assert list(streams[j, :len(o_streams[j])]) == o_streams[j]
    # decode: the port's plain decode, the JAX scan and the oracle agree
    dec, valid = td.device_rans_decode(
        got['streams'], got['states'], cdf, cdf_length, offset,
        n_symbols=n, num_lanes=lanes, cyclic_channels=C, aligned=aligned)
    assert bool(valid)
    np.testing.assert_array_equal(dec.numpy(), sym)
    jdec, jvalid = jd.device_rans_decode(
        ref['streams'], ref['states'], idx, cdf, cdf_length, offset,
        n_symbols=n, num_lanes=lanes, cyclic_channels=C, backend='xla',
        aligned=aligned)
    assert bool(jvalid)
    np.testing.assert_array_equal(np.asarray(jdec), dec.numpy())
    if not aligned:
        # the oracle pads with index 0; give it the cyclic pad indexes
        total = -(-n // lanes) * lanes
        full = td.numpy_oracle_decode(
            streams, states, np.arange(total) % C, cdf, cdf_length, offset,
            total, num_lanes=lanes)
        np.testing.assert_array_equal(full[:n], sym)


@pytest.mark.parametrize('aligned', [False, True])
def test_out_of_support_flags_ok_false_like_jax(aligned):
    cdf, cdf_length, offset, idx, sym = _case(8, 400)
    sym = sym.copy()
    sym[5] = offset[5 % 8] + 1000
    sym[77] = offset[77 % 8] - 1
    tables = (cdf, cdf_length, offset)
    ref = _jax_encode(sym, idx, tables, 48, 8, aligned=aligned)
    got = _port_encode(sym, tables, 48, 8, aligned=aligned)
    assert not bool(ref['ok']) and not bool(got['ok'])
    _assert_encode_equal(ref, got, aligned)


def test_equal_to_pallas_kernels_in_interpret_mode():
    """Tiny case through the JAX package's Pallas kernels (interpret
    mode): all four kernels' outputs equal the port's."""
    C, lanes, n = 8, 48, 400
    cdf, cdf_length, offset, idx, sym = _case(C, n, seed=3)
    tables = (cdf, cdf_length, offset)
    for aligned in (False, True):
        ref = _jax_encode(sym, idx, tables, lanes, C,
                          backend='pallas-interpret', aligned=aligned)
        got = _port_encode(sym, tables, lanes, C, aligned=aligned)
        _assert_encode_equal(ref, got, aligned)
        jdec, jvalid = jd.device_rans_decode(
            ref['streams'], ref['states'], idx, cdf, cdf_length, offset,
            n_symbols=n, num_lanes=lanes, cyclic_channels=C,
            backend='pallas-interpret', aligned=aligned)
        dec, valid = td.device_rans_decode(
            got['streams'], got['states'], cdf, cdf_length, offset,
            n_symbols=n, num_lanes=lanes, cyclic_channels=C,
            aligned=aligned)
        assert bool(jvalid) and bool(valid)
        np.testing.assert_array_equal(np.asarray(jdec), dec.numpy())


@pytest.mark.parametrize('aligned', [False, True])
def test_corrupt_stream_is_not_valid(aligned):
    C, lanes, n = 8, 48, 400
    cdf, cdf_length, offset, _, sym = _case(C, n)
    got = _port_encode(sym, (cdf, cdf_length, offset), lanes, C,
                       aligned=aligned)
    states = got['states'].clone()
    states[3] ^= 0x5A5A
    _, valid = td.device_rans_decode(
        got['streams'], states, cdf, cdf_length, offset, n_symbols=n,
        num_lanes=lanes, cyclic_channels=C, aligned=aligned)
    assert not bool(valid)


@pytest.mark.parametrize('aligned', [False, True])
def test_batched_rows_equal_single_encodes(aligned):
    """A (k, n) batch codes each row independently: equal to k batch-1
    calls, and the batched decode returns every row."""
    C, lanes, n = 24, 72, 1000
    cdf, cdf_length, offset, _, _ = _case(C, n)
    rows = np.stack([_case(C, n, seed=r)[-1] for r in range(3)])
    tables = (cdf, cdf_length, offset)
    batch = _port_encode(rows, tables, lanes, C, aligned=aligned)
    for r in range(3):
        one = _port_encode(rows[r], tables, lanes, C, aligned=aligned)
        for k in ('streams', 'lengths', 'states', 'ok', 'nbytes'):
            np.testing.assert_array_equal(batch[k][r].numpy(),
                                          one[k].numpy(), err_msg=k)
    dec, valid = td.device_rans_decode(
        batch['streams'], batch['states'], *tables, n_symbols=n,
        num_lanes=lanes, cyclic_channels=C, aligned=aligned)
    assert valid.tolist() == [True] * 3
    np.testing.assert_array_equal(dec.numpy(), rows)


def test_aligned_batch_equals_jax_xla_and_oracle_per_image():
    """A wire_batch-shaped call: k=5 images coded at once in the aligned
    layout, T = 46 steps (not a multiple of the kernels' 32-step tiles).
    Each row equals the JAX XLA path's encode of that image and the numpy
    oracle's, and the batched decode returns every row as JAX does."""
    C, lanes, n, k = 24, 72, 72 * 45 + 5, 5
    cdf, cdf_length, offset, idx, _ = _case(C, n)
    tables = (cdf, cdf_length, offset)
    rows = np.stack([_case(C, n, seed=r)[-1] for r in range(k)])
    got = _port_encode(rows, tables, lanes, C, aligned=True)
    assert tuple(got['streams'].shape) == (k, lanes, 46)
    dec, valid = td.device_rans_decode(
        got['streams'], got['states'], *tables, n_symbols=n,
        num_lanes=lanes, cyclic_channels=C, aligned=True)
    assert valid.tolist() == [True] * k
    np.testing.assert_array_equal(dec.numpy(), rows)
    for r in range(k):
        ref = _jax_encode(rows[r], idx, tables, lanes, C, aligned=True)
        one = {key: got[key][r] for key in ('streams', 'lengths', 'states',
                                            'ok', 'nbytes', 'masks')}
        _assert_encode_equal(ref, one, aligned=True)
        assert td.pack_stream_aligned(one) == jd.pack_stream_aligned(ref)
        o_streams, o_states = td.numpy_oracle_encode(
            rows[r], idx, cdf, cdf_length, offset, num_lanes=lanes,
            cyclic_channels=C)
        np.testing.assert_array_equal(one['states'].numpy(), o_states)
        streams, _ = td.unpack_stream(td.pack_stream_aligned(one))
        for j in range(lanes):
            assert list(streams[j, :len(o_streams[j])]) == o_streams[j]
        jdec, jvalid = jd.device_rans_decode(
            ref['streams'], ref['states'], idx, cdf, cdf_length, offset,
            n_symbols=n, num_lanes=lanes, cyclic_channels=C, backend='xla',
            aligned=True)
        assert bool(jvalid)
        np.testing.assert_array_equal(np.asarray(jdec), dec[r].numpy())


def test_aligned_wire_equals_compacted_wire():
    cdf, cdf_length, offset, _, sym = _case(24, 5000)
    tables = (cdf, cdf_length, offset)
    c = _port_encode(sym, tables, 72, 24)
    a = _port_encode(sym, tables, 72, 24, aligned=True)
    assert td.pack_stream(c) == td.pack_stream_aligned(a)
    assert int(c['nbytes']) == int(a['nbytes'])


@pytest.mark.parametrize('n,C', [(72600, 24), (1800, 8), (97, 6),
                                 (300000, 24), (4096, 192)])
def test_auto_lanes_equal_jax(n, C):
    assert td.auto_lanes(n, cyclic_channels=C) == \
        jd.auto_lanes(n, cyclic_channels=C)
    assert td.auto_lanes(n) == jd.auto_lanes(n)


def test_flagship_lane_layout():
    """The flagship 55x55x24 latent: 384 lanes of 190 steps."""
    n = 55 * 55 * 24
    lanes = td.auto_lanes(n, cyclic_channels=24)
    assert (lanes, -(-n // lanes)) == (384, 190)


@pytest.mark.parametrize('aligned', [False, True],
                         ids=['compacted', 'aligned'])
def test_non_cyclic_lanes_take_the_general_path_equal_to_jax(aligned):
    """12 lanes over C = 8 is not a cyclic layout: it codes through the
    general per-index path (position p on row p mod 8, as the JAX package
    codes it), bytes equal to JAX's XLA scan, and decodes."""
    cdf, cdf_length, offset, idx, sym = _case(8, 100)
    got = td.device_rans_encode(torch.from_numpy(sym), cdf, cdf_length,
                                offset, num_lanes=12, cyclic_channels=8,
                                aligned=aligned, want_masks=aligned)
    want = _jax_encode(sym, idx, (cdf, cdf_length, offset), 12, 8,
                       aligned=aligned)
    pack, jpack = (td.pack_stream_aligned, jd.pack_stream_aligned) \
        if aligned else (td.pack_stream, jd.pack_stream)
    assert pack(got) == jpack(want)
    assert int(got['nbytes']) == int(want['nbytes'])
    dec, valid = td.device_rans_decode(
        got['streams'], got['states'], cdf, cdf_length, offset,
        n_symbols=100, num_lanes=12, cyclic_channels=8, aligned=aligned)
    assert bool(valid)
    np.testing.assert_array_equal(dec.numpy(), sym)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; a tensor on another non-CUDA device is refused."""
    cdf, cdf_length, offset, _, sym = _case(8, 400)
    kernels.reset_launches()
    enc = _port_encode(sym, (cdf, cdf_length, offset), 48, 8)
    td.device_rans_decode(enc['streams'], enc['states'], cdf, cdf_length,
                          offset, n_symbols=400, num_lanes=48,
                          cyclic_channels=8)
    assert set(kernels.LAUNCHES.values()) == {0}
    vc = torch.zeros((1, 4, 8), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError):
        kernels.cyclic_encode(torch.zeros((8, 5), dtype=torch.int32,
                                          device='meta'), vc)


def test_numpy_input_defaults_to_cuda():
    """Non-tensor input goes to the CUDA device unless asked otherwise."""
    cdf, cdf_length, offset, _, sym = _case(8, 400)
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        td.device_rans_encode(sym, cdf, cdf_length, offset, num_lanes=48,
                              cyclic_channels=8)
    out = td.device_rans_encode(sym, cdf, cdf_length, offset, num_lanes=48,
                                cyclic_channels=8, device='cpu')
    assert bool(out['ok'])
