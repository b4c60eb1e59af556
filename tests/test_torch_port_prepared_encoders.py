"""The two encoders that read the prepared entries since their redesign,
`rans_indexed_encode_aligned` and `rans_masked_encode_aligned`, against the
JAX package on the CPU, and the prepared tables' path from their callers
to the wrappers.

The kernels run only on the card (`tests/test_torch_port_kernels.py`
holds them against the plain versions there). Here their steps, modelled
in torch on the prepared (start, freq, m_lo, m_hi) entries as the kernels
run them (`_encode_model` in `tests/test_torch_port_indexed_tables.py`),
are held against the JAX package's own encoders: `device_rans_encode(
aligned=True, want_masks=True, indexes=...)` (`sc2bench_tpu/ops/rans/
device.py`) and a scan of the JAHP device wire's `_rans_encode_step`
(`sc2bench_tpu/models/zoo_jahp_device.py`), on the same symbols and
tables. Recorders check that `device_rans_encode` and the JAHP runtime
hand the tables prepared once to both wrappers."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc2bench_tpu.models import zoo_jahp_device as jax_jahp_device
from sc2bench_tpu.ops.rans import device as jax_rans
from sc2bench_tpu_torch.models import zoo
from sc2bench_tpu_torch.models.zoo_jahp import JointAutoregressiveRuntime
from sc2bench_tpu_torch.ops.rans import device as td
from sc2bench_tpu_torch.ops.rans import kernels
from sc2bench_tpu_torch.ops.rans.indexed_tables import (
    IndexedTables, prepare_indexed_tables)
from test_torch_port_indexed_tables import (  # noqa: F401  (fixture)
    _aligned_layout, _blocks, _encode_model, _masked_inputs,
    _zero_frequency_decoding_tables, _zero_frequency_values, gaussian)
from test_torch_port_prepared_decoders import _recording

LANES, N = 512, 55 * 55 * 24          # the MSHP y: 512 lanes x 142 steps
K = 3


def _images(g):
    """K images of MSHP rows with frequency-1 tails: (vc, idx (K, T, N))."""
    blocks = [_blocks(g, LANES, N, seed=30 + i, tails=True)
              for i in range(K)]
    return (torch.cat([b[0] for b in blocks]).contiguous(),
            torch.cat([b[1] for b in blocks]).contiguous())


def test_aligned_encode_model_equals_jax_encode(gaussian):
    """k = 3 images at the MSHP y shape: the aligned encoder's step model
    on the prepared entries gives JAX `device_rans_encode(aligned=True,
    want_masks=True)`'s streams, masks, lengths, states and packed bytes,
    image by image."""
    g, t = gaussian
    vc, idx = _images(g)
    x, chunks = _encode_model(t, vc, idx)
    streams, masks = _aligned_layout(chunks)
    lengths = masks.sum(-1).to(torch.int32)
    encode = jax.jit(functools.partial(
        jax_rans.device_rans_encode, num_lanes=LANES, backend='xla',
        aligned=True, want_masks=True))
    tables = tuple(jnp.asarray(a) for a in (
        g.quantized_cdf, g.cdf_length, g.offset))
    sym = (vc + t.off[idx]).reshape(K, -1)[:, :N]
    rows = idx.reshape(K, -1)[:, :N]
    for i in range(K):
        out = encode(jnp.asarray(sym[i].numpy()), jnp.asarray(rows[i].numpy()),
                     *tables)
        assert bool(out['ok'])
        np.testing.assert_array_equal(np.asarray(out['streams']),
                                      streams[i].numpy())
        np.testing.assert_array_equal(np.asarray(out['masks']),
                                      masks[i].numpy())
        np.testing.assert_array_equal(np.asarray(out['lengths']),
                                      lengths[i].numpy())
        np.testing.assert_array_equal(
            np.asarray(out['states']).astype(np.int64), x[i].numpy())
        mine = {'streams': streams[i], 'lengths': lengths[i],
                'states': x[i], 'masks': masks[i]}
        assert td.pack_stream_aligned(mine) \
            == jax_rans.pack_stream_aligned(out)


@jax.jit
def _jax_masked_scan(st_all, nxt_all, lane_act):
    """The JAHP device wire's encode scan (zoo_jahp_device.py) over the
    fronts in reverse: (final states, aligned (N, T) chunks, lengths)."""
    def enc_step(x, inp):
        st, nxt, a = inp
        x, chunk, emit = jax_jahp_device._rans_encode_step(x, st, nxt - st,
                                                           a)
        return x, (chunk, emit)

    x0 = jnp.full(st_all.shape[1:], jax_rans.RANS_L, jnp.uint32)
    x, (chunks, emits) = jax.lax.scan(
        enc_step, x0, (jnp.flip(st_all, 0), jnp.flip(nxt_all, 0),
                       jnp.flip(lane_act, 0)))
    return x, jnp.flip(chunks, 0).T, jnp.sum(emits, axis=0)


def _jax_masked_encode(cdf, vc, idx, act, m):
    cdf = np.asarray(cdf)
    v, r = vc.numpy(), idx.numpy()
    st = cdf[r, v].astype(np.uint32)
    nxt = cdf[r, v + 1].astype(np.uint32)
    lane_act = np.repeat(act.numpy().astype(bool), m, axis=1)
    x, chunks, lengths = _jax_masked_scan(jnp.asarray(st), jnp.asarray(nxt),
                                          jnp.asarray(lane_act))
    return (np.asarray(x).astype(np.int64), np.asarray(chunks),
            np.asarray(lengths))


def test_masked_encode_model_equals_jax_encode_step(gaussian):
    """Every front of the 16 x 16 JAHP schedule at m = 192: the masked
    encoder's step model on the prepared entries gives a jitted scan of
    JAX `_rans_encode_step`'s states, chunks and lengths, on the Gaussian
    tables and on tables with zero-frequency entries coded on active
    lanes (where max(freq, 1) decides)."""
    g, t = gaussian
    m = 192
    vc, idx, act = _masked_inputs(g, 16, 16, m, seed=14)
    assert act.shape[0] == 61 and not bool(act.all())
    (zcdf, _, _), zt = _zero_frequency_decoding_tables()
    zvc, zidx = _zero_frequency_values(zt, *vc.shape, seed=16)
    lane_act = act.bool().repeat_interleave(m, dim=1)
    assert int(((zt.enc[zidx.long(), zvc.long(), 1] == 0)
                & lane_act).sum()) > 100
    for tab, cdf, v, ix in ((t, g.quantized_cdf, vc, idx),
                            (zt, zcdf, zvc, zidx)):
        x, chunks = _encode_model(tab, v, ix, act, m)
        streams, masks = _aligned_layout(chunks)
        jx, jchunks, jlengths = _jax_masked_encode(cdf, v, ix, act, m)
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(streams.numpy(), jchunks)
        np.testing.assert_array_equal(masks.sum(-1).numpy(), jlengths)


def test_device_rans_encode_hands_prepared_to_the_aligned_encoder(
        monkeypatch, gaussian):
    g, t = gaussian
    vc, idx = _images(g)
    calls = _recording(monkeypatch, 'indexed_encode_aligned')
    sym = (vc + t.off[idx]).reshape(K, -1)[:, :N]
    out = td.device_rans_encode(sym, g.quantized_cdf, g.cdf_length,
                                g.offset, num_lanes=LANES, aligned=True,
                                want_masks=True,
                                indexes=idx.reshape(K, -1)[:, :N],
                                prepared=t)
    assert len(calls) == 1 and calls[0] is t and bool(out['ok'].all())
    x, chunks = _encode_model(t, vc, idx)
    streams, masks = _aligned_layout(chunks)
    assert torch.equal(out['streams'], streams)
    assert torch.equal(out['masks'], masks) and torch.equal(out['states'], x)


@pytest.mark.parametrize('other', ['narrower', 'same_shape', 'offsets'])
def test_a_prepared_of_another_table_raises(other, gaussian):
    """Both encoders check `prepared` against `cdf` on any device, before
    anything runs: tables of a narrower `cdf` and of a `cdf` of the same
    shape with its rows in another order raise; tables of the same `cdf`
    with other offsets hold the same entries and pass."""
    g, t = gaussian
    if other == 'narrower':
        args = (t.cdf[:, :-1].contiguous(), t.cdf_len, t.off)
    elif other == 'same_shape':
        args = (t.cdf.flip(0).contiguous(), t.cdf_len.flip(0).contiguous(),
                t.off)
    else:
        args = (t.cdf, t.cdf_len, t.off + 1)
    wrong = prepare_indexed_tables(*args)
    vc, idx = _images(g)
    m = 4
    mvc, midx, act = _masked_inputs(g, 3, 3, m, seed=2)
    calls = ((kernels.indexed_encode_aligned, (t.cdf, vc, idx)),
             (kernels.masked_encode_aligned, (t.cdf, mvc, midx, act, m)))
    for fn, call in calls:
        if other == 'offsets':
            want = fn(*call)
            got = fn(*call, prepared=wrong)
            assert all(a is b or torch.equal(a, b)
                       for a, b in zip(got, want))
        else:
            with pytest.raises(ValueError, match='prepared tables'):
                fn(*call, prepared=wrong)


def test_jahp_encode_hands_update_s_tables_to_the_masked_encoder(
        monkeypatch):
    """A small JAHP (n = m = 8) on a 256 px image (a 16 x 16 latent, 61
    fronts) on the CPU: the device-wire encode hands the tables `update()`
    prepared to the masked encoder, once, and its streams decode to the
    encoder's y_hat."""
    torch.manual_seed(0)
    module = zoo.registry_get(
        'model', 'joint_autoregressive_hierarchical_prior')(n=8, m=8,
                                                            device='cpu')
    with torch.no_grad():
        module.entropy_parameters[-1].bias[:8] = 4.0
    rt = JointAutoregressiveRuntime(module, device='cpu')
    rt.update()
    assert isinstance(rt._g_prepared, IndexedTables)
    calls = _recording(monkeypatch, 'masked_encode_aligned')
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (1, 3, 256, 256)).astype(np.float32))
    ops = rt.encode_device_wire(x)
    assert len(calls) == 1 and calls[0] is rt._g_prepared
    assert ops['shape'] == (16, 16) and bool(ops['ok'])
    y_hat, valid = rt.decode_device_latent(ops)
    assert bool(valid) and torch.equal(y_hat, ops['y_hat'])
