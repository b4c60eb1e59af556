"""The two decoders that read the prepared tables since their redesign,
`rans_indexed_decode_aligned` and `rans_masked_decode_front`, against the
JAX package on the CPU, and the prepared tables' path from their callers
to the wrappers.

The kernels run only on the card (`tests/test_torch_port_kernels.py`
holds them against the plain versions there). Here their steps, modelled
in torch on the prepared tables as the kernels run them
(`tests/test_torch_port_indexed_tables.py`), are held against the JAX
package's own decoders: `device_rans_decode(aligned=True, indexes=...)`
(`sc2bench_tpu/ops/rans/device.py`) and the JAHP device wire's
`_rans_decode_step` (`sc2bench_tpu/models/zoo_jahp_device.py`), on the
same streams and tables. Recorders check that `device_rans_decode` and
the JAHP runtime hand the tables prepared once to every launch."""
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
    _blocks, _decode_model, _masked_front_model, _masked_inputs,
    _zero_frequency_decoding_tables, gaussian)

LANES, N = 512, 55 * 55 * 24          # the MSHP y: 512 lanes x 142 steps
K = 3


def _aligned_images(g, t):
    """K images of MSHP rows (frequency-1 tails) coded aligned by the plain
    encoder: (vc, idx (K, T, N), streams (K, N, T), states (K, N))."""
    blocks = [_blocks(g, LANES, N, seed=20 + i, tails=True)
              for i in range(K)]
    vc = torch.cat([b[0] for b in blocks]).contiguous()
    idx = torch.cat([b[1] for b in blocks]).contiguous()
    streams, _, states, _ = td.indexed_encode_plain(t.cdf, vc, idx,
                                                    aligned=True)
    return vc, idx, streams, states


def test_aligned_step_model_equals_jax_decode(gaussian):
    """k = 3 images at the MSHP y shape: the aligned decoder's step model on
    the prepared tables gives JAX `device_rans_decode(aligned=True)`'s
    symbols and validity, image by image, also on a corrupted state."""
    g, t = gaussian
    vc, idx, streams, states = _aligned_images(g, t)
    steps = vc.shape[1]
    bad = states.clone()
    bad[K - 1, LANES // 3] ^= 0x5A5A
    decode = jax.jit(functools.partial(
        jax_rans.device_rans_decode, n_symbols=N, num_lanes=LANES,
        backend='xla', aligned=True))
    tables = tuple(jnp.asarray(a) for a in (
        g.quantized_cdf, g.cdf_length, g.offset))
    for st in (states, bad):
        out, xend = _decode_model(t, streams, st, idx, steps, aligned=True)
        flat = out.reshape(K, -1)[:, :N]
        for i in range(K):
            sym, valid = decode(
                jnp.asarray(streams[i].numpy().astype(np.uint16)),
                jnp.asarray(st[i].numpy().astype(np.uint32)),
                jnp.asarray(idx[i].reshape(-1)[:N].numpy()), *tables)
            np.testing.assert_array_equal(np.asarray(sym), flat[i].numpy())
            assert bool(valid) == bool((xend[i] == td.RANS_L).all())
    assert not bool(valid)


def _jax_front_loop(streams, states, cdf, cdf_len, off, idx, act, m):
    """JAX `_rans_decode_step` over every front: (symbols (T, N), states)."""
    step = jax.jit(jax_jahp_device._rans_decode_step)
    tables = tuple(jnp.asarray(np.asarray(a)) for a in (cdf, cdf_len, off))
    x = jnp.asarray(states.numpy().astype(np.uint32))
    chunks = jnp.asarray(streams.numpy().astype(np.uint16))
    lane_act = np.repeat(act.numpy().astype(bool), m, axis=1)
    out = []
    for t in range(idx.shape[0]):
        x, sym = step(x, chunks[:, t], *tables, jnp.asarray(idx[t].numpy()),
                      jnp.asarray(lane_act[t]))
        out.append(np.asarray(sym))
    return np.stack(out), np.asarray(x).astype(np.int64)


def _model_front_loop(t, streams, states, idx, act, m):
    x, out = states, []
    for front in range(idx.shape[0]):
        sym, x = _masked_front_model(t, streams, front, x, idx[front],
                                     act[front], m)
        out.append(sym.numpy())
    return np.stack(out), x.numpy()


def test_masked_front_model_equals_jax_decode_step(gaussian):
    """Every front of the 16 x 16 JAHP schedule at m = 192 on the masked
    encoder's streams: the front decoder's step model on the prepared
    tables gives the states of a loop of JAX `_rans_decode_step` and its
    symbols on the active lanes (JAX returns a row's offset on an inactive
    lane, the kernel 0); then random states and rows on tables with
    zero-frequency entries, where max(freq, 1) decides."""
    g, t = gaussian
    m = 192
    vc, idx, act = _masked_inputs(g, 16, 16, m, seed=11)
    assert act.shape[0] == 61
    streams, _, states = td.masked_encode_plain(t.cdf, vc, idx, act, m)
    (zcdf, zlen, zoff), zt = _zero_frequency_decoding_tables()
    rng = np.random.default_rng(12)
    lanes = streams.shape[0]
    rand_idx = torch.from_numpy(
        rng.integers(0, zcdf.shape[0], (8, lanes)).astype(np.int32))
    rand_streams = torch.from_numpy(
        rng.integers(0, 1 << 16, (lanes, 8)).astype(np.int32))
    rand_states = torch.from_numpy(rng.integers(1 << 16, 1 << 32, lanes))
    for tab, cdf, cdf_len, off, s, x0, ix, a in (
            (t, t.cdf, t.cdf_len, t.off, streams, states, idx, act),
            (zt, zcdf, zlen, zoff, rand_streams, rand_states, rand_idx,
             act[:8])):
        sym, x = _model_front_loop(tab, s, x0, ix, a, m)
        jsym, jx = _jax_front_loop(s, x0, cdf, cdf_len, off, ix, a, m)
        on = np.repeat(a.numpy().astype(bool), m, axis=1)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(sym[on], jsym[on])
        assert not sym[~on].any()
    assert bool((torch.from_numpy(_model_front_loop(
        t, streams, states, idx, act, m)[1]) == td.RANS_L).all())


def _recording(monkeypatch, name):
    """Replace `kernels.<name>` by a recorder of its `prepared` argument
    that delegates to the wrapper."""
    calls = []
    real = getattr(kernels, name)

    def record(*args, **kwargs):
        calls.append(kwargs.get('prepared'))
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, name, record)
    return calls


def test_device_rans_decode_hands_prepared_to_the_aligned_decoder(
        monkeypatch, gaussian):
    g, t = gaussian
    vc, idx, streams, states = _aligned_images(g, t)
    calls = _recording(monkeypatch, 'indexed_decode_aligned')
    flat_idx = idx.reshape(K, -1)[:, :N]
    sym, valid = td.device_rans_decode(
        streams, states, g.quantized_cdf, g.cdf_length, g.offset,
        n_symbols=N, num_lanes=LANES, aligned=True, indexes=flat_idx,
        prepared=t)
    assert len(calls) == 1 and calls[0] is t and bool(valid.all())
    assert torch.equal(sym, (vc + t.off[idx]).reshape(K, -1)[:, :N])


@pytest.mark.parametrize('other', ['narrower', 'same_shape', 'offsets'])
def test_a_prepared_of_another_table_raises(other, gaussian):
    """Both wrappers check `prepared` against `cdf`, `cdf_len` and `off`
    on any device, before anything runs: tables of a narrower `cdf`, of a
    `cdf` of the same shape with its rows in another order, and of the same
    `cdf` with other offsets."""
    g, t = gaussian
    if other == 'narrower':
        args = (t.cdf[:, :-1].contiguous(), t.cdf_len, t.off)
    elif other == 'same_shape':
        args = (t.cdf.flip(0).contiguous(), t.cdf_len.flip(0).contiguous(),
                t.off)
    else:
        args = (t.cdf, t.cdf_len, t.off + 1)
    wrong = prepare_indexed_tables(*args)
    vc, idx, streams, states = _aligned_images(g, t)
    with pytest.raises(ValueError, match='prepared tables'):
        kernels.indexed_decode_aligned(streams, states, t.cdf, t.cdf_len,
                                       t.off, idx, vc.shape[1],
                                       prepared=wrong)
    m = 4
    mvc, midx, act = _masked_inputs(g, 3, 3, m, seed=2)
    ms, _, mx = td.masked_encode_plain(t.cdf, mvc, midx, act, m)
    with pytest.raises(ValueError, match='prepared tables'):
        kernels.masked_decode_front(ms, 0, mx, t.cdf, t.cdf_len, t.off,
                                    midx[0], act[0], m, prepared=wrong)
    # the tables' own prepared form, and equal copies of its tensors, pass
    kernels.masked_decode_front(ms, 0, mx, t.cdf.clone(), t.cdf_len,
                                t.off.clone(), midx[0], act[0], m,
                                prepared=t)


def test_a_table_changed_after_its_check_raises(gaussian):
    """A copy of `cdf` found equal once is not compared again while it is
    unchanged; changed in place, it is compared again and refused."""
    g, _ = gaussian
    t = prepare_indexed_tables(g.quantized_cdf, g.cdf_length, g.offset)
    m = 4
    mvc, midx, act = _masked_inputs(g, 3, 3, m, seed=2)
    ms, _, mx = td.masked_encode_plain(t.cdf, mvc, midx, act, m)
    cdf = t.cdf.clone()
    for _ in range(2):
        kernels.masked_decode_front(ms, 0, mx, cdf, t.cdf_len, t.off,
                                    midx[0], act[0], m, prepared=t)
        assert len(t._equal['cdf']) == 1
    cdf[5, 1] += 1
    with pytest.raises(ValueError, match='prepared tables'):
        kernels.masked_decode_front(ms, 0, mx, cdf, t.cdf_len, t.off,
                                    midx[0], act[0], m, prepared=t)


def test_jahp_update_prepares_the_tables_every_front_reads(monkeypatch):
    """A small JAHP (n = m = 8) on a 256 px image (a 16 x 16 latent, 61
    fronts) on the CPU: `update()` prepares the Gaussian tables once, the
    device-wire decode hands them to each of the 61 fronts, and y_hat is
    still the encoder's, bit for bit."""
    torch.manual_seed(0)
    module = zoo.registry_get(
        'model', 'joint_autoregressive_hierarchical_prior')(n=8, m=8,
                                                            device='cpu')
    with torch.no_grad():
        module.entropy_parameters[-1].bias[:8] = 4.0
    rt = JointAutoregressiveRuntime(module, device='cpu')
    rt.update()
    prepared = rt._g_prepared
    assert isinstance(prepared, IndexedTables)
    assert prepared.cdf is rt._g_tables_dev[0]
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (1, 3, 256, 256)).astype(np.float32))
    ops = rt.encode_device_wire(x)
    assert ops['shape'] == (16, 16) and bool(ops['ok'])
    calls = _recording(monkeypatch, 'masked_decode_front')
    y_hat, valid = rt.decode_device_latent(ops)
    assert len(calls) == 61 and all(c is prepared for c in calls)
    assert bool(valid) and torch.equal(y_hat, ops['y_hat'])
