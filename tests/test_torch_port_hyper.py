"""The port's hyperprior (SHP/MSHP) path against the JAX package, on the
CPU at a small size (bottleneck 8, target 64, latent 4, stages
(1, 1, 1, 1), 10 classes, 64x64 images).

Same inputs from numpy seeds go through both packages:
  - the Gaussian tables, bit-equal (the default scale table and a custom
    one); likelihoods within rtol 1e-6 and their gradients within rtol
    1e-5 of `jax.grad`; the scale indexes exact;
  - the general per-index device codec's plain versions: packed bytes
    equal to JAX's XLA scan and to the numpy oracle in both layouts, at
    lane counts that are not powers of two; `cdf_bisect`; the int16
    indexed host coder byte-equal;
  - SHP and MSHP `encode_ops` (y/z symbols and indexes equal), the 'train'
    forward with the same noise and the 'finetune' forward within 1e-5
    (of the output's largest magnitude);
  - the runtime: `stream_deploy` sizes, `stream_deploy_device` sizes and
    packed bytes at batch 1 and `wire_batch=3` (logits within 1e-4: the
    symbols are equal, only float sums differ), and the escape path;
  - one MSHP stage-1 `DistillationBox` step (losses with bpp0 and bpp1,
    gradients, updated parameters), the parameter labels of the MSHP
    configs name by name, a Flax MSHP checkpoint;
  - the `-test_only` CLI on the tiny config switched to MSHP, on both
    wires, against the JAX engine.
The Gaussian tables of the default scale table take seconds to build in
the JAX package: that function is memoized here for the module."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.models.runtime as jax_runtime_module
import sc2bench_tpu.ops.entropy.factorized as jax_factorized
import sc2bench_tpu.ops.entropy.gaussian as jax_gaussian
import sc2bench_tpu.train.engine as jax_engine_module
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.models.backbone import SplittableResNet as JaxResNet
from sc2bench_tpu.models.layer import \
    MSHPBasedResNetBottleneck as JaxMSHP
from sc2bench_tpu.models.layer import SHPBasedResNetBottleneck as JaxSHP
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.models.runtime import SplitClassifierRuntime as JaxRuntime
from sc2bench_tpu.ops.entropy.tables import \
    build_gaussian_tables as jax_gaussian_tables
from sc2bench_tpu.ops.rans import coder as jax_coder
from sc2bench_tpu.ops.rans import device as jd
from sc2bench_tpu.train.box import DistillationBox as JaxDistillationBox
from sc2bench_tpu.train.engine import ClassificationEngine as JaxEngine
from sc2bench_tpu.train.optim import label_params as jax_label_params
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
from sc2bench_tpu.utils.torch_convert import (SHP_DECONV_PATHS,
                                              SPLITTABLE_SHP_RESNET_RULES,
                                              convert_state_dict)
import sc2bench_tpu_torch.ops.entropy.factorized as port_factorized
import sc2bench_tpu_torch.ops.entropy.gaussian as port_gaussian
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models.backbone import splittable_resnet
from sc2bench_tpu_torch.models.layer import (MSHPBasedResNetBottleneck,
                                             SHPBasedResNetBottleneck)
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.ops.entropy.gaussian import (GaussianConditional,
                                                     get_scale_table)
from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
from sc2bench_tpu_torch.ops.rans import device as td
from sc2bench_tpu_torch.ops.rans.coder import RansCoder
from sc2bench_tpu_torch.tasks.image_classification import main
from sc2bench_tpu_torch.train.box import DistillationBox
from sc2bench_tpu_torch.train.optim import label_params
from sc2bench_tpu_torch.utils.ckpt import load_ckpt
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from test_torch_port_model import _nchw, _randomize

BCH, TARGET, LCH, STAGES, CLASSES, HW = 8, 64, 4, (1, 1, 1, 1), 10, 64
REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / 'configs/sample/tiny_entropic_student.yaml')
MSHP_CONFIGS = sorted(str(p) for p in (REPO / 'configs/ilsvrc2012').rglob(
    '*mshp*.yaml'))
FLAGSHIP_MSHP = str(REPO / 'configs/ilsvrc2012/supervised_compression/'
                    'entropic_student/'
                    'splitable_resnet50-mshp-beta0.16_from_resnet50.yaml')
_TABLES: dict = {}
_NOISE: dict = {}


def _cached_gaussian_tables(scale_table=None, *args, **kwargs):
    key = None if scale_table is None \
        else np.asarray(scale_table, np.float32).tobytes()
    if key not in _TABLES:
        _TABLES[key] = jax_gaussian_tables(scale_table, *args, **kwargs)
    return _TABLES[key]


@pytest.fixture(scope='module', autouse=True)
def memoized_jax_tables():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_runtime_module, 'build_gaussian_tables',
                   _cached_gaussian_tables)
        yield


def _noise(shape_nhwc) -> np.ndarray:
    key = tuple(int(s) for s in shape_nhwc)
    if key not in _NOISE:
        _NOISE[key] = np.random.default_rng(len(_NOISE) + 5).uniform(
            -0.5, 0.5, key).astype(np.float32)
    return _NOISE[key]


def _jax_noise(x, rng):
    return x + jnp.asarray(_noise(x.shape))


def _port_noise(x, generator):
    n, c, h, w = x.shape
    return x + torch.from_numpy(np.ascontiguousarray(
        _noise((n, h, w, c)).transpose(0, 3, 1, 2))).to(x)


@pytest.fixture
def same_noise(monkeypatch):
    """The same numpy noise, per shape, in both packages' factorized and
    Gaussian quantizers."""
    for module in (jax_factorized, jax_gaussian):
        monkeypatch.setattr(module, 'quantize_noise', _jax_noise)
    for module in (port_factorized, port_gaussian):
        monkeypatch.setattr(module, 'quantize_noise', _port_noise)


def _flat(tree) -> dict:
    return {'.'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_flax(named: dict) -> dict:
    """{torch name: tensor} of an SHP/MSHP student in the Flax layout,
    flat by dotted path, by the JAX package's own converter."""
    return _flat(convert_state_dict(
        {k: v.detach().cpu().numpy() for k, v in named.items()},
        SPLITTABLE_SHP_RESNET_RULES, SHP_DECONV_PATHS))


def _hyper_variables(module, rng, hw=HW):
    """Randomized Flax variables of a hyperprior student: h_s's scale
    channels made positive and spread, so that the indexes cover many
    table rows and y stays inside the Gaussian support."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, hw, hw, 3)), mode='train'))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']}, rng)
    bn = variables['params']['bottleneck_layer']
    kernel = bn['h_s_conv2']['kernel']
    bch = bn['g_a_conv2']['kernel'].shape[-1]
    kernel[..., :bch] = np.abs(kernel[..., :bch]) * 3.0
    return variables


def _jax_student(bottleneck_cls):
    return JaxResNet(bottleneck_layer=bottleneck_cls(
        num_bottleneck_channels=BCH, num_target_channels=TARGET,
        num_latent_channels=LCH), stage_sizes=STAGES, num_classes=CLASSES)


def _port_student(key, variables):
    pm = splittable_resnet(
        {'key': key, 'kwargs': {'num_bottleneck_channels': BCH,
                                'num_target_channels': TARGET,
                                'num_latent_channels': LCH}},
        stage_sizes=STAGES, num_classes=CLASSES, device='cpu')
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return pm


# ---- Gaussian conditional and its tables -------------------------------

@pytest.mark.parametrize('scale_table', [None, 'custom'])
def test_gaussian_tables_bit_equal(scale_table):
    st = None if scale_table is None else get_scale_table(0.2, 40.0, 12)
    want = _cached_gaussian_tables(st)
    got = build_gaussian_tables(st)
    for k in ('quantized_cdf', 'cdf_length', 'offset', 'scale_table'):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    if scale_table is None:
        assert got.quantized_cdf.shape == (64, 3133)
        assert int(got.cdf_length.sum()) == 27256


@pytest.mark.parametrize('with_means', [False, True], ids=['shp', 'mshp'])
def test_gaussian_likelihoods_gradients_and_indexes_equal_jax(with_means):
    rng = np.random.default_rng(3)
    shape = (2, 5, 6, 4)
    x = rng.normal(0, 3, shape).astype(np.float32)
    scales = np.abs(rng.normal(0, 2, shape)).astype(np.float32)
    scales[0, 0] = 0.01                         # below the scale bound
    means = rng.normal(0, 1, shape).astype(np.float32) if with_means \
        else None
    x[1, 1] = 40.0                              # below the likelihood bound
    w = rng.normal(0, 1, shape).astype(np.float32)
    jgc = jax_gaussian.GaussianConditional()

    def jfn(x, s, m):
        return jnp.sum(jgc.likelihood(x, s, m) * w)

    jm = jnp.asarray(means) if with_means else None
    j_lik = np.asarray(jgc.likelihood(jnp.asarray(x), jnp.asarray(scales),
                                      jm))
    j_grads = jax.grad(jfn, argnums=(0, 1) + ((2,) if with_means else ()))(
        jnp.asarray(x), jnp.asarray(scales), jm)
    gc = GaussianConditional()
    tx, ts = torch.tensor(x, requires_grad=True), \
        torch.tensor(scales, requires_grad=True)
    tm = torch.tensor(means, requires_grad=True) if with_means else None
    lik = gc.likelihood(tx, ts, tm)
    np.testing.assert_allclose(lik.detach().numpy(), j_lik, rtol=1e-6,
                               atol=1e-12)
    (lik * torch.from_numpy(w)).sum().backward()
    for got, want in zip([tx, ts] + ([tm] if with_means else []), j_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    table = get_scale_table()
    got_idx = gc.build_indexes(torch.from_numpy(scales),
                               torch.as_tensor(table, dtype=torch.float32))
    want_idx = jgc.build_indexes(jnp.asarray(scales),
                                 table.astype(np.float32))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert len(np.unique(got_idx.numpy())) > 10
    # the dequantize mode
    y_hat, _ = gc(tx.detach(), ts.detach(), tm.detach() if with_means
                  else None, mode='dequantize')
    j_hat, _ = jgc(jnp.asarray(x), jnp.asarray(scales), jm,
                   mode='dequantize')
    np.testing.assert_array_equal(y_hat.numpy(), np.asarray(j_hat))


# ---- general per-index codec --------------------------------------------

@functools.lru_cache(maxsize=1)
def _default_tables():
    """The port's tables of the default scale table, built once for the
    tests that code with them."""
    return build_gaussian_tables()


def _gaussian_case(n, seed):
    """The default Gaussian tables, rows spread over the table and symbols
    drawn from each row's own distribution."""
    t = _default_tables()
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, t.quantized_cdf.shape[0], n).astype(np.int32)
    u = rng.integers(0, 1 << 16, n)
    sym = np.empty(n, np.int32)
    for r in np.unique(idx):
        m = idx == r
        row = t.quantized_cdf[r][:t.cdf_length[r]]
        v = np.clip(np.searchsorted(row, u[m], side='right') - 1, 0,
                    t.cdf_length[r] - 3)
        sym[m] = v + t.offset[r]
    return t, idx, sym


def _oracle_wire(sym, idx, t, lanes):
    streams, states = td.numpy_oracle_encode(
        sym, idx, t.quantized_cdf, t.cdf_length, t.offset, num_lanes=lanes)
    lengths = np.asarray([len(s) for s in streams], np.uint16)
    return b''.join([np.asarray([lanes, 0], np.uint16).tobytes(),
                     lengths.tobytes(), states.astype(np.uint32).tobytes()]
                    + [np.asarray(s, np.uint16).tobytes() for s in streams])


@pytest.mark.parametrize('aligned', [False, True],
                         ids=['compacted', 'aligned'])
@pytest.mark.parametrize('lanes,n', [(48, 1000), (100, 2345)])
def test_general_codec_equals_jax_scan_and_oracle(lanes, n, aligned):
    t, idx, sym = _gaussian_case(n, seed=lanes)
    tables = (t.quantized_cdf, t.cdf_length, t.offset)
    got = td.device_rans_encode(torch.from_numpy(sym), *tables,
                                num_lanes=lanes, indexes=idx,
                                aligned=aligned, want_masks=aligned,
                                device='cpu')
    want = jax.device_get(jd.device_rans_encode(
        sym, idx, *tables, num_lanes=lanes, backend='xla', aligned=aligned,
        want_masks=aligned))
    assert bool(got['ok']) and bool(want['ok'])
    assert got['aligned'] == aligned
    assert int(got['nbytes']) == int(want['nbytes'])
    pack, jpack = (td.pack_stream_aligned, jd.pack_stream_aligned) \
        if aligned else (td.pack_stream, jd.pack_stream)
    wire = pack(got)
    assert wire == jpack(want) == _oracle_wire(sym, idx, t, lanes)
    np.testing.assert_array_equal(got['states'].numpy(), want['states'])
    dec, valid = td.device_rans_decode(
        got['streams'], got['states'], *tables, n_symbols=n,
        num_lanes=lanes, aligned=aligned, indexes=idx)
    assert bool(valid)
    np.testing.assert_array_equal(dec.numpy(), sym)
    if not aligned:
        j_dec, j_valid = jd.device_rans_decode(
            want['streams'], want['states'], idx, *tables, n_symbols=n,
            num_lanes=lanes, backend='xla')
        assert bool(j_valid)
        np.testing.assert_array_equal(np.asarray(j_dec), sym)
        bad = got['states'].clone()
        bad[lanes // 3] ^= 0x5A5A
        assert not bool(td.device_rans_decode(
            got['streams'], bad, *tables, n_symbols=n, num_lanes=lanes,
            indexes=idx)[1])


def test_cdf_bisect_equals_jax():
    t = _default_tables()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 64, 4000)
    slot = rng.integers(0, 1 << 16, 4000)
    got = td.cdf_bisect(torch.from_numpy(t.quantized_cdf),
                        torch.from_numpy(t.cdf_length),
                        torch.from_numpy(idx), torch.from_numpy(slot))
    want = jd.cdf_bisect(jnp.asarray(t.quantized_cdf),
                         jnp.asarray(t.cdf_length), jnp.asarray(idx),
                         jnp.asarray(slot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = [np.searchsorted(t.quantized_cdf[r][:t.cdf_length[r]], s,
                           'right') - 1 for r, s in zip(idx, slot)]
    np.testing.assert_array_equal(got.numpy(), ref)


def test_indexed_int16_host_coder_equals_jax():
    """Byte-equal to the JAX package's C++ coder and the pure-Python
    reference, escapes included, and it decodes."""
    t = _default_tables()
    rng = np.random.default_rng(1)
    n = 5000
    idx = rng.integers(0, 64, n).astype(np.int16)
    sym = np.round(rng.normal(0, 2, n)).astype(np.int16)
    sym[::97] = 3000                            # out of every row's support
    tables = (t.quantized_cdf, t.cdf_length, t.offset)
    coder = RansCoder(*tables)
    data = coder.encode_with_indexes_i16(sym, idx)
    assert data == jax_coder.RansCoder(*tables).encode_with_indexes_i16(
        sym, idx)
    assert data == RansCoder(*tables, use_cpp=False).encode_with_indexes_i16(
        sym, idx)
    for c in (coder, RansCoder(*tables, use_cpp=False)):
        out = c.decode_with_indexes_i16(data, idx)
        assert out.dtype == np.int16
        np.testing.assert_array_equal(out, sym)


# ---- the bottleneck layers ----------------------------------------------

@pytest.mark.parametrize('kind', ['SHP', 'MSHP'])
def test_bottleneck_equals_jax(kind, same_noise):
    """`encode_ops` symbols and indexes equal; the 'train' forward (same
    noise) and the 'finetune' forward within 1e-5 of the output's largest
    magnitude (only float sums differ, and IGDN multiplies them), and the
    captured `eb_out`/`gc_out` (likelihoods within rtol 1e-3: z's float
    sums move the factorized prior's tail probabilities most)."""
    jcls, pcls = (JaxSHP, SHPBasedResNetBottleneck) if kind == 'SHP' \
        else (JaxMSHP, MSHPBasedResNetBottleneck)
    variables = _hyper_variables(_jax_student(jcls),
                                 np.random.default_rng(5))
    bparams = {'params': variables['params']['bottleneck_layer']}
    jm = jcls(num_bottleneck_channels=BCH, num_target_channels=TARGET,
              num_latent_channels=LCH)
    pm = pcls(num_bottleneck_channels=BCH, num_target_channels=TARGET,
              num_latent_channels=LCH)
    pm.load_state_dict({k.split('.', 1)[1]: v for k, v in
                        state_dict_from_flax({'params': {
                            'bottleneck_layer': bparams['params']}}).items()})
    x = np.random.default_rng(6).normal(0, 1, (2, HW, HW, 3)).astype(
        np.float32)
    jv = jax.tree.map(jnp.asarray, bparams)
    med = np.asarray(bparams['params']['entropy_bottleneck']['quantiles']
                     [:, 0, 1])
    table = get_scale_table().astype(np.float32)
    j_ops = jm.apply(jv, jnp.asarray(x), jnp.asarray(med),
                     jnp.asarray(table), method=jm.encode_ops)
    with torch.no_grad():
        p_ops = pm.encode_ops(_nchw(x), torch.from_numpy(med),
                              torch.from_numpy(table))
    for k in ('y_symbols', 'y_indexes', 'z_symbols'):
        np.testing.assert_array_equal(
            p_ops[k].permute(0, 2, 3, 1).numpy(), np.asarray(j_ops[k]), k)
    assert len(np.unique(p_ops['y_indexes'].numpy())) >= 8
    assert pm.latent_shape(HW, HW) == (tuple(j_ops['y_symbols'].shape[1:]),
                                       tuple(j_ops['z_symbols'].shape[1:]))
    for mode in ('train', 'finetune'):
        j_out, j_io = jm.apply(jv, jnp.asarray(x), mode=mode,
                               rngs={'noise': jax.random.key(0)},
                               mutable=['entropy'])
        io = {}
        with torch.no_grad():
            p_out = pm(_nchw(x), mode=mode, generator=torch.Generator(),
                       io=io)
        want = np.asarray(j_out)
        np.testing.assert_allclose(p_out.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
        if mode == 'train':
            for name in ('eb_out', 'gc_out'):
                (got_hat, got_lik), (want_hat, want_lik) = \
                    io[name], j_io['entropy'][name][0]
                np.testing.assert_allclose(
                    got_hat.permute(0, 2, 3, 1).numpy(),
                    np.asarray(want_hat), rtol=1e-5, atol=1e-5,
                    err_msg=name)
                np.testing.assert_allclose(
                    got_lik.permute(0, 2, 3, 1).numpy(),
                    np.asarray(want_lik), rtol=1e-3, atol=1e-7,
                    err_msg=name)


# ---- runtime -----------------------------------------------------------

@pytest.fixture(scope='module')
def runtimes():
    jm = _jax_student(JaxMSHP)
    variables = _hyper_variables(jm, np.random.default_rng(7))
    jrt = JaxRuntime(jm, jax.tree.map(jnp.asarray, variables))
    assert jrt.update()
    jrt.eval()
    prt = SplitClassifierRuntime(
        _port_student('MSHPBasedResNetBottleneck', variables), device='cpu')
    assert prt.update()
    prt.eval()
    rng = np.random.default_rng(11)
    images = [rng.normal(0, 0.5, (1, HW, HW, 3)).astype(np.float32)
              for _ in range(4)]
    return variables, jrt, prt, images


def _serve(rt, images, fn, **kw):
    rt.clear_analysis()
    rt.activate_analysis()
    out = getattr(rt, fn)(images, **kw)
    sizes = list(rt.analyzers[0].file_size_list)
    summary = rt.summarize()
    rt.deactivate_analysis()
    return [np.asarray(o).reshape(1, -1) for o in out], sizes, summary


@pytest.mark.parametrize('fn,kw', [
    ('stream_deploy', {}), ('stream_deploy_device', {}),
    ('stream_deploy_device', {'wire_batch': 3}),
    ('stream_deploy_device', {'pull_wire': True})],
    ids=['host', 'device_batch1', 'device_wire_batch3', 'device_pull_wire'])
def test_runtime_equals_jax(runtimes, fn, kw):
    _, jrt, prt, images = runtimes
    j_logits, j_sizes, j_summary = _serve(
        jrt, [jnp.asarray(x) for x in images], fn, depth=2, workers=1, **kw)
    if fn == 'stream_deploy_device':
        prt.escapes = {'ok': 0, 'valid': 0}
    p_logits, p_sizes, p_summary = _serve(
        prt, [_nchw(x) for x in images], fn, depth=2, **kw)
    assert p_sizes == j_sizes
    assert p_summary == j_summary
    if fn == 'stream_deploy_device':
        assert prt.escapes == {'ok': 0, 'valid': 0}
    for a, b in zip(j_logits, p_logits):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_hyper_wire_bytes_and_symbols_equal_jax(runtimes):
    _, jrt, prt, images = runtimes
    x = images[0]
    j_ops = jrt.encode_device_wire_hyper(jnp.asarray(x))
    p_ops = prt.encode_device_wire_hyper(_nchw(x))
    assert p_ops['shapes'] == tuple(j_ops['shapes'])
    assert p_ops['lanes'] == jrt._auto_hyper_lanes_from_shapes(
        j_ops['shapes'])
    assert prt._pull_device_wire(p_ops) == \
        jrt._pull_device_wire(j_ops['z']) + jrt._pull_device_wire(j_ops['y'])
    assert np.asarray(p_ops['meta']).tolist() == \
        np.asarray(j_ops['meta']).tolist()
    # the host coder's objects are equal too
    assert prt.encode(_nchw(x)) == jrt.encode(jnp.asarray(x))


def test_escape_path_equals_jax(runtimes):
    """An image scaled out of the Gaussian support among normal ones: the
    same size and logits as the JAX runtime's host fallback."""
    _, jrt, prt, images = runtimes
    stream = images[:1] + [images[1] * 40.0] + images[2:3]
    for wire_batch in (None, 3):
        prt.escapes = {'ok': 0, 'valid': 0}
        j_logits, j_sizes, _ = _serve(jrt, [jnp.asarray(x) for x in stream],
                                      'stream_deploy_device', depth=2,
                                      workers=1, wire_batch=wire_batch)
        p_logits, p_sizes, _ = _serve(prt, [_nchw(x) for x in stream],
                                      'stream_deploy_device', depth=2,
                                      wire_batch=wire_batch)
        assert prt.escapes == {'ok': 1, 'valid': 0}
        assert p_sizes == j_sizes
        for a, b in zip(j_logits, p_logits):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_decode_batch_is_refused_for_a_hyperprior(runtimes):
    _, _, prt, images = runtimes
    with pytest.raises(ValueError, match='decode_batch'):
        prt.stream_deploy([_nchw(images[0])], decode_batch=2)


# ---- training ---------------------------------------------------------------

SMALL = {'models': {
    'teacher_model': {'key': 'resnet',
                      'kwargs': {'stage_sizes': list(STAGES),
                                 'num_classes': CLASSES}},
    'student_model': {'kwargs': {'stage_sizes': list(STAGES),
                                 'num_classes': CLASSES}}}}


def test_labels_equal_jax_name_by_name():
    """The MSHP configs' frozen globs (`bottleneck_layer.g_a_*`, `h_a_*`,
    `h_s_*`, `entropy_bottleneck`) label the same parameters as in JAX,
    name by name, in every stage."""
    assert FLAGSHIP_MSHP in MSHP_CONFIGS and len(MSHP_CONFIGS) >= 10
    cfg = jax_load_config(FLAGSHIP_MSHP, SMALL)['models']['student_model']
    jm = jax_load_model(cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)), mode='train'))
    pm = load_classification_model(cfg, device='cpu')
    names = {n for n, _ in pm.named_parameters()}
    for path in MSHP_CONFIGS:
        stages = [c for k, c in sorted(jax_load_config(path).get(
            'train', {}).items()) if k.startswith('stage')]
        for stage in stages:
            frozen = stage.get('frozen_modules', [])
            want = _flat(jax_label_params(shapes['params'], frozen, ()))
            got = label_params(pm, frozen)
            assert got.keys() == names
            assert {flax_param_path(n): v for n, v in got.items()} == want
    stage2 = jax_load_config(FLAGSHIP_MSHP)['train']['stage2']
    frozen = label_params(pm, stage2['frozen_modules'])
    assert frozen['bottleneck_layer.h_s.0.weight'] == 'frozen'
    assert frozen['bottleneck_layer.g_s.0.weight'] == 'main'
    assert frozen['bottleneck_layer.entropy_bottleneck.quantiles'] == 'aux'


def test_flax_mshp_checkpoint_loads(tmp_path):
    """A Flax MSHP checkpoint loads through the conversion rules, the
    deconvolutions flipped: the JAX package's torch converter maps the
    state dict back to the same variables."""
    jm = _jax_student(JaxMSHP)
    variables = _hyper_variables(jm, np.random.default_rng(2))
    path = str(tmp_path / 'mshp.ckpt')
    jax_save_ckpt(path, variables)
    state_dict, _, _ = load_ckpt(path)
    pm = _port_student('MSHPBasedResNetBottleneck', variables)
    pm.load_state_dict(state_dict, strict=True)
    back = _to_flax(pm.state_dict())
    want = _flat(variables)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_mshp_stage1_box_step_equals_jax(same_noise):
    """One stage-1 step of the MSHP flagship recipe (hints, bpp0 on z and
    bpp1 on y, Adam, the tail frozen) from the same variables, batch and
    noise: losses rtol 1e-4; gradients rtol 1e-3 (atol 1e-5 max|g|);
    parameters and statistics rtol 1e-4, updated parameters where their
    gradient stands clear of its tolerance (elsewhere within 2 lr)."""
    cfg = jax_load_config(FLAGSHIP_MSHP, SMALL)
    stage_cfg = cfg['train']['stage1']
    js = jax_load_model(cfg['models']['student_model'])
    jt = jax_load_model(cfg['models']['teacher_model'])
    rng = np.random.default_rng(4)
    variables = _hyper_variables(js, rng)
    t_shapes = jax.eval_shape(lambda: jt.init(
        {'params': jax.random.key(0)}, jnp.zeros((1, HW, HW, 3))))
    t_vars = _randomize({'params': t_shapes['params'],
                         'batch_stats': t_shapes['batch_stats']}, rng)
    x = rng.normal(0, 1, (2, HW, HW, 3)).astype(np.float32)
    y = np.array([1, 3])
    jbox = JaxDistillationBox(js, jax.tree.map(jnp.asarray, variables),
                              stage_cfg, teacher_module=jt,
                              teacher_variables=jax.tree.map(jnp.asarray,
                                                             t_vars),
                              steps_per_epoch=4, student_mode='train')
    from test_torch_port_train import _jax_box_step
    j_metrics, j_grads, j_vars = _jax_box_step(jbox, x, y)
    student = load_classification_model(cfg['models']['student_model'],
                                        device='cpu')
    student.load_state_dict(state_dict_from_flax(variables))
    teacher = load_classification_model(cfg['models']['teacher_model'],
                                        device='cpu')
    teacher.load_state_dict(state_dict_from_flax(t_vars))
    box = DistillationBox(student, stage_cfg, teacher=teacher,
                          steps_per_epoch=4, student_mode='train',
                          generator=torch.Generator())
    metrics = box.train_step(_nchw(x), torch.from_numpy(y))
    assert {'bpp0', 'bpp1'} <= set(metrics['loss'])
    assert metrics['loss'].keys() == j_metrics['loss'].keys()
    for k, v in j_metrics['loss'].items():
        np.testing.assert_allclose(float(metrics['loss'][k]), float(v),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(metrics['aux_loss']),
                               float(j_metrics['aux_loss']), rtol=1e-4)
    grads = _to_flax({n: p.grad for n, p in student.named_parameters()
                      if p.grad is not None})
    frozen = {k for k, v in _flat(jbox.labels).items() if v == 'frozen'}
    assert set(grads) == {f'params.{k}' for k in j_grads} \
        - {f'params.{k}' for k in frozen}
    for k, g in grads.items():
        ref = j_grads[k[len('params.'):]]
        np.testing.assert_allclose(g, ref, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=k)
    state = _to_flax(student.state_dict())
    assert state.keys() == j_vars.keys()
    lr = float(stage_cfg['optimizer']['kwargs']['lr'])
    for k, v in j_vars.items():
        ref = j_grads.get(k[len('params.'):])
        if k not in grads or ref is None:
            np.testing.assert_allclose(state[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        # Adam's first update is lr * g / (|g| + eps), about lr * sign(g):
        # where g lies inside its tolerance of zero its sign is float
        # noise, and the two updates may differ by up to 2 lr
        sure = np.abs(ref) > 1e-3 * float(np.abs(ref).max())
        np.testing.assert_allclose(state[k][sure], v[sure], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        assert np.all(np.abs(state[k] - v)[~sure] <= 2 * lr + 1e-5), k


# ---- the CLI ---------------------------------------------------------------

MSHP_OVER = {'models': {'student_model': {'kwargs': {'bottleneck_config': {
    'key': 'MSHPBasedResNetBottleneck',
    'kwargs': {'num_bottleneck_channels': BCH, 'num_target_channels': 256,
               'num_latent_channels': LCH}}}}}}


@pytest.fixture(scope='module')
def tiny_mshp_run(tmp_path_factory):
    """The JAX engine's test protocol on the tiny config with an MSHP
    student, teacher and student from Flax checkpoints with randomized
    values (6 test images), on both wires."""
    over = json.loads(json.dumps(MSHP_OVER))
    cfg = jax_load_config(TINY, over)
    ckpt_dir = tmp_path_factory.mktemp('tiny_mshp')
    rng = np.random.default_rng(9)
    t_module = jax_load_model(cfg['models']['teacher_model'])
    shapes = jax.eval_shape(lambda: t_module.init(
        {'params': jax.random.key(0)}, jnp.zeros((1, HW, HW, 3)),
        train=False))
    paths = {'teacher_model': str(ckpt_dir / 'teacher.ckpt'),
             'student_model': str(ckpt_dir / 'student.ckpt')}
    jax_save_ckpt(paths['teacher_model'], _randomize(
        {'params': shapes['params'], 'batch_stats': shapes['batch_stats']},
        rng))
    jax_save_ckpt(paths['student_model'], _hyper_variables(
        jax_load_model(cfg['models']['student_model']), rng))
    for role, path in paths.items():
        over['models'].setdefault(role, {})['ckpt'] = path
    over['test'] = {'test_data_loader': {'dataset': {
        'kwargs': {'num_samples': 6}}}}

    def zeros_like_init(module, image_size, seed=0, init_kwargs=None):
        shapes = jax.eval_shape(lambda: module.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, *image_size, 3)), **(init_kwargs or {})))
        return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                            {'params': shapes['params'],
                             'batch_stats': shapes['batch_stats']})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine_module, 'init_model', zeros_like_init)
        engine = JaxEngine(jax_load_config(TINY, over), image_size=(HW, HW),
                           mesh=None)
    per_wire = {}
    for wire in ('host', 'device'):
        engine.config['deploy_wire'] = wire
        engine.runtime.clear_analysis()
        per_wire[wire] = engine.test()
    return over, per_wire


@pytest.mark.parametrize('wire', ['host', 'device'])
def test_cli_test_only_mshp_equals_jax_engine(tiny_mshp_run, wire):
    over, per_wire = tiny_mshp_run
    want, want_summaries = per_wire[wire]
    out = main(['--config', TINY, '--json',
                json.dumps({**over, 'deploy_wire': wire}), '-test_only',
                '-student_only', '--device', 'cpu'])
    assert out['engine'].runtime.hyper
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
    assert out['summaries'][0]['num_samples'] == 6
    assert per_wire['host'][0]['acc1'] == per_wire['device'][0]['acc1']
