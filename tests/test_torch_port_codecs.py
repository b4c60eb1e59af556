"""The port's input- and feature-compression wrappers and its image-codec
zoo (FP, SHP, MSHP, and JAHP with its host and device wires) against the
JAX package, on the CPU at a small size: codecs n=8, m=12 (JAHP n=m=8),
a (1, 1, 1, 1) ResNet of 10 classes, 64 px images.

Both sides start from one set of Flax variables randomized with numpy and
carried into the port by `state_dict_from_flax`; images are numpy-seeded.
Equal means bit- or byte-equal: transforms, PIL sizes and reconstructions,
`compress` strings and pickled sizes, the JAHP device wire's streams,
states and lengths, the CLI's top-1/top-5 and data-size summaries. Float
outputs: decompressed images within 1e-4 of the image's largest
magnitude, logits within 1e-4, codec forwards rtol 1e-4 (likelihoods
atol 1e-6). The codecs' symbols and indexes come from convolutions that
torch and XLA sum in other orders, so a value within rounding of a
boundary could quantize differently; the tests count such mismatches of
the port's own forward and allow none at this size. The JAX package's
Gaussian tables are built once for the module.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.models.resnet as jax_resnet_module
import sc2bench_tpu.models.runtime as jax_runtime_module
import sc2bench_tpu.ops.entropy.factorized as jax_factorized
import sc2bench_tpu.ops.entropy.gaussian as jax_gaussian
import sc2bench_tpu.ops.entropy.tables as jax_tables_module
import sc2bench_tpu.ops.math as jax_math
from sc2bench_tpu.analysis import FileSizeAccumulator as JaxAccumulator
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.models import wrapper as jax_wrapper
from sc2bench_tpu.models import zoo as jax_zoo
from sc2bench_tpu.models.resnet import ResNet as JaxResNet
from sc2bench_tpu.models.zoo_jahp import \
    JointAutoregressiveRuntime as JaxJahpRuntime
from sc2bench_tpu.models.zoo_jahp_device import \
    _DeviceAutoregressive as JaxDeviceAutoregressive
from sc2bench_tpu.models.zoo_jahp_device import \
    _front_arrays as jax_front_arrays
from sc2bench_tpu.models.zoo_jahp_device import \
    _scale_indexes as jax_scale_indexes
from sc2bench_tpu.ops.rans.coder import RansCoder as JaxRansCoder
from sc2bench_tpu.ops.rans.coder import \
    StreamingDecoder as JaxStreamingDecoder
from sc2bench_tpu.registry import get as jax_registry_get
from sc2bench_tpu.train.engine import ClassificationEngine as JaxEngine
from sc2bench_tpu.transforms import codec as jax_codec
from sc2bench_tpu.transforms import misc as jax_misc
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
import sc2bench_tpu_torch.models.resnet as port_resnet_module
import sc2bench_tpu_torch.models.runtime as port_runtime_module
import sc2bench_tpu_torch.models.zoo_jahp as port_zoo_jahp
import sc2bench_tpu_torch.ops.entropy.factorized as port_factorized
import sc2bench_tpu_torch.ops.entropy.gaussian as port_gaussian
from sc2bench_tpu_torch.analysis import (FileSizeAccumulator,
                                         get_binary_object_size)
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models import wrapper as port_wrapper
from sc2bench_tpu_torch.models import zoo
from sc2bench_tpu_torch.models.registry import (COMPRESSION_MODEL_FAMILIES,
                                                get_compression_model,
                                                load_classification_model)
from sc2bench_tpu_torch.models.resnet import ResNet
from sc2bench_tpu_torch.models.wrapper import wrap_model
from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
from sc2bench_tpu_torch.ops.rans import kernels
from sc2bench_tpu_torch.ops.rans.coder import RansCoder, StreamingDecoder
from sc2bench_tpu_torch.tasks.image_classification import main
from sc2bench_tpu_torch.transforms import codec as port_codec
from sc2bench_tpu_torch.transforms import misc as port_misc
from sc2bench_tpu_torch.utils.ckpt import load_ckpt as port_load_ckpt
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_port_model import CLASSES, HW, STAGES, _randomize
from test_torch_port_train import _jax_noise, _port_noise

REPO = Path(__file__).resolve().parents[1]
INPUT = REPO / 'configs/ilsvrc2012/input_compression'
FEATURE = REPO / 'configs/ilsvrc2012/feature_compression'
# the 12 ILSVRC wrapper configs whose classifier the port has
WRAPPER_CONFIGS = [INPUT / f'{c}-resnet{d}.yaml'
                   for c in ('jpeg', 'webp') for d in (50, 101, 152)] + [
    FEATURE / 'jpeg-resnet50.yaml', FEATURE / 'webp-resnet50.yaml'] + [
    INPUT / f'{c}-resnet50.yaml' for c in (
        'factorized_prior', 'scale_hyperprior', 'mean_scale_hyperprior',
        'joint_autoregressive_hierarchical_prior')]
SMALL_RESNET = 'resnet_small'
CODECS = ['factorized_prior', 'scale_hyperprior', 'mean_scale_hyperprior',
          'joint_autoregressive_hierarchical_prior']
JAHP = 'joint_autoregressive_hierarchical_prior'
WIDTHS = {'factorized_prior': (8, 12), 'scale_hyperprior': (8, 12),
          'mean_scale_hyperprior': (8, 12), JAHP: (8, 8)}
NHWC = (0, 2, 3, 1)
_JAX_TABLES: dict = {}
_PORT_TABLES: dict = {}


def _cached(cache, build):
    def tables(scale_table=None, *args, **kwargs):
        key = None if scale_table is None \
            else np.asarray(scale_table, np.float32).tobytes()
        if key not in cache:
            cache[key] = build(scale_table, *args, **kwargs)
        return cache[key]
    return tables


@pytest.fixture(scope='module', autouse=True)
def memoized_gaussian_tables():
    """Each package's default Gaussian tables built once for the module."""
    jax_tables = _cached(_JAX_TABLES, jax_tables_module.build_gaussian_tables)
    port_tables = _cached(_PORT_TABLES, build_gaussian_tables)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_runtime_module, 'build_gaussian_tables', jax_tables)
        mp.setattr(jax_tables_module, 'build_gaussian_tables', jax_tables)
        mp.setattr(port_runtime_module, 'build_gaussian_tables', port_tables)
        mp.setattr(port_zoo_jahp, 'build_gaussian_tables', port_tables)
        yield


@pytest.fixture
def small_resnet(monkeypatch):
    """A (1, 1, 1, 1) ResNet under the name `resnet_small` in both
    packages' builder tables."""
    monkeypatch.setitem(
        jax_resnet_module.RESNET_BUILDERS, SMALL_RESNET,
        lambda **kw: JaxResNet(stage_sizes=STAGES, **kw))
    monkeypatch.setitem(
        port_resnet_module.RESNET_BUILDERS, SMALL_RESNET,
        lambda **kw: ResNet(STAGES, **kw))


def _images(n, seed=0, hw=HW):
    return np.random.default_rng(seed).normal(
        0, 1, (n, hw, hw, 3)).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _codec_variables(key, seed):
    """Randomized Flax variables of a small codec; the JAHP's scale half
    of the last entropy-parameters bias set to 4 so that its symbols stay
    inside the Gaussian tables' support (the device wire needs that)."""
    n, m = WIDTHS[key]
    module = jax_registry_get('model', key)(n=n, m=m)
    variables = jax.jit(lambda r, x: module.init(r, x, mode='train'))(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)))
    variables = _randomize({'params': jax.device_get(variables['params'])},
                           np.random.default_rng(seed))
    variables['batch_stats'] = {}
    if key == JAHP:
        variables['params']['ep2']['bias'][:m] = 4.0
    return module, variables


@pytest.fixture(scope='module')
def codecs():
    """{key: (JAX runtime, port runtime)} on shared weights, tables
    built."""
    out = {}
    for i, key in enumerate(CODECS):
        module, variables = _codec_variables(key, 40 + i)
        if key == JAHP:
            jrt = JaxJahpRuntime(module, variables)
        else:
            jrt = jax_zoo.ImageCodecRuntime(module, variables)
        jrt.update()
        n, m = WIDTHS[key]
        port = zoo.registry_get('model', key)(n=n, m=m, device='cpu')
        port.load_state_dict(state_dict_from_flax(variables))
        rt = zoo.codec_runtime(port, device='cpu')
        rt.update()
        out[key] = (jrt, rt)
    return out


@pytest.fixture(scope='module')
def classifier():
    """(JAX module, variables, port module) of the small ResNet."""
    module = JaxResNet(stage_sizes=STAGES, num_classes=CLASSES)
    variables = jax.jit(lambda r, x: module.init(r, x, train=False))(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3)))
    variables = _randomize(jax.device_get(dict(variables)),
                           np.random.default_rng(3))
    port = ResNet(STAGES, num_classes=CLASSES)
    port.load_state_dict(state_dict_from_flax(variables))
    return module, variables, port.eval()


# ---- transforms ---------------------------------------------------------------------

def _pil(seed=0, hw=(40, 56)):
    from PIL import Image
    arr = np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)
    return Image.fromarray(arr)


@pytest.mark.parametrize('case', ['pad', 'pad_nhwc', 'pad_centered',
                                  'to_tensor', 'normalize', 'collate'])
def test_misc_transforms_equal_jax(case):
    x = _images(2, seed=1, hw=50)
    if case == 'collate':
        batch = [(x[0], 1), (x[1], 2)]
        want = jax_misc.default_collate_w_pil(batch)
        got = port_misc.default_collate_w_pil(batch)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), np.asarray(g))
        pils = [_pil(0), _pil(1)]
        assert port_misc.default_collate_w_pil(pils) == pils
        return
    if case.startswith('pad'):
        kwargs = {'factor': 64, 'centered': case == 'pad_centered',
                  'returns_org_patch_size': True}
        inp = x if case == 'pad_nhwc' else x[0]
        want, want_hw = jax_misc.AdaptivePad(**kwargs)(inp)
        got, got_hw = port_misc.AdaptivePad(**kwargs)(inp)
        assert got_hw == want_hw and got.shape[-3:-1] == (64, 64)
    elif case == 'to_tensor':
        want, wt = jax_misc.CustomToTensor()(_pil(2), 3)
        got, gt = port_misc.CustomToTensor()(_pil(2), 3)
        assert gt == wt and got.dtype == np.float32
        np.testing.assert_array_equal(
            port_misc.CustomToTensor()(np.asarray(_pil(2))), got)
    else:
        want = jax_misc.Normalize()(x[0])
        got = port_misc.Normalize()(x[0])
    np.testing.assert_array_equal(np.asarray(want), got)


@pytest.mark.parametrize('case', ['resize_int', 'resize_tuple',
                                  'random_resized_crop', 'to_pil'])
def test_image_transforms_equal_jax(case):
    img = _pil(4)
    if case == 'to_pil':
        for a in (np.asarray(img), np.asarray(img) / 255.0, _images(1)[0]):
            np.testing.assert_array_equal(
                np.asarray(port_wrapper.to_pil(a)),
                np.asarray(jax_wrapper.to_pil(a)))
        return
    if case == 'random_resized_crop':
        want = jax_codec.WrappedRandomResizedCrop(
            24, interpolation='bicubic',
            rng=np.random.default_rng(9))(img)
        got = port_codec.WrappedRandomResizedCrop(
            24, interpolation='bicubic',
            rng=np.random.default_rng(9))(img)
    else:
        size = 32 if case == 'resize_int' else (20, 30)
        want = jax_codec.WrappedResize(size, 'lanczos')(img)
        got = port_codec.WrappedResize(size, 'lanczos')(img)
    assert got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize('fmt', ['JPEG', 'WEBP'])
def test_pil_image_module_equals_jax(fmt):
    kwargs = {'format': fmt, 'quality': 40, 'returns_file_size': True}
    img = _pil(5, (48, 48))
    want, want_size = jax_codec.PILImageModule(**kwargs)(img)
    got, got_size = port_codec.PILImageModule(**kwargs)(img)
    assert got_size == want_size > 0
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize('fmt', ['JPEG', 'WEBP'])
def test_pil_tensor_module_equals_jax(fmt):
    """Seven channels: groups of three, three and one (and of two, with a
    zero channel added, for five)."""
    kwargs = {'format': fmt, 'quality': 90, 'returns_file_size': True}
    for c in (7, 5):
        z = np.random.default_rng(c).normal(0, 2, (8, 8, c)) \
            .astype(np.float32)
        want, want_size = jax_codec.PILTensorModule(**kwargs)(z)
        got, got_size = port_codec.PILTensorModule(**kwargs)(z)
        assert got_size == want_size > 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('cls', ['BPGModule', 'VTMModule'])
def test_subprocess_codecs_raise_without_their_binary(cls):
    kwargs = {'encoder_path': 'no-such-encoder',
              'decoder_path': 'no-such-decoder', 'returns_file_size': True}
    with pytest.raises(FileNotFoundError) as want:
        getattr(jax_codec, cls)(**kwargs)(_pil(6))
    with pytest.raises(FileNotFoundError) as got:
        getattr(port_codec, cls)(**kwargs)(_pil(6))
    assert str(got.value).split(';')[0] == str(want.value).split(';')[0]


def test_file_size_accumulator_equals_jax():
    want, got = JaxAccumulator(unit='KB'), FileSizeAccumulator(unit='KB')
    for size in (1000, 2345, 77):
        want.analyze(size)
        got.analyze(size)
    assert got.summarize() == want.summarize()


# ---- streaming host decoder -----------------------------------------------------

@pytest.mark.parametrize('use_cpp', [True, False])
def test_streaming_decoder_equals_jax(use_cpp):
    """Chunks of one stream with indexes per chunk, an escaped symbol
    among them: the symbols of the JAX package's decoder, C or Python."""
    t = build_gaussian_tables()
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 64, 300).astype(np.int32)
    sym = rng.integers(-6, 7, 300).astype(np.int32)
    sym[17] = 4000
    coder = RansCoder(t.quantized_cdf, t.cdf_length, t.offset,
                      use_cpp=use_cpp)
    data = coder.encode_with_indexes(sym, idx)
    jcoder = JaxRansCoder(t.quantized_cdf, t.cdf_length, t.offset,
                          use_cpp=use_cpp)
    assert jcoder.encode_with_indexes(sym, idx) == data
    dec = StreamingDecoder(coder, data)
    jdec = JaxStreamingDecoder(jcoder, data)
    for lo in range(0, 300, 41):
        got = dec.decode(idx[lo:lo + 41])
        np.testing.assert_array_equal(got, jdec.decode(idx[lo:lo + 41]))
        np.testing.assert_array_equal(got, sym[lo:lo + 41])


# ---- the codecs -----------------------------------------------------------------------

@pytest.fixture
def same_noise(monkeypatch):
    """One noise array per shape in both packages' quantizers, the JAHP's
    y noise included."""
    monkeypatch.setattr(jax_factorized, 'quantize_noise', _jax_noise)
    monkeypatch.setattr(jax_gaussian, 'quantize_noise', _jax_noise)
    monkeypatch.setattr(jax_math, 'quantize_noise', _jax_noise)
    monkeypatch.setattr(port_factorized, 'quantize_noise', _port_noise)
    monkeypatch.setattr(port_gaussian, 'quantize_noise', _port_noise)
    monkeypatch.setattr(port_zoo_jahp, 'quantize_noise', _port_noise)


def _close(got: torch.Tensor, want, rtol=1e-4, atol_rel=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    if got.ndim == 4:
        got = got.transpose(NHWC)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


@pytest.mark.parametrize('mode', ['train', 'finetune'])
@pytest.mark.parametrize('key', CODECS)
def test_codec_forward_equals_jax(key, mode, codecs, same_noise):
    """The reconstruction and the likelihoods (`eb_out`, and `gc_out` for
    the hyperpriors): with the same noise in 'train', dequantized
    otherwise (the JAHP's context model teacher-forced over the rounded
    y)."""
    jrt, rt = codecs[key]
    x = _images(1, seed=11)
    want, state = jrt.module.apply(
        jrt.variables, jnp.asarray(x), mode=mode,
        rngs={'noise': jax.random.key(0)}, mutable=['entropy'])
    io = {}
    got = rt.module(_nchw(x), mode=mode, generator=torch.Generator(), io=io)
    _close(got, want)
    for name, ((j_hat, j_lik),) in state['entropy'].items():
        _close(io[name][0], j_hat, atol_rel=1e-5)
        np.testing.assert_allclose(io[name][1].detach().numpy().transpose(
            NHWC), np.asarray(j_lik), rtol=1e-3, atol=1e-6)


def _jax_ops(jrt, x):
    """The JAX codec's `encode_ops`: NHWC numpy symbols (and indexes)."""
    m = jrt.module
    if jrt.hyper:
        ops = m.apply(jrt.variables, jnp.asarray(x),
                      jnp.asarray(jrt.codec.tables.medians),
                      jnp.asarray(jrt.codec.g_tables.scale_table),
                      method=m.encode_ops)
    else:
        ops = m.apply(jrt.variables, jnp.asarray(x),
                      jnp.asarray(jrt.codec.tables.medians),
                      method=m.encode_ops)
    return {k: np.asarray(v) for k, v in ops.items()}


@pytest.mark.parametrize('key', CODECS[:3])
def test_compress_equals_jax(key, codecs):
    """FP/SHP/MSHP: the port's coder on the JAX package's symbols gives
    its strings; the port's own forward gives the same symbols and
    indexes (no mismatch at this size), strings and pickled size; the
    reconstruction is within 1e-4."""
    jrt, rt = codecs[key]
    x = _images(1, seed=12)
    want = jrt.compress(x)
    ops = _jax_ops(jrt, x)
    if rt.hyper:
        assert rt.codec.compress_y(ops['y_symbols'], ops['y_indexes']) \
            == want['strings'][0]
        assert rt.codec.compress_symbols(ops['z_symbols']) \
            == want['strings'][1]
        with port_runtime_module._exact_cudnn():
            port_ops = rt.module.encode_ops(_nchw(x), rt._medians,
                                            rt._scale_table)
    else:
        assert rt.codec.compress_symbols(ops['symbols']) \
            == want['strings'][0]
        port_ops = rt.module.encode_ops(_nchw(x), rt._medians)
    mismatches = sum(int((v.numpy().transpose(NHWC) != ops[k]).sum())
                     for k, v in port_ops.items())
    assert mismatches == 0
    got = rt.compress(_nchw(x))
    assert got == want
    assert isinstance(got['shape'][0], int)
    assert get_binary_object_size(got) == get_binary_object_size(want)
    _close(rt.decompress(**got), jrt.decompress(**want))


def test_jahp_host_wire_equals_jax(codecs):
    """The JAHP host wire: strings equal to JAX's (also from the JAX
    package's y and hyper), the round trip gives back y_hat bit for bit,
    and the reconstruction is within 1e-4 of JAX's."""
    jrt, rt = codecs[JAHP]
    x = _images(1, seed=13)
    want = jrt.compress(x)
    got, y_hat = rt.compress_latent(_nchw(x))
    assert got == want
    assert len(want['strings'][0][0]) > 40          # not a vacuous stream
    assert get_binary_object_size(got) == get_binary_object_size(want)
    np.testing.assert_allclose(y_hat[0].numpy().transpose(1, 2, 0),
                               jrt._last_y_hat, rtol=0, atol=1e-5)
    assert torch.equal(rt.decompress_latent(**got), y_hat)
    _close(rt.decompress(**got), jrt.decompress(**want))


def _jax_front_symbols(jrt, x):
    """(symbols, indexes) (T, F*m) of the JAX device wire's forward scan,
    run front by front with its own `_DeviceAutoregressive` and
    `_scale_indexes`."""
    ops = jrt.module.apply(jrt.variables, jnp.asarray(x), jrt._medians_dev,
                           method=jrt.module.encode_ops)
    y, hyper = ops['y'][0], ops['hyper'][0]
    h, w, m = y.shape
    ii, jj, act = jax_front_arrays(jrt._wavefronts(h, w), h, w)
    ar = JaxDeviceAutoregressive(jrt.variables['params'])
    table = jnp.asarray(jrt.scale_table, jnp.float32)
    y_hat = jnp.zeros((h + 4, w + 4, m), jnp.float32)
    syms, idxs = [], []
    for t in range(len(ii)):
        scales, means = ar.front_params(y_hat, hyper, jnp.asarray(ii[t]),
                                        jnp.asarray(jj[t]))
        sym = jnp.round(y[np.clip(ii[t], 0, None), jj[t]] - means)
        n = int(act[t].sum())
        y_hat = y_hat.at[ii[t][:n] + 2, jj[t][:n] + 2].set((sym + means)[:n])
        syms.append(np.asarray(sym, np.int32).ravel())
        idxs.append(np.asarray(jax_scale_indexes(scales, table)).ravel())
    return np.stack(syms), np.stack(idxs), act


def test_jahp_device_wire_equals_jax(codecs):
    """The device wire on the CPU (the kernels' plain versions): streams,
    states, lengths and size equal to JAX's `encode_device_wire`, also
    when the port's masked coder takes the JAX package's own symbols and
    indexes; the decode is valid and gives back the encoder's y_hat, which
    is the host path's bit for bit."""
    jrt, rt = codecs[JAHP]
    x = _images(1, seed=14)
    want = jrt.encode_device_wire(x)
    ops = rt.encode_device_wire(_nchw(x))
    assert bool(ops['ok']) and int(np.asarray(want['meta'])[0]) == 1
    assert int(ops['nbytes']) == int(np.asarray(want['meta'])[1])
    for name in ('y_streams', 'y_states', 'y_lengths'):
        np.testing.assert_array_equal(ops[name].numpy(),
                                      np.asarray(want[name]))
    assert int(ops['y_lengths'].sum()) > 0
    for name in ('streams', 'states', 'lengths'):
        np.testing.assert_array_equal(ops['z'][name].numpy(),
                                      np.asarray(want['z'][name]))
    # the masked coder alone, on the JAX package's symbols and indexes
    syms, idxs, act = _jax_front_symbols(jrt, x)
    cdf, cdf_len, off = rt._g_tables_dev
    idx = torch.from_numpy(idxs.astype(np.int32))
    v = torch.from_numpy(syms) - off[idx]
    vc = torch.minimum(v.clamp_min(0), cdf_len[idx] - 3)
    streams, lengths, states = kernels.masked_encode_aligned(
        cdf, vc, idx, torch.from_numpy(act.astype(np.uint8)), rt.module.m)
    np.testing.assert_array_equal(streams.numpy(),
                                  np.asarray(want['y_streams']))
    np.testing.assert_array_equal(states.numpy(),
                                  np.asarray(want['y_states']))
    y_hat, valid = rt.decode_device_latent(ops)
    assert bool(valid)
    assert torch.equal(y_hat, ops['y_hat'])
    assert torch.equal(y_hat, rt.compress_latent(_nchw(x))[1])
    img, _ = rt.decode_device_wire(ops)
    _close(img, np.asarray(jrt.module.apply(
        jrt.variables, jnp.asarray(y_hat.numpy().transpose(NHWC)),
        method=jrt.module.decode_image)))


def test_jahp_device_wire_non_multiple_of_16(codecs):
    """A 72 px image codes the whole ceil(72/16) = 5x5 latent, decodes
    valid to the encoder's y_hat and an 80 px image."""
    _, rt = codecs[JAHP]
    ops = rt.encode_device_wire(_nchw(_images(1, seed=7, hw=72)))
    assert ops['shape'] == (5, 5) and bool(ops['ok'])
    img, valid = rt.decode_device_wire(ops)
    assert bool(valid) and tuple(img.shape) == (1, 3, 80, 80)
    y_hat, _ = rt.decode_device_latent(ops)
    assert torch.equal(y_hat, ops['y_hat'])


def test_jahp_device_wire_rejects_a_corrupt_stream(codecs):
    _, rt = codecs[JAHP]
    ops = rt.encode_device_wire(_nchw(_images(1, seed=5)))
    lane = int(torch.argmax(ops['y_lengths']))
    col = int(torch.nonzero(ops['y_streams'][lane])[0, 0])
    ops['y_streams'] = ops['y_streams'].clone()
    ops['y_streams'][lane, col] ^= 0x5A5A
    assert not bool(rt.decode_device_latent(ops)[1])


# ---- the wrappers -------------------------------------------------------------------

ANALYSIS = {'analyzer_configs': [{'key': 'FileSizeAccumulator',
                                  'kwargs': {'unit': 'KB'}}]}
POST = [{'key': 'CustomToTensor', 'kwargs': {}},
        {'key': 'Normalize', 'kwargs': {}}]


@pytest.mark.parametrize('kind', ['input_jpeg', 'feature_webp'] + CODECS)
def test_wrapper_equals_jax(kind, classifier, codecs):
    """Logits within 1e-4 and equal data-size summaries for two images:
    JPEG on the input, WebP on the layer2 feature, and each neural
    codec."""
    j_module, j_vars, port = classifier
    images = list(_images(2, seed=21))
    if kind == 'input_jpeg':
        kwargs = {'codec_encoder_decoder': {'key': 'PILImageModule', 'kwargs': {
            'format': 'JPEG', 'quality': 75, 'returns_file_size': True}},
            'post_transform': POST, 'analysis_config': ANALYSIS}
        want_w = jax_wrapper.CodecInputCompressionClassifier(
            j_module, j_vars, **kwargs)
        got_w = port_wrapper.CodecInputCompressionClassifier(
            port, device='cpu', **kwargs)
    elif kind == 'feature_webp':
        kwargs = {'split_layer': 'layer2', 'analysis_config': ANALYSIS,
                  'compression_transform': {'key': 'PILTensorModule', 'kwargs': {
                      'format': 'WEBP', 'quality': 90,
                      'returns_file_size': True}}}
        want_w = jax_wrapper.CodecFeatureCompressionClassifier(
            j_module, j_vars, **kwargs)
        got_w = port_wrapper.CodecFeatureCompressionClassifier(
            port, device='cpu', **kwargs)
    else:
        jrt, rt = codecs[kind]
        kwargs = {'pre_transform': [{'key': 'AdaptivePad',
                                     'kwargs': {'factor': 64}}],
                  'analysis_config': {'analyzes_after_compress': True,
                                      'analyzer_configs': [{
                                          'key': 'FileSizeAnalyzer',
                                          'kwargs': {'unit': 'KB'}}]}}
        want_w = jax_wrapper.NeuralInputCompressionClassifier(
            j_module, j_vars, compression_model=jrt, **kwargs)
        got_w = port_wrapper.NeuralInputCompressionClassifier(
            port, compression_model=rt, device='cpu', **kwargs)
    want_w.activate_analysis()
    got_w.activate_analysis()
    want = np.asarray(want_w(images))
    got = got_w(images)
    assert got.shape == want.shape == (2, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert got_w.summarize() == want_w.summarize()
    assert got_w.summarize()[0]['num_samples'] == 2


# ---- the CLI ------------------------------------------------------------------------

def _cli_over(config, tmp_path, n=4):
    """A small classifier and codec, a synthetic test loader of `n` 64 px
    images, and (for a neural codec) randomized codec weights saved as the
    codec's ckpt, read by both packages."""
    cfg = jax_load_config(config)
    wrapper = {'classification_model': {
        'key': SMALL_RESNET, 'kwargs': {'num_classes': CLASSES}}}
    cm = cfg['models']['wrapper'].get('compression_model')
    if cm is not None:
        key = cm['key']
        n_ch, m_ch = WIDTHS[key]
        _, variables = _codec_variables(key, 60)
        path = str(tmp_path / f'{key}.ckpt')
        jax_save_ckpt(path, variables)
        wrapper['compression_model'] = {'kwargs': {'n': n_ch, 'm': m_ch},
                                        'ckpt': path}
    return {'models': {'wrapper': wrapper}, 'test': {'test_data_loader': {
        'dataset': {'key': 'SyntheticClassificationDataset',
                    'kwargs': {'num_samples': n, 'image_size': [HW, HW],
                               'num_classes': CLASSES}},
        'batch_size': 1}}}


@pytest.mark.parametrize('config', [
    INPUT / 'jpeg-resnet50.yaml', FEATURE / 'jpeg-resnet50.yaml',
    INPUT / 'mean_scale_hyperprior-resnet50.yaml',
    INPUT / 'joint_autoregressive_hierarchical_prior-resnet50.yaml'],
    ids=lambda p: f'{p.parent.name}-{p.stem}')
def test_cli_test_equals_jax_engine(config, small_resnet, tmp_path,
                                   monkeypatch):
    """`-test_only` on a small form of the config: top-1, top-5 and the
    data-size summary equal the JAX engine's. The port's builder of the
    small classifier loads the JAX engine's (random) classifier weights."""
    over = _cli_over(config, tmp_path)
    jax_engine = JaxEngine(jax_load_config(config, over), mesh=None)
    wrapper = jax_engine.wrapper
    j_vars = wrapper.variables if hasattr(wrapper, 'variables') \
        else wrapper.classifier.variables
    ckpt = str(tmp_path / 'classifier.ckpt')
    jax_save_ckpt(ckpt, jax.device_get(j_vars))

    def with_jax_weights(**kw):
        model = ResNet(STAGES, **kw)
        model.load_state_dict(port_load_ckpt(ckpt, model)[0])
        return model

    monkeypatch.setitem(port_resnet_module.RESNET_BUILDERS, SMALL_RESNET,
                        with_jax_weights)
    want, want_summaries = jax_engine.test()
    out = main(['--config', str(config), '--json', json.dumps(over),
                '-test_only', '--device', 'cpu'])
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
    assert want_summaries[0]['num_samples'] == 4
    assert out['teacher'] is None


def test_wrapper_config_trains_not(small_resnet, tmp_path):
    """A wrapper config without `-test_only` raises the JAX engine's
    ValueError."""
    config = INPUT / 'jpeg-resnet50.yaml'
    over = _cli_over(config, tmp_path, n=1)
    with pytest.raises(ValueError) as got:
        main(['--config', str(config), '--json', json.dumps(over),
              '--device', 'cpu'])
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_load_config(config, over), mesh=None).train()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('path', WRAPPER_CONFIGS,
                         ids=lambda p: f'{p.parent.name}-{p.stem}')
def test_wrapper_config_runs_in_the_port(path, small_resnet):
    """The port's CLI tests each of the 12 configs on the CPU with a small
    classifier, a narrowed codec and two synthetic images."""
    cm = load_config(path)['models']['wrapper'].get('compression_model')
    wrapper = {'classification_model': {
        'key': SMALL_RESNET, 'kwargs': {'num_classes': CLASSES}}}
    if cm is not None:
        n, m = WIDTHS[cm['key']]
        wrapper['compression_model'] = {'kwargs': {'n': n, 'm': m}}
    over = {'models': {'wrapper': wrapper}, 'test': {'test_data_loader': {
        'dataset': {'key': 'SyntheticClassificationDataset',
                    'kwargs': {'num_samples': 2, 'image_size': [HW, HW],
                               'num_classes': CLASSES}}, 'batch_size': 1}}}
    out = main(['--config', str(path), '--json', json.dumps(over),
                '-test_only', '--device', 'cpu'])
    s, = out['summaries']
    assert s['num_samples'] == 2 and s['mean'] > 0
    assert 0.0 <= out['result']['acc1'] <= 1.0


def test_compression_model_families():
    """Every neural codec config names one of the families, each family
    is a registered codec, and another model's name raises."""
    keys = {load_config(p)['models']['wrapper']['compression_model']['key']
            for p in WRAPPER_CONFIGS
            if 'compression_model' in load_config(p)['models']['wrapper']}
    assert keys and keys <= set(COMPRESSION_MODEL_FAMILIES)
    for key in COMPRESSION_MODEL_FAMILIES:
        assert zoo.registry_get('model', key) is not None
    with pytest.raises(KeyError, match='not a neural image codec'):
        get_compression_model({'key': 'resnet50'}, device='cpu')


@pytest.mark.parametrize('path', WRAPPER_CONFIGS,
                         ids=lambda p: f'{p.parent.name}-{p.stem}')
def test_wrapper_config_builds_at_full_width(path):
    """Each config's wrapper at full width on the meta device: the
    wrapper class, its classifier's parameter count, its codec transform
    or the neural codec at the config's quality (N, M)."""
    cfg = load_config(path)['models']['wrapper']
    counts = {'resnet50': 25_557_032, 'resnet101': 44_549_160,
              'resnet152': 60_192_808}
    with torch.device('meta'):
        model = load_classification_model(cfg['classification_model'],
                                          device='meta')
        kwargs = {}
        cm = cfg.get('compression_model')
        if cm is not None:
            module = zoo.registry_get('model', cm['key'])(
                device='meta', **cm['kwargs'])
            kwargs['compression_model'] = zoo.codec_runtime(module,
                                                            device='meta')
        wrapper = wrap_model(cfg, model, device='meta', **kwargs)
    assert type(wrapper).__name__ == cfg['key']
    assert sum(p.numel() for p in model.parameters()) \
        == counts[cfg['classification_model']['key']]
    if cm is not None:
        q = cm['kwargs']['quality']
        want = (192, 192 if q <= 5 else 320) if cm['key'] == JAHP \
            else ((128, 192) if q <= 5 else (192, 320))
        rt = wrapper.compression_model
        assert (rt.module.n, rt.module.m) == want
        assert rt.module.g_a[-1].out_channels == want[1]
    elif cfg['key'] == 'CodecFeatureCompressionClassifier':
        assert isinstance(wrapper.compress, port_codec.PILTensorModule)
        assert wrapper.split_layer == 'layer2'
    else:
        assert isinstance(wrapper.codec, port_codec.PILImageModule)
        assert wrapper.codec.save_kwargs['format'] in ('JPEG', 'WEBP')

