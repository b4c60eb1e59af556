"""The port's fine-tuning family (`EntropicClassifierModule` split after
the stem, layer1-4 or the average pool) and CR+BQ family
(`larger_resnet_bottleneck` + `SimpleQuantizer`) against the JAX package,
on the CPU at a small size (stages (1, 1, 1, 1), 10 classes, 64x64).

Both sides start from one set of Flax variables, randomized with numpy
(`state_dict_from_flax` carries them into the port); the training noise is
the same fixed array on both (`test_torch_port_train.same_noise`).
Tolerances: the split forwards and the EntropicClassifier's logits and
quantized feature 1e-5 (relative, and of each tensor's largest magnitude),
its likelihoods as the FP bottleneck's (rtol 1e-3, atol 1e-7); gradients rtol 1e-3 (atol 1e-5 max|g|); the host wire's
symbols, strings and data sizes equal; deploy logits 2e-4; one training
step of each family as `test_torch_port_train.py` holds the others. The
44 configs of both families build with the port's
`load_classification_model`.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
import pickle
import re
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.models.resnet as jax_resnet_module
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.config import \
    train_stage_configs as jax_train_stage_configs
from sc2bench_tpu.models.backbone import SplittableResNet as JaxSplittable
from sc2bench_tpu.models.entropic import \
    EntropicClassifierModule as JaxEntropic
from sc2bench_tpu.models.layer import \
    EntropyBottleneckLayer as JaxEntropyBottleneckLayer
from sc2bench_tpu.models.layer import \
    larger_resnet_bottleneck as jax_larger_resnet_bottleneck
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.models.resnet import ResNet as JaxResNet
from sc2bench_tpu.models.runtime import SplitClassifierRuntime as JaxRuntime
from sc2bench_tpu.models.wrapper import SplitClassifier as JaxSplitClassifier
from sc2bench_tpu.train.box import DistillationBox as JaxDistillationBox
from sc2bench_tpu.train.box import TrainingBox as JaxTrainingBox
from sc2bench_tpu.train.engine import ClassificationEngine as JaxEngine
from sc2bench_tpu.transforms import misc as jax_misc
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
import sc2bench_tpu_torch.models.resnet as port_resnet_module
from sc2bench_tpu_torch.analysis import get_binary_object_size
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models.backbone import splittable_resnet
from sc2bench_tpu_torch.models.entropic import (SPLIT_CHANNELS,
                                                EntropicClassifierModule)
from sc2bench_tpu_torch.models.layer import EntropyBottleneckLayer
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.models.resnet import ResNet
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.models.wrapper import SplitClassifier, wrap_model
from sc2bench_tpu_torch.tasks.image_classification import main
from sc2bench_tpu_torch.train.box import DistillationBox, TrainingBox
from sc2bench_tpu_torch.transforms import misc as port_misc
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_port_model import CLASSES, HW, STAGES, _nchw, _randomize
from test_torch_port_train import same_noise  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = REPO / 'configs/ilsvrc2012/supervised_compression'
FT_CONFIG = str(FAMILIES / 'fine-tuning/resnet50-eb_after_layer1-beta1.0e-5.yaml')
BQ_CONFIG = str(FAMILIES / 'ghnd-bq/resnet50-bq12ch_from_resnet50.yaml')
CONFIGS = sorted((FAMILIES / 'fine-tuning').glob('*.yaml')) \
    + sorted((FAMILIES / 'ghnd-bq').glob('*.yaml'))
SPLITS = ['stem', 'layer1', 'layer2', 'layer3', 'layer4', 'avgpool']
BQ_CH = 3
NHWC = (0, 2, 3, 1)
SMALL_RESNET = 'resnet_small'
QUANTIZER = {'key': 'SimpleQuantizer', 'kwargs': {'num_bits': 8}}
DEQUANTIZER = {'key': 'SimpleDequantizer', 'kwargs': {'num_bits': 8}}


def _images(seed, n=1, scale=1.0):
    return np.random.default_rng(seed).normal(
        0, scale, (n, HW, HW, 3)).astype(np.float32)


def _jax_variables(module, rng, **init_kwargs):
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)), **init_kwargs))
    return _randomize({'params': shapes['params'],
                       'batch_stats': shapes['batch_stats']}, rng)


def _close(got: torch.Tensor, want, tol, nhwc=True):
    """Within `tol`, relative and of the tensor's largest magnitude (at
    least 1): XLA's and PyTorch's convolutions sum in other orders."""
    got = got.detach()
    if nhwc and got.ndim == 4:
        got = got.permute(NHWC)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * max(
        1.0, float(np.abs(want).max())))


def _jax_entropic(split):
    return JaxEntropic(base=JaxResNet(stage_sizes=STAGES, num_classes=CLASSES,
                                      sow_intermediates=False),
                       split_layer=split)


def _port_entropic(split, variables):
    pm = EntropicClassifierModule(ResNet(STAGES, CLASSES), split)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return pm.eval()


def _jax_bq_student():
    return JaxSplittable(
        bottleneck_layer=jax_larger_resnet_bottleneck(bottleneck_channel=BQ_CH),
        stage_sizes=STAGES, num_classes=CLASSES)


def _port_bq_student(variables):
    pm = splittable_resnet({'key': 'larger_resnet_bottleneck',
                            'kwargs': {'bottleneck_channel': BQ_CH}},
                           stage_sizes=STAGES, num_classes=CLASSES,
                           device='cpu')
    pm.load_state_dict(state_dict_from_flax(variables, pm), strict=True)
    return pm.eval()


# ---- ResNet split points -----------------------------------------------------

@pytest.fixture(scope='module')
def resnets():
    jm = JaxResNet(stage_sizes=STAGES, num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3)), train=False))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(2))
    pm = ResNet(STAGES, CLASSES)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, jax.tree.map(jnp.asarray, variables), pm.eval()


@pytest.mark.parametrize('split', SPLITS)
@torch.no_grad()
def test_forward_until_and_from_equal_jax(resnets, split):
    """The head's feature and the tail's logits from the JAX head's
    feature, within 1e-5; head then tail is the whole forward."""
    jm, variables, pm = resnets
    x = _images(1, n=2)
    head = 'layer4' if split == 'avgpool' else split
    jf = jm.apply(variables, jnp.asarray(x), head,
                  method=JaxResNet.forward_until)
    pf = pm.forward_until(_nchw(x), head)
    _close(pf, jf, 1e-5)
    if split == 'avgpool':
        jf, pf = jnp.mean(jf, axis=(1, 2)), pf.mean(dim=(2, 3))
        _close(pf, jf, 1e-5)
        feature = torch.from_numpy(np.array(jf))
    else:
        feature = _nchw(np.asarray(jf))
    jl = jm.apply(variables, jf, split, method=JaxResNet.forward_from)
    _close(pm.forward_from(feature, split), jl, 1e-5)
    _close(pm.forward_from(pf, split), pm(_nchw(x)), 1e-5)
    assert pf.shape[1] == SPLIT_CHANNELS[split]


# ---- EntropicClassifierModule ------------------------------------------------

_ENTROPIC = {}


def _entropic(split):
    """(JAX module, its variables, the port's module), one per split."""
    if split not in _ENTROPIC:
        jm = _jax_entropic(split)
        variables = _jax_variables(jm, np.random.default_rng(
            SPLITS.index(split)), mode='train')
        _ENTROPIC[split] = (jm, variables, _port_entropic(split, variables))
    return _ENTROPIC[split]


@pytest.mark.parametrize('mode', ['train', 'dequantize', 'finetune'])
@pytest.mark.parametrize('split', ['layer1', 'avgpool'])
def test_entropic_classifier_forward_equals_jax(split, mode, same_noise):
    """Logits and `eb_out` = (z_hat, likelihoods), and the gradients of a
    rate + output loss: none reach the head through the rounded (or
    detached) feature."""
    jm, variables, _ = _entropic(split)
    pm = _port_entropic(split, variables)
    x = _images(3, n=2)

    def jloss(params):
        out, state = jm.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(x), mode=mode, mutable=['entropy'],
            rngs={'noise': jax.random.key(0)})
        z_hat, lik = state['entropy']['eb_out'][0]
        return (jnp.sum(out ** 2) * 1e-3 - jnp.sum(jnp.log2(lik)),
                (out, z_hat, lik))

    (_, (jout, jz, jlik)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, variables['params']))
    io = {}
    out = pm(_nchw(x), mode=mode, generator=torch.Generator(), io=io)
    z_hat, lik = io['eb_out']
    (torch.sum(out ** 2) * 1e-3 - torch.sum(torch.log2(lik))).backward()
    _close(out, jout, 1e-5)
    _close(z_hat, jz, 1e-5)
    # the density's sigmoid differences magnify the feature's float
    # noise: the FP bottleneck's tolerance (test_torch_port_train.py)
    np.testing.assert_allclose(lik.detach().permute(NHWC).numpy(),
                               np.asarray(jlik), rtol=1e-3, atol=1e-7)
    want = state_dict_from_flax({'params': jgrads})
    # the pooled feature's noisy rate term is -log2 of likelihoods near
    # their 1e-9 floor, whose gradient magnifies the feature's float noise
    atol = 5e-3 if split == 'avgpool' and mode == 'train' else 1e-5
    for name, p in pm.named_parameters():
        ref = want[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-3,
                                   atol=atol * float(np.abs(ref).max()),
                                   err_msg=name)
        if mode != 'train' and name.startswith('base.conv1'):
            assert not got.any(), name


@pytest.mark.parametrize('mode', ['train', 'dequantize', 'finetune'])
def test_entropy_bottleneck_layer_equals_jax(mode, same_noise):
    """The bare layer: output and `eb_out` within 1e-5 (likelihoods as the
    FP bottleneck's), the deploy ops' symbols bit-equal and their decoded
    values equal."""
    c = 6
    jm = JaxEntropyBottleneckLayer(channels=c)
    x = np.random.default_rng(7).normal(0, 3, (2, 5, 4, c)).astype(
        np.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.asarray(x)))
    variables = _randomize({'params': shapes['params']},
                           np.random.default_rng(8))
    jv = jax.tree.map(jnp.asarray, variables)
    jout, state = jm.apply(jv, jnp.asarray(x), mode=mode,
                           mutable=['entropy'],
                           rngs={'noise': jax.random.key(0)})
    pm = EntropyBottleneckLayer(c)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    io = {}
    out = pm(_nchw(x).requires_grad_(True), mode=mode,
             generator=torch.Generator(), io=io)
    assert out.requires_grad == (mode != 'finetune')
    _close(out, jout, 1e-5)
    jz, jlik = state['entropy']['eb_out'][0]
    _close(io['eb_out'][0], jz, 1e-5)
    np.testing.assert_allclose(io['eb_out'][1].detach().permute(NHWC),
                               np.asarray(jlik), rtol=1e-3, atol=1e-7)
    medians = np.asarray(variables['params']['entropy_bottleneck'][
        'quantiles'])[:, 0, 1]
    jsym = jm.apply(jv, jnp.asarray(x), jnp.asarray(medians),
                    method=JaxEntropyBottleneckLayer.encode_ops)['symbols']
    psym = pm.encode_ops(_nchw(x), torch.from_numpy(medians))['symbols']
    np.testing.assert_array_equal(psym.permute(NHWC).numpy(),
                                  np.asarray(jsym))
    _close(pm.decode_ops(psym, torch.from_numpy(medians)),
           jm.apply(jv, jsym, jnp.asarray(medians),
                    method=JaxEntropyBottleneckLayer.decode_ops), 0)


def test_chunked_likelihood_equals_the_whole(monkeypatch):
    """The likelihood of a large feature is checkpointed in channel chunks
    when a gradient is wanted: the same likelihoods and gradients up to
    the rounding of the batched products (rtol 1e-5)."""
    from sc2bench_tpu_torch.ops.entropy import factorized
    torch.manual_seed(0)
    eb = factorized.EntropyBottleneck(10)
    x = torch.randn(3, 10, 6, 6) * 3

    def run():
        eb.zero_grad()
        xg = x.clone().requires_grad_(True)
        y, lik = eb(xg, mode='noise',
                    generator=torch.Generator().manual_seed(1))
        (torch.sum(y) - torch.sum(torch.log2(lik))).backward()
        return lik.detach(), xg.grad, {n: p.grad.clone() for n, p in
                                       eb.named_parameters()
                                       if p.grad is not None}

    whole = run()
    # 3 of the 10 channels a chunk: four chunks, the last one short
    monkeypatch.setattr(factorized, 'CHUNK_ELEMS', 3 * 3 * 2 * 3 * 36)
    chunked = run()
    torch.testing.assert_close(chunked[0], whole[0], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(chunked[1], whole[1], rtol=1e-5, atol=1e-5)
    assert chunked[2].keys() == whole[2].keys()
    for k, g in whole[2].items():
        torch.testing.assert_close(chunked[2][k], g, rtol=1e-5, atol=1e-5)


# ---- the runtime: module-level deploy ops on the host wire ---------------------

_RUNTIMES = {}


def _runtimes(split):
    if split not in _RUNTIMES:
        jm, variables, _ = _entropic(split)
        jrt = JaxRuntime(jm, jax.tree.map(jnp.asarray, variables))
        assert jrt.update()
        jrt.eval()
        prt = SplitClassifierRuntime(_port_entropic(split, variables),
                                     device='cpu')
        assert prt.update()
        prt.eval()
        _RUNTIMES[split] = (jrt, prt)
    return _RUNTIMES[split]


def _serve(rt, images, fn, **kw):
    rt.clear_analysis()
    rt.activate_analysis()
    out = fn(images, **kw) if fn is not None \
        else [rt(x) for x in images]
    sizes = list(rt.analyzers[0].file_size_list)
    summary = rt.summarize()
    rt.deactivate_analysis()
    return [np.asarray(o).reshape(1, -1) for o in out], sizes, summary


@pytest.mark.parametrize('split', ['layer1', 'avgpool'])
def test_runtime_symbols_and_host_wire_equal_jax(split):
    """Tables and symbols bit-equal, the host-coder strings byte-equal to
    the JAX runtime's `encode`, and the deploy forward's data size equal
    and logits within 2e-4 of JAX's and of the port's 'finetune'
    forward."""
    jrt, prt = _runtimes(split)
    for k in ('quantized_cdf', 'cdf_length', 'offset', 'medians'):
        np.testing.assert_array_equal(getattr(prt.codec.tables, k),
                                      getattr(jrt.codec.tables, k))
    images = [_images(10 + i) for i in range(3)]
    for x in images:
        jsym = jrt.module.apply(
            jrt.variables, jnp.asarray(x), jrt._medians_dev,
            method=lambda m, x, med: m.encode_ops(x, med))['symbols']
        psym = prt.module.encode_ops(_nchw(x), prt._medians)['symbols']
        np.testing.assert_array_equal(psym.permute(NHWC).numpy(),
                                      np.asarray(jsym))
        assert prt.encode(_nchw(x)) == jrt.encode(jnp.asarray(x))
    j_logits, j_sizes, j_summary = _serve(
        jrt, [jnp.asarray(x) for x in images], None)
    p_logits, p_sizes, p_summary = _serve(
        prt, [_nchw(x) for x in images], None)
    assert p_sizes == j_sizes and p_summary == j_summary
    for a, b, x in zip(j_logits, p_logits, images):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)
        with torch.no_grad():
            ft = prt.module(_nchw(x), mode='finetune').numpy()
        np.testing.assert_allclose(b, ft, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('split', ['layer1', 'avgpool'])
def test_stream_deploy_equals_jax(split):
    """The cyclic int16 host wire: per-image sizes and the summary equal,
    logits within 2e-4."""
    jrt, prt = _runtimes(split)
    images = [_images(20 + i) for i in range(3)]
    j_logits, j_sizes, j_summary = _serve(
        jrt, [jnp.asarray(x) for x in images], jrt.stream_deploy, depth=2,
        workers=1)
    p_logits, p_sizes, p_summary = _serve(
        prt, [_nchw(x) for x in images], prt.stream_deploy, depth=2)
    assert p_sizes == j_sizes and p_summary == j_summary
    for a, b in zip(j_logits, p_logits):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('split', ['layer1', 'avgpool'])
def test_device_wire_and_decode_batch_raise_as_in_jax(split):
    jrt, prt = _runtimes(split)
    x = _images(30)
    for jax_call, port_call in (
            (lambda: jrt.stream_deploy_device([jnp.asarray(x)]),
             lambda: prt.stream_deploy_device([_nchw(x)])),
            (lambda: jrt.stream_deploy([jnp.asarray(x)], decode_batch=2),
             lambda: prt.stream_deploy([_nchw(x)], decode_batch=2))):
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert ('device-rANS' in str(got.value)) \
            == ('device-rANS' in str(want.value))
    with pytest.raises(ValueError, match='device-rANS wire supports the '
                       'splittable bottleneck runtimes'):
        prt.encode_device_wire(_nchw(x))
    assert prt.get_aux_module() is jrt.get_aux_module() is None
    wrapped = wrap_model({'key': 'EntropicClassifier'}, prt.module,
                         device='cpu')
    assert wrapped._module_level_ops and wrapped.update()


# ---- CR+BQ: larger_resnet_bottleneck, quantizers, SplitClassifier ---------------

@pytest.fixture(scope='module')
def bq_models():
    jm = _jax_bq_student()
    variables = _jax_variables(jm, np.random.default_rng(5), mode='train')
    return jm, variables, _port_bq_student(variables)


@torch.no_grad()
def test_larger_resnet_bottleneck_equals_jax(bq_models):
    """Latent, decoded feature, captured intermediates and logits within
    1e-5; at 224 px the latent is 28x28 and the 2x2/2 ConvTranspose takes
    the decoder back to 56x56 x 256."""
    jm, variables, pm = bq_models
    x = _images(6, n=2)
    jv = jax.tree.map(jnp.asarray, variables)
    jz = jm.apply(jv, jnp.asarray(x),
                  method=lambda m, x: m.bottleneck_layer.encode_latent(x))
    pz = pm.bottleneck_layer.encode_latent(_nchw(x))
    assert tuple(pz.shape) == (2, BQ_CH, HW // 8, HW // 8)
    _close(pz, jz, 1e-5)
    jd = jm.apply(jv, jz,
                  method=lambda m, z: m.bottleneck_layer.decode_latent(z))
    _close(pm.bottleneck_layer.decode_latent(_nchw(np.asarray(jz))), jd,
           1e-5)
    jout, state = jm.apply(jv, jnp.asarray(x), mode='train',
                           mutable=['intermediates'])
    io = {}
    _close(pm(_nchw(x), io=io), jout, 1e-5)
    want = state['intermediates']
    for key, ref in (('bottleneck_layer.bottleneck_out',
                      want['bottleneck_layer']['bottleneck_out'][0]),
                     ('bottleneck_layer_out', want['bottleneck_layer_out'][0]),
                     ('layer4_out', want['layer4_out'][0])):
        _close(io[key], ref, 1e-5)
    full = splittable_resnet({'key': 'larger_resnet_bottleneck',
                              'kwargs': {'bottleneck_channel': 12}},
                             stage_sizes=STAGES, num_classes=CLASSES,
                             device='cpu').eval()
    z = full.bottleneck_layer.encode_latent(torch.zeros(1, 3, 224, 224))
    assert tuple(z.shape) == (1, 12, 28, 28)
    assert tuple(full.bottleneck_layer.decode_latent(z).shape) \
        == (1, 256, 56, 56)


@pytest.mark.parametrize('num_bits', [8, 16, 4])
def test_quantizers_equal_jax(num_bits):
    """`SimpleQuantizer`/`SimpleDequantizer` (and `quantize_tensor`) give
    bit-equal objects of the same types, so the pickled sizes are equal."""
    z = np.random.default_rng(num_bits).normal(0.3, 2, (1, 12, 28, 28)) \
        .astype(np.float32)
    got = port_misc.SimpleQuantizer(num_bits)(z)
    want = jax_misc.SimpleQuantizer(num_bits)(z)
    if num_bits == 16:
        assert got.dtype == want.dtype == np.float16
        np.testing.assert_array_equal(got, want)
    else:
        assert got.keys() == want.keys()
        for k in got:
            assert type(got[k]) is type(want[k]), k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got['tensor'].dtype == want['tensor'].dtype
        np.testing.assert_array_equal(
            port_misc.dequantize_tensor(port_misc.quantize_tensor(z, 8)),
            jax_misc.dequantize_tensor(jax_misc.quantize_tensor(z, 8)))
    assert pickle.dumps(got) == pickle.dumps(want)
    assert get_binary_object_size(got) > 0
    back = port_misc.SimpleDequantizer(num_bits)(got)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(
        back, np.asarray(jax_misc.SimpleDequantizer(num_bits)(want)))


def test_split_classifier_equals_jax(bq_models):
    """The JAX package's SplitClassifier case (bottleneck 3, stages
    (1, 1, 1, 1), 10 classes, a 64 px normal image) through 8-bit
    quantization: the quantized object and its size equal, logits within
    1e-4."""
    jm, variables, pm = bq_models
    jw = JaxSplitClassifier(jm, jax.tree.map(jnp.asarray, variables),
                            compressor=QUANTIZER, decompressor=DEQUANTIZER)
    pw = wrap_model({'key': 'SplitClassifier',
                     'kwargs': {'compressor': QUANTIZER,
                                'decompressor': DEQUANTIZER}},
                    pm, device='cpu')
    assert isinstance(pw, SplitClassifier) and pw.codec is None
    assert not pw.update() and not pw.bottleneck_updated
    x = np.asarray(jax.random.normal(jax.random.key(2), (1, HW, HW, 3)))
    objects = []
    for w in (jw, pw):
        w.eval()
        w.activate_analysis()
        inner = w.compressor
        w.compressor = lambda z, inner=inner: objects.append(inner(z)) \
            or objects[-1]
    jl = jw(jnp.asarray(x))
    pl = pw(_nchw(x))
    assert pw.summarize() == jw.summarize()
    assert pw.summarize()[0]['num_samples'] == 1
    jq, pq = objects
    # the latent's float noise may move its extremes by an ulp: the scale
    # with them, and a value on a rounding edge by one level
    assert pq['zero_point'] == jq['zero_point']
    np.testing.assert_allclose(pq['scale'], jq['scale'], rtol=1e-6)
    levels = np.abs(pq['tensor'].transpose(NHWC).astype(np.int32)
                    - jq['tensor'].astype(np.int32))
    assert levels.max() <= 1 and levels.mean() < 1e-2
    _close(pl, jl, 1e-4)
    pw.train()          # the runtime's 'train' forward, as JAX's
    with torch.no_grad():
        _close(pw(_nchw(x)), pm(_nchw(x), mode='train'), 1e-6)


# ---- one training step of each family ------------------------------------------

def _jax_steps(box, batches):
    """The JAX box's steps on `batches`; returns the metrics of each,
    the gradient trees taken from inside the optimizer, and the final
    variables."""
    grads = []
    inner = box.tx

    def update(g, state, params=None):
        jax.debug.callback(lambda gg: grads.append(
            jax.tree.map(np.asarray, gg)), g)
        return inner.update(g, state, params)

    box.tx = optax.GradientTransformation(inner.init, update)
    metrics = []
    for x, y in batches:
        metrics.append(jax.tree.map(np.asarray, box.train_step(
            jnp.asarray(x), jnp.asarray(y), jax.random.key(0))))
        jax.effects_barrier()
    return metrics, grads, jax.tree.map(np.asarray, box.student_variables)


def _check_steps(j_out, p_metrics, box, lr, grad_atol=1e-5, vanishing=()):
    """Losses rtol 1e-4; the gradient of the main update (the mean of the
    accumulated ones) rtol 1e-3, atol `grad_atol` of its largest
    magnitude; parameters rtol 1e-4 where Adam's update sign is sure, else
    within 2 lr; statistics rtol 1e-4; frozen parameters unchanged and
    without a gradient on both sides. A parameter whose name ends with
    one of `vanishing` has no gradient by construction (a bias before a
    BatchNorm that trains on the batch): its gradient on both sides must
    be zero up to rounding, within `grad_atol` of the step's largest
    gradient, where an elementwise comparison would compare rounding."""
    student = box.student
    j_metrics, j_grads, j_vars = j_out
    for jm, pm in zip(j_metrics, p_metrics):
        assert pm['loss'].keys() == jm['loss'].keys()
        for k, v in jm['loss'].items():
            np.testing.assert_allclose(float(pm['loss'][k]), float(v),
                                       rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(pm['aux_loss']),
                                   float(jm['aux_loss']), rtol=1e-4,
                                   atol=1e-6)
    mean = jax.tree.map(lambda *g: np.mean(g, axis=0), *j_grads)
    g_ref = state_dict_from_flax({'params': mean}, student)
    state = student.state_dict()
    want = state_dict_from_flax(j_vars, student)
    assert state.keys() == want.keys()
    params = dict(student.named_parameters())
    largest = max(float(np.abs(g.numpy()).max()) for g in g_ref.values())
    for name, v in want.items():
        got, v = state[name].numpy(), v.numpy()
        if name not in params or name.endswith('quantiles'):
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            continue
        ref = g_ref[name].numpy()
        if box.optim.labels[name] == 'frozen':
            assert params[name].grad is None and not ref.any(), name
            np.testing.assert_array_equal(got, v, err_msg=name)
            continue
        g = params[name].grad.numpy()
        if name.endswith(tuple(vanishing)):
            assert max(np.abs(g).max(), np.abs(ref).max()) \
                <= grad_atol * largest, name
        else:
            np.testing.assert_allclose(
                g, ref, rtol=1e-3, atol=grad_atol * float(np.abs(ref).max()),
                err_msg=name)
        sure = np.abs(ref) > 1e-3 * float(np.abs(ref).max())
        np.testing.assert_allclose(got[sure], v[sure], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        assert np.all(np.abs(got - v)[~sure] <= 2 * lr + 1e-5), name


def test_finetuning_step_equals_jax(same_noise):
    """The fine-tuning recipe's stage (CE + beta * bpp on the top-level
    `eb_out`, Adam, `grad_accum_step: 2`, `train_bn: false`), two
    micro-steps and so one update, at the layer1 split, in the 'train'
    mode."""
    stage_cfg = jax_train_stage_configs(jax_load_config(FT_CONFIG)['train'])[0]
    assert stage_cfg['grad_accum_step'] == 2 and not stage_cfg['train_bn']
    jm, variables, _ = _entropic('layer1')
    rng = np.random.default_rng(8)
    batches = [(_images(40 + i, n=2), rng.integers(0, CLASSES, 2))
               for i in range(2)]
    jbox = JaxTrainingBox(jm, jax.tree.map(jnp.asarray, variables),
                          stage_cfg, steps_per_epoch=4, student_mode='train')
    j_out = _jax_steps(jbox, batches)
    student = _port_entropic('layer1', variables)
    box = TrainingBox(student, stage_cfg, steps_per_epoch=4,
                      student_mode='train', generator=torch.Generator())
    p_metrics = [box.train_step(_nchw(x), torch.from_numpy(y))
                 for x, y in batches]
    assert {'ce', 'bpp'} == set(p_metrics[0]['loss'])
    assert box.optim.count == 1
    _check_steps(j_out, p_metrics, box,
                 lr=float(stage_cfg['optimizer']['kwargs']['lr']))


def test_ghnd_stage1_step_equals_jax():
    """The CR+BQ recipe's stage 1: the four hint MSE terms (the
    bottleneck's output against the teacher's layer1, layer2-4 against
    the teacher's), Adam, layer2-4 frozen, BatchNorm on running
    statistics; the teacher does not change. `frozen_modules` matches
    Flax path segments, so the JAX package also freezes the bottleneck's
    `LayerSeq` entries named layer2-4 that hold parameters (encoder BN 4,
    decoder conv 2 and BN 3); the port labels them as it does."""
    cfg = jax_load_config(BQ_CONFIG, _bq_over())
    stage_cfg = cfg['train']['stage1']
    js = jax_load_model(cfg['models']['student_model'])
    jt = jax_load_model(cfg['models']['teacher_model'])
    rng = np.random.default_rng(4)
    variables = _jax_variables(js, rng, mode='train')
    t_vars = _jax_variables(jt, rng, train=False)
    x, y = _images(50, n=2), np.array([1, 3])
    jbox = JaxDistillationBox(
        js, jax.tree.map(jnp.asarray, variables), stage_cfg,
        teacher_module=jt, teacher_variables=jax.tree.map(jnp.asarray,
                                                          t_vars),
        steps_per_epoch=4, student_mode='train')
    j_out = _jax_steps(jbox, [(x, y)])
    student = load_classification_model(cfg['models']['student_model'],
                                        device='cpu')
    student.load_state_dict(state_dict_from_flax(variables, student))
    teacher = load_classification_model(cfg['models']['teacher_model'],
                                        device='cpu')
    teacher.load_state_dict(state_dict_from_flax(t_vars))
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    box = DistillationBox(student, stage_cfg, teacher=teacher,
                          steps_per_epoch=4, student_mode='train',
                          generator=torch.Generator())
    metrics = box.train_step(_nchw(x), torch.from_numpy(y))
    assert set(metrics['loss']) == {'hint1', 'hint2', 'hint3', 'hint4'}
    labels = box.optim.labels
    assert {n for n, v in labels.items() if v == 'frozen'} == {
        n for n in labels if n.split('.')[0] in ('layer2', 'layer3', 'layer4')
        or re.match(r'bottleneck_layer\.(encoder\.4|decoder\.[23])\.', n)}
    _check_steps(j_out, [metrics], box,
                 lr=float(stage_cfg['optimizer']['kwargs']['lr']))
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---- the CLI's test() on both families ------------------------------------------

def _bq_over():
    small = {'stage_sizes': list(STAGES), 'num_classes': CLASSES}
    return {'allow_missing_teacher': True, 'models': {
        'teacher_model': {'key': 'resnet', 'kwargs': small},
        'student_model': {'kwargs': {**small, 'bottleneck_config': {
            'key': 'larger_resnet_bottleneck',
            'kwargs': {'bottleneck_channel': BQ_CH}}}}}}


def _ft_over():
    return {'models': {'model': {'kwargs': {'base_name': SMALL_RESNET,
                                            'num_classes': CLASSES}}}}


@pytest.fixture
def small_resnet(monkeypatch):
    """A (1, 1, 1, 1) ResNet under the name `resnet_small` in both
    packages' builder tables, for `entropic_classifier`'s `base_name`."""
    monkeypatch.setitem(
        jax_resnet_module.RESNET_BUILDERS, SMALL_RESNET,
        lambda **kw: JaxResNet(stage_sizes=STAGES, **kw))
    monkeypatch.setitem(
        port_resnet_module.RESNET_BUILDERS, SMALL_RESNET,
        lambda **kw: ResNet(STAGES, **kw))


def _with_ckpts(config, over, tmp_path, roles):
    """`over` with each role's randomized Flax variables saved as its
    ckpt, and a test loader of 5 synthetic 64 px images."""
    cfg = jax_load_config(config, over)
    rng = np.random.default_rng(12)
    for role in roles:
        module = jax_load_model(cfg['models'][role])
        kw = {'train': False} if role == 'teacher_model' else {'mode': 'train'}
        path = str(tmp_path / f'{role}.ckpt')
        jax_save_ckpt(path, _jax_variables(module, rng, **kw))
        over['models'][role]['ckpt'] = path
    over['test'] = {'test_data_loader': {'dataset': {
        'key': 'SyntheticClassificationDataset',
        'kwargs': {'num_samples': 5, 'image_size': [HW, HW],
                   'num_classes': CLASSES}}, 'batch_size': 1}}
    return over


def _jax_engine(config, over):
    return JaxEngine(jax_load_config(config, over), image_size=(HW, HW),
                     mesh=None)


@pytest.mark.parametrize('family', ['fine-tuning', 'ghnd-bq'])
def test_cli_test_equals_jax_engine(family, small_resnet, tmp_path):
    """`-test_only` on a small config of each family from the same Flax
    checkpoints: acc1, acc5 and the data-size summaries equal the JAX
    engine's. The fine-tuning model codes every image on the host wire;
    the CR+BQ student has no codec and is scored with the plain forward,
    nothing accounted, the top-level `wrapper:` key ignored as in JAX."""
    if family == 'fine-tuning':
        config, over = FT_CONFIG, _with_ckpts(FT_CONFIG, _ft_over(),
                                              tmp_path, ['model'])
    else:
        config, over = BQ_CONFIG, _with_ckpts(
            BQ_CONFIG, _bq_over(), tmp_path,
            ['teacher_model', 'student_model'])
    want, want_summaries = _jax_engine(config, over).test()
    out = main(['--config', config, '--json', json.dumps(over),
                '-test_only', '-student_only', '--device', 'cpu'])
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
    n = want_summaries[0]['num_samples']
    assert n == (5 if family == 'fine-tuning' else 0)
    rt = out['engine'].runtime
    assert rt.bottleneck_updated == (family == 'fine-tuning')


def test_deploy_wire_device_raises_on_a_finetuning_config(small_resnet,
                                                          tmp_path):
    over = {**_with_ckpts(FT_CONFIG, _ft_over(), tmp_path, ['model']),
            'deploy_wire': 'device'}
    with pytest.raises(ValueError) as want:
        _jax_engine(FT_CONFIG, over).test()
    with pytest.raises(ValueError) as got:
        main(['--config', FT_CONFIG, '--json', json.dumps(over),
              '-test_only', '--device', 'cpu'])
    assert str(got.value) == str(want.value)


# ---- every config of both families builds ----------------------------------------

@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: p.stem)
def test_config_builds_in_the_port(path):
    """`load_classification_model` on the config's student (shapes only,
    on the meta device): the fine-tuning split with its entropy
    bottleneck's channels, the CR+BQ bottleneck with its latent channels,
    and the runtime branch each takes."""
    cfg = load_config(path)
    jcfg = jax_load_config(path)
    models = cfg['models']
    spec = models.get('student_model', models.get('model'))
    with torch.device('meta'):
        model = load_classification_model(spec, device='meta')
        rt = SplitClassifierRuntime(model, device='meta')
    jm = jax_load_model(jcfg['models'].get('student_model',
                                           jcfg['models'].get('model')))
    if spec['key'] == 'entropic_classifier':
        split = spec['kwargs']['split_layer']
        assert model.split_layer == jm.split_layer == split
        assert model.entropy_bottleneck.quantiles.shape[0] \
            == SPLIT_CHANNELS[split]
        assert rt._module_level_ops and rt.codec is not None
    else:
        bch = spec['kwargs']['bottleneck_config']['kwargs'][
            'bottleneck_channel']
        assert model.bottleneck_layer.encoder.out_channels == bch
        assert jm.bottleneck_layer.encoder_specs[-1][1] == bch
        assert rt.codec is None and cfg.get('wrapper', {}).get('key') \
            == 'SplitClassifier'
    assert sum(p.numel() for p in model.parameters()) > 2e7
