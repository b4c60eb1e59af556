"""The RegNetY and hybrid-ViT Entropic Students (FP and MSHP with the
configs' channel options) on their wires, against the JAX package on the
CPU.

Sizes as `test_torch_port_backbones.py` (RegNet stages 48/64/80, hybrid
ViT embed 64, depth 2; bottleneck encoder [3, 16, 16, 16], MSHP latent 4;
10 classes, 64 px). One set of randomized Flax variables goes into both
packages (`state_dict_from_flax`); MSHP's h_s scales are spread as in
`test_torch_port_hyper.py`. Symbols (and MSHP's indexes and z symbols),
each side from its own encoder: the count of mismatches is held to 0 at
this size. The host wire's objects, and the device wire's packed streams
(the plain versions of the kernels), equal JAX's; `stream_deploy` and
`stream_deploy_device` (batch 1, `wire_batch=2`) give JAX's sizes, and
logits within 1e-4 (same symbols: only float sums differ).

The small models register under one name in both packages' registries
(`regnet_small`, `hybrid_vit_small`, their teachers, `efficientnet_small`;
`small_models`), which `test_torch_port_backbones_train.py` shares.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.ops.entropy.factorized as jax_factorized
import sc2bench_tpu.ops.entropy.gaussian as jax_gaussian
import sc2bench_tpu.registry as jax_registry
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.models import efficientnet as jeff
from sc2bench_tpu.models import hybrid_vit as jvit
from sc2bench_tpu.models import regnet as jreg
from sc2bench_tpu.models.layer import get_layer as jax_get_layer
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.models.runtime import SplitClassifierRuntime as JaxRuntime
import sc2bench_tpu_torch.ops.entropy.factorized as port_factorized
import sc2bench_tpu_torch.ops.entropy.gaussian as port_gaussian
import sc2bench_tpu_torch.registry as port_registry
from sc2bench_tpu_torch.models import efficientnet as peff
from sc2bench_tpu_torch.models import hybrid_vit as pvit
from sc2bench_tpu_torch.models import regnet as preg
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_port_backbones import (CLASSES, EFF_SMALL, HW, REG_DEC,
                                       REG_ENC, REG_SMALL, REG_TEACHER,
                                       VIT_DEC, VIT_ENC, VIT_SMALL,
                                       _variables)
from test_torch_port_hyper import _jax_noise, _port_noise
from test_torch_port_hyper import memoized_jax_tables  # noqa: F401
from test_torch_port_model import _nchw

REPO = Path(__file__).resolve().parents[1]
ES = REPO / 'configs/ilsvrc2012/supervised_compression/entropic_student'
REGNET_FP = ES / 'splitable_regnety6.4gf-fp-beta0.08_from_regnety6.4gf.yaml'
REGNET_MSHP = ES / ('splitable_regnety6.4gf-mshp-beta0.08_from_'
                     'regnety6.4gf.yaml')
LCH = 4
N_IMAGES = 2


# ---- the small models, under one name in both packages ----------------------

def _bottleneck_kwargs(key, enc, dec):
    if key.startswith('FP'):
        return {'num_bottleneck_channels': enc[-1],
                'encoder_channel_sizes': list(enc),
                'decoder_channel_sizes': list(dec)}
    return {'num_bottleneck_channels': enc[-1], 'num_latent_channels': LCH,
            'g_a_channel_sizes': list(enc), 'g_s_channel_sizes': list(dec)}


def _jax_builders():
    def student(module, small):
        def build(bottleneck_config, num_classes=CLASSES, **kwargs):
            bneck = jax_get_layer(bottleneck_config['key'],
                                  **bottleneck_config.get('kwargs', {}))
            return module(bottleneck_layer=bneck,
                          **{**small, 'num_classes': num_classes})
        return build

    return {
        'regnet_small': student(jreg.SplittableRegNet, REG_SMALL),
        'regnet_teacher_small': lambda num_classes=CLASSES, **kw:
            jreg.RegNet(**{**REG_TEACHER, 'num_classes': num_classes}),
        'hybrid_vit_small': student(jvit.SplittableHybridViT, VIT_SMALL),
        'hybrid_vit_teacher_small': lambda num_classes=CLASSES, **kw:
            jvit.HybridViT(**{**VIT_SMALL, 'num_classes': num_classes}),
        'efficientnet_small': lambda num_classes=CLASSES, **kw:
            jeff.EfficientNet(**{**EFF_SMALL, 'num_classes': num_classes}),
    }


def _port_builders():
    def regnet(bottleneck_config, num_classes=CLASSES, device=None, **kw):
        bneck = get_layer(bottleneck_config['key'],
                          **bottleneck_config.get('kwargs', {}))
        return preg.SplittableRegNet(
            bneck, **{**REG_SMALL, 'num_classes': num_classes}).to(device)

    def vit(bottleneck_config, num_classes=CLASSES, image_size=224,
            device=None, **kw):
        bneck = get_layer(bottleneck_config['key'],
                          **bottleneck_config.get('kwargs', {}))
        return pvit.SplittableHybridViT(
            bneck, image_size=image_size,
            **{**VIT_SMALL, 'num_classes': num_classes}).to(device)

    return {
        'regnet_small': regnet,
        'regnet_teacher_small': lambda num_classes=CLASSES, device=None, **kw:
            preg.RegNet(**{**REG_TEACHER,
                           'num_classes': num_classes}).to(device),
        'hybrid_vit_small': vit,
        'hybrid_vit_teacher_small': lambda num_classes=CLASSES,
            image_size=224, device=None, **kw: pvit.HybridViT(
                image_size=image_size,
                **{**VIT_SMALL, 'num_classes': num_classes}).to(device),
        'efficientnet_small': lambda num_classes=CLASSES, device=None, **kw:
            peff.EfficientNet(**{**EFF_SMALL,
                                 'num_classes': num_classes}).to(device),
    }


@pytest.fixture
def small_models(monkeypatch):
    for registry, builders in ((jax_registry, _jax_builders()),
                               (port_registry, _port_builders())):
        for name, fn in builders.items():
            monkeypatch.setitem(registry._registry('model'), name, fn)


def _same_noise(mp):
    """The same numpy noise, per shape, in both packages' factorized and
    Gaussian quantizers."""
    for module in (jax_factorized, jax_gaussian):
        mp.setattr(module, 'quantize_noise', _jax_noise)
    for module in (port_factorized, port_gaussian):
        mp.setattr(module, 'quantize_noise', _port_noise)


@pytest.fixture
def same_noise(monkeypatch):
    _same_noise(monkeypatch)


def _student_over(config, family):
    """`--json` override of a student config: the small student and
    teacher of `family` with the small bottleneck of the config's kind."""
    key = jax_load_config(config)['models']['student_model']['kwargs'][
        'bottleneck_config']['key']
    enc, dec = (REG_ENC, REG_DEC) if family == 'regnet' \
        else (VIT_ENC, VIT_DEC)
    small = {'num_classes': CLASSES}
    return {'allow_missing_teacher': True, 'image_size': [HW, HW],
            'models': {
                'teacher_model': {'key': f'{family}_teacher_small',
                                  'kwargs': small},
                'student_model': {'key': f'{family}_small', 'kwargs': {
                    **small, 'bottleneck_config': {
                        'key': key,
                        'kwargs': _bottleneck_kwargs(key, enc, dec)}}}}}


def _student_variables(module, rng, hyper):
    """Randomized variables of a student; an MSHP's h_s scale channels
    made positive and spread, as `test_torch_port_hyper._hyper_variables`
    does, so that the indexes cover many rows and y stays in support."""
    variables = _variables(module, np.zeros((1, HW, HW, 3), np.float32),
                           int(rng.integers(1 << 30)), mode='train')
    if hyper:
        bn = variables['params']['bottleneck_layer']
        kernel = bn['h_s_conv2']['kernel']
        bch = bn['g_a_conv2']['kernel'].shape[-1]
        kernel[..., :bch] = np.abs(kernel[..., :bch]) * 3.0
    return variables


# ---- the wires --------------------------------------------------------------

WIRE_CASES = ['regnet-fp', 'regnet-mshp', 'hybrid_vit-fp', 'hybrid_vit-mshp']


@pytest.fixture(scope='module')
def wire_runtimes():
    """Per case: (JAX runtime, port runtime, images), tables built, from
    one set of randomized variables; built once for the module."""
    built = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in _jax_builders().items():
            mp.setitem(jax_registry._registry('model'), name, fn)
        for name, fn in _port_builders().items():
            mp.setitem(port_registry._registry('model'), name, fn)

        def get(case):
            if case not in built:
                family, kind = case.split('-')
                config = REGNET_FP if kind == 'fp' else REGNET_MSHP
                spec = jax_load_config(config, _student_over(
                    config, family))['models']['student_model']
                jm = jax_load_model(spec)
                variables = _student_variables(
                    jm, np.random.default_rng(31), kind == 'mshp')
                jrt = JaxRuntime(jm, jax.tree.map(jnp.asarray, variables))
                assert jrt.update()
                jrt.eval()
                pm = load_classification_model(
                    spec, device='cpu', image_size=(HW, HW))
                pm.load_state_dict(state_dict_from_flax(variables),
                                   strict=True)
                prt = SplitClassifierRuntime(pm, device='cpu')
                assert prt.update()
                prt.eval()
                rng = np.random.default_rng(32)
                images = [rng.normal(0, 0.5, (1, HW, HW, 3)).astype(
                    np.float32) for _ in range(N_IMAGES)]
                built[case] = (jm, variables, jrt, prt, images)
            return built[case]

        yield get


def _jax_symbols(jm, variables, jrt, x, prt):
    """The JAX encoder's symbols (and MSHP's indexes), NCHW int32."""
    bneck_ops = (lambda m, x, *a: m.bottleneck_layer.encode_ops(x, *a))
    if prt.hyper:
        args = (jnp.asarray(prt._medians.numpy()),
                jnp.asarray(prt._scale_table.numpy()))
    else:
        args = (jnp.asarray(prt._medians.numpy()),)
    ops = jm.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x),
                   *args, method=bneck_ops)
    return {k: torch.from_numpy(np.array(v).transpose(0, 3, 1, 2))
            for k, v in ops.items()}


@pytest.mark.parametrize('case', WIRE_CASES)
def test_symbols_and_wire_streams_equal_jax(wire_runtimes, case):
    jm, variables, jrt, prt, images = wire_runtimes(case)
    for x in images:
        want = _jax_symbols(jm, variables, jrt, x, prt)
        with torch.no_grad():
            got = prt._hyper_ops(_nchw(x)) if prt.hyper else \
                prt._bneck.encode_ops(_nchw(x), prt._medians)
        assert got.keys() == want.keys()
        # each side's own encoder: symbols a float ulp from a rounding
        # edge could differ; none may at this size
        mismatches = sum(int((got[k] != want[k]).sum()) for k in got)
        assert mismatches == 0
        assert prt.encode(_nchw(x)) == jrt.encode(jnp.asarray(x))
        if prt.hyper:
            j_ops = jrt.encode_device_wire_hyper(jnp.asarray(x))
            p_ops = prt.encode_device_wire_hyper(_nchw(x))
            assert prt._pull_device_wire(p_ops) == \
                jrt._pull_device_wire(j_ops['z']) \
                + jrt._pull_device_wire(j_ops['y'])
        else:
            j_ops = jrt.encode_device_wire(jnp.asarray(x))
            p_ops = prt.encode_device_wire(_nchw(x))
            assert prt._pull_device_wire(p_ops) == \
                jrt._pull_device_wire(j_ops)
        assert np.asarray(p_ops['meta']).tolist() == \
            np.asarray(j_ops['meta']).tolist()


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
    ('stream_deploy_device', {'wire_batch': 2})],
    ids=['host', 'device_batch1', 'device_wire_batch2'])
@pytest.mark.parametrize('case', WIRE_CASES)
def test_stream_deploy_equals_jax(wire_runtimes, case, fn, kw):
    """Sizes and summaries equal, logits after decoding within 1e-4, no
    image escapes."""
    _, _, jrt, prt, images = wire_runtimes(case)
    j_logits, j_sizes, j_summary = _serve(
        jrt, [jnp.asarray(x) for x in images], fn, depth=2, workers=1, **kw)
    prt.escapes = {'ok': 0, 'valid': 0}
    p_logits, p_sizes, p_summary = _serve(
        prt, [_nchw(x) for x in images], fn, depth=2, **kw)
    assert p_sizes == j_sizes
    assert p_summary == j_summary
    assert prt.escapes == {'ok': 0, 'valid': 0}
    for a, b in zip(j_logits, p_logits):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
