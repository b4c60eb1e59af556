"""The port's training path against the JAX package, on the CPU at a small
size (stages (1, 1, 1, 1), 64x64 images, 10 classes).

Both sides start from one set of Flax variables, randomized with numpy
(`state_dict_from_flax` carries them into the port). The training noise
is the same on both sides: `quantize_noise` is replaced, in the JAX
package's factorized module and in the port's, by the addition of one
fixed seeded numpy array per shape, made NHWC and transposed to NCHW for
the port.

Units: the bounds and their gradients, GDN's gradients, the entropy
bottleneck's likelihoods and aux loss with their gradients, the FP
bottleneck's 'train' forward, every loss (rtol 1e-5), BatchNorm's running
statistics, the parameter labels, and every optimizer and schedule fed
one gradient sequence (optax, rtol 1e-6 over 6 steps). One step of each
box (losses rtol 1e-4; gradients rtol 1e-3 with atol 1e-5 max|g|;
parameters and BatchNorm statistics rtol 1e-4): the distillation box's
are the first steps of the end-to-end run's two stages. End to end, the
port CLI's train-then-test run against the JAX engine's `train()` +
`test()` on `configs/sample/tiny_entropic_student.yaml`, on both
wires."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
import logging
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.ops.entropy.factorized as jax_factorized
import sc2bench_tpu.train.engine as jax_engine_module
from sc2bench_tpu import loss as jax_loss
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.config import \
    train_stage_configs as jax_train_stage_configs
from sc2bench_tpu.models.layer import FPBasedResNetBottleneck as JaxFP
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.models.resnet import ResNet as JaxResNet
from sc2bench_tpu.ops import math as jax_math
from sc2bench_tpu.ops.gdn import GDN1 as JaxGDN
from sc2bench_tpu.train.box import DistillationBox as JaxDistillationBox
from sc2bench_tpu.train.box import TrainingBox as JaxTrainingBox
from sc2bench_tpu.train.engine import ClassificationEngine as JaxEngine
from sc2bench_tpu.train.optim import build_multi_optimizer
from sc2bench_tpu.train.optim import label_params as jax_label_params
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
from sc2bench_tpu.utils.torch_convert import (SPLITTABLE_RESNET_RULES,
                                              convert_state_dict)
import sc2bench_tpu_torch.ops.entropy.factorized as port_factorized
import sc2bench_tpu_torch.train.engine as port_engine_module
from sc2bench_tpu_torch import loss as port_loss
from sc2bench_tpu_torch.config import load_config, train_stage_configs
from sc2bench_tpu_torch.models.backbone import resnet_builder
from sc2bench_tpu_torch.models.layer import FPBasedResNetBottleneck
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.ops import math as port_math
from sc2bench_tpu_torch.ops.gdn import GDN1
from sc2bench_tpu_torch.tasks.image_classification import main
from sc2bench_tpu_torch.train.box import DistillationBox, TrainingBox
from sc2bench_tpu_torch.train.engine import (ClassificationEngine,
                                             MetricAccumulator,
                                             scale_stage_lrs)
from sc2bench_tpu_torch.train.optim import StageOptimizer, label_params
from sc2bench_tpu_torch.utils.ckpt import load_train_state
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from sc2bench_tpu_torch.utils.metrics import MetricLogger
from test_torch_port_model import CLASSES, HW, STAGES, _nchw, _randomize

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / 'configs/sample/tiny_entropic_student.yaml')
FLAGSHIP = str(REPO / 'configs/ilsvrc2012/supervised_compression/'
               'entropic_student/'
               'splitable_resnet50-fp-beta0.16_from_resnet50.yaml')
END_TO_END = str(REPO / 'configs/ilsvrc2012/supervised_compression/'
                 'end-to-end/splitable_resnet50-fp-beta1.024e-7.yaml')
SMALL = {'models': {
    'teacher_model': {'key': 'resnet',
                      'kwargs': {'stage_sizes': list(STAGES),
                                 'num_classes': CLASSES}},
    'student_model': {'kwargs': {'stage_sizes': list(STAGES),
                                 'num_classes': CLASSES}},
    'model': {'kwargs': {'stage_sizes': list(STAGES),
                         'num_classes': CLASSES}}}}
_NOISE: dict = {}


def _noise(shape_nhwc) -> np.ndarray:
    key = tuple(int(s) for s in shape_nhwc)
    if key not in _NOISE:
        _NOISE[key] = np.random.default_rng(5).uniform(
            -0.5, 0.5, key).astype(np.float32)
    return _NOISE[key]


def _jax_noise(x, rng):
    return x + jnp.asarray(_noise(x.shape))


def _port_noise(x, generator):
    n, c, h, w = x.shape
    return x + torch.from_numpy(np.ascontiguousarray(
        _noise((n, h, w, c)).transpose(0, 3, 1, 2))).to(x)


def _same_noise(mp):
    mp.setattr(jax_factorized, 'quantize_noise', _jax_noise)
    mp.setattr(port_factorized, 'quantize_noise', _port_noise)


@pytest.fixture
def same_noise(monkeypatch):
    _same_noise(monkeypatch)


def _flat(tree) -> dict:
    """{dotted path: numpy leaf} of a nested dict."""
    return {'.'.join(str(getattr(k, 'key', k)) for k in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_flax(named: dict) -> dict:
    """{torch name: tensor} in the Flax layout, flat by dotted path
    ('params.*' and 'batch_stats.*')."""
    return _flat(convert_state_dict(
        {k: v.detach().cpu().numpy() for k, v in named.items()},
        SPLITTABLE_RESNET_RULES))


# ---- math, GDN, entropy bottleneck ----------------------------------------

@pytest.mark.parametrize('name', ['lower_bound', 'upper_bound'])
def test_bounds_and_their_gradients_equal_jax(name):
    """Values and vector-Jacobian products below, at and above the bound,
    for gradients of both signs."""
    bound = 0.25
    x = np.array([-1.0, 0.0, 0.25, 0.25, 0.5, 2.0, 0.1, 0.3], np.float32)
    for g in (np.array([1, -1, 1, -1, 1, -1, -2, 3], np.float32),
              np.array([-1, 1, -1, 1, -1, 1, 2, -3], np.float32)):
        y, vjp = jax.vjp(lambda v: getattr(jax_math, name)(v, bound),
                         jnp.asarray(x))
        want = vjp(jnp.asarray(g))[0]
        xt = torch.from_numpy(x).requires_grad_(True)
        yt = getattr(port_math, name)(xt, bound)
        yt.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def test_quantizers_equal_jax():
    x = np.random.default_rng(0).normal(0, 3, (2, 5, 4, 3)).astype(
        np.float32)
    means = np.float32(0.3)
    xt = torch.from_numpy(x).requires_grad_(True)
    np.testing.assert_array_equal(
        port_math.quantize_dequantize(xt, means).detach().numpy(),
        np.asarray(jax_math.quantize_dequantize(jnp.asarray(x), means)))
    np.testing.assert_array_equal(
        port_math.quantize_symbols(xt, means).numpy(),
        np.asarray(jax_math.quantize_symbols(jnp.asarray(x), means)))
    port_math.ste_round(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))
    gen = torch.Generator().manual_seed(1)
    y = port_math.quantize_noise(xt.detach(), gen) - xt.detach()
    assert float(y.abs().max()) <= 0.5 and float(y.std()) > 0.2
    gen2 = torch.Generator().manual_seed(1)
    assert torch.equal(port_math.quantize_noise(xt.detach(), gen2),
                       y + xt.detach())


@pytest.mark.parametrize('inverse', [False, True], ids=['gdn', 'igdn'])
def test_gdn_gradients_equal_jax(inverse):
    """GDN's reparameterization trains through `lower_bound`: stored
    values below the bound get a gradient only where it pushes them up."""
    rng = np.random.default_rng(4)
    c = 6
    x = rng.normal(0, 1, (2, 5, 4, c)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    beta = rng.uniform(0.9, 1.1, c).astype(np.float32)
    gamma = np.sqrt(0.1 * np.eye(c) + rng.uniform(0, 0.01, (c, c)))
    gamma[rng.uniform(size=(c, c)) < 0.4] = 1e-3     # below 2**-9
    gamma = gamma.astype(np.float32)
    jg = JaxGDN(c, inverse=inverse)

    def jloss(params, xx):
        return jnp.sum(jg.apply({'params': params}, xx) * w)

    want = jax.grad(jloss, argnums=(0, 1))(
        {'beta': jnp.asarray(beta), 'gamma': jnp.asarray(gamma)},
        jnp.asarray(x))
    g = GDN1(c, inverse=inverse)
    with torch.no_grad():
        g.beta.copy_(torch.from_numpy(beta))
        g.gamma.copy_(torch.from_numpy(gamma))
    xt = _nchw(x).requires_grad_(True)
    (g(xt) * _nchw(w)).sum().backward()
    for got, ref in ((g.beta.grad, want[0]['beta']),
                     (g.gamma.grad, want[0]['gamma']),
                     (xt.grad.permute(0, 2, 3, 1), want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6)
    assert (np.asarray(want[0]['gamma'])[gamma < 2 ** -9] == 0).any()


def _eb_params(rng, c):
    shapes = jax.eval_shape(lambda: jax_factorized.EntropyBottleneck(
        channels=c).init(jax.random.key(0), jnp.zeros((1, 2, 2, c)),
                         mode='dequantize'))
    return _randomize(shapes['params'], rng)


def _load_eb(eb, params):
    with torch.no_grad():
        for k, v in params.items():
            name = k if k == 'quantiles' else '_' + k.replace('_', '')
            getattr(eb, name).copy_(torch.from_numpy(v))


@pytest.mark.parametrize('mode', ['noise', 'dequantize'])
def test_entropy_bottleneck_likelihoods_and_gradients_equal_jax(
        mode, same_noise):
    c = 5
    rng = np.random.default_rng(8)
    params = _eb_params(rng, c)
    x = rng.normal(0, 2, (2, 4, 3, c)).astype(np.float32)
    x[0, 0, 0] = 40.0                              # far in the tail
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    jeb = jax_factorized.EntropyBottleneck(channels=c)

    def jloss(p, xx):
        y_hat, lik = jeb.apply({'params': p}, xx, mode=mode,
                               rng=jax.random.key(0))
        return (jnp.sum(jnp.log2(lik)) + jnp.sum(y_hat * w),
                (y_hat, lik))

    (_, (jy, jlik)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    jaux, jaux_grads = jax.jit(jax.value_and_grad(
        lambda p: jeb.apply({'params': p}, method='aux_loss')))(
            jax.tree.map(jnp.asarray, params))

    eb = port_factorized.EntropyBottleneck(c)
    _load_eb(eb, params)
    xt = _nchw(x).requires_grad_(True)
    y_hat, lik = eb(xt, mode=mode, generator=torch.Generator())
    (torch.sum(torch.log2(lik)) + torch.sum(y_hat * _nchw(w))).backward()
    nhwc = (0, 2, 3, 1)
    np.testing.assert_allclose(y_hat.detach().permute(nhwc).numpy(),
                               np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lik.detach().permute(nhwc).numpy(),
                               np.asarray(jlik), rtol=1e-5, atol=1e-9)
    assert float(lik.detach().min()) == pytest.approx(1e-9)
    np.testing.assert_allclose(xt.grad.permute(nhwc).numpy(),
                               np.asarray(jgrads[1]), rtol=1e-4, atol=1e-5)
    for k, ref in jgrads[0].items():
        name = k if k == 'quantiles' else '_' + k.replace('_', '')
        got = getattr(eb, name).grad
        if k == 'quantiles':            # the medians are detached
            assert got is None and not np.asarray(ref).any()
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()),
                                   err_msg=k)
    eb.zero_grad(set_to_none=True)
    aux = eb.aux_loss()
    aux.backward()
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(eb.quantiles.grad.numpy(),
                               np.asarray(jaux_grads['quantiles']),
                               rtol=1e-6)
    assert all(p.grad is None for n, p in eb.named_parameters()
               if n != 'quantiles')


def test_fp_bottleneck_train_forward_equals_jax(same_noise):
    """The 'train' forward: decoder output and `eb_out` = (y_hat,
    likelihoods), and the gradients of a rate + distortion loss."""
    rng = np.random.default_rng(9)
    jm = JaxFP(num_bottleneck_channels=6, num_target_channels=16)
    shapes = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)), mode='train'))
    variables = _randomize({'params': shapes['params']}, rng)
    x = rng.normal(0, 1, (2, HW, HW, 3)).astype(np.float32)

    def jloss(params):
        out, state = jm.apply({'params': params}, jnp.asarray(x),
                              mode='train', mutable=['entropy'],
                              rngs={'noise': jax.random.key(0)})
        y_hat, lik = state['entropy']['eb_out'][0]
        return (jnp.sum(out ** 2) * 1e-3 - jnp.sum(jnp.log2(lik)),
                (out, y_hat, lik))

    (_, (jout, jy, jlik)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, variables['params']))
    pm = FPBasedResNetBottleneck(num_bottleneck_channels=6,
                                 num_target_channels=16)
    pm.load_state_dict({k.split('.', 1)[1]: v for k, v in
                        state_dict_from_flax({'params': {
                            'bottleneck_layer': variables['params']}}
                        ).items()})
    io = {}
    out = pm(_nchw(x), mode='train', generator=torch.Generator(), io=io)
    y_hat, lik = io['eb_out']
    (torch.sum(out ** 2) * 1e-3 - torch.sum(torch.log2(lik))).backward()
    nhwc = (0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().permute(nhwc).numpy(),
                               np.asarray(jout), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y_hat.detach().permute(nhwc).numpy(),
                               np.asarray(jy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lik.detach().permute(nhwc).numpy(),
                               np.asarray(jlik), rtol=1e-3, atol=1e-7)
    got = _to_flax({f'bottleneck_layer.{n}': p.grad
                    for n, p in pm.named_parameters()
                    if p.grad is not None})
    want = _flat({'params': {'bottleneck_layer': jgrads}})
    assert set(got) == {k for k, v in want.items()
                        if not k.endswith('quantiles')}
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-3,
                                   atol=1e-5 * float(np.abs(want[k]).max()),
                                   err_msg=k)
    with torch.no_grad():
        fine = pm(_nchw(x), mode='finetune')
    assert not fine.requires_grad
    with pytest.raises(ValueError, match='needs a torch.Generator'):
        pm(_nchw(x), mode='train')


# ---- losses ----------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(12)
    feat = rng.normal(0, 1, (2, 5, 4, 3)).astype(np.float32)
    lik = rng.uniform(1e-4, 1, feat.shape).astype(np.float32)
    a = rng.normal(0, 1, (2, 6, 5, 7)).astype(np.float32)
    b = rng.normal(0, 1, a.shape).astype(np.float32)
    s_logits = rng.normal(0, 2, (4, CLASSES)).astype(np.float32)
    t_logits = rng.normal(0, 2, (4, CLASSES)).astype(np.float32)
    t_logits[0, 3] = 90.0             # a teacher probability that is ~0
    labels = rng.integers(0, CLASSES, 4)
    seg = rng.normal(0, 1, (2, 6, 5, 4)).astype(np.float32)
    seg_aux = rng.normal(0, 1, seg.shape).astype(np.float32)
    seg_t = rng.integers(0, 4, (2, 6, 5))
    seg_t[0, :2] = 255
    jax_io = {'eb': (feat, lik), 'a': a, 'output': s_logits,
              'seg': seg, 'seg_aux': seg_aux}
    t_io = {'a': b, 'output': t_logits}

    def nchw(v):
        return torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))

    port_io = {'eb': (nchw(feat), nchw(lik)), 'a': nchw(a),
               'output': torch.from_numpy(s_logits), 'seg': nchw(seg),
               'seg_aux': nchw(seg_aux)}
    port_t = {'a': nchw(b), 'output': torch.from_numpy(t_logits)}
    return (jax_io, t_io, labels, seg_t), (port_io, port_t)


LOSSES = [('BppLoss', {'entropy_module_path': 'eb', 'reduction': r})
          for r in ('sum', 'batchmean', 'mean')] + [
    ('MSELoss', {'student_module_path': 'a', 'teacher_module_path': 'a',
                 'reduction': r}) for r in ('sum', 'batchmean', 'mean')] + [
    ('CrossEntropyLoss', {'module_path': 'output'}),
    ('CrossEntropyLoss', {'module_path': 'output', 'reduction': 'sum',
                          'label_smoothing': 0.1}),
    ('KDLoss', {'student_module_path': 'output',
                'teacher_module_path': 'output'}),
    ('KDLoss', {'student_module_path': 'output',
                'teacher_module_path': 'output', 'temperature': 4.0,
                'alpha': 0.9}),
    ('SegCrossEntropyLoss', {'module_path': 'seg'}),
    ('SegCrossEntropyLoss', {'module_path': 'seg',
                             'aux_module_path': 'seg_aux'}),
]


@pytest.mark.parametrize('key,kwargs', LOSSES,
                         ids=[f'{k}{i}' for i, (k, _) in enumerate(LOSSES)])
def test_loss_equals_jax(key, kwargs):
    (j_io, j_t, labels, seg_t), (p_io, p_t) = _loss_inputs()
    seg = key == 'SegCrossEntropyLoss'
    jy = jnp.asarray(seg_t if seg else labels)
    py = torch.from_numpy(seg_t if seg else labels)
    want = getattr(jax_loss, key)(**kwargs)(
        jax.tree.map(jnp.asarray, j_io), jax.tree.map(jnp.asarray, j_t), jy)
    got = getattr(port_loss, key)(**kwargs)(p_io, p_t, py)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_weighted_sum_criterion_equals_jax():
    (j_io, j_t, labels, _), (p_io, p_t) = _loss_inputs()
    cfg = {'key': 'WeightedSumLoss', 'kwargs': {'sub_terms': {
        'hint': {'criterion': {'key': 'MSELoss', 'kwargs': {
            'student_module_path': 'a', 'teacher_module_path': 'a'}},
            'weight': 0.5},
        'bpp': {'criterion': {'key': 'BppLoss', 'kwargs': {
            'entropy_module_path': 'eb', 'reduction': 'batchmean'}},
            'weight': 0.16}}}}
    kd = {'key': 'KDLoss', 'kwargs': {'student_module_path': 'output',
                                      'teacher_module_path': 'output'}}
    for c in (cfg, kd):
        want_total, want = jax_loss.build_criterion(c)(
            jax.tree.map(jnp.asarray, j_io),
            jax.tree.map(jnp.asarray, j_t), jnp.asarray(labels))
        total, detail = port_loss.build_criterion(c)(
            p_io, p_t, torch.from_numpy(labels))
        assert detail.keys() == want.keys()
        np.testing.assert_allclose(float(total), float(want_total),
                                   rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(float(detail[k]), float(want[k]),
                                       rtol=1e-5)


# ---- BatchNorm, labels, optimizers -----------------------------------------

def test_batchnorm_running_statistics_equal_flax():
    """One train-mode forward of the teacher ResNet (every stage, batch 2,
    so n/(n-1) is far from 1) updates the running statistics as Flax's
    BatchNorm does: biased batch variance, momentum 0.9 on the old value."""
    fm = JaxResNet(stage_sizes=STAGES, num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3)), train=False))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(6))
    x = np.random.default_rng(2).normal(0, 1, (2, HW, HW, 3)).astype(
        np.float32)
    out, state = jax.jit(lambda v, xx: fm.apply(
        v, xx, train=True, mutable=['batch_stats']))(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    pm = resnet_builder(stage_sizes=STAGES, num_classes=CLASSES,
                        device='cpu').train()
    pm.load_state_dict(state_dict_from_flax(variables))
    got = pm(_nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    stats = _to_flax(dict(pm.named_buffers()))
    want = _flat({'batch_stats': state['batch_stats']})
    assert want.keys() == {k for k in stats if k.startswith('batch_stats')}
    for k, v in want.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    before = _flat({'batch_stats': variables['batch_stats']})
    assert any(not np.allclose(before[k], v) for k, v in want.items())


def _stage_configs(path):
    return [c for k, c in sorted(jax_load_config(path)['train'].items())
            if k.startswith('stage')]


@pytest.mark.parametrize('path', [FLAGSHIP, TINY], ids=['flagship', 'tiny'])
def test_labels_equal_jax_name_by_name(path):
    """Every parameter of the config's student gets the JAX label of its
    Flax path in both stages ('aux' before 'frozen': the quantiles keep
    training in stage 2), and a module-wise group is matched too."""
    cfg = jax_load_config(path)['models']['student_model']
    jm = jax_load_model(cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), mode='train'))
    pm = load_classification_model(cfg, device='cpu')
    names = {n for n, _ in pm.named_parameters()}
    flat_shapes = _flat(jax.tree.map(lambda s: np.zeros(()),
                                     shapes['params']))
    module_wise = [{'module': 'fc', 'kwargs': {'lr': 0.1}}]
    for stage in _stage_configs(path):
        frozen = stage['frozen_modules']
        for mw in ((), module_wise):
            want = _flat(jax_label_params(shapes['params'], frozen, mw))
            got = label_params(pm, frozen, mw)
            assert got.keys() == names
            mapped = {flax_param_path(n): v for n, v in got.items()}
            assert mapped == want
            assert len(mapped) == len(flat_shapes)
            assert 'aux' in got.values() and 'frozen' in got.values()
            assert ('mw0' in got.values()) == (bool(mw)
                                               and 'fc' not in frozen)


class _TinyStudent(torch.nn.Module):
    """A bottleneck and a classifier under the flagship's names: enough
    parameters of every label for the optimizer tests."""

    def __init__(self):
        super().__init__()
        self.bottleneck_layer = FPBasedResNetBottleneck(
            num_bottleneck_channels=4, num_target_channels=8)
        self.fc = torch.nn.Linear(8, 3)


OPTIMIZERS = {
    'adam_multistep': ({'key': 'Adam', 'kwargs': {'lr': 1e-3}},
                       {'key': 'MultiStepLR',
                        'kwargs': {'milestones': [1, 2], 'gamma': 0.1}},
                       ['bottleneck_layer.enc_*'], 1),
    'sgd_momentum_wd': ({'key': 'SGD', 'kwargs': {
        'lr': 0.1, 'momentum': 0.9, 'weight_decay': 5e-4}},
        {'key': 'StepLR', 'kwargs': {'step_size': 1, 'gamma': 0.5}},
        ['bottleneck_layer.entropy_bottleneck'], 1),
    'sgd_cosine': ({'key': 'SGD', 'kwargs': {'lr': 0.1}},
                   {'key': 'CosineAnnealingLR', 'kwargs': {'T_max': 3}},
                   ['bottleneck_layer'], 1),
    'adamw_poly_module_wise': ({'key': 'AdamW', 'kwargs': {
        'lr': 1e-2, 'weight_decay': 1e-2},
        'module_wise_kwargs': [{'module': 'fc', 'kwargs': {'lr': 0.1}}]},
        {'key': 'poly', 'kwargs': {'power': 0.9}}, [], 1),
    'adam_grad_accum2': ({'key': 'Adam', 'kwargs': {
        'lr': 1e-2, 'weight_decay': 1e-3}},
        {'key': 'MultiStepLR', 'kwargs': {'milestones': [1]}},
        ['bottleneck_layer.dec_*'], 2),
}


@pytest.mark.parametrize('case', list(OPTIMIZERS))
def test_optimizer_and_schedule_equal_optax(case):
    """Six steps on one gradient sequence (2 steps an epoch, 3 epochs):
    the main optimizer with its per-step schedule, the aux Adam on the
    quantiles, frozen parameters unchanged, module-wise groups and
    `grad_accum_step` (the mean gradient every k micro-steps, the
    schedule counting applied updates, the aux Adam every micro-step)."""
    opt_cfg, sched_cfg, frozen, accum = OPTIMIZERS[case]
    torch.manual_seed(0)
    model = _TinyStudent()
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    so = StageOptimizer(model, opt_cfg, sched_cfg, frozen,
                        steps_per_epoch=2, num_epochs=3,
                        grad_accum_step=accum, aux_lr=1e-2)
    jparams = convert_state_dict({n: p.numpy() for n, p in params0.items()},
                                 SPLITTABLE_RESNET_RULES)['params']
    jparams = jax.tree.map(jnp.asarray, jparams)
    labels, tx = build_multi_optimizer(
        jparams, opt_cfg, sched_cfg, frozen, steps_per_epoch=2,
        num_epochs=3, grad_accum_step=accum, aux_lr=1e-2)

    @jax.jit
    def jstep(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    jstate = tx.init(jparams)
    rng = np.random.default_rng(1)
    applied = []
    for _ in range(6):
        grads = {n: torch.from_numpy(rng.normal(
            0, 1, tuple(p.shape)).astype(np.float32))
            for n, p in params0.items()}
        so.zero_grad()
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = grads[n].clone()
        applied.append(so.step())
        jg = convert_state_dict({n: g.numpy() for n, g in grads.items()},
                                SPLITTABLE_RESNET_RULES)['params']
        jparams, jstate = jstep(jparams, jstate,
                                jax.tree.map(jnp.asarray, jg))
    assert applied == [True] * 6 if accum == 1 else [False, True] * 3
    assert so.count == 6 // accum
    got = _to_flax(dict(model.named_parameters()))
    want = _flat({'params': jparams})
    assert got.keys() == want.keys()
    flat_labels = _flat({'params': labels})
    start = _to_flax(params0)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        moved = not np.array_equal(v, start[k])
        assert moved == (str(flat_labels[k]) != 'frozen'), k


# ---- one step of each box ---------------------------------------------------

def _jax_variables(module, rng, **init_kwargs):
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)), **init_kwargs))
    return _randomize({'params': shapes['params'],
                       'batch_stats': shapes['batch_stats']}, rng)


def _jax_box_step(box, x, y, step=None):
    """One jitted step of a JAX box (its `train_step`, or `step`), the
    first it takes; returns (metrics, gradients, new variables), the
    gradients taken from inside the optimizer."""
    grads = {}
    inner = box.tx

    def update(g, state, params=None):
        jax.debug.callback(lambda gg: grads.update(_flat(gg)), g)
        return inner.update(g, state, params)

    box.tx = optax.GradientTransformation(inner.init, update)
    metrics = (step or box.train_step)(jnp.asarray(x), jnp.asarray(y),
                                       jax.random.key(0))
    jax.block_until_ready(metrics)
    jax.effects_barrier()
    # a copy: the callback writes each later step's gradients too
    return (jax.tree.map(np.asarray, metrics), dict(grads),
            _flat(jax.tree.map(np.asarray, box.student_variables)))


def _check_step(jax_out, port_box, port_metrics, frozen_labels):
    j_metrics, j_grads, j_vars = jax_out
    assert port_metrics['loss'].keys() == j_metrics['loss'].keys()
    for k, v in j_metrics['loss'].items():
        np.testing.assert_allclose(float(port_metrics['loss'][k]), float(v),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(port_metrics['aux_loss']),
                               float(j_metrics['aux_loss']), rtol=1e-4)
    assert float(port_metrics['acc1']) == float(j_metrics['acc1'])
    student = port_box.student
    grads = _to_flax({n: p.grad for n, p in student.named_parameters()
                      if p.grad is not None})
    frozen = {k for k, v in frozen_labels.items() if v == 'frozen'}
    assert set(grads) == {f'params.{k}' for k in j_grads} \
        - {f'params.{k}' for k in frozen}
    for k in frozen:
        assert not j_grads[k].any(), k
    for k, g in grads.items():
        ref = j_grads[k[len('params.'):]]
        np.testing.assert_allclose(g, ref, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=k)
    state = _to_flax(student.state_dict())
    assert state.keys() == j_vars.keys()
    for k, v in j_vars.items():
        np.testing.assert_allclose(state[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize('stage', ['stage1', 'stage2'])
def test_distillation_box_step_equals_jax(tiny_train_run, stage,
                                          same_noise):
    """The first step of each stage of the JAX engine's run on the tiny
    config, from the same variables, batch and noise. Stage 1: 'train'
    forward, hint and bpp, Adam, frozen tail, BatchNorm on running
    statistics. Stage 2: 'finetune' forward, KD, SGD with momentum,
    BatchNorm training, the bottleneck frozen but its quantiles on the aux
    Adam. The teacher does not change."""
    run = tiny_train_run
    first = run['first_steps'][stage]
    cfg = load_config(TINY, run['over'])
    stage_cfg = next(c for c in train_stage_configs(cfg['train'])
                     if c['name'] == stage)
    teacher = load_classification_model(cfg['models']['teacher_model'],
                                        device='cpu')
    teacher.load_state_dict(state_dict_from_flax(run['teacher']))
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    student = load_classification_model(cfg['models']['student_model'],
                                        device='cpu')
    student.load_state_dict(state_dict_from_flax(first['before']))
    box = DistillationBox(student, stage_cfg, teacher=teacher,
                          steps_per_epoch=2, student_mode=first['mode'],
                          generator=torch.Generator())
    metrics = box.train_step(_nchw(first['x']), torch.from_numpy(first['y']))
    _check_step(first['result'], box, metrics, first['labels'])
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, t_before[k]), k


def test_training_box_step_equals_jax(same_noise):
    """The end-to-end recipe's one stage: CE + beta * bpp (sum), SGD with
    momentum, weight decay and the cosine schedule, BatchNorm training."""
    cfg = jax_load_config(END_TO_END, SMALL)['models']['model']
    stage_cfg = dict(jax_load_config(END_TO_END)['train'])
    js = jax_load_model(cfg)
    variables = _jax_variables(js, np.random.default_rng(3), mode='train')
    x = np.random.default_rng(0).normal(0, 1, (2, HW, HW, 3)).astype(
        np.float32)
    y = np.array([1, 3])
    jbox = JaxTrainingBox(js, jax.tree.map(jnp.asarray, variables),
                          stage_cfg, steps_per_epoch=4, student_mode='train')
    jax_out = _jax_box_step(jbox, x, y)
    student = load_classification_model(cfg, device='cpu')
    student.load_state_dict(state_dict_from_flax(variables))
    box = TrainingBox(student, stage_cfg, steps_per_epoch=4,
                      student_mode='train', generator=torch.Generator())
    metrics = box.train_step(_nchw(x), torch.from_numpy(y))
    _check_step(jax_out, box, metrics, _flat(jbox.labels))


# ---- end to end -------------------------------------------------------------

class _Recorder:
    """Patches an engine module's `MetricAccumulator` to record every
    step's summed loss."""

    def __init__(self, mp, module):
        self.losses = []
        base = module.MetricAccumulator
        rec = self

        class Recording(base):
            def push(self, loss, aux):
                rec.losses.append(float(np.asarray(loss)))
                super().push(loss, aux)

        mp.setattr(module, 'MetricAccumulator', Recording)


def _tiny_override(ckpt_dir):
    """Small teacher and student in Flax checkpoints with randomized
    values, 8 test images."""
    cfg = jax_load_config(TINY, SMALL)
    rng = np.random.default_rng(3)
    over = json.loads(json.dumps(SMALL))
    del over['models']['model']
    for role, kw in (('teacher_model', {'train': False}),
                     ('student_model', {'mode': 'train'})):
        path = str(ckpt_dir / f'{role}.ckpt')
        jax_save_ckpt(path, _jax_variables(
            jax_load_model(cfg['models'][role]), rng, **kw))
        over['models'][role]['ckpt'] = path
    over['test'] = {'test_data_loader': {'dataset': {
        'kwargs': {'num_samples': 8}}}}
    return over


def _capturing_box(first_steps):
    """JAX's `DistillationBox`, keeping each stage's first step in
    `first_steps[name]`: the variables before it, the batch, the mode, the
    labels and `_jax_box_step`'s result."""

    class Capturing(JaxDistillationBox):
        def train_step(self, x, y, rng):
            name = self.stage_config['name']
            if name in first_steps:
                return super().train_step(x, y, rng)
            before = jax.tree.map(np.array, self.student_variables)
            result = _jax_box_step(
                self, x, y, lambda *a: JaxDistillationBox.train_step(self, *a))
            first_steps[name] = {
                'before': before, 'x': np.array(x), 'y': np.array(y),
                'mode': self.student_mode, 'labels': _flat(self.labels),
                'result': result}
            return result[0]

    return Capturing


@pytest.fixture(scope='module')
def tiny_train_run(tmp_path_factory):
    """The JAX engine's `train()` then `test()` on both wires, with the
    first step of each stage kept for the one-step tests."""
    over = _tiny_override(tmp_path_factory.mktemp('train_ckpt'))
    first_steps = {}

    def zeros_like_init(module, image_size, seed=0, init_kwargs=None):
        shapes = jax.eval_shape(lambda: module.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, *image_size, 3)), **(init_kwargs or {})))
        return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                            {'params': shapes['params'],
                             'batch_stats': shapes['batch_stats']})

    with pytest.MonkeyPatch.context() as mp:
        _same_noise(mp)
        rec = _Recorder(mp, jax_engine_module)
        mp.setattr(jax_engine_module, 'init_model', zeros_like_init)
        mp.setattr(jax_engine_module, 'DistillationBox',
                   _capturing_box(first_steps))
        engine = JaxEngine(jax_load_config(TINY, over), image_size=(64, 64),
                           mesh=None)
        best = engine.train()
    per_wire = {}
    for wire in ('host', 'device'):
        engine.config['deploy_wire'] = wire
        engine.runtime.clear_analysis()
        per_wire[wire] = engine.test()
    assert set(first_steps) == {'stage1', 'stage2'}
    return {'over': over, 'losses': rec.losses, 'best': best,
            'per_wire': per_wire, 'first_steps': first_steps,
            'teacher': jax.tree.map(np.asarray, engine.teacher_variables),
            'student': _flat(jax.tree.map(np.asarray,
                                          engine.student_variables)),
            'tables': engine.runtime.codec.tables}


@pytest.mark.parametrize('wire', ['host', 'device'])
def test_cli_train_then_test_equals_jax_engine(tiny_train_run, wire,
                                               monkeypatch):
    run = tiny_train_run
    over, j_losses, j_vars, j_tables = (run['over'], run['losses'],
                                        run['student'], run['tables'])
    _same_noise(monkeypatch)
    rec = _Recorder(monkeypatch, port_engine_module)
    out = main(['--config', TINY, '--json',
                json.dumps({**over, 'deploy_wire': wire}), '-student_only',
                '--device', 'cpu'])
    assert len(rec.losses) == len(j_losses) == 4
    np.testing.assert_allclose(rec.losses, j_losses, rtol=1e-3)
    assert out['best'] == run['best']
    engine = out['engine']
    state = _to_flax(engine.student.state_dict())
    assert state.keys() == j_vars.keys()
    for k, v in j_vars.items():
        if k.startswith('params.'):
            np.testing.assert_allclose(state[k], v, rtol=0, atol=5e-3,
                                       err_msg=k)
        else:       # statistics of the two steps after the drift above
            np.testing.assert_allclose(
                state[k], v, rtol=1e-3, atol=1e-4 * float(np.abs(v).max()),
                err_msg=k)
    tables = engine.runtime.codec.tables
    for k in ('cdf_length', 'offset'):
        np.testing.assert_array_equal(getattr(tables, k),
                                      getattr(j_tables, k))
    assert np.abs(tables.quantized_cdf.astype(np.int64)
                  - j_tables.quantized_cdf).max() <= 16
    want, want_summaries = run['per_wire'][wire]
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries


# ---- resume and what raises ----------------------------------------------

def _small_engine(tmp_path, **train_over):
    over = json.loads(json.dumps(SMALL))
    del over['models']['model']
    over['train'] = {'stage1': {'num_epochs': 2, 'epoch_to_update': None},
                     'stage2': {'num_epochs': 1}, **train_over}
    return ClassificationEngine(load_config(TINY, over), device='cpu')


def test_train_state_resume_starts_after_the_saved_epoch(tmp_path, caplog):
    dst = tmp_path / 'out' / 'student.ckpt'
    engine = _small_engine(tmp_path)
    engine.train(dst_ckpt=dst)
    saved = load_train_state(dst)
    assert (saved['stage'], saved['epoch']) == ('stage2', 0)
    assert set(saved['optimizer']) >= {'main', 'aux', 'count'}
    assert saved['optimizer']['count'] == 2
    assert Path(str(dst)).exists() and engine.runtime.bottleneck_updated
    # a state saved after stage 1's first epoch resumes at its second
    engine = _small_engine(tmp_path, stage1={'num_epochs': 1,
                                             'epoch_to_update': None})
    engine.config['train'].pop('stage2')
    engine.train(dst_ckpt=dst)
    assert load_train_state(dst)['stage'] == 'stage1'
    engine = _small_engine(tmp_path)
    steps = []
    box_cls = port_engine_module.DistillationBox
    with pytest.MonkeyPatch.context() as mp:
        class Counting(box_cls):
            def train_step(self, x, y):
                steps.append(self.stage_config['name'])
                return super().train_step(x, y)
        mp.setattr(port_engine_module, 'DistillationBox', Counting)
        with caplog.at_level(logging.INFO):
            engine.train(dst_ckpt=dst, resume=True)
    assert 'resumed stage stage1 at epoch 1' in caplog.text
    assert steps == ['stage1'] * 2 + ['stage2'] * 2


@pytest.mark.parametrize('world', [1, 4])
def test_scale_stage_lrs_equals_jax(world):
    """`-adjust_lr`: every stage's learning rate times the number of
    data-parallel processes, in copies; the loaded config is left as it
    was."""
    stages = train_stage_configs(load_config(END_TO_END)['train']) \
        + train_stage_configs(load_config(FLAGSHIP)['train'])
    before = json.loads(json.dumps(stages))
    mesh = SimpleNamespace(devices=np.zeros(world)) if world > 1 else None
    want = jax_engine_module.scale_stage_lrs(
        jax_train_stage_configs(jax_load_config(END_TO_END)['train'])
        + jax_train_stage_configs(jax_load_config(FLAGSHIP)['train']), mesh)
    got = scale_stage_lrs(stages, world)
    assert got == want
    assert stages == before
    assert [s['optimizer']['kwargs']['lr'] for s in got] == [
        world * s['optimizer']['kwargs']['lr'] for s in before]


def test_nan_loss_aborts_training():
    meter = MetricLogger()
    acc = MetricAccumulator(meter, interval=3)
    acc.push(torch.tensor(1.0), torch.tensor(2.0))
    acc.push(torch.tensor(3.0), torch.tensor(2.0))
    acc.drain()
    assert meter.meters['loss'].global_avg == 2.0
    acc.push(torch.tensor(float('nan')), torch.tensor(0.0))
    acc.push(torch.tensor(1.0), torch.tensor(0.0))
    with pytest.raises(ValueError, match='aborting'):
        acc.push(torch.tensor(1.0), torch.tensor(0.0))
    engine = ClassificationEngine(load_config(TINY, {
        **SMALL, 'train': {'stage1': {'optimizer': {
            'key': 'Adam', 'kwargs': {'lr': float('nan')}}}}}),
        device='cpu')
    engine.config['train']['nan_check_interval'] = 1
    engine.config['train']['stage1']['num_epochs'] = 2
    with pytest.raises(ValueError, match='aborting'):
        engine.train()


def test_wrapper_configs_still_raise():
    """A wrapper (input-compression) config builds its wrapper and is
    test-only: training it raises, as in the JAX engine."""
    engine = ClassificationEngine({'models': {'wrapper': {
        'key': 'CodecInputCompressionClassifier',
        'classification_model': {'key': 'resnet', 'kwargs': {
            'stage_sizes': [1, 1, 1, 1], 'num_classes': 10}}}}},
        device='cpu')
    assert engine.wrapper is not None and engine.teacher is None
    with pytest.raises(ValueError, match='test-only'):
        engine.train()
