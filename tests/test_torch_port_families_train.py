"""The ResNeSt Entropic Student on its wires and in training, and the
DenseNet GHND student in training and through the engine, against the JAX
package on the CPU, at the sizes of `test_torch_port_families.py`.

  - The ResNeSt FP student (stage sizes (1, 1, 1, 1), FP encoder [3, 16,
    16, 16], decoder [16, 64, 256, 256], 10 classes, 64 px): symbols equal
    to JAX's (no mismatch at this size), the packed device wire and the
    host wire's objects equal, and `stream_deploy_device` at batch 1 and
    `wire_batch=2` gives JAX's sizes and summaries, logits within 1e-4.
  - One stage-1 and one stage-2 step of the flagship config with that
    student and a `resnest50d` teacher at (1, 1, 1, 1) (the same noise):
    the teacher's layer2-4 and fc copied into the student as JAX copies
    them, the stage-1 hint `bottleneck_layer_out` <-> the teacher's
    `layer1_out`, and losses, gradients, parameters and the frozen set by
    Flax path with `test_torch_port_finetune._check_steps`'s tolerances
    (the gradients' atol 3e-5 of their largest, as through the hybrid
    ViT), on a batch of 8 (`_batch`).
  - One step of the DenseNet GHND student (`larger_densenet_bottleneck`,
    block_config (1, 1, 2, 2), growth 8), no teacher, SGD with momentum
    and weight decay, BatchNorm training, held as the segmentation
    family's BatchNorm-training steps are; the
    engine's test of it (the 'finetune' forward, no data size) equals the
    JAX engine's; a `SplitClassifier` over it raises `AttributeError` on
    both sides (no `forward_tail`).

The small models register under one name in both packages' registries
(`resnest_small`, `resnest_teacher_small`, `densenet_small`)."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.registry as jax_registry
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.models import backbone as jbb
from sc2bench_tpu.models import resnest as jrs
from sc2bench_tpu.models.layer import get_layer as jax_get_layer
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.models.runtime import SplitClassifierRuntime as JaxRuntime
from sc2bench_tpu.models.wrapper import SplitClassifier as JaxSplitClassifier
from sc2bench_tpu.train.box import DistillationBox as JaxDistillationBox
from sc2bench_tpu.train.box import TrainingBox as JaxTrainingBox
from sc2bench_tpu.train.engine import \
    transfer_matching_subtrees as jax_transfer
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
import sc2bench_tpu_torch.registry as port_registry
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models import backbone as pbb
from sc2bench_tpu_torch.models import resnest as prs
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.models.wrapper import SplitClassifier
from sc2bench_tpu_torch.tasks.image_classification import main
from sc2bench_tpu_torch.train.box import DistillationBox, TrainingBox
from sc2bench_tpu_torch.train.engine import (TAIL_PREFIXES,
                                             transfer_matching_subtrees)
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from test_torch_port_backbones import (CLASSES, HW, VIT_DEC, VIT_ENC,
                                       _variables)
from test_torch_port_backbones_train import (_flat_labels, _jax_engine,
                                             _teacher_as_argument)
from test_torch_port_backbones_wire import _bottleneck_kwargs, _serve
from test_torch_port_backbones_wire import same_noise  # noqa: F401
from test_torch_port_finetune import _check_steps, _jax_steps
from test_torch_port_model import _nchw
from test_torch_port_segmentation_train import _check_bn_training_step

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = REPO / ('configs/ilsvrc2012/supervised_compression/'
                   'entropic_student/'
                   'splitable_resnet50-fp-beta0.16_from_resnet50.yaml')
SMALL = (1, 1, 1, 1)
# the gradients' atol (of their largest magnitude): the hybrid ViT's
# (`test_torch_port_backbones_train.py`); XLA and PyTorch sum the grouped
# split-attention convs, the pooled attention's and the dense blocks'
# concatenated BatchNorm statistics in other orders
GRAD_ATOL = 3e-5
DENSE = {'block_config': (1, 1, 2, 2), 'growth_rate': 8}
FP = {'key': 'FPBasedResNetBottleneck',
      'kwargs': _bottleneck_kwargs('FP', VIT_ENC, VIT_DEC)}
GHND = {'key': 'larger_densenet_bottleneck',
        'kwargs': {'bottleneck_channel': 6}}
GHND_STAGE = {'num_epochs': 1, 'train_bn': True,
              'optimizer': {'key': 'SGD', 'kwargs': {
                  'lr': 0.01, 'momentum': 0.9, 'weight_decay': 0.0005}},
              'criterion': {'key': 'CrossEntropyLoss',
                            'kwargs': {'module_path': 'output'}}}


def _jax_builders():
    def resnest(bottleneck_config, num_classes=CLASSES, **kw):
        return jrs.SplittableResNeSt(
            bottleneck_layer=jax_get_layer(
                bottleneck_config['key'], **bottleneck_config['kwargs']),
            stage_sizes=SMALL, num_classes=num_classes)

    def densenet(bottleneck_config, num_classes=CLASSES, **kw):
        return jbb.SplittableDenseNet(
            bottleneck_layer=jax_get_layer(
                bottleneck_config['key'], **bottleneck_config['kwargs']),
            num_classes=num_classes, **DENSE)

    return {'resnest_small': resnest, 'densenet_small': densenet,
            'resnest_teacher_small': lambda num_classes=CLASSES, **kw:
                jrs.ResNeSt(stage_sizes=SMALL, num_classes=num_classes)}


def _port_builders():
    def resnest(bottleneck_config, num_classes=CLASSES, device=None, **kw):
        return prs.SplittableResNeSt(
            get_layer(bottleneck_config['key'], **bottleneck_config['kwargs']),
            stage_sizes=SMALL, num_classes=num_classes).to(device)

    def densenet(bottleneck_config, num_classes=CLASSES, device=None, **kw):
        return pbb.SplittableDenseNet(
            get_layer(bottleneck_config['key'], **bottleneck_config['kwargs']),
            num_classes=num_classes, **DENSE).to(device)

    return {'resnest_small': resnest, 'densenet_small': densenet,
            'resnest_teacher_small': lambda num_classes=CLASSES, device=None,
            **kw: prs.ResNeSt(stage_sizes=SMALL,
                              num_classes=num_classes).to(device)}


@pytest.fixture
def small_models(monkeypatch):
    for registry, builders in ((jax_registry, _jax_builders()),
                               (port_registry, _port_builders())):
        for name, fn in builders.items():
            monkeypatch.setitem(registry._registry('model'), name, fn)


def _spec(key, bottleneck):
    return {'key': key, 'kwargs': {'num_classes': CLASSES,
                                   'bottleneck_config': bottleneck}}


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, (1, HW, HW, 3)).astype(np.float32)
            for _ in range(n)]


# ---- the wires --------------------------------------------------------------

@pytest.fixture(scope='module')
def resnest_runtimes():
    """(JAX runtime, port runtime, images) of the ResNeSt FP student, tables
    built, from one set of randomized variables."""
    with pytest.MonkeyPatch.context() as mp:
        for registry, builders in ((jax_registry, _jax_builders()),
                                   (port_registry, _port_builders())):
            for name, fn in builders.items():
                mp.setitem(registry._registry('model'), name, fn)
        spec = _spec('resnest_small', FP)
        jm = jax_load_model(spec)
        variables = _variables(jm, _images(0, 1)[0], 60, mode='train')
        jrt = JaxRuntime(jm, jax.tree.map(jnp.asarray, variables))
        assert jrt.update()
        jrt.eval()
        pm = load_classification_model(spec, device='cpu')
        pm.load_state_dict(state_dict_from_flax(variables), strict=True)
        prt = SplitClassifierRuntime(pm, device='cpu')
        assert prt.update()
        prt.eval()
        yield jm, variables, jrt, prt, _images(61)


def test_resnest_symbols_and_wires_equal_jax(resnest_runtimes):
    jm, variables, jrt, prt, images = resnest_runtimes
    medians = jnp.asarray(prt._medians.numpy())
    for x in images:
        want = jm.apply(jax.tree.map(jnp.asarray, variables),
                        jnp.asarray(x), medians, method=lambda m, x, md:
                        m.bottleneck_layer.encode_ops(x, md))['symbols']
        with torch.no_grad():
            got = prt._bneck.encode_ops(_nchw(x), prt._medians)['symbols']
        assert torch.equal(got, torch.from_numpy(
            np.array(want).transpose(0, 3, 1, 2)))
        assert prt.encode(_nchw(x)) == jrt.encode(jnp.asarray(x))
        j_ops = jrt.encode_device_wire(jnp.asarray(x))
        p_ops = prt.encode_device_wire(_nchw(x))
        assert prt._pull_device_wire(p_ops) == jrt._pull_device_wire(j_ops)


@pytest.mark.parametrize('kw', [{}, {'wire_batch': 2}],
                         ids=['batch1', 'wire_batch2'])
def test_resnest_stream_deploy_device_equals_jax(resnest_runtimes, kw):
    """Sizes and summaries equal, logits within 1e-4, no escape."""
    _, _, jrt, prt, images = resnest_runtimes
    j_logits, j_sizes, j_summary = _serve(
        jrt, [jnp.asarray(x) for x in images], 'stream_deploy_device',
        depth=2, workers=1, **kw)
    prt.escapes = {'ok': 0, 'valid': 0}
    p_logits, p_sizes, p_summary = _serve(
        prt, [_nchw(x) for x in images], 'stream_deploy_device', depth=2,
        **kw)
    assert p_sizes == j_sizes and p_summary == j_summary
    assert prt.escapes == {'ok': 0, 'valid': 0}
    for a, b in zip(j_logits, p_logits):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


# ---- training ---------------------------------------------------------------

def _batch(seed, n=8):
    """n images and labels. The split-attention's bn1 normalizes one value
    an image a channel (the pooled attention input): over two images its
    variance is that of two numbers, where Flax's one-pass variance
    (E[x^2] - E[x]^2) and torch's part by cancellation, and training-mode
    gradients through it by far more; eight images keep it conditioned."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, HW, HW, 3)).astype(np.float32)
    return x, rng.integers(0, CLASSES, n)


@pytest.mark.parametrize('stage', ['stage1', 'stage2'])
def test_resnest_stage_step_equals_jax(stage, small_models, same_noise):
    """The flagship config's stage over the ResNeSt student and a
    `resnest50d` teacher: the tail copied from the teacher, then one step
    from the same variables, batch and noise."""
    over = {'models': {'teacher_model': {'key': 'resnest_teacher_small',
                                         'kwargs': {'num_classes': CLASSES}},
                       'student_model': _spec('resnest_small', FP)}}
    cfg = jax_load_config(FLAGSHIP, over)
    stage_cfg = cfg['train'][stage]
    js = jax_load_model(cfg['models']['student_model'])
    jt = jax_load_model(cfg['models']['teacher_model'])
    x, y = _batch(62)
    variables = _variables(js, x[:1], 63, mode='train')
    t_vars = _variables(jt, x[:1], 64, train=False)
    moved = jax_transfer(variables, t_vars, ('layer2', 'layer3', 'layer4',
                                             'fc'))
    mode = 'train' if stage == 'stage1' else 'finetune'
    jbox = JaxDistillationBox(
        js, jax.tree.map(jnp.asarray, moved), stage_cfg, teacher_module=jt,
        teacher_variables=jax.tree.map(jnp.asarray, t_vars),
        steps_per_epoch=4, student_mode=mode)
    _teacher_as_argument(jbox)
    j_out = _jax_steps(jbox, [(x, y)])
    pcfg = load_config(FLAGSHIP, over)
    student = load_classification_model(pcfg['models']['student_model'],
                                        device='cpu')
    student.load_state_dict(state_dict_from_flax(variables), strict=True)
    teacher = load_classification_model(pcfg['models']['teacher_model'],
                                        device='cpu')
    teacher.load_state_dict(state_dict_from_flax(t_vars), strict=True)
    transfer_matching_subtrees(student, teacher, TAIL_PREFIXES)
    want = state_dict_from_flax(jax.tree.map(np.asarray, moved))
    for k, v in student.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert any(k.startswith('layer2.0.conv2.fc1') for k in want)
    box = DistillationBox(student, stage_cfg, teacher=teacher,
                          steps_per_epoch=4, student_mode=mode,
                          generator=torch.Generator())
    metrics = box.train_step(_nchw(x), torch.from_numpy(y))
    if stage == 'stage1':
        assert set(metrics['loss']) == {'hint1', 'hint2', 'hint3', 'hint4',
                                        'bpp'}
    for m in student.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    frozen = {flax_param_path(n, student)
              for n, v in box.optim.labels.items() if v == 'frozen'}
    assert frozen and frozen == {k for k, v in _flat_labels(
        jbox.labels).items() if v == 'frozen'}
    # fc1's bias feeds bn1, which trains in stage 2
    _check_steps(j_out, [metrics], box,
                 lr=float(stage_cfg['optimizer']['kwargs']['lr']),
                 grad_atol=GRAD_ATOL, vanishing=('conv2.fc1.bias',)
                 if stage_cfg.get('train_bn', True) else ())


def test_densenet_step_equals_jax(small_models):
    """One teacher-free step of the DenseNet GHND student: SGD with
    momentum and weight decay, BatchNorm training, cross-entropy, on two
    images, held as the segmentation family's BatchNorm-training steps
    are (`_check_bn_training_step`: each gradient within 3e-2 of its
    largest). The stem's BatchNorm gradients sum a whole image's
    positions, and the port's float32 ones are 1e-3 of their largest off
    their float64 value. (On `_batch`'s eight images, JAX's float32
    gradient of the bottleneck's decoder is off its own float64 value by
    up to 4% of the largest, the port's by 2e-6: the decoder's BatchNorm
    statistics, whose variance Flax takes in one pass, E[x^2] - E[x]^2.)"""
    js = jax_load_model(_spec('densenet_small', GHND))
    x, y = _batch(65, n=2)
    variables = _variables(js, x[:1], 66, mode='train')
    jbox = JaxTrainingBox(js, jax.tree.map(jnp.asarray, variables),
                          GHND_STAGE, steps_per_epoch=4,
                          student_mode='train')
    j_out = _jax_steps(jbox, [(x, y)])
    student = load_classification_model(_spec('densenet_small', GHND),
                                        device='cpu')
    student.load_state_dict(state_dict_from_flax(variables, student),
                            strict=True)
    box = TrainingBox(student, GHND_STAGE, steps_per_epoch=4,
                      student_mode='train', generator=torch.Generator())
    metrics = box.train_step(_nchw(x), torch.from_numpy(y))
    for m in student.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    _check_bn_training_step(j_out, metrics, box, lr=0.01)


def test_densenet_engine_test_equals_jax_engine(small_models, tmp_path,
                                                monkeypatch):
    """The CLI's `-test_only` on a DenseNet GHND student (its ckpt the JAX
    variables): no entropy model, so the 'finetune' forward scores it,
    with acc1, acc5 and the summaries of the JAX engine; a
    `SplitClassifier` over the model raises `AttributeError` on both
    sides."""
    spec = _spec('densenet_small', GHND)
    js = jax_load_model(spec)
    variables = _variables(js, _images(0, 1)[0], 67, mode='train')
    ckpt = str(tmp_path / 'student.ckpt')
    jax_save_ckpt(ckpt, variables)
    synthetic = {'dataset': {'key': 'SyntheticClassificationDataset',
                             'kwargs': {'num_samples': 3,
                                        'image_size': [HW, HW],
                                        'num_classes': CLASSES}},
                 'batch_size': 1}
    over = {'models': {'student_model': {**spec, 'ckpt': ckpt}},
            'test': {'test_data_loader': synthetic}}
    config = REPO / 'configs/sample/tiny_entropic_student.yaml'
    want, want_summaries = _jax_engine(config, over, monkeypatch).test()
    out = main(['--config', str(config), '--json', json.dumps(over),
                '-test_only', '-student_only', '--device', 'cpu'])
    assert out['engine'].runtime.codec is None
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
    jwrap = JaxSplitClassifier(js, jax.tree.map(jnp.asarray, variables))
    with pytest.raises(AttributeError):
        jwrap(jnp.asarray(_images(68, 1)[0]))
    pwrap = SplitClassifier(out['engine'].student, device='cpu')
    with pytest.raises(AttributeError):
        pwrap(_nchw(_images(68, 1)[0]))
