"""The RegNetY and hybrid-ViT Entropic Students and the EfficientNet
wrapper trained and tested against the JAX package on the CPU, at the
sizes of `test_torch_port_backbones_wire.py` (whose small models and
helpers it shares).
  - One stage-1 and one stage-2 step of a RegNet FP and a hybrid-ViT MSHP
    config (the same noise): losses rtol 1e-4, gradients rtol 1e-3 (atol
    1e-5 of the largest; 3e-5 through the hybrid ViT's ResNetV2 stages and
    transformer, whose GroupNorm and LayerNorm variances XLA and PyTorch
    sum in other orders), parameters and statistics rtol 1e-4 where Adam's
    update sign is sure (`test_torch_port_finetune._check_steps`); the
    frozen set equal to JAX's by Flax path; no teacher subtree copied into
    the student, as in JAX.
  - The CLI `-test_only` on a RegNet FP (host wire), a hybrid-ViT MSHP
    (device wire) and an EfficientNet-L2 JPEG config: acc1, acc5 and the
    data-size summary equal the JAX engine's; without `-test_only` on a
    RegNet MSHP config, two steps a stage: every step's loss within rtol
    1e-3 of JAX's, then the best validation acc1 and the test equal.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.train.engine as jax_engine_module
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.train.box import DistillationBox as JaxDistillationBox
from sc2bench_tpu.train.engine import ClassificationEngine as JaxEngine
from sc2bench_tpu.train.engine import \
    transfer_matching_subtrees as jax_transfer
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
import sc2bench_tpu_torch.registry as port_registry
import sc2bench_tpu_torch.train.engine as port_engine_module
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models import efficientnet as peff
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.tasks.image_classification import main
from sc2bench_tpu_torch.train.box import DistillationBox
from sc2bench_tpu_torch.train.engine import (TAIL_PREFIXES,
                                             transfer_matching_subtrees)
from sc2bench_tpu_torch.utils.ckpt import load_ckpt
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from test_torch_port_backbones import CLASSES, EFF_SMALL, HW, _variables
from test_torch_port_backbones_wire import (ES, REGNET_FP, REGNET_MSHP,
                                            _same_noise, _student_over,
                                            _student_variables)
from test_torch_port_backbones_wire import (  # noqa: F401  (fixtures)
    memoized_jax_tables, same_noise, small_models)
from test_torch_port_finetune import _check_steps, _jax_steps
from test_torch_port_model import _nchw
from test_torch_port_train import _Recorder

VIT_MSHP = ES / ('splitable_hybrid_vit_small_r26_s32_224-mshp-beta0.16_from_'
                 'hybrid_vit_small_r26_s32_224.yaml')
EFF_JPEG = Path(__file__).resolve().parents[1] / (
    'configs/ilsvrc2012/input_compression/'
    'jpeg-tf_efficientnet_l2_ns_475.yaml')


# ---- one step of each stage -------------------------------------------------

def _teacher_as_argument(box):
    """Jit the JAX box's step with the teacher's variables as an argument:
    its own jit captures them as constants, and XLA's constant folding
    over the hybrid ViT's teacher takes most of a 30 s compile. The step's
    arithmetic is unchanged."""
    teacher_variables = box.teacher_variables

    def step(state, x, y, rng, t_vars, student_mode):
        box.teacher_variables = t_vars
        try:
            return JaxDistillationBox._step(box, state, x, y, rng,
                                            student_mode)
        finally:
            box.teacher_variables = teacher_variables

    jitted = jax.jit(step, static_argnames=('student_mode',))
    box._train_step = lambda state, x, y, rng, student_mode: jitted(
        state, x, y, rng, teacher_variables, student_mode=student_mode)


def _flat_labels(labels) -> dict:
    return {'.'.join(str(getattr(k, 'key', k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(labels)[0]}


@pytest.mark.parametrize('family,config', [('regnet', REGNET_FP),
                                           ('hybrid_vit', VIT_MSHP)],
                         ids=['regnet-fp', 'hybrid_vit-mshp'])
@pytest.mark.parametrize('stage', ['stage1', 'stage2'])
def test_stage_step_equals_jax(family, config, stage, small_models,
                               same_noise):
    """The config's stage from the same variables, batch and noise. Stage
    1: the 'train' forward, four hints and the rate terms, Adam, s2-s4 or
    stages 1-3 frozen, BatchNorm on running statistics. Stage 2: the
    'finetune' forward, KD, SGD with momentum and weight decay, the
    encoder side frozen, BatchNorm training. The teacher gives the student
    nothing (no tail name matches, as in JAX) and does not change."""
    over = _student_over(config, family)
    cfg = jax_load_config(config, over)
    stage_cfg = cfg['train'][stage]
    js = jax_load_model(cfg['models']['student_model'])
    jt = jax_load_model(cfg['models']['teacher_model'])
    rng = np.random.default_rng(40)
    variables = _student_variables(js, rng, config == VIT_MSHP)
    t_vars = _variables(jt, np.zeros((1, HW, HW, 3), np.float32), 41,
                        train=False)
    moved = jax_transfer(variables, t_vars, ('layer2', 'layer3', 'layer4',
                                             'fc'))
    jax.tree.map(np.testing.assert_array_equal, moved, variables)
    x = np.random.default_rng(42).normal(0, 1, (2, HW, HW, 3)).astype(
        np.float32)
    y = np.array([1, 3])
    mode = 'train' if stage == 'stage1' else 'finetune'
    jbox = JaxDistillationBox(
        js, jax.tree.map(jnp.asarray, variables), stage_cfg,
        teacher_module=jt, teacher_variables=jax.tree.map(jnp.asarray,
                                                          t_vars),
        steps_per_epoch=4, student_mode=mode)
    _teacher_as_argument(jbox)
    j_out = _jax_steps(jbox, [(x, y)])
    pcfg = load_config(config, over)
    student = load_classification_model(pcfg['models']['student_model'],
                                        device='cpu', image_size=(HW, HW))
    student.load_state_dict(state_dict_from_flax(variables), strict=True)
    teacher = load_classification_model(pcfg['models']['teacher_model'],
                                        device='cpu', image_size=(HW, HW))
    teacher.load_state_dict(state_dict_from_flax(t_vars), strict=True)
    before = {k: v.clone() for k, v in student.state_dict().items()}
    transfer_matching_subtrees(student, teacher, TAIL_PREFIXES)
    for k, v in student.state_dict().items():
        assert torch.equal(v, before[k]), k
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    box = DistillationBox(student, stage_cfg, teacher=teacher,
                          steps_per_epoch=4, student_mode=mode,
                          generator=torch.Generator())
    metrics = box.train_step(_nchw(x), torch.from_numpy(y))
    # torch's BatchNorm step counter has no Flax counterpart
    for m in student.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    frozen = {flax_param_path(n, student)
              for n, v in box.optim.labels.items() if v == 'frozen'}
    assert frozen and frozen == {k for k, v in _flat_labels(
        jbox.labels).items() if v == 'frozen'}
    _check_steps(j_out, [metrics], box,
                 lr=float(stage_cfg['optimizer']['kwargs']['lr']),
                 grad_atol=1e-5 if family == 'regnet' else 3e-5)
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, t_before[k]), k


# ---- the CLI ----------------------------------------------------------------

def _synthetic(n, batch=1):
    return {'dataset': {'key': 'SyntheticClassificationDataset',
                        'kwargs': {'num_samples': n, 'image_size': [HW, HW],
                                   'num_classes': CLASSES}},
            'batch_size': batch}


def _with_ckpts(config, over, tmp_path):
    """`over` with randomized teacher and student variables saved as
    their ckpts, and a test loader of 3 synthetic images."""
    cfg = jax_load_config(config, over)
    rng = np.random.default_rng(50)
    hyper = 'mshp' in Path(config).name
    for role in ('teacher_model', 'student_model'):
        module = jax_load_model(cfg['models'][role])
        if role == 'teacher_model':
            variables = _variables(module, np.zeros((1, HW, HW, 3),
                                                    np.float32), 51,
                                   train=False)
        else:
            variables = _student_variables(module, rng, hyper)
        path = str(tmp_path / f'{role}.ckpt')
        jax_save_ckpt(path, variables)
        over['models'][role]['ckpt'] = path
    over['test'] = {'test_data_loader': _synthetic(3)}
    return over


def _zeros_like_init(module, image_size, seed=0, init_kwargs=None):
    """The JAX engine's init without the compile (the ckpts replace it)."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, *image_size, 3)), **(init_kwargs or {})))
    return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                        {'params': shapes['params'],
                         'batch_stats': shapes.get('batch_stats', {})})


def _jax_engine(config, over, mp):
    mp.setattr(jax_engine_module, 'init_model', _zeros_like_init)
    cfg = jax_load_config(config, over)
    return JaxEngine(cfg, image_size=tuple(cfg['image_size']), mesh=None)


@pytest.mark.parametrize('family,config,wire', [
    ('regnet', REGNET_FP, 'host'), ('hybrid_vit', VIT_MSHP, 'device')],
    ids=['regnet-fp-host', 'hybrid_vit-mshp-device'])
def test_cli_test_only_equals_jax_engine(family, config, wire, small_models,
                                         tmp_path, monkeypatch):
    over = {**_with_ckpts(config, _student_over(config, family), tmp_path),
            'deploy_wire': wire}
    want, want_summaries = _jax_engine(config, over, monkeypatch).test()
    out = main(['--config', str(config), '--json', json.dumps(over),
                '-test_only', '-student_only', '--device', 'cpu'])
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
    assert want_summaries[0]['num_samples'] == 3
    assert out['engine'].runtime.escapes == {'ok': 0, 'valid': 0}


def test_cli_efficientnet_wrapper_equals_jax_engine(small_models, tmp_path,
                                                    monkeypatch):
    """JPEG q75 in front of EfficientNet (the L2 config's transforms; the
    classifier narrowed, the port's loading the JAX engine's random
    weights): acc1, acc5 and the KB summary equal."""
    over = {'models': {'wrapper': {'classification_model': {
        'key': 'efficientnet_small', 'kwargs': {'num_classes': CLASSES}}}},
        'test': {'test_data_loader': _synthetic(3)}}
    engine = JaxEngine(jax_load_config(EFF_JPEG, over), mesh=None)
    ckpt = str(tmp_path / 'classifier.ckpt')
    jax_save_ckpt(ckpt, jax.device_get(engine.wrapper.classifier.variables))

    def with_jax_weights(num_classes=CLASSES, device=None, **kw):
        model = peff.EfficientNet(**{**EFF_SMALL, 'num_classes': num_classes})
        model.load_state_dict(load_ckpt(ckpt, model)[0])
        return model.to(device)

    monkeypatch.setitem(port_registry._registry('model'),
                        'efficientnet_small', with_jax_weights)
    want, want_summaries = engine.test()
    out = main(['--config', str(EFF_JPEG), '--json', json.dumps(over),
                '-test_only', '--device', 'cpu'])
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
    assert want_summaries[0]['num_samples'] == 3


def test_cli_train_then_test_equals_jax_engine(small_models, tmp_path,
                                               monkeypatch):
    """The RegNet MSHP config trained by the CLI, two steps a stage (the
    tables built after stage 1's one epoch), then tested on the host wire:
    every step's loss within rtol 1e-3 of the JAX engine's, the best
    validation acc1 and the test equal."""
    over = _with_ckpts(REGNET_MSHP, _student_over(REGNET_MSHP, 'regnet'),
                       tmp_path)
    over['train'] = {'train_data_loader': {**_synthetic(4, 2),
                                           'shuffle': False},
                     'val_data_loader': _synthetic(2, 2),
                     'stage1': {'num_epochs': 1, 'epoch_to_update': 1},
                     'stage2': {'num_epochs': 1}}
    over['test'] = {'test_data_loader': _synthetic(2)}
    with pytest.MonkeyPatch.context() as mp:
        _same_noise(mp)
        rec = _Recorder(mp, jax_engine_module)
        engine = _jax_engine(REGNET_MSHP, over, mp)
        best = engine.train()
        want, want_summaries = engine.test()
    _same_noise(monkeypatch)
    port_rec = _Recorder(monkeypatch, port_engine_module)
    out = main(['--config', str(REGNET_MSHP), '--json', json.dumps(over),
                '-student_only', '--device', 'cpu'])
    assert len(port_rec.losses) == len(rec.losses) == 4
    np.testing.assert_allclose(port_rec.losses, rec.losses, rtol=1e-3)
    assert out['best'] == best
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
