"""The port's VOC segmentation trained and tested against the JAX package
on the CPU, at the sizes of `test_torch_port_segmentation.py` (whose small
DeepLabv3, `deeplabv3_small`, and helpers it shares).

  - One step of the Entropic Student recipe's stage 1 (hints on
    `backbone.layer2-4_out`, Adam, the encoder, the density, layer3 and
    layer4 frozen, BatchNorm on running statistics) and stage 2
    (`SegCrossEntropyLoss` on 'output' and 'output.aux', SGD with the
    module-wise learning rate of `aux_classifier`, BatchNorm training),
    and of the end-to-end recipe (CE + beta * bpp on
    `backbone.bottleneck_layer.eb_out`), from the same variables, batch
    and noise: losses rtol 1e-4; in stage 1 gradients and parameters as
    `test_torch_port_finetune._check_steps` holds them; where BatchNorm
    trains (stage 2, end to end) as `_check_bn_training_step` does, at
    3e-2 of each gradient's largest magnitude; the frozen set equal to
    JAX's by Flax path; the teacher unchanged.
  - The CLI `-test_only` on the Entropic Student config (host and device
    wire), a CR+BQ, the JPEG and the MSHP-codec config, narrowed to the
    small model and 3 synthetic 64 px images: mIoU, global accuracy and
    the data-size summary equal the JAX engine's (the CR+BQ student's the
    JAX runtime's forward, which the JAX engine's loop cannot score);
    without `-test_only` on the Entropic Student config, two steps a
    stage: every step's loss within rtol 1e-3 of the JAX engine's, then
    the best validation mIoU and the test's within 1e-3 and the data-size
    summary equal; the end-to-end and CR+BQ configs trained by the CLI,
    their losses within rtol 1e-3 of JAX's.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.models.segmentation.registry as jax_seg_registry
import sc2bench_tpu.train.engine as jax_engine_module
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.train.box import DistillationBox as JaxDistillationBox
from sc2bench_tpu.train.box import TrainingBox as JaxTrainingBox
from sc2bench_tpu.train.seg_engine import SegmentationEngine as JaxSegEngine
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
from sc2bench_tpu.utils.seg_eval import SegEvaluator as JaxSegEvaluator
import sc2bench_tpu_torch.train.engine as port_engine_module
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models.segmentation.registry import \
    load_segmentation_model
from sc2bench_tpu_torch.tasks.semantic_segmentation import main
from sc2bench_tpu_torch.train.box import DistillationBox, TrainingBox
from sc2bench_tpu_torch.utils.convert import flax_param_path
from test_torch_port_backbones_train import (_flat_labels,
                                             _teacher_as_argument)
from test_torch_port_backbones_wire import _same_noise
from test_torch_port_codecs import WIDTHS, _codec_variables
from test_torch_port_finetune import _check_steps, _jax_steps
from test_torch_port_segmentation import (BCH, CLASSES, HW, SMALL, TARGET,
                                          VOC, jax_small, nchw,
                                          register_small, seg_variables,
                                          state_dict_from_flax)
from test_torch_port_segmentation import small_deeplabv3  # noqa: F401
from test_torch_port_train import _Recorder

SC = VOC / 'supervised_compression'
ES = SC / ('entropic_student/deeplabv3_splittable_resnet50-fp-beta0.16_from_'
           'deeplabv3_resnet50.yaml')
E2E = SC / 'end-to-end/deeplabv3_splittable_resnet50-fp-beta1.024e-7.yaml'
BQ = SC / 'ghnd-bq/deeplabv3_resnet50-bq2ch_from_deeplabv3_resnet50.yaml'
INPUT = VOC / 'input_compression'
JPEG = INPUT / 'jpeg-deeplabv3_resnet101.yaml'
MSHP = INPUT / 'mean_scale_hyperprior-deeplabv3_resnet50.yaml'
SMALL_FP = {'num_bottleneck_channels': BCH, 'num_target_channels': TARGET}


def _over(config):
    """`--json` override: the small DeepLabv3 for every model of the
    config, 5 classes, 64 px; an FP bottleneck narrowed to 8 channels
    (target 64), a CR+BQ one to output 64."""
    cfg = jax_load_config(config)
    models = {}
    for role, spec in cfg['models'].items():
        if role == 'wrapper':
            models['wrapper'] = {'segmentation_model': {
                'key': SMALL, 'kwargs': {'num_classes': CLASSES}}}
            continue
        kw = {'num_classes': CLASSES}
        bneck = spec['kwargs'].get('bottleneck_config')
        if bneck is not None:
            kw['bottleneck_config'] = {'kwargs': SMALL_FP} \
                if bneck['key'].startswith('FP') \
                else {'kwargs': {'output_channel': TARGET}}
        models[role] = {'key': SMALL, 'kwargs': kw}
    return {'image_size': [HW, HW], 'num_classes': CLASSES, 'models': models}


def _synthetic(n, batch=1, seed=0):
    return {'dataset': {'key': 'SyntheticSegmentationDataset',
                        'kwargs': {'num_samples': n, 'image_size': [HW, HW],
                                   'num_classes': CLASSES, 'seed': seed}},
            'batch_size': batch}


def _models(config, over, seed):
    """{role: (JAX module, randomized variables)} of a config's teacher
    and student (`model` without a teacher)."""
    with pytest.MonkeyPatch.context() as mp:
        register_small(mp)
        cfg = jax_load_config(config, over)
        out = {}
        for i, role in enumerate(('teacher_model', 'student_model',
                                  'model')):
            if role in cfg['models']:
                spec = cfg['models'][role]
                module = jax_small(**spec['kwargs'])
                out[role] = (module, seg_variables(module, seed + i))
    return out


def _port_model(variables, spec):
    pm = load_segmentation_model({**spec, 'ckpt': None}, device='cpu')
    pm.load_state_dict(state_dict_from_flax(variables, pm), strict=True)
    return pm


# ---- one step of each stage ------------------------------------------------

def _check_bn_training_step(j_out, metrics, box, lr, tol=3e-2):
    """A step where BatchNorm trains: it normalizes ASPP's pooled branch
    over the batch, one value a channel an image, and where two such
    values nearly coincide that normalization amplifies the frameworks'
    float differences a hundredfold (the worst gradient measured 1.4e-2
    of its tensor's largest, `classifier.1`; the losses agree to 1e-6).
    Losses rtol 1e-4; each gradient within `tol` of its largest
    magnitude; each parameter within 1e-5 plus `lr` times that;
    statistics within 1e-4, relative and of the largest; frozen
    parameters unchanged."""
    j_metrics, j_grads, j_vars = j_out
    for k, v in j_metrics[0]['loss'].items():
        np.testing.assert_allclose(float(metrics['loss'][k]), float(v),
                                   rtol=1e-4, err_msg=k)
    student = box.student
    g_ref = state_dict_from_flax({'params': j_grads[0]}, student)
    want = state_dict_from_flax(j_vars, student)
    state = student.state_dict()
    params = dict(student.named_parameters())
    for name, v in want.items():
        got, v = state[name].numpy(), v.numpy()
        if name not in params or name.endswith('quantiles'):
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-4 * max(
                1.0, float(np.abs(v).max())), err_msg=name)
        elif box.optim.labels[name] == 'frozen':
            assert params[name].grad is None, name
            np.testing.assert_array_equal(got, v, err_msg=name)
        else:
            ref = g_ref[name].numpy()
            bound = tol * float(np.abs(ref).max())
            np.testing.assert_allclose(params[name].grad.numpy(), ref,
                                       rtol=0, atol=bound, err_msg=name)
            np.testing.assert_allclose(got, v, rtol=0,
                                       atol=1e-5 + lr * bound, err_msg=name)


@pytest.mark.parametrize('config,stage', [(ES, 'stage1'), (ES, 'stage2'),
                                          (E2E, None)],
                         ids=['es-stage1', 'es-stage2', 'end-to-end'])
def test_stage_step_equals_jax(config, stage, small_deeplabv3):
    over = _over(config)
    cfg = jax_load_config(config, over)
    stage_cfg = cfg['train'][stage] if stage else cfg['train']
    models = _models(config, over, 80)
    js, s_vars = models.get('student_model') or models['model']
    # two images of different mean and scale, whose pooled ASPP values
    # spread apart (see `_check_bn_training_step`)
    rng = np.random.default_rng(82)
    x = np.stack([rng.normal(m, s, (HW, HW, 3)) for m, s in
                  ((0.5, 1.0), (-0.5, 0.3))]).astype(np.float32)
    y = np.random.default_rng(83).integers(0, CLASSES, (2, HW, HW))
    y[:, :4] = 255
    mode = 'finetune' if stage == 'stage2' else 'train'
    pcfg = load_config(config, over)
    student = _port_model(s_vars, pcfg['models'].get(
        'student_model', pcfg['models'].get('model')))
    kwargs = dict(steps_per_epoch=4, student_mode=mode)
    with pytest.MonkeyPatch.context() as mp:
        _same_noise(mp)
        if 'teacher_model' in models:
            jt, t_vars = models['teacher_model']
            jbox = JaxDistillationBox(
                js, jax.tree.map(jnp.asarray, s_vars), stage_cfg,
                teacher_module=jt,
                teacher_variables=jax.tree.map(jnp.asarray, t_vars),
                **kwargs)
            _teacher_as_argument(jbox)
            teacher = _port_model(t_vars, pcfg['models']['teacher_model'])
            box = DistillationBox(student, stage_cfg, teacher=teacher,
                                  generator=torch.Generator(), **kwargs)
        else:
            jbox = JaxTrainingBox(js, jax.tree.map(jnp.asarray, s_vars),
                                  stage_cfg, **kwargs)
            teacher = None
            box = TrainingBox(student, stage_cfg,
                              generator=torch.Generator(), **kwargs)
        j_out = _jax_steps(jbox, [(x, y)])
        t_before = {} if teacher is None else {
            k: v.clone() for k, v in teacher.state_dict().items()}
        metrics = box.train_step(nchw(x), torch.from_numpy(y))
    assert 'acc1' not in metrics
    for m in student.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    labels = box.optim.labels
    frozen = {flax_param_path(n, student) for n, v in labels.items()
              if v == 'frozen'}
    assert frozen == {k for k, v in _flat_labels(jbox.labels).items()
                      if v == 'frozen'}
    lr = float(stage_cfg['optimizer']['kwargs']['lr'])
    if stage == 'stage1':
        assert frozen and all(p.split('.')[1] in (
            'bottleneck_layer', 'layer3', 'layer4') for p in frozen)
    if stage == 'stage2':
        mw = stage_cfg['optimizer']['module_wise_kwargs'][0]['kwargs']['lr']
        aux = {n for n, v in labels.items() if v == 'mw0'}
        assert aux == {n for n in labels if n.startswith('aux_classifier.')}
        assert [g['lr'] for g in box.optim.main.param_groups] == \
            pytest.approx([lr, mw])
        lr = max(lr, mw)
    if stage_cfg.get('train_bn', True):
        _check_bn_training_step(j_out, metrics, box, lr)
    else:
        _check_steps(j_out, [metrics], box, lr=lr)
    for k, v in t_before.items():
        assert torch.equal(v, teacher.state_dict()[k]), k


# ---- the CLI ---------------------------------------------------------------

def _save(tmp_path, name, variables):
    path = str(tmp_path / f'{name}.ckpt')
    jax_save_ckpt(path, variables)
    return path


def _cli_over(config, tmp_path, n_test=3):
    """`_over` with the randomized variables of the models saved as their
    ckpts (the port reads them all; the JAX engine reads the student's and
    gets the teacher's through `_jax_engine`), the codec's too, and a test
    loader of `n_test` synthetic images."""
    over = _over(config)
    models = _models(config, over, 90)
    for role, (_, variables) in models.items():
        over['models'][role]['ckpt'] = _save(tmp_path, role, variables)
    cm = jax_load_config(config)['models'].get('wrapper', {}).get(
        'compression_model')
    if cm is not None:
        n_ch, m_ch = WIDTHS[cm['key']]
        _, variables = _codec_variables(cm['key'], 91)
        over['models']['wrapper']['compression_model'] = {
            'kwargs': {'n': n_ch, 'm': m_ch},
            'ckpt': _save(tmp_path, 'codec', variables)}
    if 'wrapper' in over['models']:
        module = jax_small(num_classes=CLASSES)
        variables = seg_variables(module, 92)
        over['models']['wrapper']['segmentation_model']['ckpt'] = _save(
            tmp_path, 'segmentation_model', variables)
    over['test'] = {'test_data_loader': _synthetic(n_test, seed=100)}
    return over, models


def _jax_engine(config, over, models, mp):
    """The JAX engine on `over`, its models' initial variables those of
    `models` (its teacher has no ckpt rule) and, for a wrapper, the
    segmentation model's ckpt loaded without an init at 512 px."""
    register_small(mp)
    by_seed = {7: models.get('teacher_model'),
               0: models.get('student_model') or models.get('model')}
    mp.setattr(JaxSegEngine, '_init', lambda self, module, seed: jax.tree.map(
        jnp.asarray, by_seed[seed][1]))

    def load_wrapped(model_config, image_size=None):
        from sc2bench_tpu.utils.ckpt import load_ckpt
        module = jax_small(**model_config.get('kwargs', {}))
        variables = seg_variables(module, 0)
        return module, load_ckpt(model_config['ckpt'], variables)[0]

    mp.setattr(jax_seg_registry, 'load_segmentation_model', load_wrapped)
    return JaxSegEngine(jax_load_config(config, over), image_size=(HW, HW),
                        num_classes=CLASSES, mesh=None)


@pytest.mark.parametrize('config,wire', [
    (ES, 'host'), (ES, 'device'), (JPEG, None), (MSHP, None)],
    ids=['es-host', 'es-device', 'jpeg-resnet101', 'mshp-resnet50'])
def test_cli_test_only_equals_jax_engine(config, wire, tmp_path,
                                         monkeypatch):
    over, models = _cli_over(config, tmp_path)
    if wire:
        over['deploy_wire'] = wire
    with pytest.MonkeyPatch.context() as mp:
        want, want_summaries = _jax_engine(config, over, models, mp).test()
    register_small(monkeypatch)
    out = main(['--config', str(config), '--json', json.dumps(over),
                '-test_only', '-student_only', '--device', 'cpu'])
    for k in ('miou', 'acc_global'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
    assert want_summaries[0]['num_samples'] == 3
    assert out['result']['model_time'] > 0
    if wire:
        assert out['engine'].runtime.escapes == {'ok': 0, 'valid': 0}


def test_cli_bq_test_equals_jax_runtime(tmp_path, monkeypatch):
    """A CR+BQ config: no tables, nothing accounted, the main head of the
    runtime's 'train' forward scored as JAX's runtime scores it; the
    teacher's mIoU printed unless `-student_only`."""
    over, models = _cli_over(BQ, tmp_path)
    evaluator = JaxSegEvaluator(CLASSES)
    with pytest.MonkeyPatch.context() as mp:
        engine = _jax_engine(BQ, over, models, mp)
        assert not engine.runtime.update()
        for x, y in engine.build_loader(over['test']['test_data_loader']):
            out = engine.runtime(jnp.asarray(x))
            evaluator.update(y, np.asarray(jnp.argmax(out['out'], -1)))
        _, _, iou = evaluator.compute()
        want_teacher = engine.evaluate(engine.build_loader(
            over['test']['test_data_loader']), use_teacher=True)
    register_small(monkeypatch)
    out = main(['--config', str(BQ), '--json', json.dumps(over), '-test_only',
                '--device', 'cpu'])
    assert out['result']['miou'] == float(iou.mean())
    assert out['summaries'][0]['num_samples'] == 0
    assert not out['engine'].runtime.bottleneck_updated
    for k in ('miou', 'acc_global'):
        assert out['teacher'][k] == want_teacher[k]


def test_cli_train_then_test_equals_jax_engine(tmp_path, monkeypatch):
    """The Entropic Student config trained by the CLI, two steps a stage
    (the tables built before stage 1, `epoch_to_update: 0`), then tested
    on the host wire: every step's loss within rtol 1e-3 of the JAX
    engine's, the best validation mIoU and the test's within 1e-3 (a few
    pixels), the data-size summary (the encoder is frozen in both stages)
    equal; a wrapper config does not train, as in JAX."""
    over, models = _cli_over(ES, tmp_path, n_test=2)
    over['train'] = {'train_data_loader': _synthetic(4, 2, seed=200),
                     'val_data_loader': _synthetic(2, 2, seed=300),
                     'stage1': {'num_epochs': 1},
                     'stage2': {'num_epochs': 1}}
    with pytest.MonkeyPatch.context() as mp:
        _same_noise(mp)
        rec = _Recorder(mp, jax_engine_module)
        engine = _jax_engine(ES, over, models, mp)
        best = engine.train()
        want, want_summaries = engine.test()
    register_small(monkeypatch)
    _same_noise(monkeypatch)
    port_rec = _Recorder(monkeypatch, port_engine_module)
    out = main(['--config', str(ES), '--json', json.dumps(over),
                '-student_only', '--device', 'cpu'])
    assert len(port_rec.losses) == len(rec.losses) == 4
    np.testing.assert_allclose(port_rec.losses, rec.losses, rtol=1e-3)
    # stage 2 trains BatchNorm at batch 2 (see `_check_bn_training_step`):
    # the weights it leaves differ by float amounts, enough to flip a few
    # of the 8,192 validation pixels' argmax
    assert out['best'] == pytest.approx(best, abs=1e-3)
    for k in ('miou', 'acc_global'):
        assert out['result'][k] == pytest.approx(want[k], abs=1e-3)
    assert out['summaries'] == want_summaries
    jpeg_over, _ = _cli_over(JPEG, tmp_path, n_test=1)
    with pytest.raises(ValueError, match='test-only'):
        main(['--config', str(JPEG), '--json', json.dumps(jpeg_over),
              '--device', 'cpu'])


@pytest.mark.parametrize('config', [E2E, BQ], ids=['end-to-end', 'ghnd-bq'])
def test_cli_trains_the_other_families_as_jax(config, tmp_path, monkeypatch):
    """The end-to-end (one stage, CE + beta * bpp) and CR+BQ (hints, the
    tail frozen) configs trained by the CLI, two steps, then tested: every
    step's loss within rtol 1e-3 of the JAX engine's `train()`; the
    end-to-end test's mean data size within 1% of the JAX engine's (its
    encoder trains), the CR+BQ test with nothing accounted."""
    over, models = _cli_over(config, tmp_path, n_test=2)
    train = {'train_data_loader': _synthetic(4, 2, seed=200),
             'val_data_loader': _synthetic(2, 2, seed=300)}
    if config == E2E:
        train['num_epochs'] = 1
    else:
        train['stage1'] = {'num_epochs': 1}
    over['train'] = train
    with pytest.MonkeyPatch.context() as mp:
        _same_noise(mp)
        rec = _Recorder(mp, jax_engine_module)
        engine = _jax_engine(config, over, models, mp)
        engine.train()
        want_summaries = engine.test()[1] if config == E2E else None
    register_small(monkeypatch)
    _same_noise(monkeypatch)
    port_rec = _Recorder(monkeypatch, port_engine_module)
    out = main(['--config', str(config), '--json', json.dumps(over),
                '-student_only', '--device', 'cpu'])
    assert len(port_rec.losses) == len(rec.losses) == 2
    np.testing.assert_allclose(port_rec.losses, rec.losses, rtol=1e-3)
    if config == E2E:
        # the encoder trains here: the two frameworks' float differences
        # move a few symbols across rounding boundaries, so a few bytes
        got, want = out['summaries'][0], want_summaries[0]
        assert got['num_samples'] == want['num_samples'] == 2
        assert got['mean'] == pytest.approx(want['mean'], rel=1e-2)
    else:
        assert out['summaries'][0]['num_samples'] == 0
    assert 0.0 <= out['result']['miou'] <= 1.0


def test_cli_tiny_segmentation_config_trains_and_tests():
    """`configs/sample/tiny_segmentation.yaml` as it is (ResNet-50 depth at
    64 px, 5 classes): one stage, the tables built after it, then 2 test
    images on the host wire."""
    config = Path(__file__).resolve().parents[1] / \
        'configs/sample/tiny_segmentation.yaml'
    out = main(['--config', str(config), '--device', 'cpu'])
    assert 0.0 <= out['best'] <= 1.0
    assert out['engine'].runtime.bottleneck_updated
    assert out['summaries'][0]['num_samples'] == 2
    assert out['teacher'] is None
