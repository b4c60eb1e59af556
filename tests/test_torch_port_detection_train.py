"""The port's COCO detection trained and tested against the JAX package on
the CPU, at the sizes of `test_torch_port_detection.py` (whose small
Faster R-CNN, `faster_rcnn_small`, and helpers it shares).

  - `detection_loss` on JAX's outputs, with JAX's own sampler draws
    (its key splits replayed): the four terms within 1e-5, sampled before
    the box head and on the full proposal set.
  - One `DetectionBox` step of the Entropic Student recipe's stage 1
    (hints on `backbone.*_out`, Adam, the encoder and the density frozen,
    BatchNorm on running statistics), of its stage 2 (the RPN and RoI
    losses, the box head on the 512 sampled proposals, SGD, BatchNorm
    training) and of the end-to-end recipe (bpp + the task losses, the
    'train' forward's noise), from the same variables, batch and draws
    (both packages' samplers patched to one set of numpy uniforms, the
    quantizers to one noise): losses rtol 1e-4, gradients and parameters
    as the classification and segmentation tests hold them.
  - The CLI on `tiny_detection.yaml` (narrowed to the small model) trained
    and tested by the port's `main` and by the JAX engine: every step's
    loss within rtol 1e-3, the best validation mAP and the test's 12
    metrics within 1e-6, the data sizes equal; the CR+BQ config tested
    through the plain forward with nothing accounted.
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
from sc2bench_tpu.models.detection import rcnn as jax_rcnn
from sc2bench_tpu.train.det_engine import DetectionBox as JaxDetectionBox
from sc2bench_tpu.train.det_engine import DetectionEngine as JaxDetEngine
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
import sc2bench_tpu_torch.train.engine as port_engine_module
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models.detection import rcnn
from sc2bench_tpu_torch.tasks.object_detection import main
from sc2bench_tpu_torch.train.det_engine import DetectionBox
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from test_torch_port_backbones_train import _flat_labels
from test_torch_port_backbones_wire import _same_noise
from test_torch_port_detection import (BQ, CANVAS, CLASSES, COCO, FP,
                                       SMALL, canvases,
                                       det_variables, jax_small, nchw,
                                       port_of, random_boxes, register_small)
from test_torch_port_train import _Recorder

ES = COCO / ('entropic_student/faster_rcnn_splittable_resnet50-fp-beta0.08_'
             'fpn_from_faster_rcnn_resnet50_fpn.yaml')
E2E = COCO / ('end-to-end/faster_rcnn_splittable_resnet50-fp-beta1.28e-8_'
               'fpn.yaml')
BQ_CONFIG = COCO / ('ghnd-bq/faster_rcnn_resnet50-bq12ch_fpn_from_'
                    'faster_rcnn_resnet50_fpn.yaml')
TINY = Path(__file__).resolve().parents[1] / \
    'configs/sample/tiny_detection.yaml'
MAX_BOXES = 8


def _targets(seed, n):
    """Padded targets of `n` canvases: 1-6 boxes an image of classes
    1-4, the rest of the MAX_BOXES rows invalid."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, MAX_BOXES, 4), np.float32)
    labels = np.zeros((n, MAX_BOXES), np.int32)
    valid = np.zeros((n, MAX_BOXES), bool)
    for i in range(n):
        k = int(rng.integers(1, 7))
        boxes[i, :k] = random_boxes(rng, k, 60.0, 12.0, 40.0)
        labels[i, :k] = rng.integers(1, CLASSES, k)
        valid[i, :k] = True
    return {'boxes': boxes, 'labels': labels, 'boxes_valid': valid}


def _jax_uniforms(key, n_images, length):
    """The draws of JAX's `_sample_mask` under `rpn_loss`/`sample_rois`
    for `key`: per image split, then split into the fg and bg draws."""
    out = []
    for k in jax.random.split(key, n_images):
        a, b = jax.random.split(k)
        out.append(tuple(torch.from_numpy(np.asarray(jax.random.uniform(
            r, (length,)))) for r in (a, b)))
    return out


@pytest.fixture(scope='module')
def loss_case():
    jm = jax_small({'bottleneck_config': FP})
    variables = det_variables(jm, 11)
    pm = port_of(variables, {'bottleneck_config': FP})
    x = np.concatenate(canvases(12, 2))
    v = jax.tree.map(jnp.asarray, variables)
    out = jax.jit(lambda v, x: jm.apply(v, x, mode='finetune', train=False))(
        v, jnp.asarray(x))
    return jm, v, pm, out, _targets(13, 2)


def test_detection_loss_equals_jax(loss_case):
    """The four Faster R-CNN terms from JAX's outputs and JAX's draws:
    within 1e-5 with the box head on the sampled proposals (and the
    sampled head's logits), and with it weighted over the full set."""
    jm, v, pm, out, targets = loss_case
    hw = (CANVAS, CANVAS)
    key = jax.random.key(3)
    r1, r2 = jax.random.split(key)
    n_anchors = int(out['anchors'].shape[0])
    n_props = int(out['proposals'].shape[1])
    tj = jax.tree.map(jnp.asarray, targets)

    def apply_roi(f, p):
        return jm.apply(v, f, p, hw, method=lambda m, f, p, hw:
                        m.roi_predict(f, p, hw))

    want, want_roi = jax.jit(lambda o, t, k: jax_rcnn.detection_loss(
        {**o, 'image_hw': hw}, t, k, apply_roi=apply_roi,
        return_roi_outputs=True))(
        {k: out[k] for k in out if k != 'image_hw'}, tj, key)
    want_full = jax.jit(lambda o, t, k: jax_rcnn.detection_loss(
        {**o, 'image_hw': hw}, t, k))(
        {k: out[k] for k in out if k != 'image_hw'}, tj, key)
    p_out = {k: torch.from_numpy(np.array(out[k])) for k in (
        'anchors', 'objectness', 'rpn_deltas', 'proposals',
        'proposal_valid', 'class_logits', 'box_regression')}
    p_out['features'] = [nchw(f) for f in out['features']]
    p_out['image_hw'] = hw
    p_t = {k: torch.from_numpy(a) for k, a in targets.items()}
    rpn_u = _jax_uniforms(r1, 2, n_anchors)
    with torch.no_grad():
        got, got_roi = rcnn.detection_loss(
            p_out, p_t, apply_roi=lambda f, p: pm.roi_predict(f, p, hw),
            return_roi_outputs=True, uniforms={
                'rpn': rpn_u,
                'roi': _jax_uniforms(r2, 2, n_props + MAX_BOXES)})
        got_full = rcnn.detection_loss(p_out, p_t, uniforms={
            'rpn': rpn_u, 'roi': _jax_uniforms(r2, 2, n_props)})
    for g, w in ((got, want), (got_full, want_full)):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_roi[0].numpy(), np.asarray(want_roi[0]),
                               rtol=1e-4, atol=1e-4)
    assert float(want['loss_box_reg']) > 0 and float(
        want['loss_classifier']) > 0


# ---- one step of each stage -------------------------------------------------

def _fixed_uniforms(n):
    return np.random.default_rng(n).uniform(size=(2, n)).astype(np.float32)


def _jax_sample_mask(labels, rng, batch_size, positive_fraction):
    """JAX's `_sample_mask` with `_fixed_uniforms` for its draws."""
    u = jnp.asarray(_fixed_uniforms(labels.shape[0]))
    num_pos_target = int(batch_size * positive_fraction)
    pos, neg = labels == 1, labels == 0
    pos_rank = jnp.argsort(jnp.argsort(-jnp.where(pos, u[0], -1.0)))
    n_pos = jnp.minimum(jnp.sum(pos), num_pos_target)
    neg_rank = jnp.argsort(jnp.argsort(-jnp.where(neg, u[1], -1.0)))
    return pos & (pos_rank < n_pos), neg & (neg_rank < batch_size - n_pos)


def _same_draws(mp):
    """Both packages' samplers on `_fixed_uniforms`, and their quantizers
    on one numpy noise."""
    port_sample = rcnn._sample_mask

    def sample(labels, batch_size, positive_fraction, generator=None,
               uniforms=None):
        u = torch.from_numpy(_fixed_uniforms(labels.shape[0]))
        return port_sample(labels, batch_size, positive_fraction,
                           uniforms=(u[0], u[1]))

    mp.setattr(jax_rcnn, '_sample_mask', _jax_sample_mask)
    mp.setattr(rcnn, '_sample_mask', sample)
    _same_noise(mp)


def _teacher_as_argument(box):
    """Jit the JAX box's step with the teacher's variables as an argument
    (its own jit folds them in as constants, which slows the compile);
    the arithmetic is unchanged."""
    teacher_variables = box.teacher_variables

    def step(state, x, y, rng, t_vars, student_mode):
        box.teacher_variables = t_vars
        try:
            return JaxDetectionBox._step(box, state, x, y, rng, student_mode)
        finally:
            box.teacher_variables = teacher_variables

    jitted = jax.jit(step, static_argnames=('student_mode',))
    box._train_step = lambda state, x, y, rng, student_mode: jitted(
        state, x, y, rng, teacher_variables, student_mode=student_mode)


def _jax_step(box, x, targets):
    """The JAX box's step; returns its metrics, the gradient tree taken
    from inside the optimizer, and the new variables."""
    import optax
    grads = []
    inner = box.tx

    def update(g, state, params=None):
        jax.debug.callback(lambda gg: grads.append(
            jax.tree.map(np.asarray, gg)), g)
        return inner.update(g, state, params)

    box.tx = optax.GradientTransformation(inner.init, update)
    metrics = jax.tree.map(np.asarray, box.train_step(
        jnp.asarray(x), jax.tree.map(jnp.asarray, targets),
        jax.random.key(0)))
    jax.effects_barrier()
    return metrics, grads[0], jax.tree.map(np.asarray, box.student_variables)


def _check_step(j_out, metrics, box, lr, tol):
    """Losses rtol 1e-4; each trained parameter's gradient within `tol`
    of its largest magnitude (a parameter outside the loss's graph has
    none in the port and a zero one in JAX) and its value within 1e-5 +
    lr times that (Adam: within 2 lr where the gradient is near zero);
    statistics within 1e-4; frozen parameters unchanged without a
    gradient."""
    j_metrics, j_grads, j_vars = j_out
    assert metrics['loss'].keys() == j_metrics['loss'].keys()
    for k, v in j_metrics['loss'].items():
        np.testing.assert_allclose(float(metrics['loss'][k]), float(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    student = box.student
    g_ref = state_dict_from_flax({'params': j_grads}, student)
    want = state_dict_from_flax(j_vars, student)
    state = student.state_dict()
    params = dict(student.named_parameters())
    adam = box.stage_config['optimizer']['key'] == 'Adam'
    for name, v in want.items():
        got, v = state[name].numpy(), v.numpy()
        if name not in params or name.endswith('quantiles'):
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-4 * max(
                1.0, float(np.abs(v).max())), err_msg=name)
            continue
        ref = g_ref[name].numpy()
        grad = params[name].grad
        if box.optim.labels[name] == 'frozen' or grad is None:
            assert grad is None and not ref.any(), name
            np.testing.assert_array_equal(got, v, err_msg=name)
            continue
        bound = tol * float(np.abs(ref).max())
        np.testing.assert_allclose(grad.numpy(), ref, rtol=0, atol=bound,
                                   err_msg=name)
        if adam:
            sure = np.abs(ref) > 1e-3 * float(np.abs(ref).max())
            np.testing.assert_allclose(got[sure], v[sure], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            assert np.all(np.abs(got - v)[~sure] <= 2 * lr + 1e-5), name
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-5 + lr * bound,
                                       err_msg=name)


def _small_over(config):
    """`--json` override narrowing a COCO config to the small model: 5
    classes, the small FP or CR+BQ bottleneck, 96 px canvases from 64 px
    images, MAX_BOXES boxes."""
    cfg = jax_load_config(config)
    models = {}
    for role, spec in cfg['models'].items():
        kw = {'num_classes': CLASSES}
        bneck = spec['kwargs'].get('backbone_config', {}).get(
            'bottleneck_config')
        if bneck is not None:
            kw['backbone_config'] = {'bottleneck_config': FP
                                     if bneck['key'].startswith('FP')
                                     else BQ}
        models[role] = {'key': SMALL, 'kwargs': kw}
    return {'canvas_size': CANVAS, 'min_size': 64, 'max_boxes': MAX_BOXES,
            'models': models}


@pytest.mark.parametrize('config,stage', [(ES, 'stage1'), (ES, 'stage2'),
                                          (E2E, None)],
                         ids=['es-stage1', 'es-stage2', 'end-to-end'])
def test_box_step_equals_jax(config, stage):
    """One step of the config's stage from the same variables, canvases,
    targets and draws. Stage 1: 'finetune' forward, four hints, Adam, the
    encoder and the density frozen, BatchNorm on running statistics, the
    box head on every proposal ('output' its logits). Stage 2: the task
    losses, the box head on the sampled proposals, SGD with momentum and
    weight decay, BatchNorm training. End to end: the 'train' forward's
    noise, bpp and the task losses. The frozen set is JAX's by Flax path;
    the teacher does not change."""
    over = _small_over(config)
    cfg = jax_load_config(config, over)
    stage_cfg = cfg['train'][stage] if stage else cfg['train']
    with pytest.MonkeyPatch.context() as mp:
        register_small(mp)
        specs = cfg['models']
        js = jax_small(**specs.get('student_model', specs.get('model'))[
            'kwargs'])
        s_vars = det_variables(js, 20)
        student = port_of(s_vars, {'bottleneck_config': FP})
        mode = 'train' if stage is None else 'finetune'
        weight = float(stage_cfg.get('detection_loss_weight', 0.0))
        kwargs = dict(steps_per_epoch=4, student_mode=mode)
        teacher = t_vars = None
        if 'teacher_model' in specs:
            jt = jax_small()
            t_vars = det_variables(jt, 21)
            teacher = port_of(t_vars)
            kwargs['teacher_module'] = jt
            kwargs['teacher_variables'] = jax.tree.map(jnp.asarray, t_vars)
        jbox = JaxDetectionBox(js, jax.tree.map(jnp.asarray, s_vars),
                               stage_cfg, detection_loss_weight=weight,
                               **kwargs)
        if teacher is not None:
            _teacher_as_argument(jbox)
        rng = np.random.default_rng(22)
        x = np.stack([rng.normal(m, s, (CANVAS, CANVAS, 3)) for m, s in
                      ((0.3, 0.8), (-0.3, 0.5))]).astype(np.float32)
        targets = _targets(23, 2)
        _same_draws(mp)
        j_out = _jax_step(jbox, x, targets)
        box = DetectionBox(student, stage_cfg, detection_loss_weight=weight,
                           teacher=teacher, steps_per_epoch=4,
                           student_mode=mode, generator=torch.Generator())
        t_before = {} if teacher is None else {
            k: v.clone() for k, v in teacher.state_dict().items()}
        metrics = box.train_step(nchw(x), {k: torch.from_numpy(v)
                                           for k, v in targets.items()})
    for m in student.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    frozen = {flax_param_path(n, student)
              for n, v in box.optim.labels.items() if v == 'frozen'}
    assert frozen == {k for k, v in _flat_labels(jbox.labels).items()
                      if v == 'frozen'}
    assert bool(frozen) == (stage is not None)
    if weight:
        assert {'loss_objectness', 'loss_classifier'} <= set(metrics['loss'])
    lr = float(stage_cfg['optimizer']['kwargs']['lr'])
    _check_step(j_out, metrics, box, lr,
                tol=3e-2 if stage_cfg.get('train_bn', True) else 1e-4)
    for k, v in t_before.items():
        assert torch.equal(v, teacher.state_dict()[k]), k


# ---- the CLI ----------------------------------------------------------------

def _synthetic(n, batch=1, seed=0):
    return {'dataset': {'key': 'SyntheticDetectionDataset',
                        'kwargs': {'num_samples': n, 'image_size': [64, 64],
                                   'num_classes': CLASSES, 'seed': seed}},
            'batch_size': batch}


def _cli_case(config, tmp_path, mp, seed):
    """(`--json` override with the small models' randomized variables
    saved as their ckpts, the JAX engine on it with the same variables)."""
    over = _small_over(config)
    cfg = jax_load_config(config, over)
    by_seed = {}
    for role, init_seed in (('teacher_model', 7), ('student_model', 0),
                            ('model', 0)):
        if role in cfg['models']:
            variables = det_variables(
                jax_small(**cfg['models'][role]['kwargs']), seed + init_seed)
            path = str(tmp_path / f'{role}.ckpt')
            jax_save_ckpt(path, variables)
            over['models'][role]['ckpt'] = path
            by_seed[init_seed] = jax.tree.map(jnp.asarray, variables)
    over['test'] = {'test_data_loader': _synthetic(2, seed=100)}
    register_small(mp)
    mp.setattr(JaxDetEngine, '_init',
               lambda self, module, seed: by_seed[seed])
    return over


def test_cli_tiny_detection_trains_and_tests_as_jax(tmp_path, monkeypatch):
    """`tiny_detection.yaml` narrowed to the small model, trained (one
    epoch of two steps, the task losses, the 'train' forward's noise) and
    tested on the host wire, by the port's CLI and by the JAX engine:
    every step's loss within rtol 1e-3, the best validation mAP and the
    test's 12 metrics within 1e-6, the data sizes equal."""
    with pytest.MonkeyPatch.context() as mp:
        over = _cli_case(TINY, tmp_path, mp, 30)
        _same_draws(mp)
        rec = _Recorder(mp, jax_engine_module)
        engine = JaxDetEngine(jax_load_config(TINY, over), mesh=None)
        best = engine.train()
        want = engine.test()
    register_small(monkeypatch)
    _same_draws(monkeypatch)
    port_rec = _Recorder(monkeypatch, port_engine_module)
    out = main(['--config', str(TINY), '--json', json.dumps(over),
                '--device', 'cpu'])
    assert len(port_rec.losses) == len(rec.losses) == 2
    np.testing.assert_allclose(port_rec.losses, rec.losses, rtol=1e-3)
    assert out['best'] == pytest.approx(best, abs=1e-6)
    for k, v in want.items():
        if k != 'data_size':
            assert out['result'][k] == pytest.approx(v, abs=1e-6), k
    assert out['summaries'] == want['data_size']
    assert want['data_size'][0]['num_samples'] == 2
    assert out['result']['model_time'] > 0 and out['teacher'] is None


def test_cli_bq_tests_the_plain_forward_as_jax(tmp_path, monkeypatch):
    """The CR+BQ config test-only: no tables, nothing accounted, the
    student's plain forward scored as the JAX engine scores it; the
    teacher's metrics too unless `-student_only`. A wrapper config
    without `-test_only` (it is test-only, as in JAX) and a world size
    above 1 raise."""
    with pytest.MonkeyPatch.context() as mp:
        over = _cli_case(BQ_CONFIG, tmp_path, mp, 40)
        engine = JaxDetEngine(jax_load_config(BQ_CONFIG, over), mesh=None)
        want = engine.test()
        want_teacher = engine.evaluate(engine.build_loader(
            over['test']['test_data_loader']), use_teacher=True)
    register_small(monkeypatch)
    out = main(['--config', str(BQ_CONFIG), '--json', json.dumps(over),
                '-test_only', '--device', 'cpu'])
    assert 'data_size' not in want
    assert out['summaries'][0]['num_samples'] == 0
    for k, v in want.items():
        assert out['result'][k] == pytest.approx(v, abs=1e-6), k
        assert out['teacher'][k] == pytest.approx(want_teacher[k],
                                                  abs=1e-6), k
    wrapper = COCO.parent / ('input_compression/jpeg-faster_rcnn_resnet50_'
                             'fpn.yaml')
    with pytest.raises(ValueError, match='test-only'):
        main(['--config', str(wrapper), '--device', 'cpu'])
    with pytest.raises(ValueError, match='WORLD_SIZE'):
        main(['--config', str(TINY), '--world_size', '2', '--device', 'cpu'])
