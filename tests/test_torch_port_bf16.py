"""The port's bfloat16 options against the JAX package on the CPU: the
`dtype` of the models, the runtime's `deploy_bf16_tail`,
`deploy_bf16_decode` and `deploy_bf16_encode`, a bfloat16 stage-1 step,
and the bench entry point (`sc2bench_tpu_torch.bench`) at a tiny size.

Small size, as the other port tests: stages (1, 1, 1, 1), bottleneck 8,
target 64 (256 for DeepLabv3 and Faster R-CNN, whose heads read it),
latent 4, 10 classes (5 for the dense tasks), 64 px; a hyperprior's
Gaussian tables of a 16-entry scale table. Flax variables randomized
with numpy go into both packages.

XLA's and PyTorch's CPU bfloat16 convolutions need not round alike, so
bfloat16 outputs are held against JAX's with the JAX tests' own
tolerances and equal top-1: logits within rtol 0.1 and atol 0.15 (or 1%
of the largest logit, where the randomized weights make logits of order
100 rather than 1), features within rtol 0.1 and atol 0.08, per-pixel
predictions agreeing on more than 95%. What must be exact is exact: with `deploy_bf16_decode` or
`deploy_bf16_tail` the wire bytes and sizes equal the float32 runtime's,
at batch 1 and `wire_batch`, and a hyperprior's decoded indexes equal
the encoder's; `deploy_bf16_encode` streams decode to the very symbols
that were sent, at most 1% of them one step from the float32 encoder's,
the wire within 1e-3 of the float32 wire's size. With `dtype` unset or
float32 every output is the float32 model's, bit for bit.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.models.backbone as jax_backbone_module
import sc2bench_tpu.models.resnet as jax_resnet_module
import sc2bench_tpu.ops.entropy.factorized as jax_factorized
import sc2bench_tpu.utils.cache as jax_cache
from sc2bench_tpu.models.backbone import SplittableResNet as JaxResNet
from sc2bench_tpu.models.detection import rcnn as jax_rcnn
from sc2bench_tpu.models.detection.base import \
    SplittableDetectionBackbone as JaxDetBackbone
from sc2bench_tpu.models.layer import get_layer as jax_get_layer
from sc2bench_tpu.models.runtime import SplitClassifierRuntime as JaxRuntime
from sc2bench_tpu.models.segmentation.base import \
    SegmentationBackboneFeatures as JaxSegBackbone
from sc2bench_tpu.models.segmentation.deeplabv3 import \
    create_deeplabv3 as jax_create_deeplabv3
import sc2bench_tpu_torch.ops.entropy.factorized as port_factorized
from sc2bench_tpu_torch import bench
from sc2bench_tpu_torch.models.backbone import splittable_resnet
from sc2bench_tpu_torch.models.detection import rcnn
from sc2bench_tpu_torch.models.detection.base import \
    SplittableDetectionBackbone
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.models.precision import resolve_dtype
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.models.segmentation.base import SegmentationBackbone
from sc2bench_tpu_torch.models.segmentation.deeplabv3 import \
    create_deeplabv3
from sc2bench_tpu_torch.ops.entropy.gaussian import get_scale_table
from sc2bench_tpu_torch.ops.rans.device import device_rans_decode
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_port_hyper import _hyper_variables
from test_torch_port_model import _nchw, _randomize
from test_torch_port_train import _jax_noise, _port_noise

REPO = Path(__file__).resolve().parents[1]
BCH, TARGET, LCH, STAGES, CLASSES, HW = 8, 64, 4, (1, 1, 1, 1), 10, 64
SCALE_TABLE = get_scale_table(0.11, 64.0, 16)
KEYS = {'fp': 'FPBasedResNetBottleneck', 'shp': 'SHPBasedResNetBottleneck',
        'mshp': 'MSHPBasedResNetBottleneck'}
N_IMAGES = 4


def _bottleneck_kwargs(kind, target=TARGET):
    kw = {'num_bottleneck_channels': BCH, 'num_target_channels': target}
    if kind != 'fp':
        kw['num_latent_channels'] = LCH
    return kw


def _jax_student(kind):
    return JaxResNet(bottleneck_layer=jax_get_layer(
        KEYS[kind], **_bottleneck_kwargs(kind)), stage_sizes=STAGES,
        num_classes=CLASSES)


def _variables(kind, module):
    """Randomized Flax variables; the FP encoder's last kernel halved
    (its latent then of a trained model's order of magnitude), a
    hyperprior's scales spread over the table."""
    rng = np.random.default_rng(21)
    if kind != 'fp':
        return _hyper_variables(module, rng)
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)), mode='train'))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']}, rng)
    variables['params']['bottleneck_layer']['enc_conv2']['kernel'] *= 0.5
    return variables


def _port_student(kind, variables, **kwargs):
    pm = splittable_resnet({'key': KEYS[kind],
                            'kwargs': _bottleneck_kwargs(kind)},
                           stage_sizes=STAGES, num_classes=CLASSES,
                           device='cpu', **kwargs)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return pm.eval()


def _update(rt, kind):
    assert rt.update(scale_table=None if kind == 'fp' else SCALE_TABLE)
    rt.eval()
    rt.activate_analysis()
    return rt


def _images(n=N_IMAGES, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, (1, HW, HW, 3)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope='module', params=['fp', 'shp', 'mshp'])
def student(request):
    """(kind, JAX module, variables, port module) of a small student."""
    kind = request.param
    module = _jax_student(kind)
    variables = _variables(kind, module)
    return kind, module, variables, _port_student(kind, variables)


def _port_runtimes(kind, pm, **options):
    return (_update(SplitClassifierRuntime(pm, device='cpu'), kind),
            _update(SplitClassifierRuntime(pm, device='cpu', **options),
                    kind))


def _sizes(rt):
    return list(rt.analyzers[0].file_size_list)


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32
    assert int(np.argmax(got)) == int(np.argmax(want))
    np.testing.assert_allclose(got, want, rtol=0.1, atol=max(
        0.15, 0.01 * float(np.abs(want).max())))


# ---- the runtime's options -------------------------------------------------

def test_bf16_decode_wire_bytes_equal_and_logits_agree(student):
    """`deploy_bf16_decode`: the encoder's streams, states, lengths and
    metas are the float32 runtime's; the sizes are equal at batch 1 and
    `wire_batch=2`; no image escapes; a hyperprior's decoded y indexes
    equal the encoder's; the logits agree with the float32 runtime's and
    with JAX's `deploy_bf16_decode` runtime."""
    kind, module, variables, pm = student
    rt32, rt16 = _port_runtimes(kind, pm, deploy_bf16_decode=True)
    imgs = [_nchw(x) for x in _images()]
    for wire_batch in (None, 2):
        for rt in (rt32, rt16):
            rt.clear_analysis()
        out32 = rt32.stream_deploy_device(imgs, wire_batch=wire_batch)
        out16 = rt16.stream_deploy_device(imgs, wire_batch=wire_batch)
        assert _sizes(rt16) == _sizes(rt32) and len(_sizes(rt16)) == 4
        for a, b in zip(out32, out16):
            _close_logits(b, a)
    assert rt16.escapes == rt32.escapes == {'ok': 0, 'valid': 0}
    enc = 'encode_device_wire_hyper' if rt16.hyper else 'encode_device_wire'
    e32, e16 = getattr(rt32, enc)(imgs[0]), getattr(rt16, enc)(imgs[0])
    parts = ('z', 'y') if rt16.hyper else (None,)
    for part in parts:
        a, b = (e32, e16) if part is None else (e32[part], e16[part])
        for k in ('streams', 'states', 'lengths'):
            assert torch.equal(a[k], b[k]), (part, k)
    assert torch.equal(e32['meta'], e16['meta'])
    if rt16.hyper:
        z = e16['z']
        (_, _, _), (hz, wz, cz) = e16['shapes']
        cdf, cdf_len, off = rt16._tables_dev
        z_flat, valid = device_rans_decode(
            z['streams'], z['states'], cdf, cdf_len, off,
            n_symbols=hz * wz * cz, num_lanes=e16['lanes'][1],
            cyclic_channels=cz, aligned=z['aligned'], device=rt16.device)
        assert bool(valid)
        idx, _ = rt16._hyper_scales(z_flat.reshape(1, hz, wz, cz))
        want = rt16._hyper_ops(imgs[0])['y_indexes']
        assert torch.equal(idx, want.permute(0, 2, 3, 1))
    jrt = JaxRuntime(module, jax.tree.map(jnp.asarray, variables),
                     deploy_bf16_decode=True)
    jrt.update(scale_table=None if kind == 'fp' else SCALE_TABLE)
    jrt.eval()
    want = jrt.stream_deploy_device([jnp.asarray(x) for x in _images(2)],
                                    depth=2, workers=1)
    for got, w in zip(rt16.stream_deploy_device(imgs[:2]), want):
        _close_logits(got, w)


def _symbols(rt, x, module):
    """The symbols an encoder of `module` sends: FP's, or a hyperprior's
    z and y (with y's indexes), flat NHWC."""
    if rt.hyper:
        ops = rt._hyper_ops(x, rt._split_bottleneck(module))
        return {k: v.permute(0, 2, 3, 1).reshape(-1) for k, v in ops.items()}
    return {'symbols': rt._symbols_nhwc(x, module)[0].reshape(-1)}


def _decode_symbols(rt, ops):
    """Decode a batch-1 device-wire result to its symbols."""
    if not rt.hyper:
        cdf, cdf_len, off = rt._tables_dev
        flat, valid = device_rans_decode(
            ops['streams'], ops['states'], cdf, cdf_len, off,
            n_symbols=int(np.prod(ops['shape'])),
            num_lanes=rt._auto_wire_lanes(ops['shape']),
            cyclic_channels=ops['shape'][-1], device=rt.device)
        assert bool(valid)
        return {'symbols': flat.reshape(-1)}
    (hy, wy, cy), (hz, wz, cz) = ops['shapes']
    y_lanes, z_lanes = ops['lanes']
    cdf, cdf_len, off = rt._tables_dev
    z_flat, z_valid = device_rans_decode(
        ops['z']['streams'], ops['z']['states'], cdf, cdf_len, off,
        n_symbols=hz * wz * cz, num_lanes=z_lanes, cyclic_channels=cz,
        device=rt.device)
    idx, _ = rt._hyper_scales(z_flat.reshape(1, hz, wz, cz))
    g_cdf, g_len, g_off = rt._gtables_dev
    y_flat, y_valid = device_rans_decode(
        ops['y']['streams'], ops['y']['states'], g_cdf, g_len, g_off,
        n_symbols=hy * wy * cy, num_lanes=y_lanes, device=rt.device,
        indexes=idx.reshape(-1), prepared=rt._gprepared)
    assert bool(z_valid) and bool(y_valid)
    return {'z_symbols': z_flat.reshape(-1), 'y_symbols': y_flat.reshape(-1),
            'y_indexes': idx.reshape(-1)}


@pytest.mark.parametrize('kind', ['fp', 'shp'])
def test_bf16_encode_self_consistent_and_near_f32(kind):
    """`deploy_bf16_encode`: each stream decodes to exactly the symbols
    (and a hyperprior's indexes) that the bfloat16 encoder sent; at most
    1% of the symbols are one step from the float32 encoder's and none
    further; the wire within 1e-3 of the float32 wire's size; the served
    logits finite, of the float32 runtime's top-1 (a moved symbol moves
    the decoded feature by more than bfloat16 rounding); no escape."""
    module = _jax_student(kind)
    pm = _port_student(kind, _variables(kind, module))
    rt32, rte = _port_runtimes(kind, pm, deploy_bf16_decode=True,
                               deploy_bf16_encode=True)
    imgs = [_nchw(x) for x in _images()]
    moved = total = 0
    for x in imgs:
        sent = _symbols(rte, x, rte._encode_module())
        f32 = _symbols(rt32, x, rt32.module)
        enc = rte.encode_device_wire_hyper(x) if rte.hyper \
            else rte.encode_device_wire(x)
        got = _decode_symbols(rte, enc)
        for k, v in got.items():
            assert torch.equal(v, sent[k].to(v.dtype)), k
        for k in ('symbols', 'y_symbols', 'z_symbols'):
            if k in sent:
                d = (sent[k] - f32[k]).abs()
                assert int(d.max()) <= 1, k
                moved += int((d > 0).sum())
                total += d.numel()
    assert moved <= 0.01 * total, (moved, total)
    out32 = rt32.stream_deploy_device(imgs, wire_batch=2)
    oute = rte.stream_deploy_device(imgs, wire_batch=2)
    assert rte.escapes == {'ok': 0, 'valid': 0}
    assert abs(sum(_sizes(rte)) - sum(_sizes(rt32))) \
        <= 1e-3 * sum(_sizes(rt32)), (_sizes(rte), _sizes(rt32))
    for a, b in zip(out32, oute):
        assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
        assert int(b.argmax()) == int(a.argmax())


def test_bf16_tail_bytes_equal_and_logits_agree_with_jax():
    """`deploy_bf16_tail` on the host wire (`stream_deploy`, batch 1 and
    `decode_batch=2`, and `__call__`): sizes equal to the float32
    runtime's, logits close to it and to JAX's `deploy_bf16_tail`
    runtime."""
    module = _jax_student('fp')
    variables = _variables('fp', module)
    pm = _port_student('fp', variables)
    rt32, rtt = _port_runtimes('fp', pm, deploy_bf16_tail=True)
    imgs = [_nchw(x) for x in _images()]
    for decode_batch in (1, 2):
        for rt in (rt32, rtt):
            rt.clear_analysis()
        out32 = rt32.stream_deploy(imgs, decode_batch=decode_batch)
        outt = rtt.stream_deploy(imgs, decode_batch=decode_batch)
        assert _sizes(rtt) == _sizes(rt32)
        for a, b in zip(out32, outt):
            _close_logits(b, a)
    jrt = JaxRuntime(module, jax.tree.map(jnp.asarray, variables),
                     deploy_bf16_tail=True)
    jrt.update()
    jrt.eval()
    for x, nx in zip(imgs[:2], _images(2)):
        _close_logits(rtt(x), jrt(jnp.asarray(nx)))


def test_bf16_tail_copy_follows_the_weights():
    """The bfloat16 tail copy is made again after the weights change in
    place (a checkpoint loaded) and when the model is replaced: the
    output equals a fresh runtime's on the new weights."""
    v1 = _variables('fp', _jax_student('fp'))
    v2 = _randomize(v1, np.random.default_rng(99))
    x = _nchw(_images(1)[0])
    pm = _port_student('fp', v1)
    rt = _update(SplitClassifierRuntime(pm, device='cpu',
                                        deploy_bf16_tail=True), 'fp')
    first = rt(x)
    pm.load_state_dict(state_dict_from_flax(v2))
    rt.update()
    fresh = _update(SplitClassifierRuntime(_port_student('fp', v2),
                                           device='cpu',
                                           deploy_bf16_tail=True), 'fp')
    assert torch.equal(rt(x), fresh(x))
    assert not torch.equal(rt(x), first)
    rt.module = _port_student('fp', v1)
    rt.update()
    assert torch.equal(rt(x), first)


# ---- `dtype` of the models -------------------------------------------------

def test_float32_dtype_is_the_model_without_dtype():
    """`dtype='float32'` (or unset) gives the model's outputs bit for
    bit; the names resolve."""
    assert resolve_dtype(None) == resolve_dtype('float32') == torch.float32
    assert resolve_dtype('bfloat16') == torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype('float16')
    variables = _variables('fp', _jax_student('fp'))
    x = _nchw(_images(1)[0])
    a = _port_student('fp', variables)(x, mode='finetune')
    b = _port_student('fp', variables, dtype='float32')(x, mode='finetune')
    assert torch.equal(a, b)


def test_bf16_fp_student_agrees_with_jax():
    """The FP student with a bfloat16 tail and bottleneck (the JAX
    runtime's bfloat16 clone) against JAX's: 'finetune' logits."""
    module = _jax_student('fp')
    variables = _variables('fp', module)
    pm = _port_student('fp', variables, dtype='bfloat16')
    pm.bottleneck_layer.dtype = torch.bfloat16
    jbf = module.clone(dtype=jnp.bfloat16, bottleneck_layer=module
                       .bottleneck_layer.clone(dtype=jnp.bfloat16))
    x = _images(2)
    want = jax.jit(lambda v, x: jbf.apply(v, x, mode='finetune'))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(np.concatenate(x)))
    with torch.no_grad():
        got = pm(_nchw(np.concatenate(x)), mode='finetune')
    for g, w in zip(got, np.asarray(want)):
        _close_logits(g, w)


SEG_FP = {'key': 'FPBasedResNetBottleneck',
          'kwargs': {'num_bottleneck_channels': BCH,
                     'num_target_channels': 256}}


def test_bf16_deeplab_agrees_with_jax():
    """dtype='bfloat16' DeepLabv3 (stages, ASPP and heads in bfloat16,
    the bottleneck float32): float32 logits close to JAX's bfloat16
    model's, per-pixel predictions agreeing with it and with the float32
    model on more than 95% of the pixels."""
    def jax_model(dtype):
        return jax_create_deeplabv3(JaxSegBackbone(
            bottleneck_layer=jax_get_layer(SEG_FP['key'], **SEG_FP['kwargs']),
            stage_sizes=STAGES, return_aux=False, dtype=dtype), 5,
            dtype=dtype)

    def port_model(dtype):
        m = create_deeplabv3(SegmentationBackbone(
            get_layer(SEG_FP['key'], **SEG_FP['kwargs']), stage_sizes=STAGES,
            return_aux=False, dtype=dtype), 5, dtype=dtype)
        m.load_state_dict(state_dict_from_flax(variables, m), strict=True)
        return m.eval()

    j32 = jax_model(jnp.float32)
    shapes = jax.eval_shape(lambda: j32.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)), mode='train'))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(4))
    x = np.random.default_rng(0).normal(0, 0.25, (1, HW, HW, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jax_model(jnp.bfloat16).apply(
        v, x, mode='finetune'))(jax.tree.map(jnp.asarray, variables),
                                jnp.asarray(x))['out']
    with torch.no_grad():
        got = port_model('bfloat16')(_nchw(x), mode='finetune')['out']
        f32 = port_model(None)(_nchw(x), mode='finetune')['out']
    assert got.dtype == torch.float32
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0.1, atol=0.08 * max(
        1.0, float(np.abs(want).max())))
    pred = got.argmax(1).numpy()
    assert (pred == want.argmax(1)).mean() > 0.95
    assert (pred == f32.argmax(1).numpy()).mean() > 0.95


def test_bf16_detection_agrees_with_jax():
    """dtype='bfloat16' Faster R-CNN (the backbone's stages, FPN, RPN and
    box heads in bfloat16, box math in float32): the FPN features close to
    JAX's bfloat16 model's (atol 0.08, or 5% of a level's largest
    magnitude: the randomized FPN's features reach hundreds), float32 RPN
    and box-head outputs, finite float32 detections."""
    def jax_model(dtype):
        return jax_rcnn.FasterRCNN(backbone=JaxDetBackbone(
            bottleneck_layer=jax_get_layer(SEG_FP['key'], **SEG_FP['kwargs']),
            stage_sizes=STAGES, dtype=dtype), num_classes=5, dtype=dtype)

    j32 = jax_model(jnp.float32)
    shapes = jax.eval_shape(lambda: j32.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)), mode='train'))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(6))
    pm = rcnn.FasterRCNN(SplittableDetectionBackbone(
        get_layer(SEG_FP['key'], **SEG_FP['kwargs']), STAGES,
        dtype='bfloat16'), num_classes=5, dtype='bfloat16')
    pm.load_state_dict(state_dict_from_flax(variables, pm), strict=True)
    pm.eval()
    x = np.random.default_rng(0).normal(0, 0.25, (1, HW, HW, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jax_model(jnp.bfloat16).apply(
        v, x, method=lambda m, x: m.extract_features(x, mode='finetune')))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        out = pm(_nchw(x), mode='finetune')
        dets = rcnn.postprocess_detections(out)
    assert len(out['features']) == len(want)
    for g, w in zip(out['features'], want):
        w = np.asarray(w, np.float32).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0.1, atol=max(
            0.08, 0.05 * float(np.abs(w).max())))
    for k in ('objectness', 'rpn_deltas', 'class_logits', 'box_regression'):
        assert out[k].dtype == torch.float32, k
    assert dets['boxes'].dtype == torch.float32
    assert bool(torch.isfinite(dets['boxes']).all())


# ---- a bfloat16 stage-1 step -----------------------------------------------

def _jax_bench_train(monkeypatch):
    """The repository's script/bench_train.py, its models cut to stages
    (1, 1, 1, 1) and its persistent compilation cache left off."""
    monkeypatch.setattr(jax_cache, 'enable_persistent_cache',
                        lambda *a, **k: None)
    for module, name in ((jax_resnet_module, 'ResNet'),
                         (jax_backbone_module, 'SplittableResNet')):
        cls = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _cls=cls, **kw: _cls(
            *a, **{**kw, 'stage_sizes': STAGES}))
    spec = importlib.util.spec_from_file_location(
        'bench_train_script', REPO / 'script' / 'bench_train.py')
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def test_bf16_stage1_step_loss_equals_jax(monkeypatch):
    """One bfloat16 stage-1 `DistillationBox` step of the bench's models
    (teacher and FP-24 student, stages (1, 1, 1, 1), 1000 classes, batch
    2 at 32 px) from JAX's variables and the same noise: every loss term
    within rtol 5e-2 of JAX's."""
    script = _jax_bench_train(monkeypatch)
    monkeypatch.setattr(jax_factorized, 'quantize_noise', _jax_noise)
    monkeypatch.setattr(port_factorized, 'quantize_noise', _port_noise)
    jbox, x = script.build(jnp.bfloat16, 2, 32)
    box, _ = bench.build_train('bfloat16', 2, 32, torch.device('cpu'),
                               stage_sizes=STAGES)
    box.teacher.load_state_dict(state_dict_from_flax(
        jax.device_get(jbox.teacher_variables)))
    box.student.load_state_dict(state_dict_from_flax(
        jax.device_get(jbox.student_variables)))
    xr = np.random.default_rng(0).normal(0, 1, x.shape).astype(np.float32)
    want = jbox.train_step(jnp.asarray(xr), jnp.zeros((2,), jnp.int32),
                           jax.random.key(0))
    got = box.train_step(_nchw(xr), torch.zeros(2, dtype=torch.int64))
    assert got['loss'].keys() == want['loss'].keys()
    for k, v in want['loss'].items():
        np.testing.assert_allclose(float(got['loss'][k]), float(v),
                                   rtol=5e-2, err_msg=k)


# ---- the bench entry point -------------------------------------------------

TINY_BENCH = ['--device', 'cpu', '--image', '64', '--stage_sizes', '1', '1',
              '1', '1', '--bottleneck', '8', '--classes', '10',
              '--n_images', '2', '--n_iter', '2', '--n_trials', '1',
              '--loop_n', '1', '--fresh_n_iter', '2',
              '--throughput_wire_batch', '2', '--throughput_n_iter', '4',
              '--train_batch', '2', '--train_image', '32',
              '--train_steps', '1']
F32_REFERENCE = {'throughput_f32_device_ips', 'throughput_f32_mfu_vs_bf16_peak',
                 'train_f32_step_img_per_sec', 'train_f32_mfu_vs_bf16_peak'}


def _jax_bench_keys():
    """The keys of the JSON line of the repository's bench.py: the string
    keys of the dict that its `main` prints and of the dicts that the
    sections it spreads into that line return."""
    tree = ast.parse((REPO / 'bench.py').read_text())
    sections = {'bench_device_programs', 'bench_throughput_mode',
                'bench_train', '_throughput_bf16enc'}
    dicts = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if fn.name in sections and isinstance(node, ast.Return) \
                    and isinstance(node.value, ast.Dict):
                dicts.append(node.value)
            elif fn.name == 'main' and isinstance(node, ast.Call) \
                    and getattr(node.func, 'attr', None) == 'dumps':
                dicts.append(node.args[0])
    return {k.value for d in dicts for k in d.keys
            if isinstance(k, ast.Constant)}


def test_bench_line_has_the_jax_keys(capsys):
    """Every section at a tiny size on the CPU, with the float32
    references: the last line printed is the JSON line, with each key of
    the JAX bench's line, and `device`, `peak_bf16_flops`,
    `peak_bf16_source`, `flops_counted` and the float32 references beside
    them; no fallback backend; the MFU fields are null off the card."""
    line = bench.main(TINY_BENCH + ['--f32_reference'])
    import json
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == line
    want = _jax_bench_keys()
    assert len(want) == 40
    assert set(line) == want | F32_REFERENCE | {
        'device', 'peak_bf16_flops', 'peak_bf16_source', 'flops_counted'}
    assert line['device_wire_rans_backend'] == 'cpu-plain'
    assert line['vs_baseline'] is None \
        and line['baseline_ips_torch_cpu'] is None
    for k in ('deploy_device_mfu_vs_bf16_peak',
              'throughput_device_mfu_vs_bf16_peak',
              'throughput_bf16enc_mfu_vs_bf16_peak',
              'train_mfu_vs_bf16_peak', 'throughput_f32_mfu_vs_bf16_peak',
              'train_f32_mfu_vs_bf16_peak'):
        assert line[k] is None
    for k in ('deploy_program_gflops_per_image',
              'throughput_gflops_per_image', 'train_step_gflops'):
        assert line[k] > 0, k
    assert line['throughput_mode_wire_batch'] == 2
    assert line['value'] > 0 and line['train_step_img_per_sec'] > 0


def test_bench_section_failure_fails_the_run(monkeypatch):
    """A failing section is not swallowed: the run raises."""
    def broken(*args, **kwargs):
        raise RuntimeError('section failed')
    monkeypatch.setattr(bench, 'bench_serving', broken)
    with pytest.raises(RuntimeError, match='section failed'):
        bench.main(TINY_BENCH)
