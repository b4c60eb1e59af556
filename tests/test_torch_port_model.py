"""The PyTorch port's modules and deploy runtime against the JAX package.

One set of Flax variables, randomized with numpy, goes into the JAX
`SplitClassifierRuntime` and, through `state_dict_from_flax`, into the
port's runtime on the CPU (small widths: bottleneck 8, target 64, stages
(1, 1, 1, 1), 10 classes, 64 px). The coding tables must be bit-equal, and
`stream_deploy_device` must give equal per-image wire sizes, packed bytes
and data-size summaries, batch 1 and `wire_batch`. Logits agree within
rtol=atol=1e-4: the symbols are identical, so the decoder and tail see the
same input, and only float summation order differs between XLA:CPU and
PyTorch's CPU convolutions."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sc2bench_tpu.models.backbone import SplittableResNet as JaxResNet
from sc2bench_tpu.models.layer import FPBasedResNetBottleneck as JaxFP
from sc2bench_tpu.models.runtime import SplitClassifierRuntime as JaxRuntime
from sc2bench_tpu.ops.entropy.factorized import \
    EntropyBottleneck as JaxEntropyBottleneck
from sc2bench_tpu.ops.entropy.tables import \
    build_factorized_tables as jax_tables
from sc2bench_tpu.ops.gdn import GDN1 as JaxGDN
from sc2bench_tpu.utils.torch_convert import (SPLITTABLE_RESNET_RULES,
                                              convert_state_dict)
from sc2bench_tpu_torch.models.backbone import splittable_resnet
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.ops.entropy.factorized import EntropyBottleneck
from sc2bench_tpu_torch.ops.entropy.tables import build_factorized_tables
from sc2bench_tpu_torch.ops.gdn import GDN1
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax

BCH, TARGET, STAGES, CLASSES, HW = 8, 64, (1, 1, 1, 1), 10, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomize(tree, rng, path=()):
    """numpy values for every leaf of a Flax variable tree, by role:
    conv/dense kernels He-scaled, BN stats and affine near identity (bn3
    scales are NOT zero, unlike `zero_init_residual`), GDN stored values
    near their init, and entropy-bottleneck quantiles with nonzero
    medians."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, p)
            continue
        shape = tuple(v.shape)
        if k == 'kernel':
            a = rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
        elif k in ('scale', 'var'):
            a = rng.uniform(0.5, 1.5, shape)
        elif k == 'mean':
            a = rng.normal(0, 0.1, shape)
        elif k == 'beta':
            a = rng.uniform(0.9, 1.1, shape)
        elif k == 'gamma':
            a = np.sqrt(0.1 * np.eye(shape[0])
                        + rng.uniform(0, 0.01, shape))
        elif k == 'quantiles':
            med = rng.uniform(-0.4, 0.4, shape[0])
            a = np.stack([med - rng.uniform(7, 10, shape[0]), med,
                          med + rng.uniform(7, 10, shape[0])],
                         axis=-1)[:, None, :]
        elif k.startswith('matrix_'):
            a = rng.normal(0.0, 0.2, shape) + 0.4
        elif k.startswith('bias_'):
            a = rng.uniform(-0.5, 0.5, shape)
        elif k.startswith('factor_'):
            a = rng.normal(0, 0.2, shape)
        else:                                   # BN / dense bias
            a = rng.normal(0, 0.05, shape)
        out[k] = np.asarray(a, np.float32)
    return out


@pytest.fixture(scope='module')
def models():
    fm = JaxResNet(bottleneck_layer=JaxFP(num_bottleneck_channels=BCH,
                                          num_target_channels=TARGET),
                   stage_sizes=STAGES, num_classes=CLASSES)
    shapes = jax.eval_shape(
        lambda: fm.init({'params': jax.random.key(0),
                         'noise': jax.random.key(1)},
                        jnp.zeros((1, HW, HW, 3)), mode='train'))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(7))
    jrt = JaxRuntime(fm, jax.tree.map(jnp.asarray, variables))
    assert jrt.update()
    jrt.eval()
    pm = splittable_resnet(
        {'key': 'FPBasedResNetBottleneck',
         'kwargs': {'num_bottleneck_channels': BCH,
                    'num_target_channels': TARGET}},
        stage_sizes=STAGES, num_classes=CLASSES, device='cpu')
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    prt = SplitClassifierRuntime(pm, device='cpu')
    assert prt.update()
    prt.eval()
    rng = np.random.default_rng(11)
    images = [(rng.normal(0, 0.5, (1, HW, HW, 3))).astype(np.float32)
              for _ in range(3)]
    return variables, jrt, prt, images


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_state_dict_round_trips_through_torch_convert(models):
    """state_dict_from_flax is the inverse of the JAX package's own
    torch -> Flax conversion on every parameter and statistic."""
    variables, _, prt, _ = models
    back = convert_state_dict(prt.module.state_dict(),
                              SPLITTABLE_RESNET_RULES)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for k, a in flat_a.items():
        np.testing.assert_array_equal(a, flat_b[k], err_msg=str(k))


def test_coding_tables_bit_equal(models):
    variables, jrt, prt, _ = models
    jt, pt = jrt.codec.tables, prt.codec.tables
    for k in ('quantized_cdf', 'cdf_length', 'offset', 'medians'):
        np.testing.assert_array_equal(getattr(jt, k), getattr(pt, k), k)


@pytest.mark.parametrize('seed', [0, 1])
def test_factorized_tables_bit_equal_fresh_and_perturbed(seed):
    """build_factorized_tables from one parameter set: fresh init (seed 0)
    and perturbed parameters (seed 1)."""
    eb = EntropyBottleneck(24)
    if seed:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for p in eb.parameters():
                p.add_(torch.from_numpy(
                    rng.normal(0, 0.3, tuple(p.shape)).astype(np.float32)))
    pt = build_factorized_tables(eb)
    jt = jax_tables(JaxEntropyBottleneck(channels=24),
                    {'params': eb.numpy_params()})
    for k in ('quantized_cdf', 'cdf_length', 'offset', 'medians'):
        np.testing.assert_array_equal(getattr(jt, k), getattr(pt, k), k)


@pytest.mark.parametrize('inverse', [False, True])
def test_gdn_equals_jax(inverse):
    rng = np.random.default_rng(3)
    c = 16
    x = rng.normal(0, 1, (2, 9, 7, c)).astype(np.float32)
    beta = rng.uniform(0.9, 1.1, c).astype(np.float32)
    gamma = np.sqrt(0.1 * np.eye(c)
                    + rng.uniform(0, 0.02, (c, c))).astype(np.float32)
    ref = JaxGDN(c, inverse=inverse).apply(
        {'params': {'beta': beta, 'gamma': gamma}}, jnp.asarray(x))
    g = GDN1(c, inverse=inverse)
    with torch.no_grad():
        g.beta.copy_(torch.from_numpy(beta))
        g.gamma.copy_(torch.from_numpy(gamma))
        got = g(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


def _deploy(rt, images, **kw):
    rt.clear_analysis()
    rt.activate_analysis()
    out = rt.stream_deploy_device(images, **kw)
    sizes = list(rt.analyzers[0].file_size_list)
    summary = rt.summarize()
    rt.deactivate_analysis()
    return [np.asarray(o) for o in out], sizes, summary


@pytest.mark.parametrize('kw', [{}, {'wire_batch': 2}, {'wire_batch': 3}],
                         ids=['batch1', 'wire_batch2', 'wire_batch3'])
def test_stream_deploy_device_equals_jax(models, kw):
    _, jrt, prt, images = models
    j_logits, j_sizes, j_summary = _deploy(
        jrt, [jnp.asarray(x) for x in images], depth=2, workers=1, **kw)
    p_logits, p_sizes, p_summary = _deploy(
        prt, [_nchw(x) for x in images], depth=2, **kw)
    assert p_sizes == j_sizes
    assert p_summary == j_summary
    for a, b in zip(j_logits, p_logits):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_packed_wire_bytes_equal_jax(models):
    _, jrt, prt, images = models
    for x in images[:2]:
        j_ops = jrt.encode_device_wire(jnp.asarray(x))
        p_ops = prt.encode_device_wire(_nchw(x))
        j_wire = jrt._pull_device_wire(j_ops)
        p_wire = prt._pull_device_wire(p_ops)
        assert p_wire == j_wire
        assert np.asarray(p_ops['meta']).tolist() == \
            np.asarray(j_ops['meta']).tolist()
    # pull_wire accounts the real packed bytes: same summary as JAX
    _, j_sizes, _ = _deploy(jrt, [jnp.asarray(x) for x in images],
                            pull_wire=True)
    _, p_sizes, _ = _deploy(prt, [_nchw(x) for x in images],
                            pull_wire=True)
    assert p_sizes == j_sizes


def test_uint8_input_norm_equals_float_path(models):
    """uint8 images through `input_norm` code exactly like the same
    normalization done by the caller in float32."""
    _, _, prt, _ = models
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    rt = SplitClassifierRuntime(prt.module, input_norm=(mean, std),
                                device='cpu')
    rt.update()
    img = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, 3, HW, HW), dtype=np.uint8))
    ref = (img.float() / 255.0 - torch.tensor(mean)[:, None, None]) \
        / torch.tensor(std)[:, None, None]
    a = rt._pull_device_wire(rt.encode_device_wire(img))
    b = rt._pull_device_wire(rt.encode_device_wire(ref))
    assert a == b
    with pytest.raises(ValueError, match='input_norm'):
        prt.encode_device_wire(img)


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = {'key': 'FPBasedResNetBottleneck',
           'kwargs': {'num_bottleneck_channels': 4,
                      'num_target_channels': 16}}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        splittable_resnet(cfg, stage_sizes=STAGES, num_classes=3)
    model = splittable_resnet(cfg, stage_sizes=STAGES, num_classes=3,
                              device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        SplitClassifierRuntime(model)
    assert SplitClassifierRuntime(model, device='cpu').device.type == 'cpu'


_BLOCK_JAX = r'''
import importlib, json, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sc2bench_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
'''
_NO_JAX_IMPORTED = r'''
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sc2bench_tpu')]
assert not bad, bad
'''


def _run_with_jax_blocked(body: str) -> str:
    """Run `body` in a fresh interpreter with jax, flax and sc2bench_tpu
    blocked, then check that none of them was imported; its stdout. One
    thread: the suite runs this beside other workers."""
    out = subprocess.run(
        [sys.executable, '-c', _BLOCK_JAX + body + _NO_JAX_IMPORTED],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, 'OMP_NUM_THREADS': '1'})
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of sc2bench_tpu_torch imports with jax, flax and
    sc2bench_tpu blocked, and the classification CLI tests, and trains
    then tests, a config that lists the JAX package's modules as
    dependencies; with an MSHP student it tests on the device wire. The
    other families and tasks run blocked in the two tests below."""
    out = _run_with_jax_blocked(r'''
import sc2bench_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    sc2bench_tpu_torch.__path__, 'sc2bench_tpu_torch.')]
for n in names:
    importlib.import_module(n)
from sc2bench_tpu_torch.tasks.image_classification import main
small = {'stage_sizes': [1, 1, 1, 1]}
over = {'models': {'teacher_model': {'key': 'resnet', 'kwargs': small},
                   'student_model': {'kwargs': small}}}
for extra in (['-test_only'], []):
    out = main(['--config', 'configs/sample/tiny_entropic_student.yaml',
                '--json', json.dumps(over), '-student_only', '--device',
                'cpu', *extra])
    assert out['summaries'][0]['num_samples'] == 4, out
assert out['best'] is not None
mshp = {'key': 'MSHPBasedResNetBottleneck',
        'kwargs': {'num_bottleneck_channels': 8, 'num_target_channels': 256,
                   'num_latent_channels': 4}}
over['models']['student_model'] = {
    'kwargs': {**small, 'bottleneck_config': mshp}}
out = main(['--config', 'configs/sample/tiny_entropic_student.yaml',
            '--json', json.dumps({**over, 'deploy_wire': 'device'}),
            '-student_only', '-test_only', '--device', 'cpu'])
assert out['engine'].runtime.hyper, out
assert out['summaries'][0]['num_samples'] == 4, out
print(len(names))
''')
    assert int(out.strip().splitlines()[-1]) >= 36


def test_port_families_run_with_jax_blocked():
    """With jax, flax and sc2bench_tpu blocked: a fine-tuning config
    (EntropicClassifier on a small ResNet) tests on the host wire and a
    CR+BQ config (larger_resnet_bottleneck, which lists
    `sc2bench_tpu.transforms`) trains one step then tests; two
    input-compression configs (JPEG, and the joint autoregressive codec
    at n = m = 8) test through their wrappers; a RegNet FP config (a small
    RegNet registered in the port) tests, and a small hybrid ViT (student
    and teacher) and EfficientNet run; a small ResNeSt (student and
    teacher), a DenseNet-169 student, the hub twin's Inception-v3
    bottleneck and `splittable_inception_v3` build and run."""
    _run_with_jax_blocked(r'''
import json
from sc2bench_tpu_torch.tasks.image_classification import main
small = {'stage_sizes': [1, 1, 1, 1]}
from sc2bench_tpu_torch.models import resnet
resnet.RESNET_BUILDERS['resnet_small'] = (
    lambda **kw: resnet.ResNet((1, 1, 1, 1), **kw))
family = 'configs/ilsvrc2012/supervised_compression/'
synthetic = {'dataset': {'key': 'SyntheticClassificationDataset',
                         'kwargs': {'num_samples': 2, 'image_size': [64, 64],
                                    'num_classes': 10}}, 'batch_size': 1}
ft = {'models': {'model': {'kwargs': {'base_name': 'resnet_small',
                                      'num_classes': 10}}},
      'test': {'test_data_loader': synthetic}}
out = main(['--config', family + 'fine-tuning/'
            'resnet50-eb_after_avgpool-beta1.0e-4.yaml', '--json',
            json.dumps(ft), '-test_only', '--device', 'cpu'])
assert out['summaries'][0]['num_samples'] == 2, out
small = {**small, 'num_classes': 10}
bq = {'models': {'teacher_model': {'key': 'resnet', 'kwargs': small},
                 'student_model': {'kwargs': small}},
      'train': {'train_data_loader': {**synthetic, 'batch_size': 2},
                'val_data_loader': synthetic, 'stage1': {'num_epochs': 1}},
      'test': {'test_data_loader': synthetic}}
out = main(['--config', family + 'ghnd-bq/resnet50-bq1ch_from_resnet50.yaml',
            '--json', json.dumps(bq), '-student_only', '--device', 'cpu'])
assert out['engine'].runtime.codec is None, out
assert out['summaries'][0]['num_samples'] == 0, out
wrapped = {'classification_model': {'key': 'resnet_small',
                                    'kwargs': {'num_classes': 10}}}
for cfg, codec in (('jpeg-resnet50', None),
                   ('joint_autoregressive_hierarchical_prior-resnet50',
                    {'kwargs': {'n': 8, 'm': 8}})):
    if codec:
        wrapped['compression_model'] = codec
    out = main(['--config', 'configs/ilsvrc2012/input_compression/'
                + cfg + '.yaml', '--json', json.dumps({
                    'models': {'wrapper': wrapped},
                    'test': {'test_data_loader': synthetic}}),
                '-test_only', '--device', 'cpu'])
    assert out['summaries'][0]['num_samples'] == 2, out
import torch
from sc2bench_tpu_torch.models import efficientnet, hybrid_vit, regnet
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.registry import register_model
@register_model(name='regnet_small')
def regnet_small(bottleneck_config, num_classes=10, device=None, **kw):
    return regnet.SplittableRegNet(
        get_layer(bottleneck_config['key'], **bottleneck_config['kwargs']),
        (48, 64, 80), (1, 1, 1), 8, num_classes)
@register_model(name='regnet_teacher_small')
def regnet_teacher_small(num_classes=10, device=None, **kw):
    return regnet.RegNet((32, 48, 64, 80), (1, 1, 1, 1), 8, num_classes)
fp = {'key': 'FPBasedResNetBottleneck',
      'kwargs': {'num_bottleneck_channels': 8,
                 'encoder_channel_sizes': [3, 8, 8, 8],
                 'decoder_channel_sizes': [8, 32, 32, 32]}}
rg = {'allow_missing_teacher': True,
      'models': {'teacher_model': {'key': 'regnet_teacher_small'},
                 'student_model': {'key': 'regnet_small', 'kwargs': {
                     'num_classes': 10, 'bottleneck_config': fp}}},
      'test': {'test_data_loader': synthetic}}
out = main(['--config', family + 'entropic_student/splitable_regnety6.4gf-'
            'fp-beta0.08_from_regnety6.4gf.yaml', '--json', json.dumps(rg),
            '-test_only', '--device', 'cpu'])
assert out['summaries'][0]['num_samples'] == 2, out
fp['kwargs']['decoder_channel_sizes'] = [8, 32, 256, 256]
x = torch.zeros(1, 3, 64, 64)
with torch.no_grad():
    vit = hybrid_vit.SplittableHybridViT(
        get_layer(fp['key'], **fp['kwargs']), 64, 1, 2, 10, image_size=64)
    assert vit.eval()(x, mode='finetune').shape == (1, 10)
    for m in (hybrid_vit.HybridViT(64, 1, 2, 10, image_size=64),
              efficientnet.EfficientNet(0.25, 0.1, 10)):
        assert m.eval()(x).shape == (1, 10)
from sc2bench_tpu_torch import hubconf
from sc2bench_tpu_torch.models import inception, resnest
from sc2bench_tpu_torch.models.backbone import get_backbone
fp['kwargs']['decoder_channel_sizes'] = [8, 32, 256, 256]
with torch.no_grad():
    rs = resnest.SplittableResNeSt(get_layer(fp['key'], **fp['kwargs']),
                                   (1, 1, 1, 1), 10)
    assert rs.eval()(x, mode='finetune').shape == (1, 10)
    assert resnest.ResNeSt((1, 1, 1, 1), 10).eval()(x).shape == (1, 10)
    dn = get_backbone('splittable_densenet', bottleneck_config={
        'key': 'larger_densenet_bottleneck', 'kwargs': {}}, device='cpu')
    assert dn.eval()(x, mode='finetune').shape == (1, 1000)
    iv = hubconf.custom_inception_v3(device='cpu')
    assert iv.eval()(torch.zeros(1, 3, 75, 75)).shape == (1, 192, 7, 7)
    assert isinstance(inception.splittable_inception_v3(
        {'key': 'inception_v3_bottleneck'}, device='cpu'),
        inception.SplittableInceptionV3)
''')


def test_port_segmentation_and_detection_run_with_jax_blocked():
    """With jax, flax and sc2bench_tpu blocked: the segmentation CLI
    trains then tests `tiny_segmentation.yaml`, and tests it on the device
    wire; the detection CLI tests `tiny_detection.yaml` on the device
    wire; the scale-out modules (process group, profiler, serving pool)
    import."""
    _run_with_jax_blocked(r'''
import sc2bench_tpu_torch.models.serving_pool
import sc2bench_tpu_torch.parallel.dist
import sc2bench_tpu_torch.utils.profiling
from sc2bench_tpu_torch.tasks.semantic_segmentation import main as seg_main
tiny_seg = 'configs/sample/tiny_segmentation.yaml'
out = seg_main(['--config', tiny_seg, '--device', 'cpu'])
assert out['best'] is not None and out['summaries'][0]['num_samples'] == 2
out = seg_main(['--config', tiny_seg, '--json', '{"deploy_wire": "device"}',
                '-test_only', '--device', 'cpu'])
assert out['summaries'][0]['num_samples'] == 2, out
from sc2bench_tpu_torch.tasks.object_detection import main as det_main
out = det_main(['--config', 'configs/sample/tiny_detection.yaml', '--json',
                '{"deploy_wire": "device"}', '-test_only', '--device', 'cpu'])
assert out['summaries'][0]['num_samples'] == 2, out
assert 0.0 <= out['result']['AP'] <= 1.0, out
''')
