"""The port's PASCAL VOC segmentation (DeepLabv3 on the dilated ResNet, its
split runtime on both wires, the evaluator, the collators and the data)
against the JAX package on the CPU.

Small size: stages (1, 1, 1, 1), an FP bottleneck of 8 channels (target
64), 5 classes, 64 px. One set of Flax variables randomized with numpy
(`test_torch_port_model._randomize`) goes into both packages, into the
port through `state_dict_from_flax`. Tolerances, relative and of each
tensor's largest magnitude (`_close`): the dilated stages and the heads
1e-5, the upsampled logits 1e-4 (at 64x64, 72x56 and 66x50, whose 9x7
'out' map upsamples by a non-integer ratio), decoded logits 1e-4 (the same
symbols: only float sums differ). Symbols from each side's own encoder
must match with no mismatch at this size; host-wire bytes, device-wire
streams (the kernels' plain versions) and every data size are equal.
The 29 VOC configs the port builds and `tiny_segmentation.yaml` build on
the meta device, and the full-width parameter counts equal JAX's.

The small DeepLabv3 registers as `deeplabv3_small` in both packages'
model registries (`small_deeplabv3`), which
`test_torch_port_segmentation_train.py` shares.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.registry as jax_registry
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.datasets.voc import PairedSegTransforms as JaxPaired
from sc2bench_tpu.datasets.voc import \
    SyntheticSegmentationDataset as JaxSynthetic
from sc2bench_tpu.models.layer import get_layer as jax_get_layer
from sc2bench_tpu.models.resnet import ResNetStage as JaxStage
from sc2bench_tpu.models.segmentation.base import \
    SegmentationBackboneFeatures as JaxBackbone
from sc2bench_tpu.models.segmentation.deeplabv3 import ASPP as JaxASPP
from sc2bench_tpu.models.segmentation.deeplabv3 import \
    create_deeplabv3 as jax_create
from sc2bench_tpu.models.segmentation.wrapper import \
    SplitSegmentationRuntime as JaxSegRuntime
from sc2bench_tpu.transforms import collator as jax_collator
from sc2bench_tpu.utils.seg_eval import SegEvaluator as JaxSegEvaluator
import sc2bench_tpu_torch.registry as port_registry
from sc2bench_tpu_torch.analysis import get_binary_object_size
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.datasets.voc import (PairedSegTransforms,
                                             SyntheticSegmentationDataset)
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.models.resnet import ResNetStage
from sc2bench_tpu_torch.models.segmentation.base import SegmentationBackbone
from sc2bench_tpu_torch.models.segmentation.deeplabv3 import (
    create_deeplabv3, deeplabv3_model)
from sc2bench_tpu_torch.models.segmentation.registry import \
    load_segmentation_model
from sc2bench_tpu_torch.models.segmentation.wrapper import \
    SplitSegmentationRuntime
from sc2bench_tpu_torch.ops.rans.device import (device_rans_encode,
                                                pack_stream_aligned)
from sc2bench_tpu_torch.transforms import collator
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax
from sc2bench_tpu_torch.utils.seg_eval import SegEvaluator
from test_torch_port_model import _randomize

REPO = Path(__file__).resolve().parents[1]
VOC = REPO / 'configs/pascal_voc2012'
STAGES, CLASSES, HW, BCH, TARGET = (1, 1, 1, 1), 5, 64, 8, 64
SMALL = 'deeplabv3_small'
FP = {'key': 'FPBasedResNetBottleneck',
      'kwargs': {'num_bottleneck_channels': BCH,
                 'num_target_channels': TARGET}}
BQ = {'key': 'larger_resnet_bottleneck',
      'kwargs': {'bottleneck_channel': 3, 'output_channel': TARGET}}
# the VOC configs the port builds: all but the two that need the BPG
# binary
CONFIGS = sorted(p for p in VOC.rglob('*.yaml')
                 if not p.name.startswith('bpg-')) \
    + [REPO / 'configs/sample/tiny_segmentation.yaml']


# ---- the small model, under one name in both packages -----------------------

def jax_small(bottleneck_config=None, num_classes=CLASSES, uses_aux=False,
              **kwargs):
    bneck = jax_get_layer(bottleneck_config['key'],
                          **bottleneck_config.get('kwargs', {})) \
        if bottleneck_config else None
    return jax_create(JaxBackbone(bottleneck_layer=bneck, stage_sizes=STAGES,
                                  return_aux=uses_aux),
                      num_classes, uses_aux)


def port_small(bottleneck_config=None, num_classes=CLASSES, uses_aux=False,
               device=None, **kwargs):
    bneck = get_layer(bottleneck_config['key'],
                      **bottleneck_config.get('kwargs', {})) \
        if bottleneck_config else None
    return create_deeplabv3(SegmentationBackbone(
        bneck, stage_sizes=STAGES, return_aux=uses_aux), num_classes,
        uses_aux).to(device)


def register_small(mp):
    mp.setitem(jax_registry._registry('model'), SMALL, jax_small)
    mp.setitem(port_registry._registry('model'), SMALL, port_small)


@pytest.fixture
def small_deeplabv3(monkeypatch):
    register_small(monkeypatch)


def seg_variables(module, seed, hw=(HW, HW)):
    """Randomized Flax variables of a JAX segmentation model."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, *hw, 3)), mode='train'))
    return _randomize({'params': shapes['params'],
                       'batch_stats': shapes['batch_stats']},
                      np.random.default_rng(seed))


def port_of(variables, bottleneck_config=None, uses_aux=False):
    pm = port_small(bottleneck_config, uses_aux=uses_aux, device='cpu')
    pm.load_state_dict(state_dict_from_flax(variables, pm), strict=True)
    return pm.eval()


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(
        1.0, float(np.abs(want).max())))


def images(seed, n, hw=(HW, HW), scale=0.5):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, (1, *hw, 3)).astype(np.float32)
            for _ in range(n)]


# ---- the modules ------------------------------------------------------------

def test_dilated_stages_equal_jax():
    """layer3 (dilate from 1) and layer4 (from 2) of three blocks: the
    dilations (1, 2, 2) and (2, 4, 4), stride 1, and the features within
    1e-5 of JAX's stages on the same weights."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 9, 7, 512)).astype(np.float32)
    for filters, dilation, want_dil in ((256, 1, (1, 2, 2)),
                                        (512, 2, (2, 4, 4))):
        jm = JaxStage(filters, 3, strides=2, dilation=dilation, dilate=True)
        cin = x.shape[-1]
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                                jnp.asarray(x)))
        variables = _randomize({'params': shapes['params'],
                                'batch_stats': shapes['batch_stats']}, rng)
        want = jm.apply(variables, jnp.asarray(x))
        pm = ResNetStage(cin, filters, 3, strides=2, dilation=dilation,
                         dilate=True)
        state = state_dict_from_flax({
            coll: {'layer3': tree} for coll, tree in variables.items()})
        pm.load_state_dict({k[len('layer3.'):]: v for k, v in state.items()},
                           strict=True)
        assert tuple(b.conv2.dilation[0] for b in pm) == want_dil
        assert all(b.conv2.stride == (1, 1) for b in pm)
        assert pm[0].downsample[0].stride == (1, 1)
        with torch.no_grad():
            got = pm.eval()(nchw(x))
        assert got.shape[-2:] == x.shape[1:3]
        close(nhwc(got), want, 1e-5)
        x = np.asarray(want)


@pytest.fixture(scope='module')
def aux_models():
    """A JAX DeepLabv3 with the FP bottleneck and the aux head, its
    randomized variables, and the port's model on them."""
    jm = jax_small(FP, uses_aux=True)
    variables = seg_variables(jm, 5)
    return jm, variables, port_of(variables, FP, uses_aux=True)


def test_heads_equal_jax(aux_models):
    """ASPP, DeepLabHead and FCNHead on the same features within 1e-5;
    torchvision's key space (no Dropout at its indices); the backbone's
    'out' at stride 8."""
    jm, variables, pm = aux_models
    rng = np.random.default_rng(9)
    f4 = rng.normal(0, 1, (1, 8, 8, 2048)).astype(np.float32)
    f3 = rng.normal(0, 1, (1, 8, 8, 1024)).astype(np.float32)
    v = jax.tree.map(jnp.asarray, variables)
    aspp = {coll: v[coll]['classifier']['aspp'] for coll in v}
    want = {'aspp': JaxASPP().apply(aspp, jnp.asarray(f4)),
            'head': jm.apply(v, jnp.asarray(f4),
                             method=lambda m, f: m.classifier(f)),
            'aux': jm.apply(v, jnp.asarray(f3),
                            method=lambda m, f: m.aux_classifier(f))}
    with torch.no_grad():
        got = {'aspp': pm.classifier[0](nchw(f4)),
               'head': pm.classifier(nchw(f4)),
               'aux': pm.aux_classifier(nchw(f3))}
    for k in want:
        close(nhwc(got[k]), want[k], 1e-5)
    keys = set(pm.state_dict())
    assert {'classifier.0.convs.4.1.weight', 'classifier.0.project.1.bias',
            'classifier.4.bias', 'aux_classifier.4.weight'} <= keys
    assert not any(isinstance(m, torch.nn.Dropout) for m in pm.modules())
    with torch.no_grad():
        feats = pm.backbone(torch.zeros(1, 3, HW, HW), mode='finetune')
    assert feats['out'].shape[-2:] == (HW // 8, HW // 8)


@pytest.mark.parametrize('hw', [(64, 64), (72, 56), (66, 50)],
                         ids=lambda hw: f'{hw[0]}x{hw[1]}')
def test_logits_equal_jax(aux_models, hw):
    """The 'finetune' forward: 'out' and 'aux' logits upsampled to the
    input's size within 1e-4 of JAX's (bilinear, half-pixel centres), the
    same argmax."""
    jm, variables, pm = aux_models
    x = images(11, 1, hw)[0]
    want = jm.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x),
                    mode='finetune', train=False)
    with torch.no_grad():
        got = pm(nchw(x), mode='finetune')
    assert got.keys() == want.keys() == {'out', 'aux'}
    for k in got:
        assert got[k].shape == (1, CLASSES, *hw)
        close(nhwc(got[k]), want[k], 1e-4)
    assert (nhwc(got['out']).argmax(-1)
            == np.asarray(want['out']).argmax(-1)).mean() > 0.999


@pytest.mark.parametrize('batch', [1, 2])
def test_train_mode_batchnorm_equals_flax(batch):
    """BatchNorm in train mode everywhere, ASPP's pooled branch over
    `batch` values a channel (1: torch's own op would raise; Flax gives a
    zero variance): logits and the updated statistics within 1e-4 of
    JAX's."""
    jm = jax_small(None)
    variables = seg_variables(jm, 21)
    pm = port_of(variables)
    x = np.concatenate(images(22, batch))
    want, state = jm.apply(jax.tree.map(jnp.asarray, variables),
                           jnp.asarray(x), train=True,
                           mutable=['batch_stats'])
    pm.train()
    with torch.no_grad():
        got = pm(nchw(x))
    close(nhwc(got['out']), want['out'], 1e-4)
    stats = state_dict_from_flax({'params': variables['params'],
                                  'batch_stats': jax.device_get(
                                      state['batch_stats'])})
    for k, v in pm.state_dict().items():
        if 'running' in k:
            close(v.numpy(), stats[k].numpy(), 1e-4)


def test_full_width_parameter_counts_equal_jax():
    """`deeplabv3_model` at full width, ResNet-50 and -101, with and
    without the FP-24 bottleneck and the aux head: the parameter count of
    JAX's (`jax.eval_shape`), and the buffers its BatchNorm statistics."""
    from sc2bench_tpu.models.segmentation.deeplabv3 import \
        deeplabv3_model as jax_builder
    fp24 = {'key': 'FPBasedResNetBottleneck',
            'kwargs': {'num_bottleneck_channels': 24,
                       'num_target_channels': 256}}
    for name, bneck, aux in (('resnet50', None, True),
                             ('resnet50', fp24, True),
                             ('resnet101', None, False),
                             ('resnet101', fp24, False)):
        kw = dict(bottleneck_config=bneck, backbone_name=name,
                  num_classes=21, uses_aux=aux)
        jm = jax_builder(**kw)
        shapes = jax.eval_shape(lambda: jm.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, 64, 64, 3)), mode='train'))
        want = sum(int(np.prod(a.shape))
                   for a in jax.tree.leaves(shapes['params']))
        with torch.device('meta'):
            pm = deeplabv3_model(device='meta', **kw)
        assert sum(p.numel() for p in pm.parameters()) == want, (name, bneck)
        n_stats = sum(int(np.prod(a.shape))
                      for a in jax.tree.leaves(shapes['batch_stats']))
        assert sum(b.numel() for k, b in pm.named_buffers()
                   if 'running' in k) == n_stats


@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: p.stem)
def test_config_builds_in_the_port(path):
    """The config's student, model or wrapped segmentation model built by
    `load_segmentation_model` on the meta device: DeepLabv3 with the
    config's backbone depth, bottleneck, classes and aux head; the runtime
    branch a student takes (a codec for FP, none for CR+BQ)."""
    cfg = load_config(path)
    models = cfg['models']
    spec = models.get('student_model', models.get('model')) \
        or models['wrapper']['segmentation_model']
    with torch.device('meta'):
        model = load_segmentation_model({**spec, 'ckpt': None},
                                        device='meta')
    kw = spec['kwargs']
    assert model.classifier[4].out_channels == kw['num_classes']
    assert (model.aux_classifier is not None) == kw.get('uses_aux', False)
    depth = {'resnet50': 6, 'resnet101': 23}[kw['backbone_name']]
    assert len(model.backbone.layer3) == depth
    bneck = kw.get('bottleneck_config')
    if bneck is None:
        assert model.backbone.bottleneck_layer is None
        assert 'wrapper' in models or spec is models.get('teacher_model')
        return
    with torch.device('meta'):
        rt = SplitSegmentationRuntime(model, device='meta')
    if bneck['key'] == 'FPBasedResNetBottleneck':
        assert model.backbone.bottleneck_layer.entropy_bottleneck \
            .quantiles.shape[0] == bneck['kwargs']['num_bottleneck_channels']
        assert rt.codec is not None
    else:
        assert model.backbone.bottleneck_layer.encoder.out_channels \
            == bneck['kwargs']['bottleneck_channel']
        assert rt.codec is None and not rt.update()


# ---- the split runtime -------------------------------------------------------

@pytest.fixture(scope='module')
def runtimes():
    """(JAX model, variables, JAX runtime, port runtime), tables built."""
    jm = jax_small(FP)
    variables = seg_variables(jm, 31)
    jrt = JaxSegRuntime(jm, jax.tree.map(jnp.asarray, variables))
    assert jrt.update()
    jrt.eval()
    prt = SplitSegmentationRuntime(port_of(variables, FP), device='cpu')
    assert prt.update()
    prt.eval()
    return jm, variables, jrt, prt


def _shapes_list():
    """Two 64x64 images, then two 104x96: a shape change inside the list
    (and in the lane count), a group of each at wire_batch=2."""
    return images(41, 2) + images(42, 2, (104, 96))


def test_symbols_and_host_wire_equal_jax(runtimes):
    """Each side's own encoder gives the same symbols (0 mismatches at
    this size); on shared symbols the cyclic int16 host wire's strings are
    byte-equal, and `__call__` accounts what JAX's does."""
    _, _, jrt, prt = runtimes
    for x in _shapes_list():
        want = jrt._encode_device(jnp.asarray(x))['symbols']
        got = prt.encode_device(nchw(x))['symbols']
        assert got.dtype == torch.int16
        assert int((got.numpy() != np.asarray(want)).sum()) == 0
        sym = np.asarray(want)
        assert prt.codec.compress_wire(sym) == jrt.codec.compress_wire(sym)
    x = _shapes_list()[2]
    for rt in (jrt, prt):
        rt.clear_analysis()
        rt.activate_analysis()
    want = jrt(jnp.asarray(x))
    got = prt(nchw(x))
    assert prt.summarize() == jrt.summarize()
    close(nhwc(got), want, 1e-4)
    for rt in (jrt, prt):
        rt.deactivate_analysis()


def _jax_wire(ops, j=None):
    """JAX's packed wire of a batch-1 encode result, or of image `j` of a
    vmapped one."""
    from sc2bench_tpu.ops.rans.device import pack_stream as jax_pack
    pick = (lambda a: np.asarray(a)) if j is None \
        else (lambda a: np.asarray(a)[j])
    return jax_pack({k: pick(ops[k]) for k in ('streams', 'lengths',
                                               'states')})


def _port_wire(prt, ops, x, j):
    """The packed wire of image `j` of the port's aligned batch result:
    its streams, lengths and states are the aligned encoder's on the
    image's symbols, whose masks select the chunks."""
    flat, shape = prt._symbols_nhwc(nchw(x))
    ref = device_rans_encode(flat.reshape(-1), *prt._tables_dev,
                             num_lanes=ops['streams'].shape[1],
                             cyclic_channels=shape[-1], aligned=True,
                             want_masks=True)
    for k in ('streams', 'lengths', 'states'):
        assert torch.equal(ops[k][j], ref[k]), k
    return pack_stream_aligned(ref)


def test_device_wire_streams_equal_jax(runtimes):
    """The plain versions of the cyclic kernels: each image's packed
    stream and [ok, nbytes] equal JAX's `encode_device_wire` at batch 1
    (lanes from each shape: 64x64 -> 15x15x8 on 8 lanes, 104x96 ->
    25x23x8 on 16), and each
    image of a `wire_batch=2` group equal JAX's
    `encode_device_wire_batch`, a group per shape."""
    _, _, jrt, prt = runtimes
    xs = _shapes_list()
    lanes = set()
    for x in xs:
        j_ops = jrt.encode_device_wire(jnp.asarray(x))
        p_ops = prt.encode_device_wire(nchw(x))
        lanes.add(int(p_ops['streams'].shape[0]))
        assert prt._pull_device_wire(p_ops) == _jax_wire(j_ops)
        assert p_ops['meta'].tolist() == np.asarray(j_ops['meta']).tolist()
        assert tuple(p_ops['shape']) == tuple(j_ops['lat_shape'])
    assert len(lanes) == 2
    for grp in (xs[:2], xs[2:]):
        j_ops = jrt.encode_device_wire_batch([jnp.asarray(x) for x in grp])
        p_ops = prt.encode_device_wire_batch([nchw(x) for x in grp])
        for j in range(2):
            assert _port_wire(prt, p_ops, grp[j], j) == _jax_wire(j_ops, j)
        assert p_ops['meta'].tolist() == np.asarray(j_ops['meta']).tolist()


def _serve(rt, xs, fn, **kw):
    rt.clear_analysis()
    rt.activate_analysis()
    out = getattr(rt, fn)(xs, **kw)
    sizes = list(rt.analyzers[0].file_size_list)
    summary = rt.summarize()
    rt.deactivate_analysis()
    return out, sizes, summary


@pytest.mark.parametrize('fn,kw', [
    ('stream_deploy', {}), ('stream_deploy_device', {}),
    ('stream_deploy_device', {'wire_batch': 2})],
    ids=['host', 'device_batch1', 'device_wire_batch2'])
def test_stream_deploy_equals_jax(runtimes, fn, kw):
    """Over images of two shapes: one output an image at its own size,
    decoded logits within 1e-4 of JAX's, no escape, and each image's size
    JAX's: on the host wire its `stream_deploy`'s, on the device wire its
    `encode_device_wire` meta's (lanes per shape); on one shape also the
    summary of JAX's own stream."""
    _, _, jrt, prt = runtimes
    xs = _shapes_list()
    prt.escapes = {'ok': 0, 'valid': 0}
    got, sizes, _ = _serve(prt, [nchw(x) for x in xs], fn, depth=2, **kw)
    assert prt.escapes == {'ok': 0, 'valid': 0}
    if fn == 'stream_deploy':
        want, want_sizes, _ = _serve(jrt, [jnp.asarray(x) for x in xs], fn,
                                     depth=2, workers=1)
    else:
        want, want_sizes = [], []
        for x in xs:
            j_ops = jrt.encode_device_wire(jnp.asarray(x))
            ok, nbytes = np.asarray(j_ops['meta']).tolist()
            assert ok
            want_sizes.append(get_binary_object_size(
                {'strings': [[bytes(nbytes)]],
                 'shape': j_ops['lat_shape'][:2]}))
            want += jrt.stream_deploy_device([jnp.asarray(x)], depth=1,
                                             workers=1)
    assert sizes == want_sizes
    for x, a, b in zip(xs, got, want):
        assert a.shape == (1, CLASSES, *x.shape[1:3])
        close(nhwc(a), b, 1e-4)
    same = [jnp.asarray(x) for x in xs[:2]]
    _, j_sizes, j_summary = _serve(jrt, same, fn, depth=2, workers=1, **kw)
    _, p_sizes, p_summary = _serve(prt, [nchw(x) for x in xs[:2]], fn,
                                   depth=2, **kw)
    assert p_sizes == j_sizes == sizes[:2]
    assert p_summary == j_summary


def test_escape_recoded_on_the_host_wire_as_jax(runtimes):
    """An image whose latent leaves the CDF support (ok=False) among
    normal ones, batch 1 and `wire_batch=2`: re-coded on the host wire and
    accounted with those bytes, as JAX's device wire does; one `ok`
    escape, no `valid` one."""
    _, _, jrt, prt = runtimes
    xs = images(51, 1) + images(52, 1, scale=60.0) + images(53, 1)
    for kw in ({}, {'wire_batch': 2}):
        prt.escapes = {'ok': 0, 'valid': 0}
        got, sizes, summary = _serve(prt, [nchw(x) for x in xs],
                                     'stream_deploy_device', **kw)
        want, j_sizes, j_summary = _serve(
            jrt, [jnp.asarray(x) for x in xs], 'stream_deploy_device',
            depth=2, workers=1, **kw)
        assert prt.escapes == {'ok': 1, 'valid': 0}
        assert sizes == j_sizes and summary == j_summary
        host = _serve(prt, [nchw(xs[1])], 'stream_deploy')[1]
        assert sizes[1] == host[0]
        for a, b in zip(got, want):
            close(nhwc(a), b, 1e-4)


def test_bq_student_has_no_codec_and_runs_the_train_forward():
    """A CR+BQ student (`larger_resnet_bottleneck`): `update()` returns
    False, as in JAX, and `__call__` is the 'train' forward, {'out'}
    within 1e-4 of the JAX runtime's."""
    jm = jax_small(BQ)
    variables = seg_variables(jm, 61)
    jrt = JaxSegRuntime(jm, jax.tree.map(jnp.asarray, variables))
    prt = SplitSegmentationRuntime(port_of(variables, BQ), device='cpu')
    assert not jrt.update() and not prt.update()
    assert prt.codec is None and not prt.bottleneck_updated
    x = images(62, 1)[0]
    want = jrt(jnp.asarray(x))
    got = prt(nchw(x))
    assert got.keys() == want.keys() == {'out'}
    close(nhwc(got['out']), want['out'], 1e-4)
    with pytest.raises(ValueError, match='no entropy model'):
        prt.stream_deploy_device([nchw(x)])


# ---- evaluator, collators, data ---------------------------------------------

def test_seg_evaluator_equals_jax():
    rng = np.random.default_rng(70)
    want, got = JaxSegEvaluator(CLASSES), SegEvaluator(CLASSES)
    for _ in range(3):
        t = rng.integers(0, CLASSES, (2, 9, 7))
        t[rng.uniform(size=t.shape) < 0.2] = 255
        p = rng.integers(0, CLASSES, (2, 9, 7))
        want.update(t, p)
        got.update(torch.from_numpy(t), p)
    np.testing.assert_array_equal(got.mat.numpy(), want.mat)
    for a, b in zip(got.compute(), want.compute()):
        np.testing.assert_array_equal(a, b)
    assert str(got) == str(want)
    got.reset()
    assert int(got.mat.sum()) == 0


@pytest.mark.parametrize('pad_to', [None, 8])
def test_collators_equal_jax(pad_to):
    """Images padded with 0, masks with 255 to the batch's largest size
    (rounded up to `pad_to`), int32 masks; the eval collator unpadded."""
    rng = np.random.default_rng(71)
    batch = [(rng.normal(0, 1, (h, w, 3)).astype(np.float32),
              rng.integers(0, CLASSES, (h, w)).astype(np.int32))
             for h, w in ((5, 7), (9, 4))]
    want = jax_collator.pascal_seg_collate_fn(batch, pad_to=pad_to)
    got = collator.pascal_seg_collate_fn(batch, pad_to=pad_to)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[1:3] == ((9, 7) if pad_to is None else (16, 8))
    assert got[1][0, 8, 0] == 255 and got[0][0, 8, 0, 0] == 0
    images_, targets = collator.pascal_seg_eval_collate_fn(batch)
    assert [a.shape for a in images_] == [(5, 7, 3), (9, 4, 3)]
    assert len(targets) == 2


def test_synthetic_dataset_and_transforms_equal_jax():
    want = JaxSynthetic(num_samples=2, image_size=(9, 7), num_classes=CLASSES,
                        seed=3)
    got = SyntheticSegmentationDataset(num_samples=2, image_size=(9, 7),
                                       num_classes=CLASSES, seed=3)
    assert len(got) == len(want) == 2
    for i in range(2):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(72)
    img = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    mask = rng.integers(0, CLASSES, (30, 40)).astype(np.int32)
    for kw in ({'train': True}, {'train': False},
               {'train': True, 'jpeg_quality': 50}):
        want_t = JaxPaired(base_size=24, crop_size=20, seed=4, **kw)
        got_t = PairedSegTransforms(base_size=24, crop_size=20, seed=4, **kw)
        for _ in range(3):
            for a, b in zip(got_t(img, mask), want_t(img, mask)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_tiny_segmentation_config_matches_jax_loader():
    """The tiny sample config's loader through the port's registry and
    collator gives the JAX package's batches."""
    from sc2bench_tpu.datasets.image import \
        build_sharded_loader as jax_loader
    from sc2bench_tpu_torch.datasets.image import build_sharded_loader
    cfg = jax_load_config(REPO / 'configs/sample/tiny_segmentation.yaml')
    split = cfg['train']['train_data_loader']
    want = list(jax_loader(split,
                           collate_fn=jax_collator.pascal_seg_collate_fn))
    got = list(build_sharded_loader(
        split, collate_fn=collator.pascal_seg_collate_fn))
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
