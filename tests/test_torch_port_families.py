"""The port's ResNeSt, DenseNet and Inception-v3 families, the four
`SimpleBottleneck` builders they and the hub use, the skips and
`frozen_bn` of `splittable_resnet`, and the hub twin
(`sc2bench_tpu_torch/hubconf.py`), against the JAX package on the CPU.

One set of Flax variables, randomized with numpy, goes into the JAX module
and, through `state_dict_from_flax`, into the port's (strictly); the same
numpy inputs go through both. Sizes: ResNeSt at stage sizes (1, 1, 1, 1)
behind a small FP bottleneck (encoder [3, 16, 16, 16], decoder [16, 64,
256, 256]), 64 px; DenseNet with `block_config` (1, 1, 2, 2) and growth 8
behind `larger_densenet_bottleneck` (6 channels), 64 px; Inception-v3's
full tail behind `inception_v3_bottleneck` (6 channels) at 75 px; 10
classes. Tolerance: every float output within 1e-4, relative and of the
output's largest magnitude (at least 1). The captured intermediates
equal JAX's under its names. The state dicts go back to Flax through the
JAX package's own rules (`SPLITTABLE_RESNEST_RULES`, `RESNEST_RULES`,
`SPLITTABLE_DENSENET_RULES`, `SPLITTABLE_INCEPTION_RULES`) unchanged, and
`flax_param_path` gives the variables' own paths. The hub twin's ten
constructors build on the CPU with JAX's parameter shapes
(`jax.eval_shape` of the root `hubconf.py`'s modules)."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sc2bench_tpu.models import backbone as jbb
from sc2bench_tpu.models import inception as jinc
from sc2bench_tpu.models import layer as jlayer
from sc2bench_tpu.models import resnest as jrs
from sc2bench_tpu.utils.torch_convert import (RESNEST_RULES,
                                              SPLITTABLE_DENSENET_RULES,
                                              SPLITTABLE_INCEPTION_RULES,
                                              SPLITTABLE_RESNEST_RULES,
                                              convert_state_dict)
from sc2bench_tpu_torch.models import backbone as pbb
from sc2bench_tpu_torch.models import inception as pinc
from sc2bench_tpu_torch.models import resnest as prs
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.models.resnet import FrozenBatchNorm2d
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from test_torch_port_backbones import (CLASSES, HW, VIT_DEC, VIT_ENC,
                                       _apply, _close, _flat, _fp, _images,
                                       _sub_state, _variables)
from test_torch_port_model import _nchw

REPO = Path(__file__).resolve().parents[1]
SMALL = (1, 1, 1, 1)
INCEPTION_HW = 75


def _load(pm, variables):
    pm.load_state_dict(state_dict_from_flax(variables, pm), strict=True)
    return pm.eval()


def _resnest_student(jax_side=True, **kwargs):
    if jax_side:
        return jrs.SplittableResNeSt(bottleneck_layer=_fp(VIT_ENC, VIT_DEC),
                                     stage_sizes=SMALL, num_classes=CLASSES,
                                     **kwargs)
    return prs.SplittableResNeSt(_fp(VIT_ENC, VIT_DEC, False),
                                 stage_sizes=SMALL, num_classes=CLASSES,
                                 **kwargs)


def _densenet(jax_side=True):
    if jax_side:
        return jbb.SplittableDenseNet(
            bottleneck_layer=jlayer.larger_densenet_bottleneck(
                bottleneck_channel=6), block_config=SMALL[:2] + (2, 2),
            growth_rate=8, num_classes=CLASSES)
    return pbb.SplittableDenseNet(
        get_layer('larger_densenet_bottleneck', bottleneck_channel=6),
        growth_rate=8, block_config=(1, 1, 2, 2), num_classes=CLASSES)


def _inception(jax_side=True):
    if jax_side:
        return jinc.SplittableInceptionV3(
            bottleneck_layer=jlayer.inception_v3_bottleneck(
                bottleneck_channel=6), num_classes=CLASSES)
    return pinc.SplittableInceptionV3(
        get_layer('inception_v3_bottleneck', bottleneck_channel=6),
        num_classes=CLASSES)


# ---- ResNeSt ----------------------------------------------------------------

def test_split_attention_conv_equals_jax():
    """radix 2: the (radix, channels) split of the grouped conv's output,
    the attention's 32-wide fc1 (16 * 2 // 4 < 32) and its softmax."""
    x = _images(1, hw=8, c=16)
    jm = jrs.SplitAttentionConv(channels=16, radix=2)
    variables = _variables(jm, x, 2)
    pm = prs.SplitAttentionConv(16, 16, radix=2)
    pm.load_state_dict(_sub_state(variables, 'layer2/block0/conv2',
                                  'layer2.0.conv2.'), strict=True)
    assert pm.fc1.out_channels == 32 and pm.conv.groups == 2
    _close(pm.eval()(_nchw(x)), jm.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize('in_ch,filters,stride,hw', [
    (64, 16, 2, 8), (32, 16, 1, 15), (64, 16, 1, 8)],
    ids=['stride2-avg_down', 'projected-odd', 'identity'])
def test_resnest_block_equals_jax(in_ch, filters, stride, hw):
    x = _images(3, hw=hw, c=in_ch)
    jm = jrs.ResNeStBlock(filters, strides=stride)
    variables = _variables(jm, x, 4)
    pm = prs.ResNeStBlock(in_ch, filters, strides=stride)
    pm.load_state_dict(_sub_state(variables, 'layer2/block0', 'layer2.0.'),
                       strict=True)
    assert (pm.downsample is None) == (stride == 1 and in_ch == 4 * filters)
    _close(pm.eval()(_nchw(x)), jm.apply(variables, jnp.asarray(x)))


def test_resnest_avg_down_floors_odd_sizes_as_jax():
    """The stride-2 block at an odd input (15 px): the shortcut's 2x2/2
    pool floors to 7 (timm's rounds up to 8) while `avd` gives 8, so the
    block cannot add them, in JAX as in the port."""
    x = _images(5, hw=15, c=64)
    jm = jrs.ResNeStBlock(16, strides=2)
    variables = _variables(jm, _images(5, hw=16, c=64), 6)
    with pytest.raises((TypeError, ValueError)):
        jm.apply(variables, jnp.asarray(x))
    pm = prs.ResNeStBlock(64, 16, strides=2).eval()
    assert pm.downsample[0](_nchw(x)).shape[-2:] == (7, 7)
    assert pm.avd_last(torch.zeros(1, 16, 15, 15)).shape[-2:] == (8, 8)
    with pytest.raises(RuntimeError, match='size'):
        pm(_nchw(x))


def test_splittable_resnest_equals_jax():
    """The student's 'finetune' logits, its intermediates and
    `forward_tail` on the bottleneck's output."""
    x = _images(7)
    jm = _resnest_student()
    variables = _variables(jm, x, 8, mode='train')
    pm = _load(_resnest_student(False), variables)
    want, j_io = _apply(jm, variables, x, mode='finetune')
    io = {}
    with torch.no_grad():
        got = pm(_nchw(x), mode='finetune', io=io)
        tail = pm.forward_tail(io['bottleneck_layer_out'])
    _close(got, want)
    _close(tail, want)
    assert set(io) == set(j_io) == {'bottleneck_layer_out', 'layer2_out',
                                    'layer3_out', 'layer4_out'}
    for k, v in j_io.items():
        _close(io[k], v)


def test_resnest50d_teacher_equals_jax():
    x = _images(9)
    jm = jrs.ResNeSt(stage_sizes=SMALL, num_classes=CLASSES)
    variables = _variables(jm, x, 10, train=False)
    pm = _load(prs.ResNeSt(stage_sizes=SMALL, num_classes=CLASSES),
               variables)
    want, j_io = _apply(jm, variables, x, train=False)
    io = {}
    with torch.no_grad():
        _close(pm(_nchw(x), io=io), want)
    assert set(io) == set(j_io) == {f'layer{i}_out' for i in range(1, 5)}
    for k, v in j_io.items():
        _close(io[k], v)


# ---- DenseNet and Inception-v3 ----------------------------------------------

def test_splittable_densenet_equals_jax():
    """Blocks 3 and 4 (two dense layers each), the transition after block
    3 only, norm5 and the classifier."""
    x = _images(11)
    jm = _densenet()
    variables = _variables(jm, x, 12, mode='train')
    pm = _load(_densenet(False), variables)
    assert [n for n, _ in pm.features.named_children()] == [
        'denseblock3', 'transition3', 'denseblock4', 'norm5']
    want, j_io = _apply(jm, variables, x, mode='finetune')
    io = {}
    with torch.no_grad():
        _close(pm(_nchw(x), mode='finetune', io=io), want)
    assert set(io) == set(j_io) == {'bottleneck_layer_out',
                                    'bottleneck_layer.bottleneck_out'}
    for k, v in j_io.items():
        _close(io[k], v)


def test_splittable_inception_v3_equals_jax():
    """The full Mixed_5b..7c tail at 75 px (7x7 into Mixed_5b), BN eps
    1e-3, the asymmetric 1x7/7x1 paddings."""
    x = _images(13, hw=INCEPTION_HW)
    jm = _inception()
    variables = _variables(jm, x, 14, mode='train')
    pm = _load(_inception(False), variables)
    want, j_io = _apply(jm, variables, x, mode='finetune')
    io = {}
    with torch.no_grad():
        _close(pm(_nchw(x), mode='finetune', io=io), want)
    assert set(io) == set(j_io) == {
        'bottleneck_layer_out', 'bottleneck_layer.bottleneck_out',
        'Mixed_6e_out', 'Mixed_7c_out'}
    for k, v in j_io.items():
        _close(io[k], v)
    assert not hasattr(pm, 'forward_tail')


@pytest.mark.parametrize('builder,hw', [
    ('larger_densenet_bottleneck', 64), ('inception_v3_bottleneck', 75),
    ('smaller_resnet_layer1_bottleneck', 32),
    ('larger_resnet_layer1_bottleneck', 32)])
def test_bottleneck_builders_equal_jax(builder, hw):
    """Each builder's encoder and decoder (the `encoder.{i}`/`decoder.{i}`
    key space) at its defaults: the latent and the output."""
    x = _images(15, hw=hw)
    jm = getattr(jlayer, builder)()
    variables = _variables(jm, x, 16, mode='train')
    holder = torch.nn.Module()
    holder.bottleneck_layer = get_layer(builder)
    holder.load_state_dict(state_dict_from_flax(
        {coll: {'bottleneck_layer': tree} for coll, tree in
         variables.items()}, holder), strict=True)
    pm = holder.bottleneck_layer.eval()
    want, j_io = _apply(jm, variables, x, mode='finetune')
    io = {}
    with torch.no_grad():
        _close(pm(_nchw(x), mode='finetune', io=io), want)
    _close(io['bottleneck_out'], j_io['bottleneck_out'])
    if 'layer1' in builder:
        assert want.shape[1:3] == (hw, hw)    # every conv at stride 1


@pytest.mark.parametrize('option', ['skips_avgpool', 'skips_fc', 'both',
                                    'frozen_bn'])
def test_splittable_resnet_options_equal_jax(option):
    """`splittable_resnet`'s skips (layer4's feature, the pooled feature;
    no fc with either: JAX's tree has no fc then) and `frozen_bn` (in
    train mode the tail's BatchNorm keeps its running statistics)."""
    kwargs = {'skips_avgpool': True, 'skips_fc': True} if option == 'both' \
        else {option: True}
    x = _images(17)
    jm = jbb.SplittableResNet(bottleneck_layer=_fp(VIT_ENC, VIT_DEC),
                              stage_sizes=SMALL, num_classes=CLASSES,
                              **kwargs)
    variables = _variables(jm, x, 18, mode='train')
    pm = pbb.splittable_resnet(
        {'key': 'FPBasedResNetBottleneck', 'kwargs': {
            'num_bottleneck_channels': VIT_ENC[-1],
            'encoder_channel_sizes': list(VIT_ENC),
            'decoder_channel_sizes': list(VIT_DEC)}},
        stage_sizes=SMALL, num_classes=CLASSES, device='cpu', **kwargs)
    _load(pm, variables)
    assert hasattr(pm, 'fc') == (option == 'frozen_bn') \
        == ('fc' in variables['params'])
    train = option == 'frozen_bn'
    if train:
        assert isinstance(pm.layer2[0].bn1, FrozenBatchNorm2d)
        pm.train()
    want, _ = _apply(jm, variables, x, mode='finetune', train=train)
    with torch.no_grad():
        got = pm(_nchw(x), mode='finetune')
    _close(got, want)


# ---- conversion and names ---------------------------------------------------

CASES = {
    'resnest_student': (_resnest_student, lambda: _resnest_student(False),
                        SPLITTABLE_RESNEST_RULES, {'mode': 'train'}, HW),
    'resnest_teacher': (
        lambda: jrs.ResNeSt(stage_sizes=SMALL, num_classes=CLASSES),
        lambda: prs.ResNeSt(stage_sizes=SMALL, num_classes=CLASSES),
        RESNEST_RULES, {'train': False}, HW),
    'densenet': (_densenet, lambda: _densenet(False),
                 SPLITTABLE_DENSENET_RULES, {'mode': 'train'}, HW),
    'inception': (_inception, lambda: _inception(False),
                  SPLITTABLE_INCEPTION_RULES, {'mode': 'train'},
                  INCEPTION_HW),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_key_space_and_flax_paths(case):
    """The port's state dict is the reference's key space (timm's ResNeSt,
    torchvision's DenseNet and Inception-v3): the JAX package's torch ->
    Flax rules give back every variable unchanged, and each parameter's
    `flax_param_path` is its Flax path."""
    make_jax, make_port, rules, init_kwargs, hw = CASES[case]
    variables = _variables(make_jax(), _images(0, n=1, hw=hw), 19,
                           **init_kwargs)
    pm = _load(make_port(), variables)
    back = _flat(convert_state_dict(
        {k: v.numpy() for k, v in pm.state_dict().items()}, rules))
    want = _flat(variables)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    paths = {flax_param_path(n, pm).replace('.', '/')
             for n, _ in pm.named_parameters()}
    assert paths == {k[len('params/'):] for k in want
                     if k.startswith('params/')}


# ---- the hub twin -----------------------------------------------------------

def _module_from(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def hubs():
    return (_module_from(REPO / 'hubconf.py', 'jax_hubconf'),
            _module_from(REPO / 'sc2bench_tpu_torch' / 'hubconf.py',
                         'port_hubconf'))


def _constructors(module):
    return sorted(n for n in vars(module) if n.startswith('custom_'))


def test_hub_twin_names_every_constructor(hubs):
    jhub, phub = hubs
    assert len(_constructors(jhub)) == 10
    assert _constructors(phub) == _constructors(jhub)
    assert phub.dependencies == ['torch']


def _jax_shapes(module, hw, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, hw, hw, 3)), **kwargs))
    return {'.'.join(str(getattr(k, 'key', k)) for k in path): a.shape
            for path, a in jax.tree_util.tree_flatten_with_path(
                shapes['params'])[0]}


def _flax_shape(param: torch.Tensor, module: torch.nn.Module) -> tuple:
    """The Flax shape of a torch parameter of `module`'s kind."""
    s = tuple(param.shape)
    if param.ndim == 4 and isinstance(module, torch.nn.ConvTranspose2d):
        return s[2], s[3], s[0], s[1]
    if param.ndim == 4:
        return s[2], s[3], s[1], s[0]
    return s[::-1]


def _port_shapes(model, prefix=''):
    """{Flax path: Flax shape} of the port `model`'s parameters; a bare
    FPN or bottleneck is rooted at `prefix` ('backbone.fpn.',
    'bottleneck_layer.'), where `flax_param_path` reads it, and the Flax
    path's first scope is dropped."""
    holder = model
    if prefix:
        holder = parent = torch.nn.Module()
        *outer, last = prefix.rstrip('.').split('.')
        for name in outer:
            parent.add_module(name, torch.nn.Module())
            parent = getattr(parent, name)
        parent.add_module(last, model)
    out = {}
    for name, p in model.named_parameters():
        module = holder.get_submodule((prefix + name).rpartition('.')[0])
        path = flax_param_path(prefix + name, holder)
        if prefix:
            path = path.split('.', 1)[1]
        out[path] = _flax_shape(p, module)
    return out


@pytest.mark.parametrize('name', [
    'custom_resnet50', 'custom_resnet101', 'custom_resnet152',
    'custom_densenet169', 'custom_densenet201', 'custom_inception_v3',
    'custom_resnet_fpn_backbone', 'custom_fasterrcnn_resnet_fpn',
    'custom_maskrcnn_resnet_fpn', 'custom_keypointrcnn_resnet_fpn'])
def test_hub_twin_constructor_equals_jax(hubs, name):
    """Each constructor at its defaults builds on the CPU (initialized
    modules) with the parameter shapes of the JAX constructor's
    `eval_shape` (the R-CNNs on a 64 px image): the same Flax paths
    through `flax_param_path`, each with its shape."""
    jhub, phub = hubs
    jm = getattr(jhub, name)()
    pm = getattr(phub, name)(device='cpu')
    hw = 299 if 'inception' in name else 224
    if name == 'custom_resnet_fpn_backbone':
        body, fpn = pm
        jbody, jfpn = jm
        assert _port_shapes(body) == _jax_shapes(jbody, 64, mode='train')
        feats = [jnp.zeros((1, 8, 8, c)) for c in body.out_channels_list]
        shapes = jax.eval_shape(lambda: jfpn.init(jax.random.key(0), feats))
        assert _port_shapes(fpn, 'backbone.fpn.') == {
            '.'.join(str(getattr(k, 'key', k)) for k in path): a.shape
            for path, a in jax.tree_util.tree_flatten_with_path(
                shapes['params'])[0]}
        assert isinstance(body.layer2[0].bn1, FrozenBatchNorm2d)
        return
    if name == 'custom_inception_v3':
        assert _port_shapes(pm, 'bottleneck_layer.') == _jax_shapes(
            jm, hw, mode='train')
        return
    kwargs = {'mode': 'train'}
    if 'rcnn' in name:
        hw = 64
        kwargs = {}
    assert _port_shapes(pm) == _jax_shapes(jm, hw, **kwargs)
    assert next(pm.parameters()).device.type == 'cpu'


def test_layer1_bottleneck_detection_body_equals_jax():
    """A Faster R-CNN whose body takes `larger_resnet_layer1_bottleneck`
    (4 channels) in place of the stem and layer1, at stage sizes (1, 1, 1,
    1) and 5 classes, as the hub's R-CNNs build it: the state dict loads
    strictly, the FPN's features equal JAX's `extract_features`, and C2
    comes out at stride 1 with 256 channels."""
    from sc2bench_tpu.models.detection.base import \
        SplittableDetectionBackbone as JaxBody
    from sc2bench_tpu.models.detection.rcnn import FasterRCNN as JaxRCNN
    from sc2bench_tpu_torch.models.detection.base import \
        SplittableDetectionBackbone
    from sc2bench_tpu_torch.models.detection.rcnn import FasterRCNN
    x = _images(20, n=1, hw=32)
    jm = JaxRCNN(backbone=JaxBody(
        bottleneck_layer=jlayer.larger_resnet_layer1_bottleneck(
            bottleneck_channel=4), stage_sizes=SMALL), num_classes=5)
    variables = _variables(jm, x, 21)
    pm = FasterRCNN(SplittableDetectionBackbone(
        get_layer('larger_resnet_layer1_bottleneck', bottleneck_channel=4),
        stage_sizes=SMALL), num_classes=5)
    _load(pm, variables)
    want = jax.jit(lambda v, x: jm.apply(
        v, x, method=lambda m, x: m.extract_features(x, 'finetune')))(jax.tree.map(jnp.asarray, variables),
                             jnp.asarray(x))
    io = {}
    with torch.no_grad():
        got = pm.backbone(_nchw(x), mode='finetune', io=io)
    assert io['bottleneck_layer_out'].shape == (1, 256, 32, 32)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    paths = {flax_param_path(n, pm) for n, _ in pm.named_parameters()}
    assert paths == {k[len('params/'):].replace('/', '.')
                     for k in _flat(variables) if k.startswith('params/')}
