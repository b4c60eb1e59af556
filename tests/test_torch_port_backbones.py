"""The port's RegNetY, hybrid ViT (R26+S/32) and EfficientNet modules
against the JAX package, on the CPU at small sizes.

One set of Flax variables, randomized with numpy, goes into the JAX module
and, through `state_dict_from_flax`, into the port's (strictly); the same
numpy inputs go through both. Sizes: RegNet stages (32,) 48, 64, 80 of
depth 1 and group width 8; hybrid ViT embed 64, depth 2, 2 heads (its
ResNetV2 widths are fixed); EfficientNet width 0.25, depth 0.1; 10
classes; 64 px images (StdConv also at an odd size). Tolerance: every
float output within 1e-4, relative and of the output's largest magnitude
(at least 1): XLA's and PyTorch's convolutions and norms sum in other
orders. The captured intermediates equal JAX's under its names. The
state dicts go back to Flax through the JAX package's timm conversion
rules unchanged, and the Flax paths `flax_param_path` gives are the
variables' own. All 41 configs of the three families build on the meta
device, and the full-width parameter counts equal JAX's
(`jax.eval_shape`)."""
import torch_port_threads  # noqa: F401  (pins torch threads)
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.models import efficientnet as jeff
from sc2bench_tpu.models import hybrid_vit as jvit
from sc2bench_tpu.models import regnet as jreg
from sc2bench_tpu.models.layer import FPBasedResNetBottleneck as JaxFP
from sc2bench_tpu.models.layer import MSHPBasedResNetBottleneck as JaxMSHP
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.train.box import flatten_io
from sc2bench_tpu.utils.torch_convert import (EFFICIENTNET_RULES,
                                              HYBRID_VIT_RULES, REGNET_RULES,
                                              SPLITTABLE_HYBRID_VIT_RULES,
                                              SPLITTABLE_REGNET_RULES,
                                              convert_state_dict)
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models import efficientnet as peff
from sc2bench_tpu_torch.models import hybrid_vit as pvit
from sc2bench_tpu_torch.models import regnet as preg
from sc2bench_tpu_torch.models.layer import (FPBasedResNetBottleneck,
                                             MSHPBasedResNetBottleneck)
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.models.wrapper import wrap_model
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from test_torch_port_model import _nchw, _randomize

REPO = Path(__file__).resolve().parents[1]
ES = REPO / 'configs/ilsvrc2012/supervised_compression/entropic_student'
INPUT = REPO / 'configs/ilsvrc2012/input_compression'
REGNET_CONFIGS = sorted(ES.glob('splitable_regnety6.4gf-*.yaml'))
VIT_CONFIGS = sorted(ES.glob('splitable_hybrid_vit_small_r26_s32_224-*.yaml'))
EFFICIENTNET_CONFIGS = sorted(INPUT.glob('*-tf_efficientnet_l2_ns*.yaml'))
CLASSES, HW, NHWC = 10, 64, (0, 2, 3, 1)
TOL = 1e-4
# small forms of the configs' bottlenecks (the configs' are [3, 64, 64, 64]
# -> [64, 288, 144, 144] for RegNet, [64, 512, 256, 256] for the ViT)
REG_ENC, REG_DEC = (3, 16, 16, 16), (16, 48, 32, 32)
VIT_ENC, VIT_DEC = (3, 16, 16, 16), (16, 64, 256, 256)
REG_SMALL = dict(stage_widths=(48, 64, 80), stage_depths=(1, 1, 1),
                 group_width=8, num_classes=CLASSES)
REG_TEACHER = dict(stage_widths=(32, 48, 64, 80), stage_depths=(1, 1, 1, 1),
                   group_width=8, num_classes=CLASSES)
VIT_SMALL = dict(embed_dim=64, depth=2, num_heads=2, num_classes=CLASSES)
EFF_SMALL = dict(width_coefficient=0.25, depth_coefficient=0.1,
                 num_classes=CLASSES)


def _images(seed, n=2, hw=HW, c=3):
    return np.random.default_rng(seed).normal(0, 1, (n, hw, hw, c)).astype(
        np.float32)


def _variables(module, x, seed, **init_kwargs):
    """Randomized Flax variables of `module` for inputs shaped like `x`."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.asarray(x), **init_kwargs))
    return _randomize({'params': shapes['params'],
                       'batch_stats': shapes.get('batch_stats', {})},
                      np.random.default_rng(seed))


def _nest(prefix, tree, extra=None):
    """`tree` under the Flax scopes `prefix` ('/'-joined), beside `extra`:
    a block's variables in the place the conversion rules of its family
    read them."""
    for name in reversed(prefix.split('/')):
        tree = {name: tree}
    return {**(extra or {}), **tree}


def _sub_state(variables, prefix, torch_prefix, extra=None):
    """The port's state dict of a block whose Flax variables sit at
    `prefix` of a family's tree and whose torch keys at `torch_prefix`."""
    state = state_dict_from_flax({
        coll: _nest(prefix, tree, extra)
        for coll, tree in variables.items() if tree or coll == 'params'})
    return {k[len(torch_prefix):]: v for k, v in state.items()}


def _close(got: torch.Tensor, want, tol=TOL):
    got = got.detach()
    if got.ndim == 4:
        got = got.permute(NHWC)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * max(
        1.0, float(np.abs(want).max())))


def _apply(module, variables, x, **kwargs):
    """JAX output and its flattened intermediates (one jitted call, the
    variables its argument)."""
    out, state = jax.jit(lambda v, x: module.apply(
        v, x, mutable=['intermediates'], **kwargs))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    return out, flatten_io(state.get('intermediates', {}))


def _fp(enc, dec, jax_side=True):
    kwargs = dict(num_bottleneck_channels=enc[-1])
    if jax_side:
        return JaxFP(encoder_channel_sizes=enc, decoder_channel_sizes=dec,
                     **kwargs)
    return FPBasedResNetBottleneck(encoder_channel_sizes=list(enc),
                                   decoder_channel_sizes=list(dec), **kwargs)


# ---- RegNet ----------------------------------------------------------------

def test_se_block_equals_jax():
    """The squeeze width comes from the block's input (16), not from the
    gated tensor (32)."""
    x = _images(1, hw=8, c=32)
    jm = jreg.SEBlock(se_ratio=0.25, in_ch=16)
    variables = _variables(jm, x, 2)
    pm = preg.SEBlock(32, 16)
    pm.load_state_dict(_sub_state(variables, 's2/block0/se', 's2.b1.se.'),
                       strict=True)
    assert pm.fc1.out_channels == 4
    _close(pm(_nchw(x)), jm.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize('in_ch,width,stride', [(32, 48, 2), (48, 48, 1)],
                         ids=['projected', 'identity'])
def test_regnet_bottleneck_equals_jax(in_ch, width, stride):
    x = _images(3, hw=16, c=in_ch)
    jm = jreg.RegNetBottleneck(width, stride, group_width=8)
    variables = _variables(jm, x, 4)
    pm = preg.RegNetBottleneck(in_ch, width, stride, group_width=8)
    pm.load_state_dict(_sub_state(variables, 's2/block0', 's2.b1.'),
                       strict=True)
    assert (pm.downsample is None) == (stride == 1 and in_ch == width)
    assert pm.conv2.conv.groups == width // 8
    _close(pm.eval()(_nchw(x)), jm.apply(variables, jnp.asarray(x)))


def _regnet_student(bottleneck_cls=JaxFP):
    if bottleneck_cls is JaxFP:
        bneck = _fp(REG_ENC, REG_DEC)
    else:
        bneck = JaxMSHP(num_bottleneck_channels=REG_ENC[-1],
                        num_latent_channels=4, g_a_channel_sizes=REG_ENC,
                        g_s_channel_sizes=REG_DEC)
    return jreg.SplittableRegNet(bottleneck_layer=bneck, **REG_SMALL)


def test_splittable_regnet_equals_jax():
    """The student's logits (the 'finetune' forward), its intermediates
    and `forward_tail` on the bottleneck's output."""
    x = _images(5)
    jm = _regnet_student()
    variables = _variables(jm, x, 6, mode='train')
    pm = preg.SplittableRegNet(_fp(REG_ENC, REG_DEC, False), **REG_SMALL)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    want, j_io = _apply(jm, variables, x, mode='finetune')
    io = {}
    with torch.no_grad():
        got = pm.eval()(_nchw(x), mode='finetune', io=io)
        tail = pm.forward_tail(io['bottleneck_layer_out'])
    _close(got, want)
    _close(tail, want)
    assert set(io) == set(j_io) == {'bottleneck_layer_out', 's2_out',
                                    's3_out', 's4_out'}
    for k, v in j_io.items():
        _close(io[k], v)


def test_regnet_teacher_equals_jax():
    x = _images(7)
    jm = jreg.RegNet(**REG_TEACHER)
    variables = _variables(jm, x, 8, train=False)
    pm = preg.RegNet(**REG_TEACHER)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    want, j_io = _apply(jm, variables, x, train=False)
    io = {}
    with torch.no_grad():
        _close(pm.eval()(_nchw(x), io=io), want)
    assert set(io) == set(j_io) == {f's{i}_out' for i in range(1, 5)}
    for k, v in j_io.items():
        _close(io[k], v)


# ---- hybrid ViT -------------------------------------------------------------

@pytest.mark.parametrize('hw', [16, 15])
@pytest.mark.parametrize('kernel,stride', [(3, 2), (7, 2), (1, 1)])
def test_std_conv_equals_jax(hw, kernel, stride):
    """TF-'SAME' padding at an even and an odd size (asymmetric at stride 2
    on even inputs), weight standardization with the biased variance."""
    x = _images(9, hw=hw, c=32)
    jm = jvit.StdConv(32, (kernel, kernel), stride)
    variables = _variables(jm, x, 10)
    pm = pvit.StdConv(32, 32, kernel, stride)
    pm.load_state_dict(_sub_state(
        variables, 'stage1/block0/conv1', 'patch_embed_pruned_stages.1.'
        'blocks.0.conv1.', {'vit': {}}), strict=True)
    _close(pm(_nchw(x)), jm.apply(variables, jnp.asarray(x)))


def test_resnetv2_block_equals_jax():
    x = _images(11, hw=16, c=64)
    jm = jvit.ResNetV2Block(128, strides=2)
    variables = _variables(jm, x, 12)
    pm = pvit.ResNetV2Block(64, 128, 2)
    pm.load_state_dict(_sub_state(
        variables, 'stage1/block0', 'patch_embed_pruned_stages.1.blocks.0.',
        {'vit': {}}), strict=True)
    _close(pm(_nchw(x)), jm.apply(variables, jnp.asarray(x)))


def test_vit_block_equals_jax():
    x = np.random.default_rng(13).normal(0, 1, (2, 5, 64)).astype(np.float32)
    jm = jvit.ViTBlock(64, 2)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            jnp.asarray(x)))
    variables = _randomize({'params': shapes['params']},
                           np.random.default_rng(14))
    pm = pvit.ViTBlock(64, 2)
    pm.load_state_dict(_sub_state(variables, 'vit/block0', 'blocks.0.'),
                       strict=True)
    np.testing.assert_allclose(
        pm(torch.from_numpy(x)).detach().numpy(),
        jm.apply(variables, jnp.asarray(x)), rtol=TOL, atol=TOL * 4)


def _vit_student(bottleneck_cls=JaxFP):
    if bottleneck_cls is JaxFP:
        bneck = _fp(VIT_ENC, VIT_DEC)
    else:
        bneck = JaxMSHP(num_bottleneck_channels=VIT_ENC[-1],
                        num_latent_channels=4, g_a_channel_sizes=VIT_ENC,
                        g_s_channel_sizes=VIT_DEC)
    return jvit.SplittableHybridViT(bottleneck_layer=bneck, **VIT_SMALL)


def test_splittable_hybrid_vit_equals_jax():
    """The student at 64 px (a 2x2 patch grid: 5 tokens): logits, the
    intermediates (the last block's tokens too) and `forward_tail`."""
    x = _images(15)
    jm = _vit_student()
    variables = _variables(jm, x, 16, mode='train')
    pm = pvit.SplittableHybridViT(_fp(VIT_ENC, VIT_DEC, False),
                                  image_size=HW, **VIT_SMALL)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert pm.pos_embed.shape == (1, 5, 64)
    want, j_io = _apply(jm, variables, x, mode='finetune')
    io = {}
    with torch.no_grad():
        got = pm.eval()(_nchw(x), mode='finetune', io=io)
        tail = pm.forward_tail(io['bottleneck_layer_out'])
    _close(got, want)
    _close(tail, want)
    assert set(io) == set(j_io) == {
        'bottleneck_layer_out', 'stage1_out', 'stage2_out', 'stage3_out',
        'vit.block1_out'}
    for k, v in j_io.items():
        _close(io[k], v)


@pytest.mark.parametrize('hw', [64, 48])
def test_hybrid_vit_teacher_equals_jax(hw):
    """The teacher: 7x7/2 'SAME' stem, the -inf-padded 'SAME' max pool,
    stages 0-3; at 48 px the grid rounds up (2x2)."""
    x = _images(17, hw=hw)
    jm = jvit.HybridViT(**VIT_SMALL)
    variables = _variables(jm, x, 18)
    pm = pvit.HybridViT(image_size=hw, **VIT_SMALL)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    want, j_io = _apply(jm, variables, x)
    io = {}
    with torch.no_grad():
        _close(pm(_nchw(x), io=io), want)
    assert set(io) == set(j_io) == {f'stage{i}_out' for i in range(4)} \
        | {'vit.block1_out'}
    for k, v in j_io.items():
        _close(io[k], v)


def test_same_max_pool_pads_with_minus_infinity():
    """An all-negative input: zero padding would put zeros on the
    bottom/right edge of the pooled map; 'SAME' max pooling does not."""
    x = -1.0 - torch.rand(1, 2, 8, 8)
    out = torch.nn.functional.max_pool2d(
        pvit.pad_same(x, 3, 2, value=-float('inf')), 3, 2)
    want = jax.lax.reduce_window(
        jnp.asarray(x.permute(NHWC).numpy()), -jnp.inf, jax.lax.max,
        (1, 3, 3, 1), (1, 2, 2, 1), 'SAME')
    _close(out, want, tol=0)


# ---- EfficientNet -----------------------------------------------------------

@pytest.mark.parametrize('in_ch,out_ch,expand,stride,kernel', [
    (16, 16, 6, 1, 3), (16, 24, 6, 2, 5), (8, 8, 1, 1, 3)],
    ids=['stride1-residual', 'stride2', 'depthwise-separable'])
def test_mbconv_equals_jax(in_ch, out_ch, expand, stride, kernel):
    x = _images(19, hw=16, c=in_ch)
    jm = jeff.MBConv(out_ch, expand, stride, kernel)
    variables = _variables(jm, x, 20)
    pm = peff.MBConv(in_ch, out_ch, expand, stride, kernel)
    stage = 0 if expand == 1 else 1
    pm.load_state_dict(_sub_state(
        variables, f'stage{stage}_block0', f'blocks.{stage}.0.',
        {'stage0_block0': {}}), strict=True)
    assert pm.residual == (stride == 1 and in_ch == out_ch)
    _close(pm.eval()(_nchw(x)), jm.apply(variables, jnp.asarray(x)))


def test_efficientnet_equals_jax():
    x = _images(21)
    jm = jeff.EfficientNet(**EFF_SMALL)
    variables = _variables(jm, x, 22)
    pm = peff.EfficientNet(**EFF_SMALL)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    want, j_io = _apply(jm, variables, x)
    io = {}
    with torch.no_grad():
        _close(pm.eval()(_nchw(x), io=io), want)
    assert set(io) == set(j_io) == {f'stage{s}_out' for s in range(7)}
    for k, v in j_io.items():
        _close(io[k], v)


# ---- conversion, names, builds ----------------------------------------------

def _flat(tree) -> dict:
    return {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


CASES = {
    'regnet_student': (_regnet_student, lambda: preg.SplittableRegNet(
        _fp(REG_ENC, REG_DEC, False), **REG_SMALL),
        SPLITTABLE_REGNET_RULES, {'mode': 'train'}),
    'regnet_teacher': (lambda: jreg.RegNet(**REG_TEACHER),
                       lambda: preg.RegNet(**REG_TEACHER), REGNET_RULES,
                       {'train': False}),
    'vit_student': (_vit_student, lambda: pvit.SplittableHybridViT(
        _fp(VIT_ENC, VIT_DEC, False), image_size=HW, **VIT_SMALL),
        SPLITTABLE_HYBRID_VIT_RULES, {'mode': 'train'}),
    'vit_teacher': (lambda: jvit.HybridViT(**VIT_SMALL),
                    lambda: pvit.HybridViT(image_size=HW, **VIT_SMALL),
                    HYBRID_VIT_RULES, {}),
    'efficientnet': (lambda: jeff.EfficientNet(**EFF_SMALL),
                     lambda: peff.EfficientNet(**EFF_SMALL),
                     EFFICIENTNET_RULES, {'train': False}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_timm_key_space_and_flax_paths(case):
    """The port's state dict is timm's (the reference's) key space: the
    JAX package's torch -> Flax rules give back every variable unchanged;
    each parameter's `flax_param_path` is its Flax path; and the tree of
    randomized variables converts to a state dict the module loads
    strictly."""
    make_jax, make_port, rules, init_kwargs = CASES[case]
    variables = _variables(make_jax(), _images(0, n=1), 23, **init_kwargs)
    pm = make_port()
    pm.load_state_dict(state_dict_from_flax(variables, pm), strict=True)
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


def _jax_param_count(module, hw, **init_kwargs):
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, hw, hw, 3)), **init_kwargs))
    return sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes['params']))


# the full-width students of the families no config names: ResNeSt-50d
# behind the flagship's FP-24, the GHND DenseNets and Inception-v3
BUILT_FAMILIES = {
    'resnest': ({'key': 'splittable_resnest', 'kwargs': {
        'bottleneck_config': {'key': 'FPBasedResNetBottleneck', 'kwargs': {
            'num_bottleneck_channels': 24, 'num_target_channels': 256}}}},
        224),
    **{name: ({'key': 'splittable_densenet', 'kwargs': {
        'densenet_name': name, 'bottleneck_config': {
            'key': 'larger_densenet_bottleneck', 'kwargs': {}}}}, 224)
       for name in ('densenet169', 'densenet201')},
    'inception_v3': ({'key': 'splittable_inception_v3', 'kwargs': {
        'bottleneck_config': {'key': 'inception_v3_bottleneck',
                              'kwargs': {}}}}, 299),
}


@pytest.mark.parametrize('family', ['regnet', 'hybrid_vit', 'efficientnet',
                                    *BUILT_FAMILIES])
def test_full_width_parameter_count_equals_jax(family):
    """The full-width models of the configs (FP-64 students at 224 px,
    EfficientNet-L2), and of the ResNeSt, DenseNet and Inception-v3
    families at 224 and 299 px, built on the meta device: as many
    parameters as the JAX package's `eval_shape` gives."""
    if family in BUILT_FAMILIES:
        spec, hw = BUILT_FAMILIES[family]
        with torch.device('meta'):
            pm = load_classification_model(spec, device='meta')
        assert sum(p.numel() for p in pm.parameters()) == _jax_param_count(
            jax_load_model(spec), hw, mode='train')
        return
    if family == 'efficientnet':
        spec = load_config(EFFICIENTNET_CONFIGS[0])['models']['wrapper'][
            'classification_model']
        jspec = jax_load_config(EFFICIENTNET_CONFIGS[0])['models']['wrapper'][
            'classification_model']
        kwargs = {'train': False}
    else:
        path = (REGNET_CONFIGS if family == 'regnet' else VIT_CONFIGS)[0]
        spec = load_config(path)['models']['student_model']
        jspec = jax_load_config(path)['models']['student_model']
        kwargs = {'mode': 'train'}
    with torch.device('meta'):
        pm = load_classification_model(spec, device='meta')
    got = sum(p.numel() for p in pm.parameters())
    assert got == _jax_param_count(jax_load_model(jspec), 224, **kwargs)
    if family == 'efficientnet':
        assert got == 480_309_308
        assert sum(len(s) for s in pm.blocks) == 88
        assert pm.conv_stem.out_channels == 136
        assert pm.conv_head.out_channels == 5504


@pytest.mark.parametrize('path', REGNET_CONFIGS + VIT_CONFIGS,
                         ids=lambda p: p.stem.split('_from_')[0])
def test_student_config_builds_in_the_port(path):
    """The student and the teacher of each RegNet and hybrid-ViT config at
    full width on the meta device: the bottleneck's channel options (a
    64-channel latent), the tail's input width, and the runtime's branch."""
    cfg = load_config(path)
    spec = cfg['models']['student_model']
    kwargs = spec['kwargs']['bottleneck_config']['kwargs']
    sizes = kwargs.get('encoder_channel_sizes',
                       kwargs.get('g_a_channel_sizes'))
    assert sizes == [3, 64, 64, 64]
    with torch.device('meta'):
        student = load_classification_model(spec, device='meta')
        teacher = load_classification_model(cfg['models']['teacher_model'],
                                            device='meta')
        rt = SplitClassifierRuntime(student, device='meta')
    bneck = student.bottleneck_layer
    hyper = spec['kwargs']['bottleneck_config']['key'].startswith('MSHP')
    assert rt.hyper == hyper
    want = ((55, 55, 64), (14, 14, 16)) if hyper else (55, 55, 64)
    assert bneck.latent_shape(224, 224) == want
    if 'regnet' in path.name:
        assert bneck.out_channels == 144 and student.s2.b1.conv1.conv \
            .in_channels == 144
        assert isinstance(teacher, preg.RegNet)
    else:
        assert bneck.out_channels == 256
        assert student.pos_embed.shape == (1, 50, 384)
        assert isinstance(teacher, pvit.HybridViT)


@pytest.mark.parametrize('path', EFFICIENTNET_CONFIGS, ids=lambda p: p.stem)
def test_efficientnet_wrapper_config_builds_in_the_port(path):
    """Each EfficientNet-L2 wrapper config at full width on the meta
    device: the wrapper class and the classifier's size."""
    from sc2bench_tpu_torch.models import zoo
    cfg = load_config(path)['models']['wrapper']
    with torch.device('meta'):
        model = load_classification_model(cfg['classification_model'],
                                          device='meta')
        kwargs = {}
        cm = cfg.get('compression_model')
        if cm is not None:
            module = zoo.registry_get('model', cm['key'])(
                device='meta', **cm['kwargs'])
            kwargs['compression_model'] = zoo.codec_runtime(module,
                                                            device='meta')
        wrapper = wrap_model(cfg, model, device='meta', **kwargs)
    assert type(wrapper).__name__ == cfg['key']
    assert isinstance(model, peff.EfficientNet)
    assert sum(p.numel() for p in model.parameters()) == 480_309_308


def test_bottleneck_channel_options_equal_jax():
    """The channel options set every width of the FP and MSHP bottlenecks
    (the density over `num_bottleneck_channels`); without them the widths
    are the defaults, as before."""
    fp = FPBasedResNetBottleneck(num_bottleneck_channels=64,
                                 encoder_channel_sizes=[3, 64, 64, 64],
                                 decoder_channel_sizes=[64, 288, 144, 144])
    assert [m.out_channels for m in fp.encoder[::2]] == [64, 64, 64]
    assert [m.out_channels for m in fp.decoder[::2]] == [288, 144, 144]
    assert fp.entropy_bottleneck.quantiles.shape[0] == 64
    assert fp.out_channels == 144
    m = MSHPBasedResNetBottleneck(g_a_channel_sizes=[3, 64, 64, 64],
                                  g_s_channel_sizes=[64, 512, 256, 256])
    assert m.h_a[0].in_channels == 64 and m.h_s[-1].out_channels == 128
    assert m.out_channels == 256
    default = FPBasedResNetBottleneck()
    assert [c.out_channels for c in default.encoder[::2]] == [96, 48, 24]
    for jm, pm in ((JaxFP(num_bottleneck_channels=64,
                          encoder_channel_sizes=(3, 64, 64, 64),
                          decoder_channel_sizes=(64, 288, 144, 144)), fp),
                   (JaxMSHP(g_a_channel_sizes=(3, 64, 64, 64),
                            g_s_channel_sizes=(64, 512, 256, 256)), m)):
        count = jax.eval_shape(lambda: jm.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, 32, 32, 3))))
        assert sum(p.numel() for p in pm.parameters()) == sum(
            int(np.prod(a.shape)) for a in jax.tree.leaves(count['params']))


@pytest.mark.parametrize('builder', [
    'regnety_064', 'splittable_regnet', 'hybrid_vit_small_r26_s32_224',
    'splittable_hybrid_vit', 'efficientnet', 'tf_efficientnet_l2_ns',
    'tf_efficientnet_l2_ns_475', 'splittable_resnest', 'resnest50d',
    'splittable_densenet', 'splittable_inception_v3'])
def test_builders_need_a_card_unless_asked(builder, monkeypatch):
    """Each new builder registers under `model` and builds on the card
    unless given a device; without a card it raises before building."""
    from sc2bench_tpu_torch.registry import lookup
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    fn = lookup('model', builder)
    kwargs = {'bottleneck_config': {
        'key': 'FPBasedResNetBottleneck',
        'kwargs': {'num_bottleneck_channels': 64,
                   'encoder_channel_sizes': [3, 64, 64, 64]}}} \
        if builder.startswith('splittable') else {}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fn(**kwargs)
    with torch.device('meta'):
        model = fn(device='meta', **kwargs)
    assert next(model.parameters()).device.type == 'meta'
