"""The port's COCO detection (Faster R-CNN + FPN over the splittable
ResNet, its split runtime on both wires, the box ops, RoIAlign, the bbox
evaluator, the transform and the data) against the JAX package on the CPU.

Small size: stages (1, 1, 1, 1), an FP bottleneck of 8 channels (target
256, the width of the teacher's layer1 that the hints read), 5 classes,
96 px canvases. One set of Flax variables randomized with numpy
(`test_torch_port_model._randomize`; the FP decoder's IGDN couplings
drawn small and the FPN and heads' kernels scaled, so that the features
and the heads' outputs are of order one: `det_variables`) goes into both
packages, into the port through `state_dict_from_flax`. Tolerances,
relative and of each tensor's largest magnitude (`close`): box ops 1e-6,
FPN, RPN head and RoIAlign 1e-5, `roi_predict` 1e-4; anchors, NMS
indices and keep masks, proposal validity, the detections' labels and
validity (in every slot, the rejected ones too) equal; symbols and wire
bytes equal; the 12 COCO metrics equal.

The small Faster R-CNN registers as `faster_rcnn_small` in both packages'
model registries (`register_small`), which
`test_torch_port_detection_train.py` shares.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.registry as jax_registry
from sc2bench_tpu.datasets import coco as jax_coco
from sc2bench_tpu.datasets import util as jax_util
from sc2bench_tpu.models.detection import fpn as jax_fpn
from sc2bench_tpu.models.detection import rcnn as jax_rcnn
from sc2bench_tpu.models.detection.base import \
    SplittableDetectionBackbone as JaxBackbone
from sc2bench_tpu.models.detection.transform import \
    RCNNTransform as JaxTransform
from sc2bench_tpu.models.detection.wrapper import \
    SplitDetectionRuntime as JaxDetRuntime
from sc2bench_tpu.models.layer import get_layer as jax_get_layer
from sc2bench_tpu.ops import boxes as jax_boxes
from sc2bench_tpu.ops import roi_align as jax_roi
from sc2bench_tpu.transforms import collator as jax_collator
from sc2bench_tpu.utils.coco_eval import CocoEvaluator as JaxCocoEvaluator
import sc2bench_tpu_torch.registry as port_registry
from sc2bench_tpu_torch.analysis import get_binary_object_size
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.datasets import coco, util
from sc2bench_tpu_torch.models.detection import fpn, rcnn
from sc2bench_tpu_torch.models.detection.base import \
    SplittableDetectionBackbone
from sc2bench_tpu_torch.models.detection.registry import \
    load_detection_model
from sc2bench_tpu_torch.models.detection.transform import RCNNTransform
from sc2bench_tpu_torch.models.detection.wrapper import \
    SplitDetectionRuntime
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.ops import boxes, roi_align
from sc2bench_tpu_torch.transforms import collator
from sc2bench_tpu_torch.train.optim import label_params
from sc2bench_tpu_torch.utils.coco_eval import CocoEvaluator
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from test_torch_port_model import _randomize

REPO = Path(__file__).resolve().parents[1]
COCO = REPO / 'configs/coco2017/supervised_compression'
STAGES, CLASSES, CANVAS, BCH, TARGET = (1, 1, 1, 1), 5, 96, 8, 256
SMALL = 'faster_rcnn_small'
FP = {'key': 'FPBasedResNetBottleneck',
      'kwargs': {'num_bottleneck_channels': BCH,
                 'num_target_channels': TARGET}}
BQ = {'key': 'larger_resnet_bottleneck',
      'kwargs': {'bottleneck_channel': 3, 'output_channel': TARGET}}
# the COCO configs the port builds: the Entropic Student, end-to-end and
# CR+BQ families, and the tiny sample
CONFIGS = sorted(COCO.rglob('*.yaml')) \
    + [REPO / 'configs/sample/tiny_detection.yaml']
# the FP decoder's IGDN couplings drawn smaller than `_randomize` draws
# them (its output grows with the decoder's width) and these kernels
# scaled, so that the randomized model's features and heads' outputs are
# of order one and its first training steps stay finite at the recipes'
# learning rates
IGDN_COUPLING = 1e-4
KERNEL_SCALES = {**{('fpn', f'{kind}_{i}'): 0.3
                    for kind in ('inner', 'layer') for i in range(4)},
                 ('rpn_head', 'cls_logits'): 0.1,
                 ('rpn_head', 'bbox_pred'): 0.01,
                 ('box_head', 'fc6'): 0.3,
                 ('box_predictor', 'cls_score'): 0.5,
                 ('box_predictor', 'bbox_pred'): 0.01}


# ---- the small model, under one name in both packages -----------------------

def _small_bottleneck(backbone_config, builder):
    bcfg = (backbone_config or {}).get('bottleneck_config')
    return builder(bcfg['key'], **bcfg.get('kwargs', {})) if bcfg else None


def jax_small(backbone_config=None, num_classes=CLASSES, **kwargs):
    return jax_rcnn.FasterRCNN(
        backbone=JaxBackbone(bottleneck_layer=_small_bottleneck(
            backbone_config, jax_get_layer), stage_sizes=STAGES),
        num_classes=num_classes)


def port_small(backbone_config=None, num_classes=CLASSES, device=None,
               **kwargs):
    return rcnn.FasterRCNN(SplittableDetectionBackbone(
        _small_bottleneck(backbone_config, get_layer), STAGES),
        num_classes=num_classes).to(device)


def register_small(mp):
    mp.setitem(jax_registry._registry('model'), SMALL, jax_small)
    mp.setitem(port_registry._registry('model'), SMALL, port_small)


_SHAPES = {}


def det_variables(module, seed, hw=(CANVAS, CANVAS)):
    """Randomized Flax variables of a JAX Faster R-CNN, the FP decoder's
    IGDN couplings drawn small (IGDN_COUPLING) and some kernels scaled
    (KERNEL_SCALES). The variables' shapes are traced once a model."""
    key = (repr(module), hw)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(lambda: module.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, *hw, 3)), mode='train'))
    shapes = _SHAPES[key]
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    bneck = variables['params']['backbone'].get('bottleneck_layer', {})
    for name, tree in bneck.items():
        if name.startswith('dec_igdn'):
            c = tree['gamma'].shape[0]
            tree['gamma'] = np.sqrt(0.1 * np.eye(c) + rng.uniform(
                0, IGDN_COUPLING, (c, c))).astype(np.float32)
    for path, scale in KERNEL_SCALES.items():
        tree = variables['params']
        for name in path:
            tree = tree[name]
        tree['kernel'] *= np.float32(scale)
    return variables


def port_of(variables, backbone_config=None):
    pm = port_small(backbone_config, device='cpu')
    pm.load_state_dict(state_dict_from_flax(variables, pm), strict=True)
    return pm.eval()


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(
        1.0, float(np.abs(want).max())))


def canvases(seed, n, hw=(CANVAS, CANVAS)):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, (1, *hw, 3)).astype(np.float32)
            for _ in range(n)]


def random_boxes(rng, n, extent=100.0, min_wh=2.0, max_wh=40.0):
    x1 = rng.uniform(0, extent, n)
    y1 = rng.uniform(0, extent, n)
    return np.stack([x1, y1, x1 + rng.uniform(min_wh, max_wh, n),
                     y1 + rng.uniform(min_wh, max_wh, n)],
                    1).astype(np.float32)


# ---- box ops and NMS --------------------------------------------------------

def test_box_ops_equal_jax():
    """IoU, encode, decode (dw, dh clamped at log(1000/16)), clip and the
    small-box mask within 1e-6 of JAX's."""
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 30), random_boxes(rng, 20)
    close(boxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)),
          jax_boxes.box_iou(a, b), 1e-6)
    for w in ((1.0, 1.0, 1.0, 1.0), rcnn.BOX_REG_WEIGHTS):
        close(boxes.encode_boxes(torch.from_numpy(a[:20]),
                                 torch.from_numpy(b), w),
              jax_boxes.encode_boxes(a[:20], b, w), 1e-6)
        d = rng.normal(0, 3, (20, 4)).astype(np.float32)
        d[0, 2] = 40.0           # beyond the clamp
        close(boxes.decode_boxes(torch.from_numpy(d), torch.from_numpy(b),
                                 w), jax_boxes.decode_boxes(d, b, w), 1e-6)
    wide = random_boxes(rng, 40, extent=120.0) - 10.0
    close(boxes.clip_boxes(torch.from_numpy(wide), (90, 100)),
          jax_boxes.clip_boxes(wide, (90, 100)), 1e-6)
    np.testing.assert_array_equal(
        boxes.remove_small_boxes_mask(torch.from_numpy(a), 10.0),
        jax_boxes.remove_small_boxes_mask(a, 10.0))


def _nms_case(name):
    """(boxes, scores, max_out) of one NMS case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == 'all_suppressed':            # one box repeated
        b = np.tile(random_boxes(rng, 1), (300, 1))
        return b, rng.uniform(0, 1, 300).astype(np.float32), 20
    if name == 'none_suppressed':           # a grid of disjoint boxes
        g = np.arange(20, dtype=np.float32) * 10
        x, y = np.meshgrid(g, g)
        b = np.stack([x.ravel(), y.ravel(), x.ravel() + 5, y.ravel() + 5], 1)
        return b, rng.uniform(0, 1, 400).astype(np.float32), 1000
    n, max_out = {'n50': (50, 10), 'n700_ties': (700, 100),
                  'n1500_few_out': (1500, 64),
                  'n1500_many_out': (1500, 2000)}[name]
    b = random_boxes(rng, n, extent=200.0)
    s = rng.uniform(0, 1, n).astype(np.float32)
    if 'ties' in name:                      # exact ties and -1 fillers
        s = np.round(s * 8) / 8
        s[rng.uniform(size=n) < 0.2] = -1.0
    return b, s, max_out


@pytest.mark.parametrize('name', ['n50', 'n700_ties', 'n1500_few_out',
                                  'n1500_many_out', 'all_suppressed',
                                  'none_suppressed'])
def test_nms_equals_jax_and_the_serial_oracle(name):
    """`nms_mask` gives JAX's indices and keep mask; its kept set is the
    serial greedy one (the port's and JAX's oracles agree); and
    `batched_nms_mask` over three classes equals JAX's."""
    b, s, max_out = _nms_case(name)
    tb, ts = torch.from_numpy(b), torch.from_numpy(s)
    idx, keep = boxes.nms_mask(tb, ts, 0.5, max_out)
    j_idx, j_keep = jax.jit(jax_boxes.nms_mask, static_argnums=(2, 3))(
        jnp.asarray(b), jnp.asarray(s), 0.5, max_out)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    k = min(max_out, len(b))
    s_idx, s_keep = boxes._nms_mask_serial(tb, ts, 0.5, k)
    j_sidx, j_skeep = jax.jit(jax_boxes._nms_mask_serial,
                              static_argnums=(2, 3))(
        jnp.asarray(b), jnp.asarray(s), 0.5, k)
    np.testing.assert_array_equal(s_keep.numpy(), np.asarray(j_skeep))
    np.testing.assert_array_equal(s_idx.numpy()[s_keep.numpy()],
                                  np.asarray(j_sidx)[np.asarray(j_skeep)])
    np.testing.assert_array_equal(keep.numpy()[:k], s_keep.numpy())
    np.testing.assert_array_equal(idx.numpy()[:k][keep.numpy()[:k]],
                                  s_idx.numpy()[s_keep.numpy()])
    cls = np.random.default_rng(1).integers(0, 3, len(b))
    idx, keep = boxes.batched_nms_mask(tb, ts, torch.from_numpy(cls), 0.5,
                                       max_out)
    j_idx, j_keep = jax.jit(jax_boxes.batched_nms_mask,
                            static_argnums=(3, 4))(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(cls), 0.5, max_out)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))


# ---- RoIAlign ---------------------------------------------------------------

def test_roi_align_equals_jax():
    """`multiscale_roi_align` over P2-P5 of a 96 px canvas within 1e-5 of
    JAX's: RoIs on every level, partly outside the map, and degenerate
    (zero width or height); `roi_align` on one level likewise."""
    rng = np.random.default_rng(2)
    feats = [rng.normal(0, 1, (s, s + 2, 16)).astype(np.float32)
             for s in (24, 12, 6, 3)]
    rois = np.concatenate([
        random_boxes(rng, 8, 80.0, 4.0, 20.0),           # level 0
        random_boxes(rng, 6, 60.0, 130.0, 200.0),       # level 1
        random_boxes(rng, 6, 60.0, 250.0, 400.0),       # level 2
        random_boxes(rng, 4, 40.0, 500.0, 700.0),       # level 3
        random_boxes(rng, 6, 80.0) - 30.0,              # partly outside
        np.asarray([[10, 10, 10, 30], [20, 5, 40, 5], [50, 50, 50, 50]],
                   np.float32)])                       # degenerate
    scales = [0.25, 0.125, 0.0625, 0.03125]
    want = jax.jit(lambda f, r: jax_roi.multiscale_roi_align(
        f, r, 7, scales))([jnp.asarray(f) for f in feats], jnp.asarray(rois))
    got = roi_align.multiscale_roi_align(
        [torch.from_numpy(f.transpose(2, 0, 1).copy()) for f in feats],
        torch.from_numpy(rois), 7, scales)
    levels = roi_align._fpn_level(torch.from_numpy(rois), 4, 224, 4)
    assert set(levels.tolist()) == {0, 1, 2, 3}
    close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)
    want = jax.jit(lambda f, r: jax_roi.roi_align(f, r, 7, 0.125))(
        jnp.asarray(feats[1]), jnp.asarray(rois))
    got = roi_align.roi_align(
        torch.from_numpy(feats[1].transpose(2, 0, 1).copy()),
        torch.from_numpy(rois), 7, 0.125)
    close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)


# ---- the model --------------------------------------------------------------

@pytest.fixture(scope='module')
def fp_models():
    """A JAX Faster R-CNN with the FP bottleneck, its variables, the
    port's model on them, and JAX's 'finetune' outputs and detections on
    a 96 px canvas."""
    jm = jax_small({'bottleneck_config': FP})
    variables = det_variables(jm, 5)
    pm = port_of(variables, {'bottleneck_config': FP})
    x = canvases(6, 1)[0]
    out, dets = jax.jit(lambda v, x: (lambda o: (o, jax_rcnn.
                                                 postprocess_detections(o)))(
        jm.apply(v, x, mode='finetune', train=False)))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    return jm, variables, pm, x, out, dets


def test_fpn_rpn_head_and_anchors_equal_jax(fp_models):
    """P2-P6 and the RPN head's flattened objectness and deltas within
    1e-5 of JAX's from the same image; the anchors equal (the numpy copy
    of `generate_anchors`, also at a non-square canvas); the captured
    `io` names the JAX package's."""
    _, _, pm, x, out, _ = fp_models
    io = {}
    with torch.no_grad():
        got = pm(nchw(x), mode='finetune', io=io)
    for a, b in zip(got['features'], out['features']):
        close(nhwc(a), b, 1e-5)
    assert len(got['features']) == 5
    close(got['objectness'].numpy(), out['objectness'], 1e-5)
    close(got['rpn_deltas'].numpy(), out['rpn_deltas'], 1e-5)
    np.testing.assert_array_equal(got['anchors'].numpy(),
                                  np.asarray(out['anchors']))
    shapes = [(20, 34), (10, 17), (5, 9), (3, 5), (2, 3)]
    for want, have in zip(jax_fpn.generate_anchors(shapes, (80, 136)),
                          fpn.generate_anchors(shapes, (80, 136))):
        np.testing.assert_array_equal(have, want)
    assert set(io) == {'backbone.bottleneck_layer_out',
                       'backbone.layer2_out', 'backbone.layer3_out',
                       'backbone.layer4_out'}


def test_propose_equals_jax(fp_models):
    """Fed JAX's objectness and deltas, `propose` gives JAX's proposals
    (within 1e-5) and validity (equal), in eval and training budgets; and
    some are valid."""
    _, _, pm, _, out, _ = fp_models
    obj, deltas = np.array(out['objectness'])[0], \
        np.array(out['rpn_deltas'])[0]
    anchors = np.array(out['anchors'])
    sizes = [CANVAS // 4 * CANVAS // 4 * 3, 12 * 12 * 3, 6 * 6 * 3, 27, 12]
    propose = jax.jit(jax_rcnn.propose, static_argnums=(3, 4, 5))
    for training in (False, True):
        want = propose(jnp.asarray(obj), jnp.asarray(deltas),
                       jnp.asarray(anchors), tuple(sizes), (CANVAS, CANVAS),
                       training)
        got = rcnn.propose(torch.from_numpy(obj), torch.from_numpy(deltas),
                           torch.from_numpy(anchors), sizes,
                           (CANVAS, CANVAS), training)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        close(got[0].numpy(), want[0], 1e-5)
        assert 0 < int(got[1].sum()) < len(got[1])


def test_roi_predict_and_postprocess_equal_jax(fp_models):
    """Fed JAX's features and proposals, `roi_predict` within 1e-4; fed
    JAX's head outputs, `postprocess_detections` gives JAX's labels and
    validity in every slot and its boxes and scores within 1e-5."""
    jm, variables, pm, _, out, dets = fp_models
    feats = [torch.from_numpy(np.ascontiguousarray(
        np.asarray(f).transpose(0, 3, 1, 2))) for f in out['features']]
    with torch.no_grad():
        logits, reg = pm.roi_predict(
            feats, torch.from_numpy(np.asarray(out['proposals'])),
            (CANVAS, CANVAS))
    close(logits.numpy(), out['class_logits'], 1e-4)
    close(reg.numpy(), out['box_regression'], 1e-4)
    heads = {k: np.array(out[k]) for k in (
        'class_logits', 'box_regression', 'proposals', 'proposal_valid')}
    for thresh in (rcnn.BOX_SCORE_THRESH, 0.4):
        want = dets if thresh == rcnn.BOX_SCORE_THRESH else jax.jit(
            lambda h: jax_rcnn.postprocess_detections(
                {**h, 'image_hw': (CANVAS, CANVAS)}, score_thresh=thresh))(
            heads)
        got = rcnn.postprocess_detections(
            {k: torch.from_numpy(v) for k, v in heads.items()}
            | {'image_hw': (CANVAS, CANVAS)}, score_thresh=thresh)
        for k in ('labels', 'valid'):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        for k in ('boxes', 'scores'):
            close(got[k].numpy(), want[k], 1e-5)
    assert 0 < int(got['valid'].sum()) < got['valid'].numel()


def test_fc6_conversion_and_flax_paths():
    """Flax's `box_head/fc6` flattens a pooled RoI as (h, w, c), torch's
    reads (c, h, w): on a non-symmetric kernel the converted weight gives
    the same product; every parameter's Flax path round-trips, and the
    configs' frozen prefixes label the bottleneck's encoder and density as
    JAX's optimizer does."""
    rng = np.random.default_rng(8)
    kernel = rng.normal(0, 1, (7 * 7 * 16, 10)).astype(np.float32)
    pooled = rng.normal(0, 1, (3, 7, 7, 16)).astype(np.float32)
    variables = {'params': {'backbone': {}, 'rpn_head': {}, 'box_head': {
        'fc6': {'kernel': kernel, 'bias': np.zeros(10, np.float32)}}}}
    weight = state_dict_from_flax(variables)['roi_heads.box_head.fc6.weight']
    got = torch.from_numpy(pooled.transpose(0, 3, 1, 2).copy()).flatten(1) \
        @ weight.T
    close(got.numpy(), pooled.reshape(3, -1) @ kernel, 1e-5)
    for bneck in (FP, BQ, None):
        cfg = {'bottleneck_config': bneck} if bneck else None
        pm = port_small(cfg, device='cpu')
        jm = jax_small(cfg)
        shapes = jax.eval_shape(lambda: jm.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, 64, 64, 3)), mode='train'))['params']
        want = {'.'.join(str(getattr(k, 'key', k)) for k in p)
                for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        assert {flax_param_path(n, pm) for n, _ in pm.named_parameters()} \
            == want
    labels = label_params(port_small({'bottleneck_config': FP}),
                          ['bottleneck_layer.enc_*',
                           'bottleneck_layer.entropy_bottleneck'])
    frozen = {n for n, v in labels.items() if v == 'frozen'}
    assert frozen and all(n.startswith(('backbone.body.bottleneck_layer.'
                                        'encoder.', 'backbone.body.'
                                        'bottleneck_layer.entropy_')) for n
                          in frozen)
    assert labels['backbone.body.bottleneck_layer.entropy_bottleneck.'
                  'quantiles'] == 'aux'


@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: p.stem)
def test_config_builds_in_the_port(path):
    """The config's student (or model) and teacher built by
    `load_detection_model` on the meta device at full width: 91 classes
    (5 for the tiny sample), ResNet-50, the configured bottleneck (FP-24
    with a codec, or the CR+BQ encoder with none), the teacher's stem and
    layer1."""
    cfg = load_config(path)
    models = cfg['models']
    for role, spec in models.items():
        with torch.device('meta'):
            model = load_detection_model({**spec, 'ckpt': None},
                                         device='meta')
        kw = spec['kwargs']
        assert model.roi_heads.box_predictor.cls_score.out_features \
            == kw['num_classes']
        assert len(model.backbone.body.layer3) == 6
        bneck = kw.get('backbone_config', {}).get('bottleneck_config')
        if bneck is None:
            assert role == 'teacher_model'
            assert len(model.backbone.body.layer1) == 3
            continue
        with torch.device('meta'):
            rt = SplitDetectionRuntime(model, device='meta')
        if bneck['key'] == 'FPBasedResNetBottleneck':
            assert rt.codec is not None and rt._bneck.entropy_bottleneck \
                .quantiles.shape[0] == bneck['kwargs'][
                    'num_bottleneck_channels']
        else:
            assert rt.codec is None and not rt.update()
            assert rt._bneck.encoder.out_channels \
                == bneck['kwargs']['bottleneck_channel']


def test_full_width_parameter_count_equals_jax():
    """`faster_rcnn_model` at full width (ResNet-50, 91 classes), with the
    FP-24 bottleneck and without: JAX's parameter and statistics counts."""
    fp24 = {'key': 'FPBasedResNetBottleneck',
            'kwargs': {'num_bottleneck_channels': 24,
                       'num_target_channels': 256}}
    for bcfg in (fp24, None):
        kw = {'backbone_config': {'resnet_name': 'resnet50',
                                  'bottleneck_config': bcfg},
              'num_classes': 91}
        jm = jax_rcnn.faster_rcnn_model(**kw)
        shapes = jax.eval_shape(lambda: jm.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, 64, 64, 3)), mode='train'))
        with torch.device('meta'):
            pm = rcnn.faster_rcnn_model(device='meta', **kw)
        assert sum(p.numel() for p in pm.parameters()) == sum(
            int(np.prod(a.shape)) for a in jax.tree.leaves(shapes['params']))
        assert sum(b.numel() for k, b in pm.named_buffers()
                   if 'running' in k) == sum(
            int(np.prod(a.shape))
            for a in jax.tree.leaves(shapes['batch_stats']))


# ---- the split runtime ------------------------------------------------------

@pytest.fixture(scope='module')
def runtimes(fp_models):
    """(port runtime, canvases, JAX's per-image references) on the FP
    model's variables, tables built. Two 96x96 canvases, then one 64x128:
    a canvas change inside the list (and in the lane count), groups of 2
    and 1 at wire_batch=2. JAX's references: the int16 symbols, the host
    wire's detections, sizes and summary (`stream_detect`), and the device
    wire's packed bytes and [ok, nbytes] (`encode_device_wire`)."""
    jm, variables, pm, _, _, _ = fp_models
    jrt = JaxDetRuntime(jm, jax.tree.map(jnp.asarray, variables))
    assert jrt.update()
    prt = SplitDetectionRuntime(pm, device='cpu')
    assert prt.update()
    xs = canvases(41, 2) + canvases(42, 1, (64, 128))
    ref = {'symbols': [np.asarray(jrt._encode_device(jnp.asarray(x))[
        'symbols']) for x in xs]}
    ref['dets'], ref['sizes'], ref['summary'] = _serve(
        jrt, [jnp.asarray(x) for x in xs], 'stream_detect', depth=2,
        workers=1)
    ref['wire'], ref['meta'] = [], []
    for x in xs:
        ops = jrt.encode_device_wire(jnp.asarray(x))
        ref['wire'].append(_jax_wire(ops))
        ref['meta'].append((np.asarray(ops['meta']).tolist(),
                            tuple(ops['lat_shape'][:2])))
    ref['codec'] = jrt.codec
    return prt, xs, ref


def _serve(rt, xs, fn, **kw):
    rt.clear_analysis()
    rt.activate_analysis()
    out = getattr(rt, fn)(xs, **kw)
    sizes = list(rt.analyzers[0].file_size_list)
    summary = rt.summarize()
    rt.deactivate_analysis()
    return out, sizes, summary


def _jax_wire(ops):
    from sc2bench_tpu.ops.rans.device import pack_stream as jax_pack
    return jax_pack({k: np.asarray(ops[k]) for k in ('streams', 'lengths',
                                                     'states')})


def _check_dets(got, want, tol=1e-4):
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ('boxes', 'scores'):
        close(got[k].numpy(), want[k], tol)


def test_symbols_and_host_wire_equal_jax(runtimes):
    """The port's encoder gives JAX's int16 symbols (no mismatch), and its
    cyclic host coder JAX's strings on them; `stream_detect` accounts
    JAX's sizes and summary and gives its detections (labels and validity
    in every slot equal, boxes and scores within 1e-4)."""
    prt, xs, ref = runtimes
    for x, want in zip(xs, ref['symbols']):
        got = prt.encode_device(nchw(x))['symbols']
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)
        assert prt.codec.compress_wire(want) \
            == ref['codec'].compress_wire(want)
    got, sizes, summary = _serve(prt, [nchw(x) for x in xs], 'stream_detect',
                                 depth=2)
    assert sizes == ref['sizes'] and summary == ref['summary']
    assert 0 < sum(int(g['valid'].sum()) for g in got)
    for g, w in zip(got, ref['dets']):
        assert g['boxes'].shape == (1, 100, 4)
        _check_dets(g, w)


@pytest.mark.parametrize('wire_batch', [None, 2], ids=['batch1',
                                                       'wire_batch2'])
def test_device_wire_equals_jax(runtimes, wire_batch):
    """The device wire through the cyclic kernels' plain versions, over a
    canvas change: each image's packed stream and [ok, nbytes] equal
    JAX's `encode_device_wire` (lanes per canvas); `stream_detect_device`
    accounts those sizes, no image escapes, and its detections are the
    direct decode -> tail -> postprocess on the encoder's symbols (equal
    at batch 1) and JAX's."""
    prt, xs, ref = runtimes
    lanes, want_sizes = set(), []
    for x, wire, (meta, lat_hw) in zip(xs, ref['wire'], ref['meta']):
        p_ops = prt.encode_device_wire(nchw(x))
        lanes.add(int(p_ops['streams'].shape[0]))
        assert prt._pull_device_wire(p_ops) == wire
        assert meta[0] and p_ops['meta'].tolist() == meta
        want_sizes.append(get_binary_object_size(
            {'strings': [[bytes(meta[1])]], 'shape': lat_hw}))
    assert len(lanes) == 2
    prt.escapes = {'ok': 0, 'valid': 0}
    got, sizes, _ = _serve(prt, [nchw(x) for x in xs],
                           'stream_detect_device', depth=2,
                           wire_batch=wire_batch)
    assert prt.escapes == {'ok': 0, 'valid': 0}
    assert sizes == want_sizes
    for i, (x, g) in enumerate(zip(xs, got)):
        _check_dets(g, ref['dets'][i])
        if wire_batch is None and i in (0, len(xs) - 1):
            flat, shape = prt._symbols_nhwc(nchw(x))
            with torch.no_grad():
                direct = prt._decode_tail(flat, shape, x.shape[1:3])
            for k in direct:
                assert torch.equal(direct[k], g[k]), k


def test_escape_recoded_on_the_host_wire_as_jax(runtimes):
    """An image whose latent leaves the CDF support (ok=False) after a
    normal one: re-coded on the host wire and accounted with JAX's
    host-wire bytes (JAX's device wire escapes to its host stage), the
    other with its device-wire size; one `ok` escape."""
    prt, xs, ref = runtimes
    wild = xs[1] * 120.0
    _, host_sizes, _ = _serve(prt, [nchw(wild)], 'stream_detect')
    prt.escapes = {'ok': 0, 'valid': 0}
    got, sizes, _ = _serve(prt, [nchw(xs[0]), nchw(wild)],
                           'stream_detect_device')
    assert prt.escapes == {'ok': 1, 'valid': 0}
    meta, lat_hw = ref['meta'][0]
    assert sizes == [get_binary_object_size(
        {'strings': [[bytes(meta[1])]], 'shape': lat_hw}), host_sizes[0]]
    _check_dets(got[0], ref['dets'][0])
    assert got[1]['boxes'].shape == (1, 100, 4)


def test_bq_student_has_no_codec():
    """A CR+BQ student (`larger_resnet_bottleneck`): `update()` returns
    False (JAX's raises, and its engine then tests the plain forward),
    and the device wire raises."""
    prt = SplitDetectionRuntime(port_small({'bottleneck_config': BQ},
                                           device='cpu'), device='cpu')
    assert prt.codec is None and not prt.update()
    with pytest.raises(ValueError, match='no entropy model'):
        prt.stream_detect_device([torch.zeros(1, 3, 64, 64)])


# ---- evaluator, transform, data ---------------------------------------------

def _eval_case():
    """Targets of four images (one with a crowd box, one with a box per
    area range) and predictions (none for one image, misses, duplicates,
    a crowd hit)."""
    rng = np.random.default_rng(60)
    targets, preds = [], {}
    for i in range(4):
        n = 3 + i
        b = random_boxes(rng, n, 300.0, 5.0, 150.0)
        t = {'boxes': b, 'labels': rng.integers(1, 4, n).astype(np.int32),
             'area': ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
                      ).astype(np.float32),
             'iscrowd': (np.arange(n) == 1).astype(np.int32) * (i == 0),
             'image_id': 10 + i}
        targets.append(t)
        if i == 2:
            continue                        # no detections at all
        jitter = rng.normal(0, 4, b.shape).astype(np.float32)
        pb = np.concatenate([b + jitter, random_boxes(rng, 3, 300.0),
                             b[:1] + 1.0])
        preds[10 + i] = {
            'boxes': pb, 'scores': rng.uniform(0, 1, len(pb)),
            'labels': np.concatenate([t['labels'],
                                      rng.integers(1, 4, 3),
                                      t['labels'][:1]])}
    return targets, preds


def test_coco_evaluator_equals_jax():
    """All 12 COCO metrics equal JAX's, with crowd boxes and an image
    without detections; an area range without ground truth gives -1; an
    unknown evaluation type raises."""
    targets, preds = _eval_case()
    out = []
    for cls in (CocoEvaluator, JaxCocoEvaluator):
        ev = cls()
        for t in targets:
            ev.add_gt(t)
        ev.update(preds)
        ev.synchronize_between_processes()
        ev.accumulate()
        out.append(ev.summarize())
    assert out[0] == out[1]
    assert len(out[0]) == 12 and 0.0 < out[0]['AP'] < 1.0
    with pytest.raises(ValueError, match='unknown iou_type'):
        CocoEvaluator(iou_type='mask')


def test_transform_equals_jax():
    """Resize, normalization and the bucketed canvas equal JAX's: a
    landscape, a portrait and a mixed batch (the square canvas)."""
    rng = np.random.default_rng(70)
    land = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    port = rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)
    kw = dict(min_size=64, max_size=96, size_divisible=32,
              canvas_buckets=True)
    for batch in ([land], [port], [land, port]):
        got = RCNNTransform(**kw)(batch)
        want = JaxTransform(**kw)(batch)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    assert RCNNTransform(**kw)([land, port])[0].shape[1:3] == (96, 96)


def test_data_collate_and_padding_equal_jax(tmp_path):
    """`SyntheticDetectionDataset` makes JAX's draws; `coco_collate_fn`,
    `pad_detection_targets` and `get_num_iterations` equal JAX's;
    `CocoDetectionDataset` reads a COCO JSON as JAX's does (an image
    without annotations dropped, a zero-width box skipped)."""
    want = jax_coco.SyntheticDetectionDataset(num_samples=3,
                                              image_size=(20, 30), seed=4)
    got = coco.SyntheticDetectionDataset(num_samples=3, image_size=(20, 30),
                                         seed=4)
    batch_g, batch_w = [got[i] for i in range(3)], [want[i] for i in range(3)]
    for (gi, gt), (wi, wt) in zip(batch_g, batch_w):
        np.testing.assert_array_equal(gi, wi)
        assert gt.keys() == wt.keys()
        for k in gt:
            np.testing.assert_array_equal(gt[k], wt[k])
    g_imgs, g_tgts = collator.coco_collate_fn(batch_g)
    w_imgs, w_tgts = jax_collator.coco_collate_fn(batch_w)
    assert len(g_imgs) == len(w_imgs) == 3
    for k, v in coco.pad_detection_targets(g_tgts, 2).items():
        np.testing.assert_array_equal(
            v, jax_coco.pad_detection_targets(w_tgts, 2)[k])
    loader = list(range(7))
    assert util.get_num_iterations(loader, 3, 2) \
        == jax_util.get_num_iterations(loader, 3, 2) == 10
    from PIL import Image
    import json
    for name in ('a.png', 'b.png'):
        Image.fromarray(np.full((6, 8, 3), 7, np.uint8)).save(tmp_path / name)
    ann = {'images': [{'id': 3, 'file_name': 'a.png'},
                      {'id': 1, 'file_name': 'b.png'}],
           'categories': [{'id': 2, 'name': 'x'}],
           'annotations': [
               {'id': 5, 'image_id': 3, 'bbox': [1, 1, 3, 2],
                'category_id': 2, 'area': 6.0, 'iscrowd': 0},
               {'id': 6, 'image_id': 3, 'bbox': [1, 1, 0, 2],
                'category_id': 2}]}
    (tmp_path / 'ann.json').write_text(json.dumps(ann))
    kw = dict(img_dir=str(tmp_path), ann_file_path=str(tmp_path / 'ann.json'))
    got, want = coco.CocoDetectionDataset(**kw), \
        jax_coco.CocoDetectionDataset(**kw)
    assert len(got) == len(want) == 1
    (gi, gt), (wi, wt) = got[0], want[0]
    np.testing.assert_array_equal(gi, wi)
    for k in wt:
        np.testing.assert_array_equal(gt[k], wt[k])
