"""The port's Mask R-CNN, Keypoint R-CNN and RetinaNet, the segm and
keypoint COCO evaluations and FrozenBatchNorm against the JAX package on
the CPU.

Small size, as `test_torch_port_detection.py`: stages (1, 1, 1, 1), an FP
bottleneck of 8/256 channels (or the CR+BQ one, whose student the engine
scores on its plain forward), 5 classes (2 for Keypoint R-CNN, 17
keypoints), 64-96 px canvases; the heads at their full widths (they have
no width option in JAX). One set of randomized Flax variables
(`det_variables`) goes into both packages, into the port through
`state_dict_from_flax`. The small models register as `mask_rcnn_small`,
`keypoint_rcnn_small` and `retinanet_small` in both packages' registries.

Tolerances, relative and of each tensor's largest magnitude (`close`):
the heads' logits 1e-4, mask probabilities and heatmaps 1e-4 (absolute),
RetinaNet's outputs 1e-4, its losses and their gradients 1e-5, the
postprocessed boxes and scores 1e-5, `mask_loss` 1e-6, FrozenBatchNorm's
forward 1e-5 and its step's parameters as the other step tests hold them;
anchors, detection labels and valid slots, pasted masks, rasterized
polygons and the evaluators' metrics equal.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.registry as jax_registry
from sc2bench_tpu.datasets import coco as jax_coco
from sc2bench_tpu.models.detection import heads as jax_heads
from sc2bench_tpu.models.detection import rcnn as jax_rcnn
from sc2bench_tpu.models.detection import retinanet as jax_retina
from sc2bench_tpu.models.detection.base import \
    SplittableDetectionBackbone as JaxBackbone
from sc2bench_tpu.models.detection.transform import \
    RCNNTransform as JaxTransform
from sc2bench_tpu.models.layer import get_layer as jax_get_layer
from sc2bench_tpu.train.det_engine import DetectionEngine as JaxDetEngine
from sc2bench_tpu.train.optim import build_optimizer as jax_build_optimizer
from sc2bench_tpu.utils import coco_eval as jax_eval
from sc2bench_tpu.utils import torch_convert as jax_convert
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
import sc2bench_tpu_torch.registry as port_registry
from sc2bench_tpu_torch.datasets import coco
from sc2bench_tpu_torch.models.detection import heads, rcnn, retinanet
from sc2bench_tpu_torch.models.detection.base import \
    SplittableDetectionBackbone
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.models.resnet import BatchNorm2d, FrozenBatchNorm2d
from sc2bench_tpu_torch.tasks.object_detection import main
from sc2bench_tpu_torch.train.det_engine import DetectionEngine
from sc2bench_tpu_torch.train.optim import StageOptimizer
from sc2bench_tpu_torch.utils import coco_eval
from sc2bench_tpu_torch.utils.convert import (flax_param_path,
                                              state_dict_from_flax)
from test_torch_port_detection import (BQ, CANVAS, CLASSES, FP,
                                       IGDN_COUPLING, STAGES,
                                       _small_bottleneck, close,
                                       det_variables, nchw, nhwc,
                                       random_boxes)
from test_torch_port_model import _randomize

MASK, KP, RETINA = 'mask_rcnn_small', 'keypoint_rcnn_small', \
    'retinanet_small'
KP_CLASSES, KPS = 2, 17
HW = 64                       # the engine's images and canvases (64 px)
N_KP = 8                      # the keypoint slots compared directly


# ---- the small models, under one name in both packages ----------------------

def _jax_body(backbone_config):
    return JaxBackbone(bottleneck_layer=_small_bottleneck(
        backbone_config, jax_get_layer), stage_sizes=STAGES)


def _port_body(backbone_config):
    return SplittableDetectionBackbone(
        _small_bottleneck(backbone_config, get_layer), STAGES)


def jax_mask(backbone_config=None, num_classes=CLASSES, **kwargs):
    return jax_rcnn.MaskRCNN(backbone=_jax_body(backbone_config),
                             num_classes=num_classes)


def port_mask(backbone_config=None, num_classes=CLASSES, device=None,
              **kwargs):
    return rcnn.MaskRCNN(_port_body(backbone_config),
                         num_classes=num_classes).to(device)


def jax_kp(backbone_config=None, num_classes=KP_CLASSES, **kwargs):
    return jax_rcnn.KeypointRCNN(backbone=_jax_body(backbone_config),
                                 num_classes=num_classes, num_keypoints=KPS)


def port_kp(backbone_config=None, num_classes=KP_CLASSES, device=None,
            **kwargs):
    return rcnn.KeypointRCNN(_port_body(backbone_config),
                             num_classes=num_classes,
                             num_keypoints=KPS).to(device)


def jax_retinanet(backbone_config=None, num_classes=CLASSES, **kwargs):
    return jax_retina.RetinaNet(backbone=_jax_body(backbone_config),
                                num_classes=num_classes)


def port_retinanet(backbone_config=None, num_classes=CLASSES, device=None,
                   **kwargs):
    return retinanet.RetinaNet(_port_body(backbone_config),
                               num_classes=num_classes).to(device)


def register(mp):
    for name, jb, pb in ((MASK, jax_mask, port_mask), (KP, jax_kp, port_kp),
                         (RETINA, jax_retinanet, port_retinanet)):
        mp.setitem(jax_registry._registry('model'), name, jb)
        mp.setitem(port_registry._registry('model'), name, pb)


def load_port(model, variables):
    model.load_state_dict(state_dict_from_flax(variables, model),
                          strict=True)
    return model.eval()


def retina_variables(module, seed, hw=(CANVAS, CANVAS)):
    """Randomized Flax variables of a JAX RetinaNet: the FP decoder's IGDN
    couplings drawn small and the FPN, P6/P7 and box-regression kernels
    scaled, as `det_variables` does for Faster R-CNN."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, *hw, 3)), mode='train'))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    params = variables['params']
    for name, tree in params['backbone'].get('bottleneck_layer', {}).items():
        if name.startswith('dec_igdn'):
            c = tree['gamma'].shape[0]
            tree['gamma'] = np.sqrt(0.1 * np.eye(c) + rng.uniform(
                0, IGDN_COUPLING, (c, c))).astype(np.float32)
    for name in params['fpn']:
        params['fpn'][name]['kernel'] *= np.float32(0.3)
    params['head']['bbox_reg']['kernel'] *= np.float32(0.01)
    return variables


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _image(seed, hw=(HW, HW)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3),
                                                dtype=np.uint8)


def _canvas(img):
    """The engine's canvas of one image (min 64, max 64: scale 1)."""
    return JaxTransform(min_size=HW, max_size=HW, size_divisible=32)(
        [img])[0]


# ---- Mask R-CNN -------------------------------------------------------------

@pytest.fixture(scope='module')
def mask_case():
    """A JAX Mask R-CNN (FP bottleneck), its variables, the port's model
    on them, two 64 px images, and JAX's 'finetune' outputs, detections
    and mask probabilities of all 100 slots of each."""
    jm = jax_mask({'bottleneck_config': FP})
    variables = det_variables(jm, 31, hw=(HW, HW))
    pm = load_port(port_mask({'bottleneck_config': FP}, device='cpu'),
                   variables)
    images = [_image(32), _image(33)]
    x = np.concatenate([_canvas(img) for img in images])

    def fwd(v, x):
        out = jm.apply(v, x, mode='finetune', train=False)
        dets = jax_rcnn.postprocess_detections(out)
        probs = jax.vmap(lambda f, b, lb: jm.apply(
            v, f, b, lb, method=lambda m, f, b, lb: m.predict_masks(
                f, b, lb, out['image_hw'])))(
            out['features'][:4], dets['boxes'], dets['labels'])
        return out['features'][:4], dets, probs

    feats, dets, probs = jax.jit(fwd)(_jnp(variables), jnp.asarray(x))
    return jm, variables, pm, images, feats, dets, probs


def test_mask_head_and_predict_masks_equal_jax(mask_case):
    """The mask head on the same pooled RoIs (logits within 1e-4), the
    standalone `MaskHead` on the model's weights equal to it, and
    `predict_masks` on JAX's features, boxes and labels of every slot:
    probabilities within 1e-4 of JAX's."""
    jm, variables, pm, _, feats, dets, probs = mask_case
    v = _jnp(variables)
    pooled = np.random.default_rng(34).normal(
        0, 1, (6, 14, 14, 256)).astype(np.float32)
    want = jax.jit(lambda v, p: jm.apply(v, p, method=lambda m, p:
                                         m.mask_head(p)))(v, pooled)
    with torch.no_grad():
        got = heads.mask_logits(pm.roi_heads, nchw(pooled))
        alone = heads.MaskHead(CLASSES)
        alone.load_state_dict({k[len('roi_heads.'):]: t for k, t in
                               pm.state_dict().items()
                               if '.mask_' in k})
        assert torch.equal(alone(nchw(pooled)), got)
    assert tuple(got.shape) == (6, CLASSES, 28, 28)
    close(nhwc(got), want, 1e-4)
    for i in range(2):
        with torch.no_grad():
            p = pm.predict_masks(
                [nchw(f[i:i + 1])[0] for f in feats],
                torch.from_numpy(np.asarray(dets['boxes'][i])),
                torch.from_numpy(np.asarray(dets['labels'][i])), (HW, HW))
        assert tuple(p.shape) == (100, 28, 28)
        np.testing.assert_allclose(p.numpy(), np.asarray(probs[i]),
                                   rtol=0, atol=1e-4)


def test_heads_key_space_is_the_jax_rules_torchvision_space(mask_case):
    """The port's Mask and Keypoint R-CNN state dicts are torchvision's
    key space as the JAX package reads it: `convert_state_dict` with
    `MASKRCNN_RULES` / `KEYPOINTRCNN_RULES` (the deconvolutions flipped
    back) gives the Flax variables they were converted from, every head
    leaf included; every parameter's Flax path round-trips."""
    _, variables, pm, _, _, _, _ = mask_case
    jk = jax_kp({'bottleneck_config': FP})
    kvars = det_variables(jk, 35, hw=(HW, HW))
    pk = load_port(port_kp({'bottleneck_config': FP}, device='cpu'), kvars)
    for model, want, rules, deconv, head in (
            (pm, variables, jax_convert.MASKRCNN_RULES,
             jax_convert.MASKRCNN_DECONV_PATHS, 'mask_head'),
            (pk, kvars, jax_convert.KEYPOINTRCNN_RULES,
             jax_convert.KEYPOINTRCNN_DECONV_PATHS, 'keypoint_head')):
        back = jax_convert.convert_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, rules,
            deconv_paths=deconv,
            weight_transforms=jax_convert.DETECTION_WEIGHT_TRANSFORMS)
        got = dict(_flat(back['params']))
        assert {k for k in got if k.startswith(head)} \
            == {k for k, _ in _flat(want['params'][head], head)}
        for k, a in got.items():
            np.testing.assert_array_equal(np.asarray(a), _at(
                want['params'], k), err_msg=k)
        paths = {flax_param_path(n, model) for n, _ in
                 model.named_parameters()}
        assert paths == {k.replace('/', '.') for k, _ in
                         _flat(want['params'])}


def _flat(tree, prefix=''):
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _at(tree, path):
    for k in path.split('/'):
        tree = tree[k]
    return np.asarray(tree)


def test_mask_loss_equals_jax():
    """`mask_loss` and its gradient in the logits within 1e-6 of JAX's,
    with a foreground mask that drops some RoIs."""
    rng = np.random.default_rng(36)
    logits = rng.normal(0, 3, (10, 28, 28)).astype(np.float32)
    gt = (rng.uniform(size=(10, 28, 28)) > 0.5).astype(np.float32)
    fg = (np.arange(10) % 3 != 0).astype(np.float32)
    want, want_g = jax.value_and_grad(jax_heads.mask_loss)(
        jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(fg))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = heads.mask_loss(t, torch.from_numpy(gt), torch.from_numpy(fg))
    got.backward()
    close(got.detach().numpy(), want, 1e-6)
    close(t.grad.numpy(), want_g, 1e-6)


# ---- Keypoint R-CNN ---------------------------------------------------------

@pytest.fixture(scope='module')
def kp_case():
    """A JAX Keypoint R-CNN (FP bottleneck, 2 classes, 17 keypoints), its
    variables, the port's model on them, one 64 px image, and JAX's
    features, detections and the heatmaps of the first N_KP slots."""
    jk = jax_kp({'bottleneck_config': FP})
    variables = det_variables(jk, 41, hw=(HW, HW))
    pk = load_port(port_kp({'bottleneck_config': FP}, device='cpu'),
                   variables)
    image = _image(42)

    def fwd(v, x):
        out = jk.apply(v, x, mode='finetune', train=False)
        dets = jax_rcnn.postprocess_detections(out)
        hm = jk.apply(v, [f[0] for f in out['features'][:4]],
                      dets['boxes'][0, :N_KP],
                      method=lambda m, f, b: m.predict_keypoints(
                          f, b, out['image_hw']))
        return out['features'][:4], dets, hm

    feats, dets, hm = jax.jit(fwd)(_jnp(variables),
                                   jnp.asarray(_canvas(image)))
    return jk, variables, pk, image, feats, dets, hm


def test_keypoint_head_and_predict_keypoints_equal_jax(kp_case):
    """`predict_keypoints` on JAX's features and boxes: (D, 56, 56, K)
    heatmaps within 1e-4 of JAX's (the 4x4/2 deconvolution and the 2x
    bilinear upsample, edge rows and columns included); the standalone
    `KeypointHead` equals the model's head; the 2x upsample alone equals
    `jax.image.resize(..., 'bilinear')` within 1e-6."""
    _, _, pk, _, feats, dets, hm = kp_case
    with torch.no_grad():
        got = pk.predict_keypoints(
            [nchw(f)[0] for f in feats],
            torch.from_numpy(np.asarray(dets['boxes'][0, :N_KP])), (HW, HW))
    assert tuple(got.shape) == (N_KP, 56, 56, KPS)
    close(got.numpy(), hm, 1e-4)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        close(got.numpy()[edge], np.asarray(hm)[edge], 1e-4)
    pooled = torch.from_numpy(np.random.default_rng(43).normal(
        0, 1, (2, 256, 14, 14)).astype(np.float32))
    with torch.no_grad():
        alone = heads.KeypointHead(KPS)
        alone.load_state_dict({k[len('roi_heads.'):]: t for k, t in
                               pk.state_dict().items() if '.keypoint_' in k})
        assert torch.equal(alone(pooled),
                           heads.keypoint_logits(pk.roi_heads, pooled))
    low = np.random.default_rng(44).normal(0, 1, (2, 7, 9, 3)).astype(
        np.float32)
    want = jax.image.resize(low, (2, 14, 18, 3), 'bilinear')
    got = torch.nn.functional.interpolate(
        nchw(low), scale_factor=2, mode='bilinear', align_corners=False)
    close(nhwc(got), want, 1e-6)


# ---- RetinaNet --------------------------------------------------------------

@pytest.fixture(scope='module')
def retina_case():
    """A JAX RetinaNet (FP bottleneck, 5 classes), its variables, the
    port's model on them, two 96 px canvases and JAX's outputs."""
    jr = jax_retinanet({'bottleneck_config': FP})
    variables = retina_variables(jr, 51)
    pr = load_port(port_retinanet({'bottleneck_config': FP}, device='cpu'),
                   variables)
    x = np.concatenate(canvases_96(52))
    out = jax.jit(lambda v, x: jr.apply(v, x, mode='finetune',
                                        train=False))(_jnp(variables),
                                                      jnp.asarray(x))
    return jr, variables, pr, x, out


def canvases_96(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, (1, CANVAS, CANVAS, 3)).astype(np.float32)
            for _ in range(2)]


def test_retinanet_outputs_and_anchors_equal_jax(retina_case):
    """The flattened class logits and box deltas (NHWC order: (y, x,
    anchor)) within 1e-4, the 9-anchor levels' anchors and sizes equal."""
    _, _, pr, x, out = retina_case
    with torch.no_grad():
        got = pr(nchw(x), mode='finetune')
    close(got['cls_logits'].numpy(), out['cls_logits'], 1e-4)
    close(got['bbox_deltas'].numpy(), out['bbox_deltas'], 1e-4)
    np.testing.assert_array_equal(got['anchors'].numpy(),
                                  np.asarray(out['anchors']))
    assert got['level_sizes'] == [int(s) for s in out['level_sizes']]
    assert got['image_hw'] == (CANVAS, CANVAS)
    assert got['cls_logits'].shape[1] == got['anchors'].shape[0] \
        == sum(got['level_sizes'])


def _retina_targets():
    rng = np.random.default_rng(53)
    boxes = np.zeros((2, 6, 4), np.float32)
    labels = np.zeros((2, 6), np.int32)
    valid = np.zeros((2, 6), bool)
    for i, k in enumerate((3, 5)):
        boxes[i, :k] = random_boxes(rng, k, 60.0, 10.0, 50.0)
        labels[i, :k] = rng.integers(1, CLASSES, k)
        valid[i, :k] = True
    return {'boxes': boxes, 'labels': labels, 'boxes_valid': valid}


def test_retinanet_loss_and_gradient_equal_jax(retina_case):
    """Focal and L1 terms from JAX's outputs within 1e-5, and the
    gradient of their sum in the logits and deltas within 1e-5; through
    the port's model the loss reaches the head and the backbone."""
    _, _, pr, x, out = retina_case
    targets = _retina_targets()
    keep = {k: out[k] for k in ('anchors', 'cls_logits', 'bbox_deltas')}

    def total(o, t):
        losses = jax_retina.retinanet_loss(o, t)
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        keep, _jnp(targets))
    logits = torch.from_numpy(np.array(out['cls_logits'])).requires_grad_()
    deltas = torch.from_numpy(np.array(out['bbox_deltas'])).requires_grad_()
    got = retinanet.retinanet_loss(
        {'anchors': torch.from_numpy(np.asarray(out['anchors'])),
         'cls_logits': logits, 'bbox_deltas': deltas},
        {k: torch.from_numpy(v) for k, v in targets.items()})
    sum(got.values()).backward()
    for k in ('classification', 'bbox_regression'):
        close(got[k].detach().numpy(), want[k], 1e-5)
        assert float(want[k]) > 0
    close(logits.grad.numpy(), grads['cls_logits'], 1e-5)
    close(deltas.grad.numpy(), grads['bbox_deltas'], 1e-5)
    pr.zero_grad()
    sum(retinanet.retinanet_loss(pr(nchw(x), mode='finetune'), {
        k: torch.from_numpy(v) for k, v in targets.items()}).values()
        ).backward()
    for name in ('head.classification_head.cls_logits.weight',
                 'backbone.body.layer4.0.conv1.weight'):
        g = dict(pr.named_parameters())[name].grad
        assert g is not None and bool(torch.isfinite(g).all()) \
            and float(g.abs().max()) > 0, name


@pytest.mark.parametrize('prior', [False, True], ids=['random', 'prior'])
def test_retinanet_postprocess_equals_jax(retina_case, prior):
    """Fed JAX's outputs, `retinanet_postprocess` gives JAX's labels and
    valid slots (equal) and boxes and scores (within 1e-5): on the
    randomized logits (many candidates over the threshold) and with the
    focal prior's bias added (almost every candidate scored -1, the ties
    broken toward the lower index as `jax.lax.top_k` does)."""
    _, _, _, _, out = retina_case
    logits = np.array(out['cls_logits'])
    if prior:
        logits = np.float32(0.1) * logits - np.float32(np.log(0.99 / 0.01))
    jo = {'anchors': out['anchors'], 'cls_logits': jnp.asarray(logits),
          'bbox_deltas': out['bbox_deltas']}
    want = jax.jit(lambda o: jax_retina.retinanet_postprocess(
        {**o, 'image_hw': (CANVAS, CANVAS)}))(jo)
    got = retinanet.retinanet_postprocess(
        {k: torch.from_numpy(np.array(v)) for k, v in jo.items()}
        | {'image_hw': (CANVAS, CANVAS)})
    for k in ('labels', 'valid'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ('boxes', 'scores'):
        close(got[k].numpy(), want[k], 1e-5)
    over = float((torch.sigmoid(torch.from_numpy(logits)) > 0.05).float()
                 .mean())
    assert (over < 0.05) if prior else (over > 0.3)
    assert int(got['valid'].sum()) > 0


# ---- evaluator helpers ------------------------------------------------------

def _polygons():
    return [
        [[5, 5, 40, 8, 20, 45]],                            # triangle
        [[2, 2, 50, 2, 50, 50, 26, 20, 2, 50]],             # concave
        [[10, 10, 40, 40, 40, 10, 10, 40]],                 # bow tie
        [[-10, -5, 30, 3, 70, 60, 5, 44], [1, 1, 3, 3]],    # outside, short
        [[4.5, 4.5, 20.5, 4.5, 20.5, 20.5, 4.5, 20.5],      # two rings
         [30, 30, 60, 30, 45, 60]],
    ]


def test_polygon_paste_mask_and_ious_equal_jax():
    """`rasterize_polygon`, `paste_mask` (boxes inside, partly outside,
    sub-pixel, and thresholds 0.5 and 0.3), `_mask_iou` (crowd and not),
    `_oks_iou` (invisible keypoints, a gt with none visible) and
    `keypoints_from_heatmaps` equal JAX's."""
    for poly in _polygons():
        got = coco.rasterize_polygon(poly, 48, 56)
        np.testing.assert_array_equal(
            got, jax_coco.rasterize_polygon(poly, 48, 56))
    assert got.any()
    rng = np.random.default_rng(60)
    prob = rng.uniform(0, 1, (28, 28)).astype(np.float32)
    for box in ([3.2, 4.7, 30.1, 41.9], [-5.5, 10, 20, 70.3],
                [40.2, 40.6, 40.4, 40.9], [10, 12, 60, 15]):
        for thresh in (0.5, 0.3):
            np.testing.assert_array_equal(
                coco_eval.paste_mask(prob, box, 48, 56, thresh),
                jax_eval.paste_mask(prob, box, 48, 56, thresh))
    dets = [coco_eval.paste_mask(rng.uniform(0, 1, (28, 28)),
                                 random_boxes(rng, 1, 30.0, 5.0, 25.0)[0],
                                 48, 56) for _ in range(5)]
    gts = [coco.rasterize_polygon(p, 48, 56) for p in _polygons()[:3]]
    crowd = np.asarray([0, 1, 0])
    np.testing.assert_array_equal(coco_eval._mask_iou(dets, gts, crowd),
                                  jax_eval._mask_iou(dets, gts, crowd))
    gk = rng.uniform(0, 50, (3, 17, 3))
    gk[:, :, 2] = rng.integers(0, 3, (3, 17))
    gk[2, :, 2] = 0
    dk = rng.uniform(0, 50, (4, 17, 3))
    area = np.asarray([200.0, 900.0, 50.0])
    np.testing.assert_array_equal(
        coco_eval._oks_iou(dk, gk, area, crowd),
        jax_eval._oks_iou(dk, gk, area, crowd))
    hm = rng.normal(0, 1, (3, 56, 56, 17)).astype(np.float32)
    boxes = random_boxes(rng, 3, 40.0)
    np.testing.assert_array_equal(
        coco_eval.keypoints_from_heatmaps(hm, boxes),
        jax_eval.keypoints_from_heatmaps(hm, boxes))


def _eval_targets(iou_type, with_extra=True):
    """Targets of four images (a crowd region in the first) and
    predictions near them, with masks or keypoints: matches at several
    overlaps, misses, duplicates, an image without predictions."""
    rng = np.random.default_rng(61 if iou_type == 'segm' else 62)
    h, w = 64, 80
    targets, preds = [], {}
    for i in range(4):
        n = 2 + i
        b = random_boxes(rng, n, 40.0, 8.0, 30.0)
        t = {'boxes': b, 'labels': rng.integers(1, 4, n).astype(np.int32),
             'iscrowd': (np.arange(n) == 1).astype(np.int32) * (i == 0),
             'image_id': 20 + i}
        jitter = b + rng.normal(0, 2, b.shape).astype(np.float32)
        pb = np.concatenate([jitter, random_boxes(rng, 2, 40.0, 8.0, 30.0)])
        pred = {'boxes': pb, 'scores': rng.uniform(0, 1, len(pb)),
                'labels': np.concatenate([t['labels'],
                                          rng.integers(1, 4, 2)])}
        if iou_type == 'segm':
            t['masks'] = [coco.rasterize_polygon([coco._octagon(x)], h, w)
                          for x in b]
            t['area'] = np.asarray([m.sum() for m in t['masks']],
                                   np.float32)
            pred['masks'] = [coco_eval.paste_mask(
                rng.uniform(0.2, 1.0, (28, 28)), x, h, w) for x in pb]
        else:
            t['area'] = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))
            kps = np.concatenate([
                b[:, None, :2] + rng.uniform(0, 1, (n, 17, 2))
                * (b[:, None, 2:] - b[:, None, :2]),
                rng.integers(0, 3, (n, 17, 1))], axis=-1)
            t['keypoints'] = kps.astype(np.float32)
            pk = np.concatenate([kps[:, :, :2] + rng.normal(
                0, 1.5, (n, 17, 2)), rng.uniform(0, 50, (2, 17, 2))])
            pred['keypoints'] = np.concatenate(
                [pk, np.ones((len(pk), 17, 1))], axis=-1)
        if not with_extra:
            pred.pop('masks', None)
            pred.pop('keypoints', None)
        targets.append(t)
        if i != 2:
            preds[20 + i] = pred
    return targets, preds


def _summarize(cls, iou_type, targets, preds):
    ev = cls(iou_type=iou_type)
    for t in targets:
        ev.add_gt(t)
    ev.update(preds)
    ev.synchronize_between_processes()
    ev.accumulate()
    return ev.summarize()


@pytest.mark.parametrize('iou_type', ['segm', 'keypoints'])
def test_segm_and_keypoint_evaluators_equal_jax(iou_type):
    """The 12 metrics of the segm (mask IoU, crowd over the detection's
    area) and keypoint (OKS) evaluators equal JAX's; predictions without
    masks or keypoints fall back to box IoU as in JAX; an unknown type
    raises."""
    targets, preds = _eval_targets(iou_type)
    got = _summarize(coco_eval.CocoEvaluator, iou_type, targets, preds)
    assert got == _summarize(jax_eval.CocoEvaluator, iou_type, targets,
                             preds)
    assert 0.0 < got['AP'] < 1.0
    targets, preds = _eval_targets(iou_type, with_extra=False)
    got_box = _summarize(coco_eval.CocoEvaluator, iou_type, targets, preds)
    assert got_box == _summarize(jax_eval.CocoEvaluator, iou_type, targets,
                                 preds)
    assert got_box == _summarize(coco_eval.CocoEvaluator, 'bbox', targets,
                                 preds)
    with pytest.raises(ValueError, match='unknown iou_type'):
        coco_eval.CocoEvaluator(iou_type='mask')


def test_synthetic_masks_and_keypoints_keep_jax_draws():
    """The synthetic dataset's mask and keypoint options leave the image,
    boxes, labels and crowd flags JAX's; masks are the boxes' octagons
    (inside the box, area the mask's), keypoints inside the boxes."""
    kw = dict(num_samples=3, image_size=(40, 52), num_classes=CLASSES,
              seed=5)
    plain = jax_coco.SyntheticDetectionDataset(**kw)
    rich = coco.SyntheticDetectionDataset(with_masks=True, num_keypoints=KPS,
                                          **kw)
    for i in range(3):
        (wi, wt), (gi, gt) = plain[i], rich[i]
        np.testing.assert_array_equal(gi, wi)
        for k in ('boxes', 'labels', 'iscrowd', 'image_id'):
            np.testing.assert_array_equal(gt[k], wt[k])
        for m, b, a in zip(gt['masks'], gt['boxes'], gt['area']):
            ys, xs = np.nonzero(m)
            assert m.sum() == a > 0
            assert xs.min() >= b[0] - 1 and xs.max() <= b[2] \
                and ys.min() >= b[1] - 1 and ys.max() <= b[3]
        k = gt['keypoints']
        assert k.shape == (len(gt['boxes']), KPS, 3) and (k[..., 2] == 2).all()
        assert (k[..., 0] >= gt['boxes'][:, None, 0]).all() \
            and (k[..., 1] <= gt['boxes'][:, None, 3]).all()


# ---- the engine and the CLI -------------------------------------------------

def _engine_config(key, classes, tmp_path, variables, bneck=FP, **extra):
    path = str(tmp_path / f'{key}.ckpt')
    jax_save_ckpt(path, variables)
    return {'min_size': HW, 'canvas_size': HW, 'max_boxes': 8, **extra,
            'models': {'model': {'key': key, 'ckpt': path, 'kwargs': {
                'num_classes': classes,
                'backbone_config': {'bottleneck_config': bneck}}}}}


def _check_stats(got, want):
    for k, v in want.items():
        if k == 'model_time':
            continue
        if isinstance(v, dict):
            _check_stats(got[k], v)
        else:
            assert got[k] == pytest.approx(v, abs=1e-6), k


def test_engine_mask_rcnn_segm_eval_equals_jax(mask_case, tmp_path,
                                               monkeypatch):
    """`iou_types` derived from a Mask R-CNN student (bbox, segm) as in
    JAX; `evaluate` on the plain forward (masks of every slot, the valid
    ones pasted at the image's size) gives JAX's bbox and segm metrics
    (within 1e-6), on targets made from JAX's own detections so that
    segm AP is above 0."""
    _, variables, _, images, _, dets, probs = mask_case
    register(monkeypatch)
    loader = []
    for i, img in enumerate(images):
        valid = np.asarray(dets['valid'][i])
        boxes = np.asarray(dets['boxes'][i])[valid][:3]
        masks = [jax_eval.paste_mask(p, b, HW, HW) for p, b in zip(
            np.asarray(probs[i])[valid][:3], boxes)]
        loader.append(([img], [{
            'boxes': boxes, 'labels': np.asarray(dets['labels'][i])[valid][:3],
            'area': np.asarray([m.sum() for m in masks], np.float32),
            'iscrowd': np.zeros(len(boxes), np.int32), 'masks': masks,
            'image_id': i}]))
    assert sum(len(t[0]['boxes']) for _, t in loader) >= 4
    config = _engine_config(MASK, CLASSES, tmp_path, variables)
    monkeypatch.setattr(JaxDetEngine, '_init',
                        lambda self, module, seed: _jnp(variables))
    jeng = JaxDetEngine(config, mesh=None)
    peng = DetectionEngine(config, device='cpu')
    assert peng.iou_types == jeng.iou_types == ['bbox', 'segm']
    want = jeng.evaluate(loader)
    got = peng.evaluate(loader)
    _check_stats(got, want)
    assert got['segm']['AP'] > 0.0 and got['AP'] > 0.0


def test_engine_keypoint_rcnn_oks_eval_equals_jax(kp_case, tmp_path,
                                                  monkeypatch):
    """`iou_types` from the config (the CLI's override) as in JAX; the
    plain forward's heatmaps of every slot decoded in the image's
    coordinates give JAX's bbox and keypoint metrics (within 1e-6), on
    targets whose keypoints are JAX's decoded ones, moved a pixel."""
    _, variables, _, image, _, dets, hm = kp_case
    register(monkeypatch)
    valid = np.asarray(dets['valid'][0])[:N_KP]
    assert valid.sum() >= 2
    boxes = np.asarray(dets['boxes'][0])[:N_KP][valid]
    kps = jax_eval.keypoints_from_heatmaps(np.asarray(hm)[valid], boxes)
    kps[..., :2] += 1.0
    kps[..., 2] = 2
    loader = [([image], [{
        'boxes': boxes, 'labels': np.asarray(dets['labels'][0])[:N_KP][valid],
        'area': (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]),
        'iscrowd': np.zeros(len(boxes), np.int32), 'keypoints': kps,
        'image_id': 0}])]
    config = _engine_config(KP, KP_CLASSES, tmp_path, variables,
                            iou_types=['bbox', 'keypoints'])
    monkeypatch.setattr(JaxDetEngine, '_init',
                        lambda self, module, seed: _jnp(variables))
    jeng = JaxDetEngine(config, mesh=None)
    peng = DetectionEngine(config, device='cpu')
    assert peng.iou_types == jeng.iou_types == ['bbox', 'keypoints']
    want = jeng.evaluate(loader)
    got = peng.evaluate(loader)
    _check_stats(got, want)
    assert got['keypoints']['AP'] > 0.0


def test_cli_iou_types_bbox_segm_equals_jax(tmp_path, monkeypatch):
    """`--iou_types bbox segm` through the CLI on a small config of a
    CR+BQ Mask R-CNN (no entropy model: the plain forward scores every
    type, as in JAX) and synthetic images with octagon masks: the JAX
    engine's bbox and segm metrics (within 1e-6)."""
    from sc2bench_tpu.config import load_config as jax_load_config
    jm = jax_mask({'bottleneck_config': BQ})
    variables = det_variables(jm, 71, hw=(HW, HW))
    register(monkeypatch)
    config = _engine_config(MASK, CLASSES, tmp_path, variables, bneck=BQ)
    config['test'] = {'test_data_loader': {'dataset': {
        'key': 'SyntheticDetectionDataset', 'kwargs': {
            'num_samples': 1, 'image_size': [HW, HW],
            'num_classes': CLASSES, 'seed': 72, 'with_masks': True}},
        'batch_size': 1}}
    path = tmp_path / 'mask_rcnn_bq.yaml'
    path.write_text(json.dumps(config))
    monkeypatch.setattr(JaxDetEngine, '_init',
                        lambda self, module, seed: _jnp(variables))
    monkeypatch.setitem(jax_registry._registry('dataset'),
                        'SyntheticDetectionDataset',
                        coco.SyntheticDetectionDataset)
    jcfg = jax_load_config(str(path))
    jcfg['iou_types'] = ['bbox', 'segm']
    want = JaxDetEngine(jcfg, mesh=None).test()
    out = main(['--config', str(path), '-test_only', '--iou_types', 'bbox',
                'segm', '--device', 'cpu'])
    assert out['engine'].iou_types == ['bbox', 'segm']
    assert 'segm' in want and out['summaries'][0]['num_samples'] == 0
    _check_stats(out['result'], want)


# ---- FrozenBatchNorm --------------------------------------------------------

@pytest.fixture(scope='module')
def frozen_case():
    """A JAX detection backbone with `frozen_bn` (the teacher's stem and
    layer1, stages (1, 1, 1, 1)), randomized variables, the port's on
    them, and a 64 px batch of two."""
    jb = JaxBackbone(stage_sizes=STAGES, frozen_bn=True)
    shapes = jax.eval_shape(lambda: jb.init(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3))))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(81))
    pb = SplittableDetectionBackbone(None, STAGES, frozen_bn=True)
    pb.load_state_dict(state_dict_from_flax(variables, pb), strict=True)
    x = np.random.default_rng(82).normal(0, 1, (2, HW, HW, 3)).astype(
        np.float32)
    return jb, variables, pb, x


def test_frozen_batch_norm_forward_and_step_equal_jax(frozen_case):
    """Train mode: C2-C5 within 1e-5 of JAX's; the frozen layers'
    statistics unchanged in both, the stem's BatchNorm updated as JAX's.
    One SGD step (momentum, weight decay 1e-2) through the port's
    `StageOptimizer` and JAX's optax chain: the frozen affine terms get a
    zero gradient and move by the weight decay alone, as optax moves
    them; every parameter within the step tests' tolerance of JAX's."""
    jb, variables, pb, x = frozen_case
    opt_cfg = {'key': 'SGD', 'kwargs': {'lr': 0.1, 'momentum': 0.9,
                                        'weight_decay': 1e-2}}

    def loss_fn(params, bs):
        out, state = jb.apply({'params': params, 'batch_stats': bs},
                              jnp.asarray(x), train=True,
                              mutable=['batch_stats', 'intermediates'])
        return sum(jnp.mean(o ** 2) for o in out), (out, state)

    @jax.jit
    def step(params, bs):
        grads, (out, state) = jax.grad(loss_fn, has_aux=True)(params, bs)
        tx = jax_build_optimizer(opt_cfg)
        updates, _ = tx.update(grads, tx.init(params), params)
        import optax
        return out, state['batch_stats'], optax.apply_updates(params,
                                                              updates), grads

    v = _jnp(variables)
    out, new_bs, new_params, grads = step(v['params'], v['batch_stats'])
    frozen = [m for m in pb.modules() if isinstance(m, FrozenBatchNorm2d)]
    assert len(frozen) == 4 * 4 and isinstance(pb.bn1, BatchNorm2d)
    before = {k: t.clone() for k, t in pb.state_dict().items()}
    optim = StageOptimizer(pb, opt_cfg)
    pb.train()
    feats = pb(nchw(x))
    for a, b in zip(feats, out):
        close(nhwc(a), b, 1e-5)
    optim.zero_grad()
    sum(torch.mean(f ** 2) for f in feats).backward()
    optim.step()
    new = state_dict_from_flax(jax.device_get(
        {'params': new_params, 'batch_stats': new_bs}), pb)
    ref = state_dict_from_flax(jax.device_get(
        {'params': grads, 'batch_stats': v['batch_stats']}), pb)
    lr, wd = 0.1, 1e-2
    for k, t in pb.state_dict().items():
        if 'running' in k and k.startswith('bn1.'):
            close(t.numpy(), new[k].numpy(), 1e-5)
        elif 'running' in k:
            assert torch.equal(t, before[k]) and torch.equal(new[k], t), k
    for name, p in pb.named_parameters():
        g = ref[name].numpy()
        if isinstance(pb.get_submodule(name.rsplit('.', 1)[0]),
                      FrozenBatchNorm2d):
            assert not g.any() and not p.grad.any(), name
            np.testing.assert_allclose(p.detach().numpy(),
                                       before[name].numpy() * (1 - lr * wd),
                                       rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(
            p.detach().numpy(), new[name].numpy(), rtol=0,
            atol=1e-5 + lr * 1e-4 * max(1.0, float(np.abs(g).max())),
            err_msg=name)


def test_frozen_bn_config_builds_and_counts_equal_jax():
    """`frozen_bn: true` in a `backbone_config` builds Faster R-CNN's body
    with `FrozenBatchNorm2d` in layer1-4 (the stem's BatchNorm stays
    trainable), the argument wins over the config as JAX's kwargs do,
    and the parameter and statistics counts equal JAX's."""
    cfg = {'resnet_name': 'resnet50', 'frozen_bn': True}
    with torch.device('meta'):
        pm = rcnn.faster_rcnn_model(backbone_config=cfg, device='meta')
        off = SplittableDetectionBackbone.from_config(cfg, frozen_bn=False)
    body = pm.backbone.body
    assert isinstance(body.bn1, BatchNorm2d)
    assert all(isinstance(m, FrozenBatchNorm2d) for name, m in
               body.named_modules() if name.startswith('layer')
               and isinstance(m, (BatchNorm2d, FrozenBatchNorm2d)))
    assert not any(isinstance(m, FrozenBatchNorm2d) for m in off.modules())
    _counts_equal(pm, jax_rcnn.faster_rcnn_model(backbone_config=cfg))


def _counts_equal(pm, jm):
    shapes = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), mode='train'))
    assert sum(p.numel() for p in pm.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes['params']))
    assert sum(b.numel() for k, b in pm.named_buffers() if 'running' in k) \
        == sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes['batch_stats']))


@pytest.mark.parametrize('builder,kwargs', [
    ('mask_rcnn_model', {'num_classes': 91}),
    ('keypoint_rcnn_model', {}),
    ('retinanet_model', {'num_classes': 91})])
def test_full_width_builders_count_equal_jax(builder, kwargs):
    """The three builders under their JAX names at full width (ResNet-50,
    FP-24; 91 classes, or Keypoint R-CNN's 2 and 17 keypoints) on the meta
    device: JAX's parameter and statistics counts."""
    kw = {'backbone_config': {'resnet_name': 'resnet50',
                              'bottleneck_config': {
                                  'key': 'FPBasedResNetBottleneck',
                                  'kwargs': {'num_bottleneck_channels': 24,
                                             'num_target_channels': 256}}},
          **kwargs}
    with torch.device('meta'):
        pm = port_registry.get('model', builder)(device='meta', **kw)
    _counts_equal(pm, jax_registry.get('model', builder)(**kw))
