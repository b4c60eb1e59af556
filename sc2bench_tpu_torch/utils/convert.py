"""Flax variables -> this package's `state_dict`.

Carries the JAX package's weights across: `state_dict_from_flax` takes
`{'params': ..., 'batch_stats': ...}` as nested dicts of numpy arrays (no
JAX needed) and returns the torch key space of `SplittableResNet`,
`ResNet`, `EntropicClassifierModule` and the zoo's image codecs
(torchvision ResNet names, CompressAI bottleneck and codec names):

  Conv kernel (kH, kW, I, O)       -> Conv2d.weight (O, I, kH, kW)
  Dense kernel (I, O)              -> Linear.weight (O, I)
  BatchNorm scale/bias, mean/var   -> weight/bias, running_mean/running_var
  GDN beta/gamma (stored values)   -> beta/gamma, unchanged
  EntropyBottleneck matrix_i/bias_i/factor_i/quantiles
                                   -> _matrix{i}/_bias{i}/_factor{i}/quantiles
                                      (same (C, r, d)/(C, 1, 3) shapes)
  ConvTranspose kernel (kH, kW, I, O) of the hyperprior's h_s
                                   -> ConvTranspose2d.weight (I, O, kH, kW),
                                      spatially flipped: Flax runs an
                                      input-dilated convolution with the
                                      kernel as it is, torch the gradient of
                                      a convolution (an implicit flip)

The image codecs (`models/zoo.py`, `models/zoo_jahp.py`) keep their
Sequential children at the top of the Flax tree: `g_a{i}`/`g_a_gdn{i}` ->
`g_a.{2i}`/`g_a.{2i+1}`, `g_s{i}`/`g_s_igdn{i}` likewise (every `g_s{i}`
and `h_s0`/`h_s1` a ConvTranspose, flipped), `h_a{i}`/`h_s{i}` ->
`h_a.{2i}`/`h_s.{2i}`, `ep{i}` -> `entropy_parameters.{2i}`, and
`context_prediction`, whose kernel gets the 'A' mask applied and whose
mask is written as the module's `mask` buffer.

The bottleneck's scopes are the FP bottleneck's (`enc_conv0` ...), the
SHP/MSHP bottleneck's (`g_a_conv0`, `h_a_conv0`, `h_s_deconv0` ...) or the
`SimpleBottleneck`'s `LayerSeq` stacks (`encoder/layer{i}` ->
`encoder.{i}`). A `LayerSeq` scope does not say whether its kernel is a
convolution's or a transposed one's (the CR+BQ decoder's 2x2/2
upsampling), so converting one needs the torch `model`, whose module
there tells. An `EntropicClassifierModule` keeps the ResNet under `base/`
and its `entropy_bottleneck` at the top.

The other backbones share Flax scope names (`stem_conv` is RegNet's,
the hybrid ViT's and EfficientNet's), so the tree's scopes pick the
rules: `vit` a hybrid ViT (the teacher when it has `stem_conv`, else
the splittable student), `stage0_block0` an EfficientNet, `s1`/`s2` a
RegNet (student or teacher), `Mixed_5b` an Inception-v3 student,
`block3_l0_bn1` a DenseNet student, a split-attention conv inside a stage
(`layer{i}/block0/conv2/fc1`) a ResNeSt (student or teacher), anything
else the ResNet family above.
  RegNet      `s{i}/block{j}/conv1|bn1` -> `s{i}.b{j+1}.conv1.conv|bn`
              (likewise 2, 3), `se/fc1|fc2` -> `se.fc1|fc2`,
              `down_conv|down_bn` -> `downsample.conv|bn`; `stem_conv|bn`
              -> `stem.conv|bn`, `head_fc` -> `head.fc`
  hybrid ViT  `stage{i}/block{j}/...` -> the teacher's
              `patch_embed.backbone.stages.{i}.blocks.{j}.` or the
              student's `patch_embed_pruned_stages.{i}.blocks.{j}.`
              (`downsample_conv|norm` -> `downsample.conv|norm`);
              `vit/patch_proj` -> `patch_embed.proj` / `patch_embed_proj`;
              `vit/block{i}/qkv|attn_proj|mlp_fc1|mlp_fc2|norm1|norm2` ->
              `blocks.{i}.attn.qkv|attn.proj|mlp.fc1|mlp.fc2|norm1|norm2`;
              `vit/norm|head` -> `norm|head`; `vit/cls_token|pos_embed`
              -> top-level `cls_token|pos_embed` (same shapes);
              GroupNorm and LayerNorm `scale` -> `weight`
  EfficientNet `stage{s}_block{b}/...` -> `blocks.{s}.{b}.`: stage 0
              `dw_conv|dw_bn|project_conv|project_bn` ->
              `conv_dw|bn1|conv_pw|bn2`, the others `expand_conv|
              expand_bn|dw_conv|dw_bn|project_conv|project_bn` ->
              `conv_pw|bn1|conv_dw|bn2|conv_pwl|bn3`; `se_reduce|
              se_expand` -> `se.conv_reduce|conv_expand`; `stem_conv|
              stem_bn|head_conv|head_bn` -> `conv_stem|bn1|conv_head|bn2`
  ResNeSt     timm's `resnest50d`: `stem_conv{0,1,2}|stem_bn{0,1}` ->
              `conv1.{0,3,6}|conv1.{1,4}`, `stem_bn2` -> `bn1`;
              `layer{i}/block{j}/conv2/conv|bn0|fc1|bn1|fc2` ->
              `layer{i}.{j}.conv2.*`, `downsample_conv|downsample_bn` ->
              `downsample.1|2` (index 0 is the pool); the rest as ResNet
  DenseNet    `block{b}_l{l}_bn{k}|conv{k}` ->
              `features.denseblock{b}.denselayer{l+1}.norm{k}|conv{k}`,
              `trans{b}_bn|conv` -> `features.transition{b}.norm|conv`,
              `final_bn` -> `features.norm5`, `classifier`
  Inception   `Mixed_*/<branch>/conv|bn` -> `inception_modules.Mixed_*.
              <torchvision branch>.conv|bn` (`b1` -> `branch1x1`, `bd_2` ->
              `branch3x3dbl_2` in InceptionB and E but `branch7x7dbl_2` in
              C: the names depend on the block's type), `fc`

A DeepLabv3 (a tree with top-level `backbone` and `classifier`) maps
`backbone/...` by the ResNet rules above under `backbone.` (the teacher's
`backbone/stem/conv1|bn1` -> `backbone.conv1|bn1`, `backbone/layer1` ...;
the student's `backbone/bottleneck_layer/...`), and its heads to
torchvision's Sequentials: `classifier/aspp/b0_conv|b0_bn` ->
`classifier.0.convs.0.0|1`, `classifier/aspp/b{i}/conv|bn` ->
`classifier.0.convs.{i}.0|1`, `classifier/aspp/pool/conv|bn` ->
`classifier.0.convs.4.1|2`, `classifier/aspp/proj_conv|proj_bn` ->
`classifier.0.project.0|1`, `classifier/conv|bn|classifier` ->
`classifier.1|2|4`, `aux_classifier/conv|bn|classifier` ->
`aux_classifier.0|1|4`.

A Faster R-CNN (top-level `backbone` and `rpn_head`) maps `backbone/...`
by the ResNet rules under `backbone.body.` (the teacher's stem and layer1
too, which the JAX package's `DETECTION_RULES` leave out), `fpn/inner_{i}|
layer_{i}` -> `backbone.fpn.inner_blocks|layer_blocks.{i}.0`,
`rpn_head/conv` -> `rpn.head.conv.0.0`, `rpn_head/cls_logits|bbox_pred`
-> `rpn.head.*`, `box_head/fc6|fc7` -> `roi_heads.box_head.*` and
`box_predictor/*` -> `roi_heads.box_predictor.*`. Flax flattens a pooled
RoI as (h, w, c) and torchvision's `fc6` reads (c, h, w), so fc6's input
axis is permuted back (the inverse of the JAX package's
`convert_box_head_fc6`).

A Mask R-CNN adds `mask_head/mask_fcn{i+1}` -> `roi_heads.mask_head.{i}.0`,
`mask_head/mask_deconv|mask_predictor` -> `roi_heads.mask_predictor.
conv5_mask|mask_fcn_logits`; a Keypoint R-CNN `keypoint_head/kp_fcn{i+1}`
-> `roi_heads.keypoint_head.{2i}` and `keypoint_head/kp_deconv` ->
`roi_heads.keypoint_predictor.kps_score_lowres`. Both deconvolutions are
Flax `ConvTranspose`s, flipped as the hyperprior's are. A RetinaNet (top-
level `backbone` and `head`) maps `backbone/...` as Faster R-CNN does,
`fpn/inner_{i}|layer_{i}` -> `backbone.fpn.inner_blocks|layer_blocks.{i}.0`,
`fpn/p6|p7` -> `backbone.fpn.extra_blocks.p6|p7`, `head/cls_conv{i}|
box_conv{i}` -> `head.classification_head|regression_head.conv.{i}.0` and
`head/cls_logits|bbox_reg` -> `head.classification_head.cls_logits|
head.regression_head.bbox_reg` (torchvision's RetinaNet key space).

`flax_param_path` is the inverse on names: a torch parameter name ->
its Flax path, dotted (`bottleneck_layer.encoder.0.weight` ->
`bottleneck_layer.enc_conv0.kernel`), the space in which configs name
frozen and module-wise parameter groups. A `SimpleBottleneck` shares the
FP bottleneck's torch names (`encoder.{i}`), an EfficientNet's `bn1`/
`bn2` are a ResNet's names, and a ResNeSt's `downsample.1` is a conv where
a ResNet's is a BatchNorm, so their paths need the `model` too.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# flax scope path ('/'-joined) -> torch module path
_FP_SCOPES = {
    'enc_conv0': 'encoder.0', 'enc_gdn0': 'encoder.1',
    'enc_conv1': 'encoder.2', 'enc_gdn1': 'encoder.3',
    'enc_conv2': 'encoder.4',
    'dec_conv0': 'decoder.0', 'dec_igdn0': 'decoder.1',
    'dec_conv1': 'decoder.2', 'dec_igdn1': 'decoder.3',
    'dec_conv2': 'decoder.4',
    'entropy_bottleneck': 'entropy_bottleneck',
}

_SHP_SCOPES = {
    'g_a_conv0': 'g_a.0', 'g_a_gdn0': 'g_a.1', 'g_a_conv1': 'g_a.2',
    'g_a_gdn1': 'g_a.3', 'g_a_conv2': 'g_a.4',
    'g_s_conv0': 'g_s.0', 'g_s_igdn0': 'g_s.1', 'g_s_conv1': 'g_s.2',
    'g_s_igdn1': 'g_s.3', 'g_s_conv2': 'g_s.4',
    'h_a_conv0': 'h_a.0', 'h_a_conv1': 'h_a.2',
    'h_s_deconv0': 'h_s.0', 'h_s_deconv1': 'h_s.2', 'h_s_conv2': 'h_s.4',
}
# the image codecs of the zoo (CompressAI names): Sequential children at
# the top level of the Flax tree, `g_a{i}`/`g_a_gdn{i}` -> g_a.{2i}/.{2i+1}
_ZOO_SCOPES = {**{f'g_a{i}': f'g_a.{2 * i}' for i in range(4)},
               **{f'g_a_gdn{i}': f'g_a.{2 * i + 1}' for i in range(3)},
               **{f'g_s{i}': f'g_s.{2 * i}' for i in range(4)},
               **{f'g_s_igdn{i}': f'g_s.{2 * i + 1}' for i in range(3)},
               **{f'h_a{i}': f'h_a.{2 * i}' for i in range(3)},
               **{f'h_s{i}': f'h_s.{2 * i}' for i in range(3)},
               **{f'ep{i}': f'entropy_parameters.{2 * i}' for i in range(3)},
               'context_prediction': 'context_prediction'}
# flax scopes holding a ConvTranspose kernel
_DECONV_SCOPES = {f'bottleneck_layer/{k}' for k in _SHP_SCOPES
                  if '_deconv' in k} | {'g_s0', 'g_s1', 'g_s2', 'g_s3',
                                        'h_s0', 'h_s1',
                                        'mask_head/mask_deconv',
                                        'keypoint_head/kp_deconv'}
_BOTTLENECK_SCOPES = {**_FP_SCOPES, **_SHP_SCOPES}

# the SimpleBottleneck's LayerSeq stacks
_LAYER_SEQ = r'^bottleneck_layer/(encoder|decoder)/layer(\d+)$'
_BOTTLENECK_RULES = [(rf'^bottleneck_layer/{k}$', f'bottleneck_layer.{v}')
                     for k, v in _BOTTLENECK_SCOPES.items()] + [
    (_LAYER_SEQ, r'bottleneck_layer.\1.\2')]
_RULES = _BOTTLENECK_RULES + [
    (r'^entropy_bottleneck$', 'entropy_bottleneck'),
    (r'^(base/)?stem/(conv1|bn1)$', r'\1\2'),
    (r'^(base/)?layer(\d)/block(\d+)/(conv\d|bn\d)$', r'\1layer\2.\3.\4'),
    (r'^(base/)?layer(\d)/block(\d+)/downsample_conv$',
     r'\1layer\2.\3.downsample.0'),
    (r'^(base/)?layer(\d)/block(\d+)/downsample_bn$',
     r'\1layer\2.\3.downsample.1'),
    (r'^(base/)?fc$', r'\1fc'),
] + [(rf'^{k}$', v) for k, v in _ZOO_SCOPES.items()]


def _block1(m):
    """timm's 1-indexed block name for the Flax `block{j}` of match `m`."""
    return f'b{int(m[2]) + 1}'


_REGNET_RULES = _BOTTLENECK_RULES + [
    (r'^stem_(conv|bn)$', r'stem.\1'),
    (r'^s(\d)/block(\d+)/(conv|bn)(\d)$',
     lambda m: f's{m[1]}.{_block1(m)}.conv{m[4]}.{m[3]}'),
    (r'^s(\d)/block(\d+)/se/(fc\d)$',
     lambda m: f's{m[1]}.{_block1(m)}.se.{m[3]}'),
    (r'^s(\d)/block(\d+)/down_(conv|bn)$',
     lambda m: f's{m[1]}.{_block1(m)}.downsample.{m[3]}'),
    (r'^head_fc$', 'head.fc'),
]
_VIT_TAIL_RULES = [
    (r'^vit/block(\d+)/(norm1|norm2)$', r'blocks.\1.\2'),
    (r'^vit/block(\d+)/qkv$', r'blocks.\1.attn.qkv'),
    (r'^vit/block(\d+)/attn_proj$', r'blocks.\1.attn.proj'),
    (r'^vit/block(\d+)/mlp_(fc\d)$', r'blocks.\1.mlp.\2'),
    (r'^vit/(norm|head)$', r'\1'),
    (r'^vit$', ''),
]
_V2_BLOCK = (r'(\d)/block(\d+)/'
             r'(conv\d|norm\d|downsample_conv|downsample_norm)$')


def _v2_rule(prefix):
    return (r'^stage' + _V2_BLOCK, lambda m: f'{prefix}.{m[1]}.blocks.{m[2]}.'
            + m[3].replace('downsample_', 'downsample.'))


_HYBRID_VIT_RULES = _BOTTLENECK_RULES + [
    _v2_rule('patch_embed_pruned_stages'),
    (r'^vit/patch_proj$', 'patch_embed_proj')] + _VIT_TAIL_RULES
_HYBRID_VIT_TEACHER_RULES = [
    (r'^stem_(conv|norm)$', r'patch_embed.backbone.stem.\1'),
    _v2_rule('patch_embed.backbone.stages'),
    (r'^vit/patch_proj$', 'patch_embed.proj')] + _VIT_TAIL_RULES
_EFFICIENTNET_STAGE0 = {'dw_conv': 'conv_dw', 'dw_bn': 'bn1',
                        'project_conv': 'conv_pw', 'project_bn': 'bn2'}
_EFFICIENTNET_BLOCK = {'expand_conv': 'conv_pw', 'expand_bn': 'bn1',
                       'dw_conv': 'conv_dw', 'dw_bn': 'bn2',
                       'project_conv': 'conv_pwl', 'project_bn': 'bn3'}
_EFFICIENTNET_TOP = {'stem_conv': 'conv_stem', 'stem_bn': 'bn1',
                     'head_conv': 'conv_head', 'head_bn': 'bn2',
                     'classifier': 'classifier'}


def _efficientnet_block(m):
    names = _EFFICIENTNET_STAGE0 if m[1] == '0' else _EFFICIENTNET_BLOCK
    leaf = m[3].replace('se_', 'se.conv_') if m[3].startswith('se_') \
        else names[m[3]]
    return f'blocks.{m[1]}.{m[2]}.{leaf}'


_EFFICIENTNET_RULES = [
    (r'^stage(\d)_block(\d+)/(\w+)$', _efficientnet_block)] + [
    (rf'^{k}$', v) for k, v in _EFFICIENTNET_TOP.items()]
# DeepLabv3: torchvision's DeepLabHead and FCNHead Sequentials
_SEG_HEADS = {
    'classifier/aspp/b0_conv': 'classifier.0.convs.0.0',
    'classifier/aspp/b0_bn': 'classifier.0.convs.0.1',
    **{f'classifier/aspp/b{i}/{leaf}': f'classifier.0.convs.{i}.{j}'
       for i in (1, 2, 3) for j, leaf in enumerate(('conv', 'bn'))},
    'classifier/aspp/pool/conv': 'classifier.0.convs.4.1',
    'classifier/aspp/pool/bn': 'classifier.0.convs.4.2',
    'classifier/aspp/proj_conv': 'classifier.0.project.0',
    'classifier/aspp/proj_bn': 'classifier.0.project.1',
    'classifier/conv': 'classifier.1', 'classifier/bn': 'classifier.2',
    'classifier/classifier': 'classifier.4',
    'aux_classifier/conv': 'aux_classifier.0',
    'aux_classifier/bn': 'aux_classifier.1',
    'aux_classifier/classifier': 'aux_classifier.4',
}
_SEGMENTATION_RULES = [
    (r'^backbone/(.+)$', lambda m: 'backbone.' + _torch_scope(m[1]))] + [
    (rf'^{k}$', v) for k, v in _SEG_HEADS.items()]
# Faster R-CNN: torchvision's key space (the JAX package's
# `DETECTION_RULES`, inverted), the body under `backbone.body`
_DET_HEADS = {
    **{f'fpn/inner_{i}': f'backbone.fpn.inner_blocks.{i}.0'
       for i in range(4)},
    **{f'fpn/layer_{i}': f'backbone.fpn.layer_blocks.{i}.0'
       for i in range(4)},
    'rpn_head/conv': 'rpn.head.conv.0.0',
    'rpn_head/cls_logits': 'rpn.head.cls_logits',
    'rpn_head/bbox_pred': 'rpn.head.bbox_pred',
    'box_head/fc6': 'roi_heads.box_head.fc6',
    'box_head/fc7': 'roi_heads.box_head.fc7',
    'box_predictor/cls_score': 'roi_heads.box_predictor.cls_score',
    'box_predictor/bbox_pred': 'roi_heads.box_predictor.bbox_pred',
    # Mask R-CNN's and Keypoint R-CNN's heads (the JAX package's
    # `MASKRCNN_RULES` / `KEYPOINTRCNN_RULES`, inverted)
    **{f'mask_head/mask_fcn{i + 1}': f'roi_heads.mask_head.{i}.0'
       for i in range(4)},
    'mask_head/mask_deconv': 'roi_heads.mask_predictor.conv5_mask',
    'mask_head/mask_predictor': 'roi_heads.mask_predictor.mask_fcn_logits',
    **{f'keypoint_head/kp_fcn{i + 1}': f'roi_heads.keypoint_head.{2 * i}'
       for i in range(8)},
    'keypoint_head/kp_deconv': 'roi_heads.keypoint_predictor.'
                               'kps_score_lowres',
}
_DETECTION_RULES = [
    (r'^backbone/(.+)$', lambda m: 'backbone.body.' + _torch_scope(m[1]))
] + [(rf'^{k}$', v) for k, v in _DET_HEADS.items()]
# RetinaNet: torchvision's key space, P6/P7 as `extra_blocks`
_RETINA_HEADS = {
    **{f'fpn/{kind}_{i}': f'backbone.fpn.{kind}_blocks.{i}.0'
       for kind in ('inner', 'layer') for i in range(3)},
    'fpn/p6': 'backbone.fpn.extra_blocks.p6',
    'fpn/p7': 'backbone.fpn.extra_blocks.p7',
    **{f'head/cls_conv{i}': f'head.classification_head.conv.{i}.0'
       for i in range(4)},
    **{f'head/box_conv{i}': f'head.regression_head.conv.{i}.0'
       for i in range(4)},
    'head/cls_logits': 'head.classification_head.cls_logits',
    'head/bbox_reg': 'head.regression_head.bbox_reg',
}
_RETINANET_RULES = _DETECTION_RULES[:1] + [
    (rf'^{k}$', v) for k, v in _RETINA_HEADS.items()]
# ResNeSt: timm's `resnest50d` key space (the JAX package's
# `RESNEST_RULES` / `SPLITTABLE_RESNEST_RULES`, inverted)
_RESNEST_STEM = {'stem_conv0': 'conv1.0', 'stem_bn0': 'conv1.1',
                 'stem_conv1': 'conv1.3', 'stem_bn1': 'conv1.4',
                 'stem_conv2': 'conv1.6', 'stem_bn2': 'bn1'}
_RESNEST_RULES = [(rf'^{k}$', v) for k, v in _RESNEST_STEM.items()] + [
    (r'^layer(\d)/block(\d+)/conv2/(conv|bn0|fc1|bn1|fc2)$',
     r'layer\1.\2.conv2.\3'),
    (r'^layer(\d)/block(\d+)/downsample_conv$', r'layer\1.\2.downsample.1'),
    (r'^layer(\d)/block(\d+)/downsample_bn$', r'layer\1.\2.downsample.2'),
] + _RULES
# DenseNet: torchvision's `features.*` names (1-indexed dense layers)
_DENSENET_RULES = _BOTTLENECK_RULES + [
    (r'^block(\d)_l(\d+)_(bn|conv)(\d)$',
     lambda m: f'features.denseblock{m[1]}.denselayer{int(m[2]) + 1}.'
               + ('norm' if m[3] == 'bn' else 'conv') + m[4]),
    (r'^trans(\d)_bn$', r'features.transition\1.norm'),
    (r'^trans(\d)_conv$', r'features.transition\1.conv'),
    (r'^final_bn$', 'features.norm5'),
    (r'^classifier$', 'classifier'),
]
# Inception-v3: the Flax branch names -> torchvision's, by block type
_INCEPTION_KIND = {'Mixed_5b': 'A', 'Mixed_5c': 'A', 'Mixed_5d': 'A',
                   'Mixed_6a': 'B', 'Mixed_6b': 'C', 'Mixed_6c': 'C',
                   'Mixed_6d': 'C', 'Mixed_6e': 'C', 'Mixed_7a': 'D',
                   'Mixed_7b': 'E', 'Mixed_7c': 'E'}
_INCEPTION_BRANCH = {
    'A': {'b1': 'branch1x1', 'b5_1': 'branch5x5_1', 'b5_2': 'branch5x5_2',
          'b3_1': 'branch3x3dbl_1', 'b3_2': 'branch3x3dbl_2',
          'b3_3': 'branch3x3dbl_3', 'bp': 'branch_pool'},
    'B': {'b3': 'branch3x3', 'bd_1': 'branch3x3dbl_1',
          'bd_2': 'branch3x3dbl_2', 'bd_3': 'branch3x3dbl_3'},
    'C': {'b1': 'branch1x1', 'b7_1': 'branch7x7_1', 'b7_2': 'branch7x7_2',
          'b7_3': 'branch7x7_3', 'bd_1': 'branch7x7dbl_1',
          'bd_2': 'branch7x7dbl_2', 'bd_3': 'branch7x7dbl_3',
          'bd_4': 'branch7x7dbl_4', 'bd_5': 'branch7x7dbl_5',
          'bp': 'branch_pool'},
    'D': {'b3_1': 'branch3x3_1', 'b3_2': 'branch3x3_2',
          'b7_1': 'branch7x7x3_1', 'b7_2': 'branch7x7x3_2',
          'b7_3': 'branch7x7x3_3', 'b7_4': 'branch7x7x3_4'},
    'E': {'b1': 'branch1x1', 'b3_1': 'branch3x3_1', 'b3_2a': 'branch3x3_2a',
          'b3_2b': 'branch3x3_2b', 'bd_1': 'branch3x3dbl_1',
          'bd_2': 'branch3x3dbl_2', 'bd_3a': 'branch3x3dbl_3a',
          'bd_3b': 'branch3x3dbl_3b', 'bp': 'branch_pool'},
}
_INCEPTION_RULES = _BOTTLENECK_RULES + [
    (r'^(Mixed_\w+)/(\w+)/(conv|bn)$', lambda m: 'inception_modules.'
     f'{m[1]}.{_INCEPTION_BRANCH[_INCEPTION_KIND[m[1]]][m[2]]}.{m[3]}'),
    (r'^fc$', 'fc'),
]
_FAMILY_RULES = {'resnet': _RULES, 'regnet': _REGNET_RULES,
                 'resnest': _RESNEST_RULES, 'densenet': _DENSENET_RULES,
                 'inception': _INCEPTION_RULES,
                 'hybrid_vit': _HYBRID_VIT_RULES,
                 'hybrid_vit_teacher': _HYBRID_VIT_TEACHER_RULES,
                 'efficientnet': _EFFICIENTNET_RULES,
                 'segmentation': _SEGMENTATION_RULES,
                 'detection': _DETECTION_RULES,
                 'retinanet': _RETINANET_RULES}


def _family(params: dict) -> str:
    """Which rules convert a Flax tree, from its top-level scopes."""
    if 'backbone' in params and 'classifier' in params:
        return 'segmentation'
    if 'backbone' in params and 'rpn_head' in params:
        return 'detection'
    if 'backbone' in params and 'head' in params:
        return 'retinanet'
    if 'vit' in params:
        return 'hybrid_vit_teacher' if 'stem_conv' in params \
            else 'hybrid_vit'
    if 'stage0_block0' in params:
        return 'efficientnet'
    if 's1' in params or 's2' in params:
        return 'regnet'
    if 'Mixed_5b' in params:
        return 'inception'
    if any(re.fullmatch(r'block\d_l\d+_bn1', k) for k in params):
        return 'densenet'
    if any('fc1' in block.get('conv2', {})
           for k, stage in params.items() if re.fullmatch(r'layer\d', k)
           for block in stage.values()):
        return 'resnest'
    return 'resnet'


def _torch_scope(scope: str, family: str = 'resnet') -> str:
    for pattern, repl in _FAMILY_RULES[family]:
        m = re.fullmatch(pattern, scope)
        if m:
            out = repl(m) if callable(repl) else m.expand(repl)
            return out.replace('base/', 'base.')
    raise KeyError(f'no torch counterpart for flax scope {scope!r}')


def _is_deconv(scope: str, model) -> bool:
    """Whether the kernel at flax `scope` is a ConvTranspose's."""
    if scope.startswith('backbone/'):   # a segmentation/detection body
        body = None if model is None else model.backbone
        return _is_deconv(scope[len('backbone/'):],
                          getattr(body, 'body', body))
    if scope in _DECONV_SCOPES:
        return True
    if not re.fullmatch(_LAYER_SEQ, scope):
        return False
    if model is None:
        raise ValueError(f'{scope} is a LayerSeq kernel: converting it needs '
                         'the torch model (state_dict_from_flax(variables, '
                         'model))')
    return isinstance(model.get_submodule(_torch_scope(scope)),
                      torch.nn.ConvTranspose2d)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix, k, np.asarray(v)


def _box_head_fc6(value: np.ndarray, pooled: int = 7) -> np.ndarray:
    """Flax `box_head/fc6` kernel (h*w*c, out), its input a pooled RoI
    flattened as (h, w, c), -> torchvision's weight (out, c*h*w), which
    reads the RoI as (c, h, w)."""
    out = value.shape[1]
    c = value.shape[0] // (pooled * pooled)
    return np.transpose(value.reshape(pooled, pooled, c, out),
                        (3, 2, 0, 1)).reshape(out, -1)


def _param_leaf(leaf: str, value: np.ndarray, deconv: bool = False):
    """(torch leaf name, converted array) for one flax param leaf;
    `deconv` marks a ConvTranspose kernel."""
    if leaf == 'kernel':
        if deconv:                                # flipped HWIO -> IOHW
            return 'weight', np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        if value.ndim == 4:                       # HWIO -> OIHW
            return 'weight', np.transpose(value, (3, 2, 0, 1))
        return 'weight', value.T                  # Dense (I, O) -> (O, I)
    if leaf == 'scale':
        return 'weight', value
    m = re.fullmatch(r'(matrix|bias|factor)_(\d+)', leaf)
    if m:
        return f'_{m.group(1)}{m.group(2)}', value
    return leaf, value                            # bias, beta, gamma, quantiles


def state_dict_from_flax(variables: dict, model=None) -> dict:
    """Flax `{'params', 'batch_stats'}` of the JAX `SplittableResNet` (FP,
    SHP, MSHP or `SimpleBottleneck`), `ResNet`, `EntropicClassifierModule`,
    an image codec of the zoo, a RegNet, a hybrid ViT (student or teacher),
    an EfficientNet, a ResNeSt (student or teacher), a DenseNet or
    Inception-v3 student, a DeepLabv3, a Faster R-CNN (student or
    teacher), a Mask or Keypoint R-CNN or a RetinaNet -> a state_dict that
    `load_state_dict` takes strictly. `model`, the port's counterpart, is needed for a
    `SimpleBottleneck` (see the module doc)."""
    out = {}
    family = _family(variables['params'])
    for scope, leaf, value in _leaves(variables['params']):
        path = '/'.join(scope)
        name, arr = _param_leaf(leaf, value, deconv=leaf == 'kernel'
                                and _is_deconv(path, model))
        if path == 'box_head/fc6' and name == 'weight':
            arr = _box_head_fc6(value)
        if path == 'context_prediction' and name == 'weight':
            # the 'A' mask applied, and kept as the module's buffer
            from ..models.zoo_jahp import causal_mask
            mask = np.broadcast_to(causal_mask(arr.shape[-1]), arr.shape)
            arr = arr * mask
            out['context_prediction.mask'] = mask
        module = _torch_scope(path, family)
        out[f'{module}.{name}' if module else name] = arr
    for scope, leaf, value in _leaves(variables.get('batch_stats', {})):
        path = _torch_scope('/'.join(scope), family)
        out[f'{path}.running_{leaf}'] = value
        out[f'{path}.num_batches_tracked'] = np.asarray(0, np.int64)
    return {k: torch.from_numpy(np.array(v, order='C', copy=True))
            for k, v in out.items()}


def _block0(m):
    """The Flax `block{j}` of timm's 1-indexed block of match `m`."""
    return f'block{int(m[2]) - 1}'


_V2_INVERSE = (r'^(?:patch_embed\.backbone\.stages|patch_embed_pruned_stages)'
               r'\.(\d)\.blocks\.(\d+)\.(conv\d|norm\d|downsample\.conv|'
               r'downsample\.norm)$')
_BACKBONE_INVERSE = [
    (r'^stem\.(conv|bn)$', r'stem_\1'),
    (r'^s(\d)\.b(\d+)\.conv(\d)\.(conv|bn)$',
     lambda m: f's{m[1]}.{_block0(m)}.{m[4]}{m[3]}'),
    (r'^s(\d)\.b(\d+)\.se\.(fc\d)$',
     lambda m: f's{m[1]}.{_block0(m)}.se.{m[3]}'),
    (r'^s(\d)\.b(\d+)\.downsample\.(conv|bn)$',
     lambda m: f's{m[1]}.{_block0(m)}.down_{m[3]}'),
    (r'^head\.fc$', 'head_fc'),
    (r'^patch_embed\.backbone\.stem\.(conv|norm)$', r'stem_\1'),
    (_V2_INVERSE, lambda m: f'stage{m[1]}.block{m[2]}.'
     + m[3].replace('downsample.', 'downsample_')),
    (r'^patch_embed(\.|_)proj$', 'vit.patch_proj'),
    (r'^blocks\.(\d+)\.(norm1|norm2)$', r'vit.block\1.\2'),
    (r'^blocks\.(\d+)\.attn\.qkv$', r'vit.block\1.qkv'),
    (r'^blocks\.(\d+)\.attn\.proj$', r'vit.block\1.attn_proj'),
    (r'^blocks\.(\d+)\.mlp\.(fc\d)$', r'vit.block\1.mlp_\2'),
    (r'^(norm|head)$', r'vit.\1'),
    (r'^$', 'vit'),
]
_INVERSE_RULES = [(rf'^bottleneck_layer\.{re.escape(v)}$',
                   f'bottleneck_layer.{k}')
                  for k, v in _BOTTLENECK_SCOPES.items()] + [
    (r'^entropy_bottleneck$', 'entropy_bottleneck'),
    (r'^(base\.)?(conv1|bn1)$', r'\1stem.\2'),
    (r'^(base\.)?layer(\d)\.(\d+)\.(conv\d|bn\d)$', r'\1layer\2.block\3.\4'),
    (r'^(base\.)?layer(\d)\.(\d+)\.downsample\.0$',
     r'\1layer\2.block\3.downsample_conv'),
    (r'^(base\.)?layer(\d)\.(\d+)\.downsample\.1$',
     r'\1layer\2.block\3.downsample_bn'),
    (r'^(base\.)?fc$', r'\1fc'),
    (r'^backbone\.body\.(.+)$', lambda m: 'backbone.' + _flax_scope(m[1])),
] + [(rf'^{re.escape(v)}$', k.replace('/', '.'))
     for k, v in {**_DET_HEADS, **_RETINA_HEADS}.items()] + [
    (r'^backbone\.(.+)$', lambda m: 'backbone.' + _flax_scope(m[1])),
] + [(rf'^{re.escape(v)}$', k.replace('/', '.'))
     for k, v in _SEG_HEADS.items()] + _BACKBONE_INVERSE
_INVERSE_RULES += [
    (r'^features\.denseblock(\d)\.denselayer(\d+)\.(norm|conv)(\d)$',
     lambda m: f'block{m[1]}_l{int(m[2]) - 1}_'
               + ('bn' if m[3] == 'norm' else 'conv') + m[4]),
    (r'^features\.transition(\d)\.norm$', r'trans\1_bn'),
    (r'^features\.transition(\d)\.conv$', r'trans\1_conv'),
    (r'^features\.norm5$', 'final_bn'),
    (r'^classifier$', 'classifier'),
    (r'^inception_modules\.(Mixed_\w+)\.(\w+)\.(conv|bn)$',
     lambda m: f'{m[1]}.' + {v: k for k, v in _INCEPTION_BRANCH[
         _INCEPTION_KIND[m[1]]].items()}[m[2]] + f'.{m[3]}'),
]
_RESNEST_INVERSE = [(rf'^{re.escape(v)}$', k)
                    for k, v in _RESNEST_STEM.items()] + [
    (r'^layer(\d)\.(\d+)\.conv2\.(conv|bn0|fc1|bn1|fc2)$',
     r'layer\1.block\2.conv2.\3'),
    (r'^layer(\d)\.(\d+)\.downsample\.1$', r'layer\1.block\2.downsample_conv'),
    (r'^layer(\d)\.(\d+)\.downsample\.2$', r'layer\1.block\2.downsample_bn'),
] + _INVERSE_RULES
_EFFICIENTNET_INVERSE = [
    (r'^blocks\.(\d)\.(\d+)\.se\.conv_(reduce|expand)$',
     r'stage\1_block\2.se_\3'),
    (r'^blocks\.(\d)\.(\d+)\.(\w+)$', lambda m: f'stage{m[1]}_block{m[2]}.'
     + {v: k for k, v in (_EFFICIENTNET_STAGE0 if m[1] == '0'
                          else _EFFICIENTNET_BLOCK).items()}[m[3]]),
] + [(rf'^{v}$', k) for k, v in _EFFICIENTNET_TOP.items()]


def _layer_seq_entry(model, module: str):
    """The module at `module` when its parent is a `LayerSeq`, else None."""
    from ..models.layer import LayerSeq
    parent, _, index = module.rpartition('.')
    if model is None or not index.isdigit():
        return None
    try:
        seq = model.get_submodule(parent)
    except AttributeError:
        return None
    return seq[int(index)] if isinstance(seq, LayerSeq) else None


def _flax_scope(module: str, rules=_INVERSE_RULES) -> str:
    for pattern, repl in rules:
        m = re.fullmatch(pattern, module)
        if m:
            return repl(m) if callable(repl) else m.expand(repl)
    raise KeyError(f'no flax counterpart for torch module {module!r}')


def flax_param_path(name: str, model=None) -> str:
    """Dotted Flax path of the parameter `name` of the port's
    `SplittableResNet`, `ResNet`, `EntropicClassifierModule`, RegNet,
    hybrid ViT, DenseNet or Inception-v3 student, DeepLabv3, Faster, Mask
    or Keypoint R-CNN or RetinaNet; a `SimpleBottleneck`'s (`LayerSeq`
    entry `{i}` -> `layer{i}`), an EfficientNet's and a ResNeSt's (student
    or teacher) only when `model` is given."""
    from ..models.efficientnet import EfficientNet
    from ..models.resnest import ResNeSt, SplittableResNeSt
    module, _, leaf = name.rpartition('.')
    entry = _layer_seq_entry(model, module)
    if entry is not None:
        prefix, _, index = module.rpartition('.')
        prefix = re.sub(r'^backbone\.body\.', 'backbone.', prefix)
        if leaf == 'weight':
            leaf = 'scale' if isinstance(entry, torch.nn.BatchNorm2d) \
                else 'kernel'
        return f'{prefix}.layer{index}.{leaf}'
    rules = _INVERSE_RULES
    if isinstance(model, EfficientNet):
        rules = _EFFICIENTNET_INVERSE
    elif isinstance(model, (ResNeSt, SplittableResNeSt)):
        rules = _RESNEST_INVERSE
    scope = _flax_scope(module, rules)
    if leaf == 'weight':
        # BatchNorm, GroupNorm and LayerNorm scopes: `bn1`, `down_bn`,
        # `stem_norm`, `norm`, ...
        last = scope.rsplit('.', 1)[-1]
        leaf = 'scale' if re.fullmatch(r'(\w+_)?(bn|norm)\d*', last) \
            else 'kernel'
    else:
        m = re.fullmatch(r'_(matrix|bias|factor)(\d+)', leaf)
        if m:
            leaf = f'{m.group(1)}_{m.group(2)}'
    return f'{scope}.{leaf}'
