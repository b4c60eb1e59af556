#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`sc2bench_tpu_torch`) on one
NVIDIA GPU.

Run from the repository root with `python3 chip_smoke.py` (no arguments,
one card). It imports nothing of JAX or of `sc2bench_tpu`. Phases, each of
which fails loudly with a nonzero exit:

 1. build the CUDA rANS kernels from `sc2bench_tpu_torch/csrc/` (one nvcc
    per source, sm_90a, started together) and print the build seconds and
    ptxas register counts;
 2. hold each of the four cyclic kernels against its plain PyTorch version
    on the card at the flagship shapes (55x55x24 latent: 384 lanes x 190
    steps, 8 images) and on edge cases: 72 and 168 lanes (not multiples of
    32), n not a multiple of the lanes, k > 1, T = 600 (many staging
    tiles), a 225-column CDF row, and frequency-1 symbols. Bit-equal
    streams/lengths/states, packed bytes equal to the numpy oracle and
    equal between the two layouts, symbols back with valid=True, and
    valid=False for a corrupted stream. The aligned (wire_batch) pair also
    at k = 128 (the throughput mode's wire_batch) and k = 1, 3, 5 on the
    flagship lanes, and at a T beyond the batch-1 pair's limit. All four
    at 600- and 1,200-column CDF rows (k = 1 and 8, the flagship's lanes),
    which read their lane tables from device memory. The same checks for
    the four general per-index kernels at the MSHP y shape (55x55x24 on
    512 lanes x 142 steps, the default Gaussian tables) at k = 1 and 8,
    and at 100 lanes (n = 2,345, k = 3) and at T = 4,000 (40 lanes), with
    rows 0 and 63 and frequency-1 tail symbols, and on Gaussian tables of
    a custom scale table (0.11..1,024) too large for shared memory; the
    four indexed kernels read the tables' prepared form, whose one-time
    cost is printed, and the plan each case took (shared or device-memory
    encoder rows and decoder tables) is printed, both plans required of
    the batch-1 pair and of the aligned decoder, with the aligned
    decoder's images a block at k = 1, 8 and 128 (a corrupted state
    decoded as the plain version in each case); the aligned encoder with
    masks on and off; the aligned indexed pair also at k = 128 (timed,
    with its bound and the images a block each took).
    Print each kernel's ms
    (CUDA events around one call on an idle card, host dispatch
    included), device ms (launches queued behind a sleep kernel), plain
    ms and bound ms, the aligned cyclic pair's device ms at k = 8 and
    k = 128 with the images per block (G) each used, and the SM clocks;
 3. drive the main path, batch 1: `stream_deploy_device` of the
    full-width ResNet-50 + FP-24 model (1000 classes, seeded random
    weights) on 16 float 224x224 images and 4 uint8 images through
    `input_norm`; the compacted kernels must have launched once per image,
    no image may have taken the host escape path, and two images are
    checked against a reference built from the same symbols with the
    plain (CPU) coder;
 4. the same images with `wire_batch=8`: the aligned kernels launched, no
    escapes, per-image wire sizes and the data-size summary equal to
    phase 3, logits within rtol=atol=1e-3 of phase 3 (the tail runs at
    batch 8, where cuDNN may sum in another order);
 5. the escape path: an image whose latent leaves the CDF support among
    normal images, batch 1 and `wire_batch=8`: its accounted size equals
    that of `rt.encode(x)`, its logits equal `rt.decode(**rt.encode(x))`,
    the other images' sizes equal a run without it, and the run counts
    exactly one `ok=False` escape and no `valid=False` one;
 6. the classification test CLI (`sc2bench_tpu_torch.tasks.
    image_classification`) on the flagship config: phase 1's model saved
    with the port's `save_ckpt` is the student, the teacher is random
    (`allow_missing_teacher`), the test loader is 32 synthetic 224x224
    images of 1000 classes at batch 1. Once on the host wire and once
    with `deploy_wire: device`; each prints acc1, acc5, the data-size
    summary and the mean model_time, and the teacher's acc1 prints once.
    The device-wire run must launch `rans_cyclic_encode`/`_decode` once
    per image and no image may escape; its per-image sizes must equal a
    direct `stream_deploy_device` of the same images; the host-wire run
    launches no kernel, and its sizes must equal a direct `stream_deploy`,
    which prints the host wire's time per image by stage (wait for the
    symbols, host coding, decode dispatch); the two wires must give the
    same acc1 and logits within 1e-3 (same symbols, another coder);
 7. training on the card: the CLI without `-test_only` on the flagship
    Entropic Student config (phase 1's model as the student, a random
    teacher, synthetic 224x224 loaders of 1000 classes: 64 training
    images at batch 32 with drop_last, 32 validation images at batch 32;
    stage 1 two epochs with `epoch_to_update: 2`, stage 2 one epoch), then
    16 test images at batch 1 on the device wire; then one epoch (two
    steps) of the end-to-end config with `epoch_to_update: 1` and 8 test
    images. Per stage it prints the first and last step's loss detail,
    img/s over the steps after the first (host clock behind
    `torch.cuda.synchronize()`) and the peak device memory; per run the
    test's acc1, data size and escapes. It fails on a non-finite loss; on
    a teacher parameter, a stage-1-frozen layer2-4 tensor or any BN
    statistic that stage 1 changed; on an encoder or density parameter
    that stage 2 changed, or quantiles it did not; on tables not built
    after training; unless each test launched `rans_cyclic_encode` and
    `_decode` once per image; on a `valid=False` decode; and unless the
    test sizes equal a direct `stream_deploy_device`. Escapes are counted,
    not failed (a few steps on noise may leave the support). Last, one
    flagship stage-1 step at batch 2 on the card and on the CPU from the
    same state, batch and noise: loss detail, gradients and updated
    parameters within rtol 1e-3;
 8. one 2,584 px image through the FP model at batch 1 on auto lanes
    (3,072 lanes x 3,251 steps, beyond the batch-1 decoder's limit): it
    must be served through the aligned pair at k = 1 with no escape, its
    size equal to the plain coder's wire;
 9. MSHP serving: ResNet-50 + `MSHPBasedResNetBottleneck` (24/256/16),
    1000 classes, seeded random weights with h_s's scales spread
    (`spread_mshp_scales`), phase 3's 16 float images: the y indexes must
    use at least 8 of the 64 rows; at batch 1 the cyclic pair (z) and the
    indexed pair (y) launch once per image, at `wire_batch=8` the four
    aligned kernels once per group, y's encoder handed the Gaussian
    tables' prepared form that `update()` built on each of its calls (at
    both batch sizes, recorded); no escape, equal sizes, logits within
    1e-3; two images decode to the host path's y and z symbols with
    logits within 1e-3 of `rt.decode(**rt.encode(x))`; a scaled image
    takes the ok=False escape with `rt.encode`'s size; img/s both ways;
10. the test CLI on the MSHP flagship config (phase 6's checks, the
    indexed pair launching once per image too), then its two stages at 2
    steps each (batch 32) and 8 test images on the device wire: stage 1
    must leave layer2-4 and the BN statistics alone, stage 2 g_a, h_a,
    h_s and the density; img/s and peak memory per stage;
11. fine-tuning serving at full width: `entropic_classifier(resnet50,
    split, 1000)` with seeded random weights (not scaled to fit the
    support) at each configured split (layer1-4, avgpool), tables built,
    8 of phase 3's float images through `stream_deploy` (the host wire;
    JAX serves this family on no other): no kernel may launch; each
    image's accounted size must equal its host-wire object's and be
    within one byte of `rt.encode(x)`'s (the channel-major coder codes
    the same symbols in another order); its logits equal
    `rt.decode(**rt.encode(x))` (1e-5) and the 'finetune' forward (rtol
    = atol = 2e-4); `stream_deploy_device` must raise ValueError. Per
    split: the latent shape, symbols an image, the share out of support,
    KB an image, host coding ms an image and img/s;
12. the CLI on both families at the configs' batch 256 (synthetic 224 px
    loaders of 1000 classes): the fine-tuning config
    `resnet50-eb_after_layer1-beta1.0e-5.yaml`, two epochs of two steps
    (`grad_accum_step: 2`, one update an epoch; the tables built after
    epoch 1, epoch 2 in the 'finetune' mode), then 8 test images on the
    host wire (no kernel, sizes equal a direct `stream_deploy`, BN
    statistics unchanged under `train_bn: false`); the CR+BQ config
    `resnet50-bq12ch_from_resnet50.yaml` (its one stage, two steps, a
    random teacher), which must leave layer2-4, every BN statistic and
    the teacher unchanged and move the encoder, then 8 test images
    through the plain forward with no data size, as in JAX; then those
    images through the config's `SplitClassifier` wrapper
    (`SimpleQuantizer(8)`, a 12x28x28 latent): KB an image, and the
    8-bit round trip within half a quantization step (and float32
    rounding). img/s and peak memory per stage;
13. the input- and feature-compression wrappers through the test CLI at
    full width (ResNet-50, random weights, synthetic 224 px images of
    1000 classes): JPEG (16 images) and WebP (4) on the input, JPEG on
    the layer2 feature (16); the neural codecs at the configs' quality 1
    with seeded weights (`codec_weights`: He-normal, the last g_a
    convolution halved, the hyperpriors' scales spread) saved as the
    codec ckpt: `factorized_prior-resnet50.yaml` and
    `mean_scale_hyperprior-resnet50.yaml` at 16 images padded to 256 px
    by the configs' AdaptivePad, `scale_hyperprior-resnet50.yaml` at 4.
    Each prints acc1, acc5, KB an image, img/s and the host coder's ms an
    image; no kernel may launch (host coders); each neural codec's
    encoder on the card agrees with the CPU's on one image (99.9% of the
    symbols and indexes at least) and its host round trip gives the
    decoder on the encoder's own symbols. Then the joint autoregressive
    codec q1 (192, 192) on 4 images of 256 px, on the host wire and the
    device wire: every symbol in support, the device decode valid with a
    y_hat equal to the encoder's and to the host path's bit for bit;
    `rans_masked_encode_aligned` launched once an image, `rans_masked_
    decode_front` once a front (61 an image), both on the Gaussian
    tables' prepared form that `update()` built (recorded at each call),
    the aligned cyclic pair once each for z; at the path's shapes all four
    equal their plain versions, the front decoder on every front, the
    masked encoder also on tables with zero-frequency entries coded on
    active lanes; the masked kernels' ms, device ms, plain ms and bound,
    and their launch floor (an empty kernel on their grid);
14. the RegNetY-6.4GF and hybrid ViT-S R26+S/32 students at full width
    with seeded weights (`build_student`: the configs' 64-channel FP and
    MSHP bottlenecks, `build_model`'s weights and halved last encoder
    conv, MSHP's scales spread): each FP student serves 16 images at
    batch 1 and `wire_batch=8` (55x55x64 on 1,024 cyclic lanes), checked
    as phases 3-4 (wires equal to the plain coder, logits equal to
    `forward_tail` on the decoded feature); each MSHP student 8 images as
    phase 9 (y on 1,024 general lanes, z 14x14x16 on 16 cyclic lanes;
    the scales spread with channel 0's median at 2.0);
    the cyclic kernels at FP-64 and MSHP z and the indexed ones at MSHP y
    held against their plain versions and timed there; the test CLI on
    the FP and MSHP config of each family (16 images, both wires, as
    phase 6); two steps of each stage of the RegNet MSHP and hybrid-ViT
    FP configs at batch 32 (what each stage may change, as phase 10),
    then 8 test images; EfficientNet-L2 (480,309,308 parameters) at full
    width behind `jpeg-` and `mean_scale_hyperprior-tf_efficientnet_l2_
    ns_475.yaml` through the CLI on 4 synthetic 475 px images. Launches
    are counted per path, each from 0;
15. PASCAL VOC segmentation: DeepLabv3-ResNet-50 + FP-24 (the
    `-fp-beta0.16` student with its aux head, `build_model`'s seeded
    weights and halved last encoder conv) serves 16 synthetic 512x512
    images at batch 1 and `wire_batch=8` on the device wire (127x127x24
    on 1,536 cyclic lanes x 253 steps), 8 on the host wire and 2 of
    500x375 (93x124x24, 1,536 x 181), launches counted per run: wires
    equal the plain coder, logits equal the direct decode -> tail ->
    head -> upsampling, no escape, sizes equal at batch 1 and
    `wire_batch`; the four cyclic kernels held against their plain
    versions at both shapes and timed at 512x512; the segmentation test
    CLI on the `-fp-beta0.16` config on both wires (16 images: mIoU, KB,
    model_time); two steps of each stage of that config (batch 16) and of
    the end-to-end config (batch 8) at 512 px (img/s, peak memory, what
    each stage may change), each then tested on 4 images; the
    `jpeg-deeplabv3_resnet101`, `mean_scale_hyperprior-deeplabv3_
    resnet50` (with `codec_weights`) and `ghnd-bq` bq12ch configs through
    the CLI on 4 images each;
16. COCO detection: Faster R-CNN R50-FPN + FP-24 (the `-fp-beta0.08`
    student, 91 classes, `build_model`'s seeded weights and halved last
    encoder conv, torchvision's initialization of the RPN and box
    predictors) serves 8 synthetic 480x640 images and 2 of 640x480 (the
    800x1344 and 1344x800 canvases: 199x335x24 on 3,072 cyclic lanes x
    521 steps) at batch 1 and `wire_batch=4` on the device wire, and 4 on
    the host wire, launches counted per run: wires equal the plain coder,
    detections equal the direct decode -> tail -> postprocess, no escape,
    sizes equal at batch 1 and `wire_batch`; the four cyclic kernels held
    against their plain versions at 3,072 x 521 and at the square
    canvas's 3,072 x 877, and timed at 3,072 x 521; the detection test
    CLI on that config on both wires (8 images: mAP, KB, model_time); two
    steps of each stage of that config and of the end-to-end config at
    batch 4 on the 1344x1344 canvas (img/s, peak memory, what each stage
    may change), each then tested on 2 images; the `ghnd-bq` bq12ch config
    through the CLI on 4 images;
17. COCO input compression before Faster R-CNN: the 6 runnable
    `configs/coco2017/input_compression/` configs (JPEG, WebP, and the
    FP, SHP, MSHP and JAHP codecs q1 with `codec_weights` saved as their
    ckpt) through the detection CLI at full width, 2 synthetic 480x640
    images each (resized to 800x1067, compressed, on the 1344x1344
    canvas): mAP, KB an image, model_time; no kernel launch (host
    coders);
18. the bfloat16 options: on the FP and MSHP models of phases 3 and 9,
    8 images, `deploy_bf16_decode` at batch 1 and `wire_batch=8` and
    `deploy_bf16_tail` on the host wire, their sizes equal to the float32
    runtime's image by image (no escape), top-1 agreeing on at least 7 of
    8, img/s beside the float32 runtime's; `deploy_bf16_encode` streams
    decoding exactly (no escape), at most 1% of the symbols one step from
    the float32 encoder's, the wire within 1e-3 of its size;
    DeepLabv3-ResNet-50 + FP-24 at 512x512 and Faster R-CNN R50-FPN +
    FP-24 on the 800x1344 canvas at `dtype='bfloat16'` beside float32 on
    the same weights, one image each (float32 outputs, finite, the share
    of agreeing pixels or detections, img/s); and `python -m
    sc2bench_tpu_torch.bench` with short loops, its JSON line printed
    (the MFU fields present and below 1), its launches counted;
19. print the kernels line (all ten kernels; it fails if one never
    launched on its path or differs from its plain version, if a cyclic
    or indexed kernel never launched in phase 14, or a cyclic one in
    phase 15 or 16, or a cyclic one on phase 18's bfloat16 device wire
    or bench; the counts of phases 11-18 beside, and phase 14's, 15's
    and 16's timings at their shapes under `*_64ch`, `*_seg` and
    `*_det`), the card's name and power limit, and last `{"ok": true,
    "device": {...}}`. Every phase prints its seconds.

Without a CUDA device, or outside a checkout of the repository, it exits
with an error before printing any result.
"""
from __future__ import annotations

import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = {'cyclic': 'sc2bench_tpu_torch/csrc/rans_cyclic.cu',
           'indexed': 'sc2bench_tpu_torch/csrc/rans_indexed.cu'}
PALLAS = 'sc2bench_tpu/ops/rans/pallas_kernel.py'
SCAN = 'sc2bench_tpu/ops/rans/device.py'
JAHP_DEVICE = 'sc2bench_tpu/models/zoo_jahp_device.py'
REPLACES = {
    'rans_cyclic_encode': f'{PALLAS}:397 _encode_kernel',
    'rans_cyclic_decode': f'{PALLAS}:54 _decode_kernel',
    'rans_cyclic_encode_aligned': f'{PALLAS}:130 _encode_kernel_aligned',
    'rans_cyclic_decode_aligned': f'{PALLAS}:95 _decode_kernel_aligned',
    'rans_indexed_encode': f'{SCAN}:551 step + :591 _finish_encode '
                           '(XLA scan, no Pallas kernel)',
    'rans_indexed_decode': f'{SCAN}:704 step with :409 cdf_bisect '
                           '(XLA scan, no Pallas kernel)',
    'rans_indexed_encode_aligned': f'{SCAN}:551 step, aligned=True '
                                   '(:578-587; XLA scan, no Pallas kernel)',
    'rans_indexed_decode_aligned': f'{SCAN}:688-702 step_a (XLA scan, no '
                                   'Pallas kernel)',
    'rans_masked_encode_aligned': f'{JAHP_DEVICE}:122 _rans_encode_step, '
                                  'scanned at :258 (XLA scan, no Pallas '
                                  'kernel)',
    'rans_masked_decode_front': f'{JAHP_DEVICE}:142 _rans_decode_step, one '
                                'a front in the :331 scan (XLA scan, no '
                                'Pallas kernel)',
}
N_FLOAT, N_UINT8, WIRE_BATCH, HW = 16, 4, 8, 224
LOGIT_TOL = 1e-3
FLAGSHIP_CONFIG = ('configs/ilsvrc2012/supervised_compression/'
                   'entropic_student/'
                   'splitable_resnet50-fp-beta0.16_from_resnet50.yaml')
N_CLI = 32
MSHP_CONFIG = ('configs/ilsvrc2012/supervised_compression/'
               'entropic_student/'
               'splitable_resnet50-mshp-beta0.16_from_resnet50.yaml')
# the kernels a batch-1 image launches once each on the device wire
FP_BATCH1 = ('rans_cyclic_encode', 'rans_cyclic_decode')
MSHP_BATCH1 = FP_BATCH1 + ('rans_indexed_encode', 'rans_indexed_decode')
# phase 8's image: a 645x645x24 latent, 3,072 lanes x 3,251 steps
BIG_HW = 2584
END_TO_END_CONFIG = ('configs/ilsvrc2012/supervised_compression/end-to-end/'
                     'splitable_resnet50-fp-beta1.024e-7.yaml')
# phases 11-12: the fine-tuning and CR+BQ families
FT_SPLITS = ('layer1', 'layer2', 'layer3', 'layer4', 'avgpool')
N_FT = 8
FT_CONFIG = ('configs/ilsvrc2012/supervised_compression/fine-tuning/'
             'resnet50-eb_after_layer1-beta1.0e-5.yaml')
BQ_CONFIG = ('configs/ilsvrc2012/supervised_compression/ghnd-bq/'
             'resnet50-bq12ch_from_resnet50.yaml')
# the configs' batch; two steps an epoch
N_BQ_TRAIN, BQ_BATCH, N_BQ_TEST = 512, 256, 8
# phase 7: synthetic 224x224 loaders, 1000 classes
N_TRAIN, N_VAL, TRAIN_BATCH, N_TRAIN_TEST, N_E2E_TEST = 64, 32, 32, 16, 8
# phase 13: the wrapper configs at full width; the JAHP at 256 px
INPUT_CFG = 'configs/ilsvrc2012/input_compression/'
FEATURE_CFG = 'configs/ilsvrc2012/feature_compression/'
N_CODEC, N_CODEC_SMALL, N_JAHP, CODEC_HW = 16, 4, 4, 256
JAHP_KEY = 'joint_autoregressive_hierarchical_prior'
# phase 14: the RegNetY-6.4GF and hybrid-ViT (R26+S/32) students of the
# configs (64-channel latents), and EfficientNet-L2 behind two wrappers
ES_CFG = 'configs/ilsvrc2012/supervised_compression/entropic_student/'
VIT_CFG = ES_CFG + ('splitable_hybrid_vit_small_r26_s32_224-{}-beta0.16_from_'
                    'hybrid_vit_small_r26_s32_224.yaml')
BACKBONE_CONFIGS = {
    'regnet': {kind: ES_CFG + f'splitable_regnety6.4gf-{kind}-beta0.08_from_'
               'regnety6.4gf.yaml' for kind in ('fp', 'mshp')},
    'hybrid_vit': {kind: VIT_CFG.format(kind) for kind in ('fp', 'mshp')},
}
BACKBONE_NAMES = {'regnet': 'RegNetY-6.4GF', 'hybrid_vit': 'hybrid ViT-S '
                  'R26+S/32'}
# stage 1's frozen tail of each family (its config's frozen_modules)
BACKBONE_TAILS = {'regnet': ('s2', 's3', 's4'),
                  'hybrid_vit': ('patch_embed_pruned_stages',)}
N_BACKBONE, N_BACKBONE_MSHP, N_BACKBONE_CLI = 16, 8, 16
# channel 0's median scale of the 64-channel MSHP students: at phase 9's
# 0.8 a few of their 193,600 y symbols an image fall outside their rows'
# support, and the image escapes; at 2.0 every symbol of the served and
# tested images stays inside
MSHP64_MEDIAN_SCALE = 2.0
L2_CONFIGS = ('jpeg-tf_efficientnet_l2_ns_475.yaml',
              'mean_scale_hyperprior-tf_efficientnet_l2_ns_475.yaml')
N_L2, L2_HW, L2_PARAMS = 4, 475, 480_309_308
# phase 15: PASCAL VOC segmentation (DeepLabv3-ResNet-50 + FP-24)
SEG_CFG = 'configs/pascal_voc2012/'
SEG_SC = SEG_CFG + 'supervised_compression/'
SEG_ES_CONFIG = SEG_SC + ('entropic_student/deeplabv3_splittable_resnet50-fp-'
                          'beta0.16_from_deeplabv3_resnet50.yaml')
SEG_E2E_CONFIG = SEG_SC + ('end-to-end/deeplabv3_splittable_resnet50-fp-'
                           'beta1.024e-7.yaml')
SEG_SMALL_CONFIGS = (
    SEG_CFG + 'input_compression/jpeg-deeplabv3_resnet101.yaml',
    SEG_CFG + 'input_compression/'
    'mean_scale_hyperprior-deeplabv3_resnet50.yaml',
    SEG_SC + 'ghnd-bq/deeplabv3_resnet50-bq12ch_from_deeplabv3_resnet50.yaml')
# 512x512 and VOC's typical 500x375 (375 high); the configs' batches
SEG_HW, SEG_VOC_HW, SEG_CLASSES = (512, 512), (375, 500), 21
N_SEG, N_SEG_HOST, N_SEG_VOC, N_SEG_CLI, N_SEG_SMALL = 16, 8, 2, 16, 4
SEG_ES_BATCH, SEG_E2E_BATCH = 16, 8
# phase 16: COCO detection (Faster R-CNN R50-FPN + FP-24)
DET_SC = 'configs/coco2017/supervised_compression/'
DET_ES_CONFIG = DET_SC + ('entropic_student/faster_rcnn_splittable_resnet50-'
                          'fp-beta0.08_fpn_from_faster_rcnn_resnet50_fpn.yaml')
DET_E2E_CONFIG = DET_SC + ('end-to-end/faster_rcnn_splittable_resnet50-fp-'
                           'beta1.28e-8_fpn.yaml')
DET_BQ_CONFIG = DET_SC + ('ghnd-bq/faster_rcnn_resnet50-bq12ch_fpn_from_'
                          'faster_rcnn_resnet50_fpn.yaml')
# COCO's typical 480x640 (landscape) and 640x480: the 800x1344 and
# 1344x800 canvases of the configs' `canvas_size: 1344`
DET_LAND, DET_PORT, DET_CLASSES = (480, 640), (640, 480), 91
N_DET_LAND, N_DET_PORT, N_DET_HOST, N_DET_CLI, N_DET_SMALL = 8, 2, 4, 8, 2
N_DET_BQ, DET_WIRE_BATCH, DET_BATCH = 4, 4, 4
# the training runs' canvas: every batch padded to the square bucket
DET_SQUARE = [[1344, 1344]]
# phase 17: COCO input compression before Faster R-CNN (the 6 runnable
# configs; BPG needs its binary)
DET_IC = 'configs/coco2017/input_compression/'
DET_IC_CODECS = ('jpeg', 'webp', 'factorized_prior', 'scale_hyperprior',
                 'mean_scale_hyperprior', JAHP_KEY)
N_DET_IC = 2
# phase 18: the bfloat16 options, 8 images; the bench with short loops
N_BF16, BF16_TOP1 = 8, 7
BENCH_ARGS = ['--n_iter', '32', '--n_trials', '2', '--loop_n', '10',
              '--fresh_n_iter', '16', '--throughput_n_iter', '256',
              '--train_steps', '2']
# H100 SXM published peaks: HBM bytes/s, and
# the non-tensor-core rate used for the kernels' integer operations
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# integer operations per coded symbol, counted from the kernels' code:
# encode = compare, shift, mask, select, divide, remainder, shift, two adds
# and the stream write; decode = one compare+add per CDF entry searched
# plus mask, shift, multiply, add, subtract, compare, shift, or, add
ENCODE_OPS_PER_SYMBOL = 10
DECODE_OPS_PER_SYMBOL = 9


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def per_call_ms(torch, fn, reps):
    """Median ms of CUDA events around one call on an idle card, after two
    warm-up calls: the host's dispatch (argument checks, allocation, the
    ctypes call) plus the kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps, tries=3):
    """Device ms per call of `reps` calls queued back to back: a sleep
    kernel holds the card while the host enqueues them, so the events
    see only device work. The sleep is twice the measured enqueue time;
    a run whose enqueue outlasted it saw idle gaps and is taken again."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # cycles at 2 GHz, at or above the H100's top SM clock: at any
        # lower clock the sleep only lasts longer
        torch.cuda._sleep(int(2 * enqueue_s * 2e9) + 1000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        end.record()
        queued_s = time.perf_counter() - t0
        end.synchronize()
        if queued_s <= 2 * enqueue_s:
            return start.elapsed_time(end) / reps
    raise SmokeFailure(f'enqueue took {queued_s:.4f} s in each of {tries} '
                       'runs, longer than the sleep covering it: the timing '
                       'saw idle gaps')


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def build_model(torch, device, seed, bottleneck=24, target=256,
                stage_sizes=(3, 4, 6, 3), classes=1000,
                key='FPBasedResNetBottleneck'):
    """The flagship model with seeded random weights: He-normal convs, BN
    affine and statistics near identity (bn3 scales not zero). `key`
    names the bottleneck (FP, or MSHP with its default 16 latent
    channels)."""
    from sc2bench_tpu_torch.models.backbone import splittable_resnet
    torch.manual_seed(seed)
    model = splittable_resnet(
        {'key': key,
         'kwargs': {'num_bottleneck_channels': bottleneck,
                    'num_target_channels': target}},
        stage_sizes=stage_sizes, num_classes=classes, device=device)
    randomize_weights(torch, model, seed, device)
    return halve_last_encoder_conv(torch, model)


def halve_last_encoder_conv(torch, model):
    """Halve the bottleneck's last encoder conv: the latent (std ~0.9 on
    unit-normal images) then stays inside the +-10 support of fresh
    quantiles, as a trained model's latent does."""
    with torch.no_grad():
        bneck = model.bottleneck_layer
        last = bneck.encoder[-1] if hasattr(bneck, 'encoder') \
            else bneck.g_a[-1]
        last.weight.mul_(0.5)
    return model


def randomize_weights(torch, model, seed, device):
    """He-normal convolutions, BN affine and statistics near identity (bn3
    scales not zero), from a CPU generator seeded with `seed`."""
    gen = torch.Generator(device='cpu').manual_seed(seed)

    def rand(shape, lo, hi):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(device)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = m.weight if isinstance(m, torch.nn.Conv2d) \
                    else m.weight.transpose(0, 1)
                fan_in = w[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               .to(device) * (2.0 / fan_in) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(rand(m.weight.shape, 0.2, 0.6))
                m.bias.copy_(rand(m.bias.shape, -0.1, 0.1))
                m.running_mean.copy_(rand(m.running_mean.shape, -0.1, 0.1))
                m.running_var.copy_(rand(m.running_var.shape, 0.5, 1.5))
    return model


def spread_mshp_scales(torch, model, image, median=0.8):
    """Make an MSHP model's predicted scales positive and spread over the
    Gaussian table, as a trained model's are: h_s's last convolution gets
    |w| on its scale channels, channel c times 2^(c/4), scaled so that
    channel 0's median scale on `image` is `median`; its mean channels are
    damped (x 0.1). y then stays inside the support (|y - mean| well below
    6 scales) while its rows cover tens of the 64."""
    bneck = model.bottleneck_layer
    conv = bneck.h_s[-1]
    bch = conv.out_channels // 2
    with torch.no_grad():
        w = conv.weight
        mult = 2.0 ** (torch.arange(bch, device=w.device) / 4.0)
        w[:bch] = w[:bch].abs() * mult[:, None, None, None]
        w[bch:] *= 0.1
        z = bneck.h_a(bneck.hyper_input(bneck.g_a(image)))
        scales, _ = bneck.gaussian_params(bneck.h_s(torch.round(z)))
        w[:bch] *= median / float(scales[0, 0].median())
    return model


def draw_symbols(tables, n, rng):
    """n cyclic symbols (position p codes channel p % C) drawn from the
    tables' own distributions, inside the coded support."""
    cdf, cdf_len, off = tables.quantized_cdf, tables.cdf_length, tables.offset
    c = cdf.shape[0]
    idx = np.arange(n) % c
    u = rng.integers(0, 1 << 16, n)
    sym = np.empty(n, np.int32)
    for ch in range(c):
        m = idx == ch
        row = cdf[ch][:cdf_len[ch]]
        v = np.clip(np.searchsorted(row, u[m], side='right') - 1,
                    0, cdf_len[ch] - 3)
        sym[m] = v + off[ch]
    return sym


def synthetic_tables(channels, support, seed, rare=False, skew=1):
    """Random CDF rows of `support` + 2 entries. With `rare=True`, value 1
    of every row has frequency 1; `skew` > 1 gives many symbols of
    frequency 2, so one coarse decode bucket (256 slots) holds many."""
    from sc2bench_tpu_torch.ops.entropy.tables import CodingTables
    rng = np.random.default_rng(seed)
    cols = support + 2
    cdf = np.zeros((channels, cols), np.int32)
    for c in range(channels):
        w = rng.uniform(0.05, 1.0, cols - 1) ** skew
        freqs = np.maximum((w / w.sum() * (1 << 16)).astype(np.int64), 2)
        if rare:
            freqs[1] = 1
        freqs[np.argmax(freqs)] += (1 << 16) - freqs.sum()
        cdf[c, 1:] = np.cumsum(freqs)
    return CodingTables(cdf, np.full(channels, cols, np.int32),
                        rng.integers(-20, -5, channels).astype(np.int32))


def oracle_wire(td, sym, tables, lanes):
    """Packed wire bytes from the numpy oracle alone."""
    c = tables.quantized_cdf.shape[0]
    streams, states = td.numpy_oracle_encode(
        sym, np.arange(len(sym)) % c, tables.quantized_cdf,
        tables.cdf_length, tables.offset, num_lanes=lanes,
        cyclic_channels=c)
    lengths = np.asarray([len(s) for s in streams], np.uint16)
    body = [np.asarray([lanes, 0], np.uint16).tobytes(), lengths.tobytes(),
            states.astype(np.uint32).tobytes()]
    body += [np.asarray(s, np.uint16).tobytes() for s in streams]
    return b''.join(body)


def kernel_case(torch, td, kernels, tables, lanes, n, k, rng, device,
                rare=False, batch1=True):
    """Phase 2 checks for one (lanes, n, k) case; `rare=True` sets every
    seventh symbol to value 1 (frequency 1 in `synthetic_tables(...,
    rare=True)`); `batch1=False` checks the aligned pair only, without the
    numpy oracle. Returns the inputs and outputs the timing step needs."""
    c = tables.quantized_cdf.shape[0]
    rows = np.stack([draw_symbols(tables, n, rng) for _ in range(k)])
    if rare:
        rows[:, ::7] = 1 + tables.offset[np.arange(n)[::7] % c]
    cdf_lane, len_lane, off_lane = td.lane_tables(
        tables.quantized_cdf, tables.cdf_length, tables.offset, lanes, c,
        device)
    sym3, _, _ = td._blocks(torch.from_numpy(rows).to(device), lanes,
                            off_lane)
    vc = (sym3 - off_lane).contiguous()
    steps = vc.shape[1]
    tag = f'lanes={lanes} n={n} k={k} cols={cdf_lane.shape[1]}'
    errs = {}

    def compare(name, got, ref):
        for a, b in zip(got, ref):
            if a is None and b is None:
                continue
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
            err = int(diff.max()) if diff.numel() else 0
            errs[name] = max(errs.get(name, 0), err)
            check(err == 0 and a.shape == b.shape and a.dtype == b.dtype,
                  f'{name} differs from its plain version ({tag})')

    enca = kernels.cyclic_encode_aligned(cdf_lane, vc, want_masks=True)
    compare('rans_cyclic_encode_aligned', enca,
            td.cyclic_encode_plain(cdf_lane, vc, aligned=True,
                                   want_masks=True))
    states = enca[2]
    decoders = [('rans_cyclic_decode_aligned', enca[0], True)]
    enc = None
    if batch1:
        enc = kernels.cyclic_encode(cdf_lane, vc)
        compare('rans_cyclic_encode', enc,
                td.cyclic_encode_plain(cdf_lane, vc))
        decoders.insert(0, ('rans_cyclic_decode', enc[0], False))
        for r in range(k):
            wire = td.pack_stream({'streams': enc[0][r],
                                   'lengths': enc[1][r],
                                   'states': enc[2][r]})
            wire_a = td.pack_stream_aligned(
                {'streams': enca[0][r], 'lengths': enca[1][r],
                 'states': enca[2][r], 'masks': enca[3][r]})
            check(wire == wire_a,
                  f'compacted and aligned wires differ ({tag})')
            check(wire == oracle_wire(td, rows[r], tables, lanes),
                  f'packed bytes differ from the numpy oracle ({tag})')

    for name, streams, aligned in decoders:
        fn = kernels.cyclic_decode_aligned if aligned \
            else kernels.cyclic_decode
        out, xend = fn(streams, states, cdf_lane, len_lane, off_lane, steps)
        compare(name, (out, xend), td.cyclic_decode_plain(
            streams, states, cdf_lane, len_lane, off_lane, steps,
            aligned=aligned))
        flat = out.reshape(k, -1)[:, :n].cpu().numpy()
        check(np.array_equal(flat, rows), f'{name} lost symbols ({tag})')
        check(bool((xend == td.RANS_L).all()),
              f'{name}: valid=False on a good stream ({tag})')
        bad = states.clone()
        bad[k - 1, lanes // 3] ^= 0x5A5A
        out, xbad = fn(streams, bad, cdf_lane, len_lane, off_lane, steps)
        compare(name, (out, xbad), td.cyclic_decode_plain(
            streams, bad, cdf_lane, len_lane, off_lane, steps,
            aligned=aligned))
        check(not bool((xbad[k - 1] == td.RANS_L).all()),
              f'{name}: valid=True on a corrupted stream ({tag})')
    torch.cuda.synchronize()
    return dict(vc=vc, cdf_lane=cdf_lane, len_lane=len_lane,
                off_lane=off_lane, steps=steps, enc=enc, enca=enca,
                errs=errs)


def kernel_phase(torch, td, kernels, tables, device):
    """Phase 2: every kernel against its plain version; timings at the
    main path's shapes (batch 1 compacted, WIRE_BATCH aligned)."""
    rng = np.random.default_rng(1234)
    c = tables.quantized_cdf.shape[0]
    n = 55 * 55 * c
    lanes = td.auto_lanes(n, cyclic_channels=c)
    flag = kernel_case(torch, td, kernels, tables, lanes, n, WIRE_BATCH,
                       rng, device)
    edge = [kernel_case(torch, td, kernels, tables, 72, 5000, 2, rng,
                        device),
            kernel_case(torch, td, kernels, tables, 168, 168 * 77 + 5, 3,
                        rng, device),
            kernel_case(torch, td, kernels, tables, lanes, lanes * 600, 2,
                        rng, device),
            kernel_case(torch, td, kernels,
                        synthetic_tables(8, 223, 5, skew=24), 40,
                        40 * 50 - 3, 2, rng, device),
            kernel_case(torch, td, kernels,
                        synthetic_tables(6, 19, 6, rare=True), 30, 3001, 2,
                        rng, device, rare=True)]
    log(f'phase 2: kernels equal their plain versions (lanes={lanes}, '
        f'steps={flag["steps"]}, cols={tables.quantized_cdf.shape[1]}, k=8; '
        'edge cases: 72 lanes n=5000 k=2; 168 lanes k=3; T=600; '
        '225-column rows; frequency-1 symbols)')
    cols = tables.quantized_cdf.shape[1]
    long_steps = kernels.max_steps(False, device) + 5
    # the aligned pair alone: the throughput mode's k = 128, k not a
    # multiple of the block's images, and a T the batch-1 pair refuses
    wide = kernel_case(torch, td, kernels, tables, lanes, n, 128, rng,
                       device, batch1=False)
    edge += [kernel_case(torch, td, kernels, tables, lanes, n, k, rng,
                         device, batch1=False) for k in (1, 3, 5)]
    edge.append(kernel_case(torch, td, kernels, tables, 48,
                            48 * long_steps - 7, 2, rng, device,
                            batch1=False))
    log(f'phase 2: aligned pair equals its plain versions at k=128, at '
        f'k=1, 3, 5 and at T={long_steps} (48 lanes)')
    # rows wider than the shared-memory plans: lane tables in device memory
    for support in (598, 1198):
        wide_tables = synthetic_tables(c, support, support)
        wcols = wide_tables.quantized_cdf.shape[1]
        plans = {f'{name} k={k}': kernels.table_bytes(
            name, wcols, flag['steps'], flag['steps'], k, lanes, device)
            for name in kernels.KERNELS for k in (1, WIRE_BATCH)}
        check(plans['rans_cyclic_encode k=1'] > 0,
              f'{wcols}-column rows kept their tables in shared memory')
        edge += [kernel_case(torch, td, kernels, wide_tables, lanes, n, k,
                             rng, device) for k in (1, WIRE_BATCH)]
        log(f'phase 2: all four kernels equal their plain versions at '
            f'{wcols}-column rows (k=1 and {WIRE_BATCH}, {lanes} lanes); '
            'global-table buffers, bytes: ' + ', '.join(
                f'{name} {b}' for name, b in plans.items()))
    log(f'phase 2: batch-1 kernels take up to '
        f'{kernels.max_steps(False, device)} steps (encode) and '
        f'{kernels.max_steps(True, device)} stream columns (decode) at any '
        'CDF width')

    stats = cyclic_stats(torch, td, kernels, flag, wide)
    for name, st in stats.items():
        st['max_abs_err'] = max(case['errs'].get(name, 0)
                                for case in [flag, wide] + edge)
    k8 = WIRE_BATCH
    log('phase 2: aligned pair on the card, k=8 / k=128: '
        + ', '.join(f'{name} {stats[name]["device_ms"]:.4f} / '
                    f'{stats[name]["device_ms_k128"]:.4f} ms (bound '
                    f'{stats[name]["bound_ms"]:.6f} / '
                    f'{stats[name]["bound_ms_k128"]:.6f}; images per block '
                    f'G={kernels.aligned_group("decode" in name, k8, lanes)}'
                    f' / {kernels.aligned_group("decode" in name, 128, lanes)}'
                    ')' for name in ('rans_cyclic_encode_aligned',
                                     'rans_cyclic_decode_aligned')))
    clocks = smi_query('clocks.sm,clocks.max.sm')
    log(f'phase 2: SM clock now, max (MHz): {clocks}')
    return stats


def cyclic_stats(torch, td, kernels, flag, wide=None, tag='phase 2'):
    """Timings of the four cyclic kernels at `flag`'s shape (a
    `kernel_case` at k = WIRE_BATCH: the batch-1 pair on its first image,
    the aligned pair on all k; `wide`, a k = 128 case, adds the aligned
    pair's device ms there): ms a call, device ms, plain ms and the bound
    of each."""
    steps, cols = flag['steps'], flag['cdf_lane'].shape[1]
    lanes = flag['vc'].shape[-1]
    cdf_lane, len_lane, off_lane = (flag['cdf_lane'], flag['len_lane'],
                                    flag['off_lane'])
    vc1 = flag['vc'][:1].contiguous()
    enc1 = [t[:1].contiguous() for t in flag['enc']]
    enca = flag['enca']
    k8 = WIRE_BATCH
    search = int(len_lane.sum())          # CDF entries scanned per row
    table_bytes = 4 * lanes * cols + 8 * lanes

    def enc_cost(k):
        nbytes = 4 * k * steps * lanes + 4 * lanes * cols \
            + 4 * k * lanes * steps + 4 * k * lanes + 8 * k * lanes
        return bound(nbytes, ENCODE_OPS_PER_SYMBOL * k * steps * lanes)

    def dec_cost(k, width):
        nbytes = 4 * k * lanes * width + 8 * k * lanes + table_bytes \
            + 4 * k * steps * lanes + 8 * k * lanes
        ops = k * steps * (2 * search + DECODE_OPS_PER_SYMBOL * lanes)
        return bound(nbytes, ops)

    specs = {
        'rans_cyclic_encode': (
            lambda: kernels.cyclic_encode(cdf_lane, vc1),
            lambda: td.cyclic_encode_plain(cdf_lane, vc1), enc_cost(1)),
        'rans_cyclic_decode': (
            lambda: kernels.cyclic_decode(enc1[0], enc1[2], cdf_lane,
                                          len_lane, off_lane, steps),
            lambda: td.cyclic_decode_plain(enc1[0], enc1[2], cdf_lane,
                                           len_lane, off_lane, steps),
            dec_cost(1, steps)),
        'rans_cyclic_encode_aligned': (
            lambda: kernels.cyclic_encode_aligned(cdf_lane, flag['vc']),
            lambda: td.cyclic_encode_plain(cdf_lane, flag['vc'],
                                           aligned=True), enc_cost(k8)),
        'rans_cyclic_decode_aligned': (
            lambda: kernels.cyclic_decode_aligned(
                enca[0], enca[2], cdf_lane, len_lane, off_lane, steps),
            lambda: td.cyclic_decode_plain(
                enca[0], enca[2], cdf_lane, len_lane, off_lane, steps,
                aligned=True), dec_cost(k8, steps)),
    }
    # ms: one call on an idle card, host dispatch included; device_ms:
    # the card's time per launch, launches queued back to back
    k128 = {}
    if wide is not None:
        enca128 = wide['enca']
        k128 = {
            'rans_cyclic_encode_aligned': (
                lambda: kernels.cyclic_encode_aligned(cdf_lane, wide['vc']),
                enc_cost(128)),
            'rans_cyclic_decode_aligned': (
                lambda: kernels.cyclic_decode_aligned(
                    enca128[0], enca128[2], cdf_lane, len_lane, off_lane,
                    steps), dec_cost(128, steps)),
        }
    stats = {}
    for name, (kern, plain, (bound_ms, bound_by)) in specs.items():
        ms = per_call_ms(torch, kern, reps=50)
        dev_ms = device_ms(torch, kern, reps=200)
        plain_ms = per_call_ms(torch, plain, reps=5)
        stats[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           max_abs_err=flag['errs'].get(name, 0))
        log(f'{tag}: {name} ({lanes} lanes x {steps} steps, {cols} columns'
            f'): kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the card),'
            f' plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms '
            f'({bound_by})')
        if name in k128:
            kern, (bound128, _) = k128[name]
            stats[name].update(device_ms_k128=device_ms(torch, kern, 200),
                               bound_ms_k128=bound128)
    return stats


# ---- the general per-index kernels (phase 2) -------------------------------

def gaussian_symbols(tables, n, rng, tails=False):
    """(rows, symbols) of n positions over all rows of the Gaussian
    tables (row 0 and the last among them), symbols drawn from each row's
    distribution; with `tails`, every fifth symbol uniform over its row's
    support, which codes many frequency-1 tail symbols."""
    cdf, cdf_len, off = tables.quantized_cdf, tables.cdf_length, tables.offset
    idx = rng.integers(0, cdf.shape[0], n).astype(np.int32)
    idx[:2] = (0, cdf.shape[0] - 1)
    u = rng.integers(0, 1 << 16, n)
    vals = np.empty(n, np.int64)
    for r in np.unique(idx):
        m = idx == r
        vals[m] = np.clip(np.searchsorted(cdf[r][:cdf_len[r]], u[m],
                                          side='right') - 1, 0,
                          cdf_len[r] - 3)
    if tails:
        pick = np.arange(n) % 5 == 0
        vals[pick] = rng.integers(0, cdf_len[idx[pick]] - 2)
    return idx, (vals + off[idx]).astype(np.int32)


def indexed_inputs(torch, td, tables, lanes, n, k, rng, device,
                   tails=False):
    """Blocks (vc, idx3) of k images of n general-path symbols on `lanes`
    lanes, with the tables on the card and the host rows and symbols."""
    draws = [gaussian_symbols(tables, n, rng, tails=tails and i % 2 == 1)
             for i in range(k)]
    idx = np.stack([d[0] for d in draws])
    rows = np.stack([d[1] for d in draws])
    cdf, cdf_len, off = (torch.from_numpy(a).to(device) for a in (
        tables.quantized_cdf, tables.cdf_length, tables.offset))
    sym3, idx3 = td._index_blocks(torch.from_numpy(rows).to(device),
                                  torch.from_numpy(idx).to(device), lanes,
                                  off[0])
    return dict(vc=(sym3 - off[idx3]).contiguous(), idx3=idx3.contiguous(),
                cdf=cdf, cdf_len=cdf_len, off=off, idx=idx, rows=rows,
                steps=sym3.shape[1])


def indexed_case(torch, td, kernels, tables, lanes, n, k, rng, device,
                 prepared, tails=False):
    """Phase 2 checks of the four indexed kernels for one (lanes, n, k)
    case: bit-equal to the plain versions (a corrupted state included),
    packed bytes equal to the numpy oracle with per-index rows and equal
    between the layouts, the symbols back with valid=True, valid=False on
    the corrupted stream, the aligned encoder with masks on and off. All
    four read `prepared`, the tables' `prepare_indexed_tables`; `plans`
    records the plan each took."""
    inp = indexed_inputs(torch, td, tables, lanes, n, k, rng, device, tails)
    vc, idx3, steps = inp['vc'], inp['idx3'], inp['steps']
    cdf, cdf_len, off = inp['cdf'], inp['cdf_len'], inp['off']
    tag = f'indexed lanes={lanes} n={n} k={k} T={steps}'
    errs = {}
    plans = {name: kernels.indexed_plan(name, steps, prepared.dec.numel(),
                                        device) for name in PLANNED}

    def compare(name, got, ref):
        for a, b in zip(got, ref):
            if a is None and b is None:
                continue
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
            err = int(diff.max()) if diff.numel() else 0
            errs[name] = max(errs.get(name, 0), err)
            check(err == 0 and a.shape == b.shape and a.dtype == b.dtype,
                  f'{name} differs from its plain version ({tag})')

    enc = kernels.indexed_encode(cdf, vc, idx3, prepared=prepared)
    compare('rans_indexed_encode', enc, td.indexed_encode_plain(cdf, vc,
                                                                idx3))
    enca = kernels.indexed_encode_aligned(cdf, vc, idx3, want_masks=True,
                                          prepared=prepared)
    compare('rans_indexed_encode_aligned', enca, td.indexed_encode_plain(
        cdf, vc, idx3, aligned=True, want_masks=True))
    compare('rans_indexed_encode_aligned', kernels.indexed_encode_aligned(
        cdf, vc, idx3, prepared=prepared), enca[:3] + (None,))
    for r in range(k):
        wire = td.pack_stream({'streams': enc[0][r], 'lengths': enc[1][r],
                               'states': enc[2][r]})
        check(wire == td.pack_stream_aligned(
            {'streams': enca[0][r], 'lengths': enca[1][r],
             'states': enca[2][r], 'masks': enca[3][r]}),
              f'compacted and aligned wires differ ({tag})')
        check(wire == indexed_oracle_wire(td, inp['rows'][r], inp['idx'][r],
                                          tables, lanes),
              f'packed bytes differ from the numpy oracle ({tag})')
    for name, (streams, _, states, *_), aligned in (
            ('rans_indexed_decode', enc, False),
            ('rans_indexed_decode_aligned', enca, True)):
        fn = functools.partial(kernels.indexed_decode_aligned if aligned
                               else kernels.indexed_decode,
                               prepared=prepared)
        bad = states.clone()
        bad[k - 1, lanes // 3] ^= 0x5A5A
        outs = []
        for st in (states, bad):
            got = fn(streams, st, cdf, cdf_len, off, idx3, steps)
            compare(name, got, td.indexed_decode_plain(
                streams, st, cdf, cdf_len, off, idx3, steps,
                aligned=aligned))
            outs.append(got)
        (out, xend), (_, xbad) = outs
        check(np.array_equal(out.reshape(k, -1)[:, :n].cpu().numpy(),
                             inp['rows']), f'{name} lost symbols ({tag})')
        check(bool((xend == td.RANS_L).all()),
              f'{name}: valid=False on a good stream ({tag})')
        check(not bool((xbad[k - 1] == td.RANS_L).all()),
              f'{name}: valid=True on a corrupted stream ({tag})')
    torch.cuda.synchronize()
    return dict(inp, enc=enc, enca=enca, errs=errs, plans=plans,
                prepared=prepared, tag=tag)


def aligned_k128(torch, td, kernels, tables, lanes, n, rng, device,
                 prepared):
    """Phase 2: the aligned indexed pair at k = 128 (the throughput mode's
    wire_batch) on `prepared`: the encoder with masks on and off and the
    decoder on its streams, each bit-equal to its plain version, the
    symbols back valid; returns {name: (max error, device ms (the encoder
    with masks off, as the MSHP path), bound ms)}
    and the encoder's (tile, images a block) and the decoder's images a
    block."""
    k = 128
    inp = indexed_inputs(torch, td, tables, lanes, n, k, rng, device,
                         tails=True)
    vc, idx3, steps = inp['vc'], inp['idx3'], inp['steps']
    cdf, cdf_len, off = inp['cdf'], inp['cdf_len'], inp['off']

    def encode(masks=True):
        return kernels.indexed_encode_aligned(cdf, vc, idx3, masks,
                                              prepared=prepared)

    def decode():
        return kernels.indexed_decode_aligned(
            enca[0], enca[2], cdf, cdf_len, off, idx3, steps,
            prepared=prepared)

    enca = encode()
    want = td.indexed_encode_plain(cdf, vc, idx3, aligned=True,
                                   want_masks=True)
    errs = {'rans_indexed_encode_aligned': max(
        [int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
         for a, b in zip(enca, want)]
        + [int((a - b).abs().max()) for a, b in zip(encode(False)[:3],
                                                     want[:3])])}
    out, xend = decode()
    pout, pxend = td.indexed_decode_plain(enca[0], enca[2], cdf, cdf_len,
                                          off, idx3, steps, aligned=True)
    errs['rans_indexed_decode_aligned'] = max(
        int((out - pout).abs().max()), int((xend - pxend).abs().max()))
    check(bool((xend == td.RANS_L).all()) and np.array_equal(
        out.reshape(k, -1)[:, :n].cpu().numpy(), inp['rows']),
        f'aligned indexed pair at k={k}: symbols lost or invalid')
    for name, e in errs.items():
        check(e == 0, f'{name} differs from its plain version at k={k} by '
              f'{e}')
    out = {}
    for name, fn, dec in (('rans_indexed_encode_aligned',
                           lambda: encode(False), False),
                          ('rans_indexed_decode_aligned', decode, True)):
        out[name] = (errs[name], device_ms(torch, fn, reps=50),
                     indexed_costs(inp, tables, k, enca[1], dec)[0])
    plans = (kernels.indexed_encode_aligned_plan(k, lanes, device),
             kernels.indexed_aligned_group(k, lanes, prepared.dec.numel(),
                                           device))
    return out, plans


def indexed_oracle_wire(td, sym, idx, tables, lanes):
    """Packed wire bytes of the general layout from the numpy oracle."""
    streams, states = td.numpy_oracle_encode(
        sym, idx, tables.quantized_cdf, tables.cdf_length, tables.offset,
        num_lanes=lanes)
    lengths = np.asarray([len(s) for s in streams], np.uint16)
    body = [np.asarray([lanes, 0], np.uint16).tobytes(), lengths.tobytes(),
            states.astype(np.uint32).tobytes()]
    body += [np.asarray(s, np.uint16).tobytes() for s in streams]
    return b''.join(body)


def indexed_costs(inp, tables, k, lengths, decode):
    """(bound ms, bound_by) of one indexed launch on `inp`'s first k
    images, each input read once and each output written once. Both read
    the symbol rows (int32), the table entries this data codes
    (cdf[row, v] and cdf[row, v + 1]) and the int64 states in or out. The
    encoder reads the int32 symbols and writes the whole (k, lanes, steps)
    int32 stream array (the compacted one zeroes its tail) and the int32
    lengths. The decoder reads the chunks the streams hold (`lengths`, the
    encoder's per-lane counts) and each used row's length and offset, and
    writes the int32 symbols and the final states. Integer operations per
    symbol as counted from the kernels' code, the decoder's bisection by
    the probes each symbol's row needs."""
    cols = tables.quantized_cdf.shape[1]
    vc = inp['vc'][:k].cpu().numpy().astype(np.int64)
    rows = inp['idx3'][:k].cpu().numpy().astype(np.int64)
    pos = rows * cols + vc
    entries = np.unique(np.concatenate([pos.ravel(), pos.ravel() + 1])).size
    sym = vc.size
    lanes = vc.shape[-1]
    nbytes = 4 * entries + 4 * sym + 4 * sym + 8 * k * lanes
    if decode:
        probes = np.ceil(np.log2(np.maximum(
            tables.cdf_length[rows] - 1, 2))).sum()
        nbytes += 4 * int(lengths[:k].sum()) + 8 * np.unique(rows).size
        ops = 4 * probes + DECODE_OPS_PER_SYMBOL * sym
    else:
        nbytes += 4 * sym + 4 * k * lanes
        ops = ENCODE_OPS_PER_SYMBOL * sym
    return bound(nbytes, ops)


def prepare_tables(torch, tables, device, reps=5):
    """(prepared tables of the batch-1 indexed pair for `tables`, on the
    card; the median ms of building them, their one-time cost)."""
    from sc2bench_tpu_torch.ops.rans.indexed_tables import \
        prepare_indexed_tables
    cdf, cdf_len, off = (torch.from_numpy(a).to(device) for a in (
        tables.quantized_cdf, tables.cdf_length, tables.offset))
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepared = prepare_indexed_tables(cdf, cdf_len, off)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return prepared, statistics.median(times[1:] or times)


# the indexed kernels with two plans, and the images a block of the aligned
# decoder at the MSHP y's wire_batch sizes
PLANNED = ('rans_indexed_encode', 'rans_indexed_decode',
           'rans_indexed_decode_aligned')
ALIGNED_KS = (1, WIRE_BATCH, 128)


def log_plans(cases, tag='phase 2'):
    log(f'{tag}: indexed plans (batch-1 encoder rows / batch-1 decoder '
        'tables / aligned decoder tables): '
        + '; '.join(f'{c["tag"]}: ' + ' / '.join(c['plans'][name]
                                                 for name in PLANNED)
                    for c in cases))


def indexed_phase(torch, td, kernels, tables, device):
    """Phase 2 (general path): the four indexed kernels against their
    plain versions at the MSHP y shape (55x55x24 on 512 lanes x 142 steps,
    the default Gaussian tables) at k = 1 and 8, and on edge cases (the
    long latent's encoder on its device-row plan; a custom scale table
    too large for shared memory, the decoder on its global-table plan);
    the one-time cost of preparing the tables; timings at the main path's
    shapes (batch 1 compacted, WIRE_BATCH aligned)."""
    from sc2bench_tpu_torch.ops.entropy.gaussian import get_scale_table
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    rng = np.random.default_rng(4321)
    n = 55 * 55 * 24
    lanes = td.auto_lanes(n)
    prepared, prep_ms = prepare_tables(torch, tables, device)
    wide = build_gaussian_tables(get_scale_table(0.11, 1024.0, 64))
    wide_prepared, wide_ms = prepare_tables(torch, wide, device)
    flag = indexed_case(torch, td, kernels, tables, lanes, n, WIRE_BATCH,
                        rng, device, prepared)
    one = indexed_case(torch, td, kernels, tables, lanes, n, 1, rng, device,
                       prepared)
    edge = [indexed_case(torch, td, kernels, tables, 100, 2345, 3, rng,
                         device, prepared, tails=True),
            indexed_case(torch, td, kernels, tables, 40, 40 * 4000 - 7, 2,
                         rng, device, prepared, tails=True),
            indexed_case(torch, td, kernels, wide, lanes, n, 1, rng,
                         device, wide_prepared, tails=True)]
    log(f'phase 2: indexed kernels equal their plain versions (lanes='
        f'{lanes}, steps={flag["steps"]}, Gaussian tables '
        f'{tables.quantized_cdf.shape}, k=1 and {WIRE_BATCH}; edge cases: '
        '100 lanes n=2345 k=3 and 40 lanes T=4000 k=2, rows 0 and 63, '
        'frequency-1 tail symbols; scale table 0.11..1024, Gaussian tables '
        f'{wide.quantized_cdf.shape}); packed bytes equal the numpy oracle')
    cases = [flag, one] + edge
    log_plans(cases)
    for names in (PLANNED[:2], PLANNED[2:]):
        got = {c['plans'][name] for c in cases for name in names}
        check(got == {'shared', 'global'}, f'phase 2: {" and ".join(names)} '
              f'plans exercised: {sorted(got)}, expected shared and global')
    groups = {k: kernels.indexed_aligned_group(k, lanes, prepared.dec.numel(),
                                               device) for k in ALIGNED_KS}
    log(f'phase 2: rans_indexed_decode_aligned at {lanes} lanes x '
        f'{flag["steps"]} steps, plan {flag["plans"][PLANNED[2]]}: images a '
        'block ' + ', '.join(f'k={k}: {g}' for k, g in groups.items())
        + f'; custom scale table: plan {edge[2]["plans"][PLANNED[2]]}, k=8: '
        + str(kernels.indexed_aligned_group(
            WIRE_BATCH, lanes, wide_prepared.dec.numel(), device)))
    log(f'phase 2: preparing the batch-1 indexed tables (one time, on the '
        f'card): {prep_ms:.3f} ms for {tables.quantized_cdf.shape} '
        f'(decoder pack {4 * prepared.dec.numel()} bytes, encoder entries '
        f'{4 * prepared.enc.numel()} bytes), {wide_ms:.3f} ms for '
        f'{wide.quantized_cdf.shape} ({4 * wide_prepared.dec.numel()} / '
        f'{4 * wide_prepared.enc.numel()} bytes)')
    k128, (genc, gdec) = aligned_k128(torch, td, kernels, tables, lanes, n,
                                      rng, device, prepared)
    stats = indexed_stats(torch, td, kernels, tables, flag, one)
    for name, st in stats.items():
        st['max_abs_err'] = max(case['errs'].get(name, 0) for case in cases)
    for name, (err, dev_ms, bound_ms) in k128.items():
        stats[name].update(max_abs_err=max(stats[name]['max_abs_err'], err),
                           device_ms_k128=dev_ms, bound_ms_k128=bound_ms)
    log(f'phase 2: aligned indexed pair at k=128 on {lanes} lanes x '
        f'{flag["steps"]} steps (masks on and off, frequency-1 tails) equal '
        'their plain versions: ' + ', '.join(
            f'{name} {dev_ms:.4f} ms on the card (bound {bound_ms:.6f})'
            for name, (_, dev_ms, bound_ms) in k128.items())
        + f'; encoder tile {genc[0]} steps, images a block {genc[1]} / '
        f'{gdec}')
    for name in ('rans_indexed_encode', 'rans_indexed_decode'):
        stats[name]['prepare_ms'] = prep_ms
    return stats


def indexed_stats(torch, td, kernels, tables, flag, one, tag='phase 2'):
    """Timings of the four indexed kernels: the batch-1 pair on `one` (an
    `indexed_case` at k = 1), the aligned pair on `flag` (k =
    WIRE_BATCH): ms a call, device ms, plain ms and the bound of each."""
    steps = flag['steps']
    lanes = flag['vc'].shape[-1]
    cdf, cdf_len, off = flag['cdf'], flag['cdf_len'], flag['off']
    vc1, idx1, prep = one['vc'], one['idx3'], one['prepared']
    enc1, enca = one['enc'], flag['enca']
    specs = {
        'rans_indexed_encode': (
            lambda: kernels.indexed_encode(cdf, vc1, idx1, prepared=prep),
            lambda: td.indexed_encode_plain(cdf, vc1, idx1),
            indexed_costs(one, tables, 1, enc1[1], False)),
        'rans_indexed_decode': (
            lambda: kernels.indexed_decode(enc1[0], enc1[2], cdf, cdf_len,
                                           off, idx1, steps, prepared=prep),
            lambda: td.indexed_decode_plain(enc1[0], enc1[2], cdf, cdf_len,
                                            off, idx1, steps),
            indexed_costs(one, tables, 1, enc1[1], True)),
        'rans_indexed_encode_aligned': (
            lambda: kernels.indexed_encode_aligned(cdf, flag['vc'],
                                                   flag['idx3'],
                                                   prepared=prep),
            lambda: td.indexed_encode_plain(cdf, flag['vc'], flag['idx3'],
                                            aligned=True),
            indexed_costs(flag, tables, WIRE_BATCH, enca[1], False)),
        'rans_indexed_decode_aligned': (
            lambda: kernels.indexed_decode_aligned(
                enca[0], enca[2], cdf, cdf_len, off, flag['idx3'], steps,
                prepared=flag['prepared']),
            lambda: td.indexed_decode_plain(
                enca[0], enca[2], cdf, cdf_len, off, flag['idx3'], steps,
                aligned=True),
            indexed_costs(flag, tables, WIRE_BATCH, enca[1], True)),
    }
    stats = {}
    for name, (kern, plain, (bound_ms, bound_by)) in specs.items():
        ms = per_call_ms(torch, kern, reps=30)
        dev_ms = device_ms(torch, kern, reps=100)
        plain_ms = per_call_ms(torch, plain, reps=3)
        stats[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           max_abs_err=max(c['errs'].get(name, 0)
                                           for c in (flag, one)))
        log(f'{tag}: {name} ({lanes} lanes x {steps} steps): kernel '
            f'{ms:.4f} ms per call ({dev_ms:.4f} ms on the card), plain '
            f'{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by})')
    stats['rans_indexed_decode_aligned']['images_per_block'] = \
        kernels.indexed_aligned_group(WIRE_BATCH, lanes,
                                      flag['prepared'].dec.numel(),
                                      cdf.device)
    tile, group = kernels.indexed_encode_aligned_plan(WIRE_BATCH, lanes,
                                                      cdf.device)
    stats['rans_indexed_encode_aligned'].update(images_per_block=group,
                                                tile_steps=tile)
    return stats


def main_path(torch, kernels, rt, rt_u8, images, images_u8):
    """Phases 3 and 4: the deploy loop, batch 1 then wire_batch."""
    from sc2bench_tpu_torch.analysis import get_binary_object_size
    from sc2bench_tpu_torch.ops.rans.device import (device_rans_encode,
                                                    pack_stream)
    classes = rt.module.fc.out_features
    # warm both paths (cuDNN set-up) outside the counted windows
    rt.stream_deploy_device(images[:2])
    rt.stream_deploy_device(images[:WIRE_BATCH], wire_batch=WIRE_BATCH)
    rt_u8.stream_deploy_device(images_u8[:1])

    # ---- phase 3: batch 1 ----
    for r in (rt, rt_u8):
        r.clear_analysis()
        r.activate_analysis()
        r.escapes = {'ok': 0, 'valid': 0}
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits1 = rt.stream_deploy_device(images)
    dt1 = time.perf_counter() - t0
    logits_u8 = rt_u8.stream_deploy_device(images_u8)
    counts1 = dict(kernels.LAUNCHES)
    n_img = len(images) + len(images_u8)
    check(counts1['rans_cyclic_encode'] == n_img
          and counts1['rans_cyclic_decode'] == n_img,
          f'batch-1 path launched {counts1}, expected {n_img} each')
    check(counts1['rans_cyclic_encode_aligned'] == 0
          and counts1['rans_cyclic_decode_aligned'] == 0
          and all(counts1[k] == 0 for k in kernels.INDEXED_KERNELS),
          f'batch-1 path launched aligned or indexed kernels: {counts1}')
    for r in (rt, rt_u8):
        check(r.escapes == {'ok': 0, 'valid': 0},
              f'batch-1 path sent images to the host coder: {r.escapes}')
    sizes1 = list(rt.analyzers[0].file_size_list)
    summary1 = rt.summarize()[0]
    summary_u8 = rt_u8.summarize()[0]
    for lg in logits1 + logits_u8:
        check(tuple(lg.shape) == (1, classes) and bool(torch.isfinite(lg).all()),
              f'bad logits {tuple(lg.shape)}')
    check(len(sizes1) == len(images) and all(s > 0 for s in sizes1),
          f'accounted sizes {sizes1}')
    log(f'phase 3: batch 1, {len(images)} float images: '
        f'{len(images) / dt1:.2f} img/s; data size {summary1}')
    log(f'phase 3: {len(images_u8)} uint8 images via input_norm: '
        f'data size {summary_u8}')

    # reference: the same symbols through the plain coder on the CPU give
    # the kernels' wire bytes, and the decoder+tail on those symbols (no
    # rANS) give the served logits
    cdf, cdf_len, off = (rt.codec.tables.quantized_cdf,
                         rt.codec.tables.cdf_length, rt.codec.tables.offset)
    for i in (0, len(images) - 1):
        flat, shape = rt._symbols_nhwc(images[i])
        lanes = rt._auto_wire_lanes(shape)
        ref = device_rans_encode(flat.reshape(-1).cpu(), cdf, cdf_len, off,
                                 num_lanes=lanes, cyclic_channels=shape[-1])
        wire = rt._pull_device_wire(rt.encode_device_wire(images[i]))
        check(wire == pack_stream(ref), f'image {i}: wire differs from the '
              'plain coder on the same symbols')
        check(sizes1[i] == get_binary_object_size(
            {'strings': [[wire]], 'shape': shape[:2]}),
              f'image {i}: accounted size differs from the packed wire')
        with torch.no_grad():
            direct = rt._decode_tail(flat, shape)
        check(torch.allclose(direct, logits1[i], rtol=1e-5, atol=1e-5),
              f'image {i}: served logits differ from the decoder on the '
              'encoder symbols')
    # uint8 path: equal wire to the same normalization done in float
    mean = torch.tensor(NORM[0], device=rt.device)[:, None, None]
    std = torch.tensor(NORM[1], device=rt.device)[:, None, None]
    as_float = (images_u8[0].float() / 255.0 - mean) / std
    check(rt_u8._pull_device_wire(rt_u8.encode_device_wire(images_u8[0]))
          == rt._pull_device_wire(rt.encode_device_wire(as_float)),
          'uint8 input_norm wire differs from the float path')
    log('phase 3: wire bytes equal the plain coder; logits equal the '
        'decoder on the encoder symbols; uint8 path equals float')

    # ---- phase 4: wire_batch ----
    rt.clear_analysis()
    rt.escapes = {'ok': 0, 'valid': 0}
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits_b = rt.stream_deploy_device(images, wire_batch=WIRE_BATCH)
    dt2 = time.perf_counter() - t0
    counts2 = dict(kernels.LAUNCHES)
    groups = -(-len(images) // WIRE_BATCH)
    check(counts2['rans_cyclic_encode_aligned'] == groups
          and counts2['rans_cyclic_decode_aligned'] == groups,
          f'wire_batch path launched {counts2}, expected {groups} each')
    check(counts2['rans_cyclic_encode'] == 0
          and counts2['rans_cyclic_decode'] == 0,
          f'wire_batch path launched batch-1 kernels: {counts2}')
    check(rt.escapes == {'ok': 0, 'valid': 0},
          f'wire_batch path sent images to the host coder: {rt.escapes}')
    sizes2 = list(rt.analyzers[0].file_size_list)
    summary2 = rt.summarize()[0]
    check(sizes2 == sizes1, 'wire_batch per-image sizes differ from batch 1')
    check(summary2 == summary1, f'wire_batch summary {summary2} != '
          f'batch-1 summary {summary1}')
    worst = 0.0
    for a, b in zip(logits1, logits_b):
        check(tuple(b.shape) == (1, classes), f'bad logits {tuple(b.shape)}')
        check(torch.allclose(b, a, rtol=LOGIT_TOL, atol=LOGIT_TOL),
              'wire_batch logits differ from batch 1')
        worst = max(worst, float((b - a).abs().max()))
    log(f'phase 4: wire_batch={WIRE_BATCH}: {len(images) / dt2:.2f} img/s; '
        f'sizes and summary equal batch 1; max |logit diff| {worst:.3e}')
    return {**{k: counts1[k] for k in ('rans_cyclic_encode',
                                       'rans_cyclic_decode')},
            **{k: counts2[k] for k in ('rans_cyclic_encode_aligned',
                                       'rans_cyclic_decode_aligned')}}


def deploy(rt, images, wire_batch):
    """(per-image accounted sizes, logits, escapes) of one
    `stream_deploy_device`."""
    rt.clear_analysis()
    rt.activate_analysis()
    rt.escapes = {'ok': 0, 'valid': 0}
    logits = rt.stream_deploy_device(images, wire_batch=wire_batch)
    return list(rt.analyzers[0].file_size_list), logits, dict(rt.escapes)


def escape_phase(torch, rt, images):
    """Phase 5: an image whose latent leaves the CDF support (a normal
    image scaled up) among normal images is re-coded on the host coder."""
    from sc2bench_tpu_torch.analysis import get_binary_object_size
    classes = rt.module.fc.out_features
    x_esc = None
    for scale in (30.0, 100.0, 1000.0):
        if not bool(rt.encode_device_wire(images[-1] * scale)['ok']):
            x_esc = images[-1] * scale
            break
    check(x_esc is not None, 'no scaled image left the CDF support')
    compressed = rt.encode(x_esc)
    want_size = get_binary_object_size(compressed)
    want_logits = rt.decode(**compressed)
    normal, pos = images[:WIRE_BATCH - 1], 3
    stream = normal[:pos] + [x_esc] + normal[pos:]
    for wire_batch in (None, WIRE_BATCH):
        tag = f'wire_batch={wire_batch}' if wire_batch else 'batch 1'
        clean_sizes, _, clean_esc = deploy(rt, normal, wire_batch)
        sizes, logits, esc = deploy(rt, stream, wire_batch)
        check(clean_esc == {'ok': 0, 'valid': 0},
              f'{tag}: normal images escaped: {clean_esc}')
        check(esc == {'ok': 1, 'valid': 0},
              f'{tag}: escapes {esc}, expected one ok=False and no '
              'valid=False')
        check(len(logits) == len(stream), f'{tag}: {len(logits)} results')
        for lg in logits:
            check(tuple(lg.shape) == (1, classes)
                  and bool(torch.isfinite(lg).all()),
                  f'{tag}: bad logits {tuple(lg.shape)}')
        check(sizes[pos] == want_size, f'{tag}: escape image accounted '
              f'{sizes[pos]}, rt.encode(x) gives {want_size}')
        check(torch.allclose(logits[pos], want_logits, rtol=1e-5, atol=1e-5),
              f'{tag}: escape logits differ from rt.decode(**rt.encode(x))')
        check(sizes[:pos] + sizes[pos + 1:] == clean_sizes,
              f'{tag}: the other images\' sizes changed')
    log(f'phase 5: escape image (scale {scale:g}) re-coded on the host '
        f'coder at batch 1 and wire_batch={WIRE_BATCH}: size {want_size} '
        f'KB equals rt.encode(x), logits equal rt.decode, other sizes '
        'unchanged, one ok=False escape and no valid=False one')


def cli_phase(torch, kernels, model, config=FLAGSHIP_CONFIG,
              per_image=FP_BATCH1, tag='phase 6', n=N_CLI):
    """Phase 6: the test CLI on the flagship config (or `config`), host
    wire then device wire, `n` images. Returns the device-wire run's
    launch counts."""
    import tempfile
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    from sc2bench_tpu_torch.tasks.image_classification import main as cli
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    loader = synthetic_split(n, 1, seed=0)
    # the served logits, caught where the engine's stream returns them
    served = []
    originals = {name: getattr(SplitClassifierRuntime, name)
                 for name in ('stream_deploy', 'stream_deploy_device')}

    def catching(fn):
        def stream(self, images, *args, **kwargs):
            out = fn(self, images, *args, **kwargs)
            served.extend(out)
            return out
        return stream

    runs = {}
    try:
        for name, fn in originals.items():
            setattr(SplitClassifierRuntime, name, catching(fn))
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, 'student.ckpt')
            save_ckpt(ckpt, model.state_dict())
            over = {'allow_missing_teacher': True,
                    'models': {'student_model': {'ckpt': ckpt}},
                    'test': {'test_data_loader': loader}}
            for wire in ('host', 'device'):
                served.clear()
                args = ['--config', os.path.join(REPO, config),
                        '--json', json.dumps({**over, 'deploy_wire': wire}),
                        '-test_only']
                if wire == 'device':
                    args.append('-student_only')
                kernels.reset_launches()
                t0 = time.perf_counter()
                out = cli(args)
                wall = time.perf_counter() - t0
                runs[wire] = dict(out, wall=wall,
                                  launches=dict(kernels.LAUNCHES),
                                  logits=torch.cat(served))
    finally:
        for name, fn in originals.items():
            setattr(SplitClassifierRuntime, name, fn)

    host, dev = runs['host'], runs['device']
    rt = dev['engine'].runtime
    check(all(v == 0 for v in host['launches'].values()),
          f'the host wire launched kernels: {host["launches"]}')
    want = expected_launches(kernels, per_image, n)
    check(dev['launches'] == want, f'the device wire launched '
          f'{dev["launches"]}, expected {want}')
    check(rt.escapes == {'ok': 0, 'valid': 0},
          f'device-wire images escaped: {rt.escapes}')
    for wire, run in runs.items():
        lg = run['logits']
        check(tuple(lg.shape) == (n, 1000)
              and bool(torch.isfinite(lg).all()),
              f'{wire} wire: bad logits {tuple(lg.shape)}')
        check(run['summaries'][0]['num_samples'] == n,
              f'{wire} wire: summary {run["summaries"]}')
    check(host['result']['acc1'] == dev['result']['acc1']
          and host['result']['acc5'] == dev['result']['acc5'],
          f'wires differ: host {host["result"]}, device {dev["result"]}')
    worst = float((host['logits'] - dev['logits']).abs().max())
    check(worst <= LOGIT_TOL, f'wires\' logits differ by {worst:.3e}')
    sizes = list(rt.analyzers[0].file_size_list)
    images = synthetic_images(torch, n, rt.device)
    rt.clear_analysis()
    rt.stream_deploy_device(images)
    check(list(rt.analyzers[0].file_size_list) == sizes,
          'CLI device-wire sizes differ from a direct stream_deploy_device')
    # the host wire's breakdown, on the host-wire engine's runtime
    hrt = host['engine'].runtime
    sizes = list(hrt.analyzers[0].file_size_list)
    hrt.clear_analysis()
    timings = {}
    t0 = time.perf_counter()
    hrt.stream_deploy(images, timings=timings)
    wall = time.perf_counter() - t0
    check(list(hrt.analyzers[0].file_size_list) == sizes,
          'CLI host-wire sizes differ from a direct stream_deploy')
    log(f'{tag}: host wire, direct stream_deploy of the {n} images: '
        f'{n / wall:.2f} img/s; per image, ms: ' + ', '.join(
            f'{k} {1e3 * v / n:.3f}' for k, v in sorted(timings.items())))
    for wire, run in runs.items():
        res, summary = run['result'], run['summaries'][0]
        log(f'{tag}: {wire} wire, {n} images of 224x224 through the '
            f'CLI: acc1 {res["acc1"]}, acc5 {res["acc5"]}, data size '
            f'{summary}, model_time {res["model_time"]:.6f} s per image '
            f'({1 / res["model_time"]:.2f} img/s); CLI wall {run["wall"]:.2f}'
            ' s')
    log(f'{tag}: teacher (random weights) acc1 {host["teacher"]["acc1"]}, '
        f'acc5 {host["teacher"]["acc5"]}; device wire: escapes {rt.escapes}, '
        f'launches {dev["launches"]}, sizes equal a direct '
        f'stream_deploy_device; max |logit diff| between wires {worst:.3e}')
    return dev['launches']


def synthetic_split(n, batch, seed, hw=HW, **extra):
    """A loader config of `n` synthetic hw x hw images of 1000 classes."""
    return {'dataset': {'key': 'SyntheticClassificationDataset',
                        'kwargs': {'num_samples': n, 'image_size': [hw, hw],
                                   'num_classes': 1000, 'seed': seed}},
            'batch_size': batch, **extra}


def synthetic_images(torch, n, device, seed=0):
    """The images of `synthetic_split(n, 1, seed)`, NCHW on `device`."""
    from sc2bench_tpu_torch.datasets.image import \
        SyntheticClassificationDataset
    data = SyntheticClassificationDataset(num_samples=n, image_size=(HW, HW),
                                          seed=seed)
    return [torch.from_numpy(np.ascontiguousarray(
        data[i][0].transpose(2, 0, 1)[None])).to(device) for i in range(n)]


def snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def recording(torch, base, records):
    """`base` (a training box class) that records, per stage, the student's
    and teacher's state at its start, each step's loss detail and
    host-clock seconds (behind `torch.cuda.synchronize()`), and the peak
    device memory since the stage began."""

    class Recording(base):
        def __init__(self, student, stage_config, **kwargs):
            torch.cuda.synchronize()
            teacher = kwargs.get('teacher')
            self._record = {'name': stage_config.get('name'), 'steps': [],
                            'student': snapshot(student),
                            'teacher': None if teacher is None
                            else snapshot(teacher)}
            records.append(self._record)
            torch.cuda.reset_peak_memory_stats()
            super().__init__(student, stage_config, **kwargs)

        def train_step(self, x, y):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = super().train_step(x, y)
            torch.cuda.synchronize()
            self._record['steps'].append((
                {k: float(v) for k, v in metrics['loss'].items()},
                time.perf_counter() - t0, int(x.shape[0])))
            self._record['peak'] = torch.cuda.max_memory_allocated()
            return metrics

    return Recording


def train_cli(torch, kernels, config, over, n_test, wire='device',
              segmentation=False):
    """One train-then-test CLI run on `wire` (the segmentation CLI with
    `segmentation`); returns its output, the stage records, the launches
    of its test and the test images."""
    if segmentation:
        import sc2bench_tpu_torch.train.seg_engine as engine_module
        from sc2bench_tpu_torch.tasks.semantic_segmentation import \
            main as cli
    else:
        import sc2bench_tpu_torch.train.engine as engine_module
        from sc2bench_tpu_torch.tasks.image_classification import \
            main as cli
    records = []
    boxes = {name: getattr(engine_module, name)
             for name in ('DistillationBox', 'TrainingBox')}
    try:
        for name, cls in boxes.items():
            setattr(engine_module, name, recording(torch, cls, records))
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = cli(['--config', os.path.join(REPO, config), '--json',
                   json.dumps({**over, 'deploy_wire': wire}),
                   '-student_only'])
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        for name, cls in boxes.items():
            setattr(engine_module, name, cls)
    images = (seg_images if segmentation else synthetic_images)(
        torch, n_test, out['engine'].runtime.device)
    return dict(out, wall=wall, launches=launches, records=records,
                images=images)


def expected_launches(kernels, per_image, n):
    """Every kernel's expected count: n for those in `per_image`, else 0."""
    return {k: (n if k in per_image else 0) for k in kernels.ALL_KERNELS}


def check_test_of_training(torch, kernels, run, n_test, tag,
                           per_image=FP_BATCH1):
    """The trained model's device-wire test: one launch of each batch-1
    kernel of its path per image, no valid=False, sizes equal a direct
    `stream_deploy_device`. Escapes (ok=False) are counted, not failed."""
    engine = run['engine']
    rt = engine.runtime
    check(rt.bottleneck_updated, f'{tag}: tables not built after training')
    want = expected_launches(kernels, per_image, n_test)
    check(run['launches'] == want, f'{tag}: the test launched '
          f'{run["launches"]}, expected {want}')
    escapes = dict(rt.escapes)
    check(escapes['valid'] == 0, f'{tag}: valid=False decodes: {escapes}')
    check(run['summaries'][0]['num_samples'] == n_test,
          f'{tag}: summary {run["summaries"]}')
    sizes = list(rt.analyzers[0].file_size_list)
    rt.clear_analysis()
    logits = rt.stream_deploy_device(run['images'])
    check(list(rt.analyzers[0].file_size_list) == sizes,
          f'{tag}: CLI sizes differ from a direct stream_deploy_device')
    check(all(bool(torch.isfinite(lg).all()) for lg in logits),
          f'{tag}: non-finite logits')
    return escapes


def log_stages(run, tag, phase='phase 7', wire='device'):
    for rec in run['records']:
        steps = rec['steps']
        for i, (loss, _, _) in ((0, steps[0]), (len(steps) - 1, steps[-1])):
            check(all(np.isfinite(v) for v in loss.values()),
                  f'{tag} {rec["name"]} step {i}: loss {loss}')
        later = steps[1:]
        rate = sum(n for _, _, n in later) / sum(t for _, t, _ in later)
        log(f'{phase}: {tag} {rec["name"]}: {len(steps)} steps of '
            f'{steps[0][2]} images; loss detail, first step '
            f'{steps[0][0]}, last step {steps[-1][0]}; {rate:.2f} img/s '
            f'over steps 2-{len(steps)} (first step {steps[0][1]:.3f} s); '
            f'peak memory {rec["peak"] / 2 ** 30:.3f} GiB')
    res, summary = run['result'], run['summaries'][0]
    log(f'{phase}: {tag} test, {wire} wire: acc1 {res["acc1"]}, acc5 '
        f'{res["acc5"]}, data size {summary}, escapes {run["escapes"]}, '
        f'launches {run["launches"]}; CLI wall {run["wall"]:.2f} s')


def changed(before, after, keys):
    """The keys whose tensors differ between two state snapshots."""
    return [k for k in keys if not bool((before[k] == after[k]).all())]


def train_phase(torch, kernels, model):
    """Phase 7: the train-then-test CLI on the card: the flagship Entropic
    Student config (two stages) and an end-to-end config, each tested on
    the device wire. Returns the Entropic Student test's launch counts."""
    import tempfile
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    loaders = {'train_data_loader': synthetic_split(
        N_TRAIN, TRAIN_BATCH, seed=1000, shuffle=True, drop_last=True),
        'val_data_loader': synthetic_split(N_VAL, TRAIN_BATCH, seed=2000)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'student.ckpt')
        save_ckpt(ckpt, model.state_dict())
        es = train_cli(torch, kernels, FLAGSHIP_CONFIG, {
            'allow_missing_teacher': True,
            'models': {'student_model': {'ckpt': ckpt}},
            'train': {**loaders,
                      'stage1': {'num_epochs': 2, 'epoch_to_update': 2},
                      'stage2': {'num_epochs': 1}},
            'test': {'test_data_loader': synthetic_split(N_TRAIN_TEST, 1,
                                                         seed=0)}},
            N_TRAIN_TEST)
        e2e = train_cli(torch, kernels, END_TO_END_CONFIG, {
            'models': {'model': {'ckpt': ckpt}},
            'train': {**loaders, 'num_epochs': 1, 'epoch_to_update': 1},
            'test': {'test_data_loader': synthetic_split(N_E2E_TEST, 1,
                                                         seed=0)}},
            N_E2E_TEST)
    steps = N_TRAIN // TRAIN_BATCH
    for tag, run, want in (('entropic student', es,
                            [('stage1', 2 * steps), ('stage2', steps)]),
                           ('end-to-end', e2e, [('train', steps)])):
        got = [(r['name'], len(r['steps'])) for r in run['records']]
        check(got == want, f'{tag}: stages and steps {got}, expected {want}')
    # what each Entropic Student stage may change
    s0, s1 = es['records'][0]['student'], es['records'][1]['student']
    s2 = snapshot(es['engine'].student)
    teacher_moved = changed(es['records'][0]['teacher'],
                            snapshot(es['engine'].teacher),
                            es['records'][0]['teacher'])
    check(not teacher_moved, f'teacher changed: {teacher_moved[:3]}')
    buffers = {k for k, _ in es['engine'].student.named_buffers()}
    frozen1 = [k for k in s0 if k.split('.')[0] in ('layer2', 'layer3',
                                                   'layer4') or k in buffers]
    moved = changed(s0, s1, frozen1)
    check(not moved, f'stage 1 changed frozen layer2-4 or BN statistics: '
          f'{moved[:3]}')
    check(changed(s0, s1, [k for k in s0 if '.encoder.' in k]),
          'stage 1 left the encoder unchanged')
    density = [k for k in s1 if '.encoder.' in k or re.search(
        r'entropy_bottleneck\._(matrix|bias|factor)\d', k)]
    moved = changed(s1, s2, density)
    check(not moved, f'stage 2 changed the frozen encoder or density: '
          f'{moved[:3]}')
    check(changed(s1, s2, ['bottleneck_layer.entropy_bottleneck.quantiles']),
          'stage 2 left the quantiles unchanged')
    for tag, run, n in (('entropic student', es, N_TRAIN_TEST),
                        ('end-to-end', e2e, N_E2E_TEST)):
        run['escapes'] = check_test_of_training(torch, kernels, run, n, tag)
        log_stages(run, tag)
    log('phase 7: teacher unchanged; stage 1 left layer2-4 and every BN '
        'statistic as they were and moved the encoder; stage 2 left the '
        'encoder and the density as they were and moved the quantiles; '
        'test sizes equal a direct stream_deploy_device')
    step_on_card_and_cpu(torch, model)
    return es['launches'], e2e['launches']


def step_on_card_and_cpu(torch, model, devices=('cuda', 'cpu')):
    """One flagship stage-1 step at batch 2 on the card and on the CPU from
    the same state, batch and noise: loss detail within rtol 1e-3,
    gradients within rtol 1e-3 (atol 1e-3 max|g| of each tensor), updated
    parameters within rtol 1e-3 (atol 1e-2 lr) where |g| > 0.1 max|g|:
    Adam's first step, lr * g / (|g| + eps), turns a small gradient's
    float error into a difference of up to 2 lr."""
    import copy
    import sc2bench_tpu_torch.ops.entropy.factorized as factorized
    from sc2bench_tpu_torch.config import load_config
    from sc2bench_tpu_torch.models.registry import load_classification_model
    from sc2bench_tpu_torch.train.box import DistillationBox
    cfg = load_config(os.path.join(REPO, FLAGSHIP_CONFIG))
    torch.manual_seed(7)
    teacher = load_classification_model(cfg['models']['teacher_model'],
                                        device='cpu')
    student = copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 3, HW, HW), generator=gen)
    y = torch.tensor([1, 2])
    noise = {}

    def fixed_noise(v, generator):
        if v.shape not in noise:
            noise[v.shape] = torch.rand(v.shape, generator=gen) - 0.5
        return v + noise[v.shape].to(v.device)

    original = factorized.quantize_noise
    out = {}
    try:
        factorized.quantize_noise = fixed_noise
        for dev in devices:
            s, t = copy.deepcopy(student).to(dev), copy.deepcopy(teacher)
            box = DistillationBox(s, cfg['train']['stage1'], teacher=t.to(dev),
                                  steps_per_epoch=2, student_mode='train',
                                  generator=torch.Generator(device=dev))
            m = box.train_step(x.to(dev), y.to(dev))
            out[dev] = ({k: float(v) for k, v in m['loss'].items()},
                        {n: (p.detach().cpu(), p.grad.cpu())
                         for n, p in s.named_parameters()
                         if p.grad is not None})
    finally:
        factorized.quantize_noise = original
    (loss_c, params_c), (loss_p, params_p) = (out[d] for d in devices)
    for k, v in loss_p.items():
        check(abs(loss_c[k] - v) <= 1e-3 * abs(v),
              f'card vs CPU step: loss {k} {loss_c[k]} vs {v}')
    check(params_c.keys() == params_p.keys(), 'card vs CPU: other params')
    lr = float(cfg['train']['stage1']['optimizer']['kwargs']['lr'])
    worst_g = worst_u = 0.0
    compared = 0
    for n, (p_ref, g_ref) in params_p.items():
        p, g = params_c[n]
        scale = float(g_ref.abs().max()) or 1.0
        dg = (g - g_ref).abs()
        worst_g = max(worst_g, float(dg.max()) / scale)
        check(bool((dg <= 1e-3 * g_ref.abs() + 1e-3 * scale).all()),
              f'card vs CPU: gradient of {n}, max |dg| / max|g| '
              f'{float(dg.max()) / scale:.3e}')
        # Adam's first step is lr * g / (|g| + eps), about lr * sign(g):
        # compared where the gradient stands clear of its tolerance
        sure = g_ref.abs() > 0.1 * scale
        dp = (p - p_ref).abs()[sure]
        compared += dp.numel()
        if dp.numel():
            worst_u = max(worst_u, float(dp.max()) / lr)
            tol = (1e-3 * p_ref.abs() + 1e-2 * lr)[sure]
            check(bool((dp <= tol).all()),
                  f'card vs CPU: updated {n}, max |dp| '
                  f'{float(dp.max()):.3e} ({float(dp.max()) / lr:.3e} lr)')
    log(f'phase 7: one flagship stage-1 step at batch 2, card vs CPU: loss '
        f'{loss_c} vs {loss_p}; gradients: max |dg| / max|g| '
        f'{worst_g:.3e}; updated parameters: max |dp| {worst_u:.3e} lr over '
        f'the {compared} elements whose |g| > 0.1 max|g|')


def big_image_phase(torch, kernels, rt):
    """Phase 8: one 2,584 px image at batch 1 on auto lanes: a 645x645x24
    latent of 3,072 lanes x 3,251 steps, beyond the batch-1 decoder's
    limit, coded through the aligned pair at k = 1 with no escape; its
    accounted size equals the plain coder's wire on the same symbols."""
    from sc2bench_tpu_torch.analysis import get_binary_object_size
    from sc2bench_tpu_torch.ops.rans.device import (device_rans_encode,
                                                    pack_stream,
                                                    pack_stream_aligned)
    x = torch.from_numpy(np.random.default_rng(77).normal(
        0, 1, (1, 3, BIG_HW, BIG_HW)).astype(np.float32)).to(rt.device)
    shape = rt._latent_shape(x.shape)
    lanes = rt._auto_wire_lanes(shape)
    steps = -(-int(np.prod(shape)) // lanes)
    check((lanes, steps) == (3072, 3251), f'{BIG_HW} px: {lanes} lanes x '
          f'{steps} steps, expected 3072 x 3251')
    check(not kernels.batch1_fits(steps, rt.device),
          f'{steps} steps fit the batch-1 kernels: no repair to show')
    rt.clear_analysis()
    rt.activate_analysis()
    rt.escapes = {'ok': 0, 'valid': 0}
    rt.stream_deploy_device([x])                      # warm
    rt.clear_analysis()
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits = rt.stream_deploy_device([x])
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    want = expected_launches(kernels, ('rans_cyclic_encode_aligned',
                                       'rans_cyclic_decode_aligned'), 1)
    check(counts == want, f'{BIG_HW} px launched {counts}, expected {want}')
    check(rt.escapes == {'ok': 0, 'valid': 0},
          f'{BIG_HW} px image escaped: {rt.escapes}')
    check(bool(torch.isfinite(logits[0]).all()), 'non-finite logits')
    size = rt.analyzers[0].file_size_list[0]
    flat, _ = rt._symbols_nhwc(x)
    t = rt.codec.tables
    plain = device_rans_encode(flat.reshape(-1).cpu(), t.quantized_cdf,
                               t.cdf_length, t.offset, num_lanes=lanes,
                               cyclic_channels=shape[-1])
    wire = (pack_stream_aligned if plain['aligned'] else pack_stream)(plain)
    check(size == get_binary_object_size({'strings': [[wire]],
                                          'shape': shape[:2]}),
          f'{BIG_HW} px: accounted {size} KB, the plain coder gives '
          f'{len(wire)} bytes')
    check(rt._pull_device_wire(rt.encode_device_wire(x)) == wire,
          f'{BIG_HW} px: the packed wire differs from the plain coder')
    log(f'phase 8: one {BIG_HW}x{BIG_HW} image at batch 1 ({shape} latent, '
        f'{lanes} lanes x {steps} steps, beyond the batch-1 limit of '
        f'{kernels.max_steps(True, rt.device)} decode columns): served '
        f'through the aligned pair at k = 1 in {dt:.3f} s, no escape, '
        f'{size} KB equal to the plain coder\'s wire')


def hyper_symbols(torch, rt, x):
    """The host path's and the encoder's y and z symbols of one image:
    (encoder y, encoder z, host-decoded y, host-decoded z), NHWC numpy."""
    ops = rt._hyper_ops(x)
    compressed = rt.encode(x)
    codec = rt.codec
    z_host = codec.decompress_symbols(compressed['strings'][1],
                                      compressed['shape'],
                                      rt._bneck.num_latent_channels)
    idx, _ = rt._hyper_scales(torch.from_numpy(z_host).to(rt.device))
    y_host = codec.decompress_y(compressed['strings'][0],
                                idx.cpu().numpy())
    nhwc = [ops[k].permute(0, 2, 3, 1).cpu().numpy()
            for k in ('y_symbols', 'z_symbols')]
    return nhwc + [y_host, z_host]


def device_symbols(rt, x):
    """y and z symbols decoded by the device wire's kernels, NHWC numpy."""
    from sc2bench_tpu_torch.ops.rans.device import device_rans_decode
    ops = rt.encode_device_wire_hyper(x)
    (hy, wy, cy), (hz, wz, cz) = ops['shapes']
    y_lanes, z_lanes = ops['lanes']
    cdf, cdf_len, off = rt._tables_dev
    z, _ = device_rans_decode(ops['z']['streams'], ops['z']['states'], cdf,
                              cdf_len, off, n_symbols=hz * wz * cz,
                              num_lanes=z_lanes, cyclic_channels=cz,
                              aligned=ops['z']['aligned'])
    z = z.reshape(1, hz, wz, cz)
    idx = rt._hyper_scales(z)[0].reshape(-1)
    g_cdf, g_len, g_off = rt._gtables_dev
    y, _ = device_rans_decode(ops['y']['streams'], ops['y']['states'], g_cdf,
                              g_len, g_off, n_symbols=hy * wy * cy,
                              num_lanes=y_lanes, indexes=idx,
                              aligned=ops['y']['aligned'])
    return y.reshape(1, hy, wy, cy).cpu().numpy(), z.cpu().numpy()


def prepared_calls(kernels, name):
    """Replace the wrapper `kernels.<name>` by one that records the
    `prepared` each call hands it; returns (that list, a function that
    puts the wrapper back)."""
    calls, real = [], getattr(kernels, name)

    def record(*args, **kwargs):
        calls.append(kwargs.get('prepared'))
        return real(*args, **kwargs)

    setattr(kernels, name, record)
    return calls, lambda: setattr(kernels, name, real)


def mshp_serve_phase(torch, kernels, rt, images, phase='phase 9',
                     label='MSHP-24/256/16 ResNet-50'):
    """Phase 9: the MSHP deploy loop at full width, batch 1 then
    wire_batch; returns the launch counts of both runs."""
    from sc2bench_tpu_torch.analysis import get_binary_object_size
    classes = 1000
    rows = set()
    for x in images:
        rows |= set(np.unique(rt._hyper_ops(x)['y_indexes'].cpu().numpy())
                    .tolist())
    check(len(rows) >= 8, f'the y indexes use {len(rows)} of the 64 rows')
    rt.stream_deploy_device(images[:2])
    rt.stream_deploy_device(images[:WIRE_BATCH], wire_batch=WIRE_BATCH)
    runs = {}
    for wire_batch, encoder in ((None, 'indexed_encode'),
                                (WIRE_BATCH, 'indexed_encode_aligned')):
        rt.clear_analysis()
        rt.activate_analysis()
        rt.escapes = {'ok': 0, 'valid': 0}
        kernels.reset_launches()
        handed, restore = prepared_calls(kernels, encoder)
        try:
            t0 = time.perf_counter()
            logits = rt.stream_deploy_device(images, wire_batch=wire_batch)
            dt = time.perf_counter() - t0
        finally:
            restore()
        runs[wire_batch] = dict(logits=logits, dt=dt,
                                launches=dict(kernels.LAUNCHES),
                                sizes=list(rt.analyzers[0].file_size_list),
                                summary=rt.summarize()[0],
                                escapes=dict(rt.escapes), handed=handed)
    b1, bk = runs[None], runs[WIRE_BATCH]
    n = len(images)
    groups = -(-n // WIRE_BATCH)
    for run, want in ((b1, n), (bk, groups)):
        check(len(run['handed']) == want
              and all(p is rt._gprepared for p in run['handed']),
              f'MSHP: the y encoder was not handed the tables update() '
              f'prepared on each of its {want} calls')
    want1 = expected_launches(kernels, MSHP_BATCH1, n)
    wantk = expected_launches(kernels, [k + '_aligned' for k in MSHP_BATCH1],
                              groups)
    check(b1['launches'] == want1, f'MSHP batch 1 launched '
          f'{b1["launches"]}, expected {want1}')
    check(bk['launches'] == wantk, f'MSHP wire_batch launched '
          f'{bk["launches"]}, expected {wantk}')
    for tag, run in (('batch 1', b1), ('wire_batch', bk)):
        check(run['escapes'] == {'ok': 0, 'valid': 0},
              f'MSHP {tag}: images escaped: {run["escapes"]}')
        for lg in run['logits']:
            check(tuple(lg.shape) == (1, classes)
                  and bool(torch.isfinite(lg).all()),
                  f'MSHP {tag}: bad logits {tuple(lg.shape)}')
    check(bk['sizes'] == b1['sizes'], 'MSHP wire_batch sizes differ from '
          'batch 1')
    worst = max(float((a - b).abs().max())
                for a, b in zip(b1['logits'], bk['logits']))
    check(worst <= LOGIT_TOL, f'MSHP wire_batch logits differ by {worst}')
    # two images against the host path
    host_worst = 0.0
    for i in (0, n - 1):
        y_enc, z_enc, y_host, z_host = hyper_symbols(torch, rt, images[i])
        y_dev, z_dev = device_symbols(rt, images[i])
        for name, a, b in (('y', y_dev, y_host), ('z', z_dev, z_host),
                           ('y', y_enc, y_host), ('z', z_enc, z_host)):
            check(np.array_equal(a, b), f'MSHP image {i}: {name} symbols '
                  'differ between the device wire and the host path')
        want = rt.decode(**rt.encode(images[i]))
        diff = float((b1['logits'][i] - want).abs().max())
        host_worst = max(host_worst, diff)
        check(diff <= LOGIT_TOL, f'MSHP image {i}: logits differ from the '
              f'host path by {diff}')
    # the escape
    x_esc = None
    for scale in (30.0, 100.0, 1000.0):
        if not bool(rt.encode_device_wire_hyper(images[-1] * scale)['meta']
                    [0]):
            x_esc = images[-1] * scale
            break
    check(x_esc is not None, 'no scaled image left the Gaussian support')
    want_size = get_binary_object_size(rt.encode(x_esc))
    rt.clear_analysis()
    rt.escapes = {'ok': 0, 'valid': 0}
    stream = images[:2] + [x_esc]
    logits = rt.stream_deploy_device(stream)
    check(rt.escapes == {'ok': 1, 'valid': 0},
          f'MSHP escape: escapes {rt.escapes}')
    sizes = list(rt.analyzers[0].file_size_list)
    check(sizes[2] == want_size and sizes[:2] == b1['sizes'][:2],
          f'MSHP escape: sizes {sizes}, rt.encode gives {want_size}')
    check(all(bool(torch.isfinite(lg).all()) for lg in logits),
          'MSHP escape: non-finite logits')
    log(f'{phase}: {label}, {n} float 224x224 images: '
        f'y indexes use {len(rows)} of 64 rows; batch 1 '
        f'{n / b1["dt"]:.2f} img/s, wire_batch={WIRE_BATCH} '
        f'{n / bk["dt"]:.2f} img/s; data size {b1["summary"]} (equal at '
        f'both); max |logit diff| batch 1 vs wire_batch {worst:.3e}, vs the '
        f'host path {host_worst:.3e} (y and z symbols equal); escape image '
        f'(scale {scale:g}) re-coded on the host coder, {want_size} KB; '
        f'launches batch 1 {b1["launches"]}, wire_batch {bk["launches"]}')
    return b1['launches'], bk['launches']


def mshp_train_phase(torch, kernels, model):
    """Phase 10 (second half): the MSHP flagship config's two stages at 2
    steps each (batch 32), then 8 test images on the device wire."""
    import tempfile
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    loaders = {'train_data_loader': synthetic_split(
        N_TRAIN, TRAIN_BATCH, seed=1000, shuffle=True, drop_last=True),
        'val_data_loader': synthetic_split(N_VAL, TRAIN_BATCH, seed=2000)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'student.ckpt')
        save_ckpt(ckpt, model.state_dict())
        run = train_cli(torch, kernels, MSHP_CONFIG, {
            'allow_missing_teacher': True,
            'models': {'student_model': {'ckpt': ckpt}},
            'train': {**loaders,
                      'stage1': {'num_epochs': 1, 'epoch_to_update': 1},
                      'stage2': {'num_epochs': 1}},
            'test': {'test_data_loader': synthetic_split(N_E2E_TEST, 1,
                                                         seed=0)}},
            N_E2E_TEST)
    steps = N_TRAIN // TRAIN_BATCH
    got = [(r['name'], len(r['steps'])) for r in run['records']]
    check(got == [('stage1', steps), ('stage2', steps)],
          f'MSHP stages and steps {got}')
    s0, s1 = run['records'][0]['student'], run['records'][1]['student']
    s2 = snapshot(run['engine'].student)
    buffers = {k for k, _ in run['engine'].student.named_buffers()}
    frozen1 = [k for k in s0 if k.split('.')[0] in ('layer2', 'layer3',
                                                   'layer4') or k in buffers]
    moved = changed(s0, s1, frozen1)
    check(not moved, f'MSHP stage 1 changed layer2-4 or BN statistics: '
          f'{moved[:3]}')
    check(changed(s0, s1, [k for k in s0 if '.g_a.' in k]),
          'MSHP stage 1 left g_a unchanged')
    frozen2 = [k for k in s1 if re.search(r'bottleneck_layer\.(g_a|h_a|h_s)'
                                          r'\.', k) or re.search(
        r'entropy_bottleneck\._(matrix|bias|factor)\d', k)]
    moved = changed(s1, s2, frozen2)
    check(not moved, f'MSHP stage 2 changed g_a, h_a, h_s or the density: '
          f'{moved[:3]}')
    check(changed(s1, s2, [k for k in s1 if '.g_s.' in k]),
          'MSHP stage 2 left g_s unchanged')
    run['escapes'] = check_test_of_training(torch, kernels, run, N_E2E_TEST,
                                            'MSHP', per_image=MSHP_BATCH1)
    log_stages(run, 'MSHP', phase='phase 10')
    log('phase 10: MSHP stage 1 left layer2-4 and every BN statistic as '
        'they were and moved g_a; stage 2 left g_a, h_a, h_s and the '
        'density as they were and moved g_s; test sizes equal a direct '
        'stream_deploy_device')
    return run['launches']


def out_of_support(symbols, tables):
    """Share of NHWC symbols outside their channel's CDF support (coded
    through the host coder's bypass)."""
    value = symbols.astype(np.int64) - tables.offset
    return float(np.mean((value < 0) | (value >= tables.cdf_length - 2)))


def finetune_serve_phase(torch, kernels, images):
    """Phase 11: an `entropic_classifier(resnet50, split, 1000)` with
    seeded random weights at each configured split, served on the host
    wire (`stream_deploy`). Returns the launch counts of each split."""
    from sc2bench_tpu_torch.analysis import get_binary_object_size
    from sc2bench_tpu_torch.models.entropic import entropic_classifier
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    device = images[0].device
    launches = {}
    for i, split in enumerate(FT_SPLITS):
        torch.manual_seed(100 + i)
        model = randomize_weights(torch, entropic_classifier(
            'resnet50', split, 1000, device=device), 100 + i, device)
        rt = SplitClassifierRuntime(model, device=device)
        t0 = time.perf_counter()
        rt.update()
        t_update = time.perf_counter() - t0
        rt.eval()
        rt.stream_deploy(images[:1])        # cuDNN set-up, not counted
        rt.clear_analysis()
        rt.activate_analysis()
        timings = {}
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = rt.stream_deploy(images, timings=timings)
        wall = time.perf_counter() - t0
        launches[split] = dict(kernels.LAUNCHES)
        check(all(v == 0 for v in launches[split].values()),
              f'phase 11 {split}: the host wire launched {launches[split]}')
        sizes = list(rt.analyzers[0].file_size_list)
        summary = rt.summarize()[0]
        check(len(logits) == len(images) == len(sizes),
              f'phase 11 {split}: {len(logits)} results, {len(sizes)} sizes')
        worst_dec = worst_ft = 0.0
        oos, enc_bytes = [], []
        for x, lg, size in zip(images, logits, sizes):
            check(tuple(lg.shape) == (1, 1000)
                  and bool(torch.isfinite(lg).all()),
                  f'phase 11 {split}: bad logits {tuple(lg.shape)}')
            sym = rt.encode_device(x)['symbols'].cpu().numpy()
            oos.append(out_of_support(sym, rt.codec.tables))
            wire = {'strings': [rt.codec.compress_wire(sym)],
                    'shape': tuple(sym.shape[1:3])}
            check(get_binary_object_size(wire) == size,
                  f'phase 11 {split}: accounted {size} KB, the host wire '
                  f'object is {get_binary_object_size(wire)} KB')
            compressed = rt.encode(x)
            # the channel-major coder codes the same symbols in another
            # order: the final rANS state may take one byte more or less
            enc_bytes.append(round(1024 * (get_binary_object_size(compressed)
                                           - size)))
            check(abs(enc_bytes[-1]) <= 1, f'phase 11 {split}: rt.encode '
                  f'size differs from the host wire by {enc_bytes[-1]} B')
            with torch.no_grad():
                worst_dec = max(worst_dec, float(
                    (lg - rt.decode(**compressed)).abs().max()))
                ft = model(x, mode='finetune')
            check(torch.allclose(lg, ft, rtol=2e-4, atol=2e-4),
                  f'phase 11 {split}: logits differ from the finetune '
                  f'forward by {float((lg - ft).abs().max()):.3e}')
            worst_ft = max(worst_ft, float((lg - ft).abs().max()))
        check(worst_dec <= 1e-5, f'phase 11 {split}: logits differ from '
              f'rt.decode(**rt.encode(x)) by {worst_dec:.3e}')
        try:
            rt.stream_deploy_device(images[:1])
        except ValueError as e:
            raised = str(e)
        else:
            raised = None
        check(raised is not None,
              f'phase 11 {split}: stream_deploy_device did not raise')
        n = len(images)
        h, w, c = sym.shape[1:]
        log(f'phase 11: {split}: latent {h}x{w}x{c} ({h * w * c} symbols an '
            f'image), out of support {100 * np.mean(oos):.4f}% (max '
            f'{100 * max(oos):.4f}%), {summary["mean"]:.6f} KB an image (std '
            f'{summary["std"]:.6f}), host coding '
            f'{1e3 * timings.get("host_code", 0.0) / n:.3f} ms an image '
            f'(wait {1e3 * timings.get("d2h_sync", 0.0) / n:.3f}, decode '
            f'dispatch {1e3 * timings.get("decode_dispatch", 0.0) / n:.3f}), '
            f'{n / wall:.2f} img/s over {n} images; tables {c} rows built in '
            f'{t_update:.2f} s; rt.encode sizes minus the host wire: '
            f'{enc_bytes} B; max |logit diff| vs rt.decode {worst_dec:.3e}, '
            f'vs the finetune forward {worst_ft:.3e}; stream_deploy_device '
            f'raises ValueError({raised!r})')
        del model, rt
        torch.cuda.empty_cache()
    return launches


def frozen_and_buffers(engine, prefixes=('layer2', 'layer3', 'layer4')):
    """The student's keys under `prefixes` and its buffers."""
    student = engine.student
    buffers = {k for k, _ in student.named_buffers()}
    return [k for k in student.state_dict()
            if k.split('.')[0] in prefixes or k in buffers]


def bq_phase(torch, kernels):
    """Phase 12: the CLI on a fine-tuning config (train then test on the
    host wire) and on the bq12ch CR+BQ config (stage 1, then the plain
    test), then the bq12ch student served through its `SplitClassifier`
    wrapper. Returns the launch counts of the two tests and the
    wrapper's run."""
    from sc2bench_tpu_torch.config import load_config
    from sc2bench_tpu_torch.models.wrapper import wrap_model
    loaders = {'train_data_loader': synthetic_split(
        N_BQ_TRAIN, BQ_BATCH, seed=1000, shuffle=True, drop_last=True),
        'val_data_loader': synthetic_split(N_VAL, TRAIN_BATCH, seed=2000)}
    test = {'test_data_loader': synthetic_split(N_BQ_TEST, 1, seed=0)}
    steps = N_BQ_TRAIN // BQ_BATCH
    # fine-tuning: epoch 1 in the 'train' mode, the tables built after
    # it, epoch 2 in the 'finetune' mode; grad_accum_step 2
    ft = train_cli(torch, kernels, FT_CONFIG, {
        'train': {**loaders, 'num_epochs': 2, 'epoch_to_update': 1},
        'test': test}, N_BQ_TEST, wire='host')
    got = [(r['name'], len(r['steps'])) for r in ft['records']]
    check(got == [('train', 2 * steps)], f'fine-tuning: stages {got}')
    rt = ft['engine'].runtime
    check(rt.bottleneck_updated, 'fine-tuning: tables not built')
    s0, s1 = ft['records'][0]['student'], snapshot(ft['engine'].student)
    buffers = {k for k, _ in ft['engine'].student.named_buffers()}
    moved = changed(s0, s1, sorted(buffers))
    check(not moved, f'fine-tuning (train_bn false) changed BN statistics: '
          f'{moved[:3]}')
    check(changed(s0, s1, [k for k in s0 if k.startswith('base.layer1.')]),
          'fine-tuning left layer1 unchanged')
    check(all(v == 0 for v in ft['launches'].values()),
          f'fine-tuning test launched {ft["launches"]}')
    check(ft['summaries'][0]['num_samples'] == N_BQ_TEST,
          f'fine-tuning summary {ft["summaries"]}')
    sizes = list(rt.analyzers[0].file_size_list)
    rt.clear_analysis()
    rt.stream_deploy(ft['images'])
    check(list(rt.analyzers[0].file_size_list) == sizes,
          'fine-tuning: CLI sizes differ from a direct stream_deploy')
    ft['escapes'] = 'none (host wire)'
    log_stages(ft, 'fine-tuning layer1', phase='phase 12', wire='host')
    # CR+BQ: stage 1 (hints, layer2-4 frozen); no codec, no data size
    bq = train_cli(torch, kernels, BQ_CONFIG, {
        'allow_missing_teacher': True,
        'train': {**loaders, 'stage1': {'num_epochs': 1}}, 'test': test},
        N_BQ_TEST, wire='host')
    got = [(r['name'], len(r['steps'])) for r in bq['records']]
    check(got == [('stage1', steps)], f'bq12ch: stages {got}')
    engine = bq['engine']
    check(engine.runtime.codec is None
          and not engine.runtime.bottleneck_updated,
          'bq12ch: the runtime has a codec')
    s0, s1 = bq['records'][0]['student'], snapshot(engine.student)
    moved = changed(s0, s1, frozen_and_buffers(engine))
    check(not moved, f'bq12ch stage 1 changed layer2-4 or BN statistics: '
          f'{moved[:3]}')
    check(changed(s0, s1, [k for k in s0 if '.encoder.' in k]),
          'bq12ch stage 1 left the encoder unchanged')
    moved = changed(bq['records'][0]['teacher'], snapshot(engine.teacher),
                    bq['records'][0]['teacher'])
    check(not moved, f'bq12ch: teacher changed: {moved[:3]}')
    check(all(v == 0 for v in bq['launches'].values()),
          f'bq12ch test launched {bq["launches"]}')
    check(bq['summaries'][0]['num_samples'] == 0,
          f'bq12ch: data size accounted {bq["summaries"]}')
    bq['escapes'] = 'none (no codec)'
    log_stages(bq, 'bq12ch', phase='phase 12',
               wire='no (plain forward, no data size)')
    # the SplitClassifier wrapper of the config: 8-bit quantized latent
    cfg = load_config(os.path.join(REPO, BQ_CONFIG))
    wrapper = wrap_model(cfg['wrapper'], engine.student,
                         device=engine.device)
    wrapper.eval()
    wrapper.activate_analysis()
    quant, worst_q, worst_logit = wrapper.compressor, 0.0, 0.0
    seen = []
    wrapper.compressor = lambda z: seen.append(z) or quant(z)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [wrapper(x) for x in bq['images']]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrap_launches = dict(kernels.LAUNCHES)
    check(all(v == 0 for v in wrap_launches.values()),
          f'SplitClassifier launched {wrap_launches}')
    for x, lg, z in zip(bq['images'], logits, seen):
        check(z.shape == (1, 12, HW // 8, HW // 8),
              f'bq12ch latent {z.shape}')
        q = quant(z)
        err = np.abs(wrapper.decompressor(q) - z).max()
        # half a step, plus float32 rounding of z / scale and of the
        # dequantizing product
        check(err <= 0.5 * q['scale'] + 1e-6 * np.abs(z).max(),
              f'8-bit round trip off by {err} (scale {q["scale"]})')
        worst_q = max(worst_q, float(err / q['scale']))
        with torch.no_grad():
            plain = engine.student(x, mode='finetune')
        check(bool(torch.isfinite(lg).all()), 'SplitClassifier: bad logits')
        worst_logit = max(worst_logit, float((lg - plain).abs().max()))
    summary = wrapper.summarize()[0]
    check(summary['num_samples'] == N_BQ_TEST,
          f'SplitClassifier summary {summary}')
    log(f'phase 12: bq12ch SplitClassifier, SimpleQuantizer(8): latent '
        f'{"x".join(map(str, seen[0].shape[1:]))}, {summary["mean"]:.6f} KB '
        f'an image (std '
        f'{summary["std"]:.6f}), {N_BQ_TEST / wall:.2f} img/s; round trip '
        f'within {worst_q:.4f} scale; max |logit diff| vs the unquantized '
        f'forward {worst_logit:.3e}')
    return ft['launches'], bq['launches'], wrap_launches


NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


# ---- phase 13: the input- and feature-compression wrappers -----------------

def codec_weights(torch, module, seed, image, median=4.0):
    """Seeded weights for an image codec of the zoo, as a trained one's
    latents behave: He-normal convolutions (`randomize_weights`), the last
    g_a convolution halved (y, std about 1, and z inside the +-10 support
    of fresh quantiles), and for a hyperprior the layer that gives the
    Gaussian scales made positive (|w|, bias 0) and scaled so that their
    median on `image` is `median`, its mean half damped (x 0.1): every
    symbol then lies inside its row's support."""
    randomize_weights(torch, module, seed, image.device)
    with torch.no_grad():
        module.g_a[-1].weight.mul_(0.5)
        if not hasattr(module, 'h_s'):
            return module
        m = module.m
        y = module.g_a(image)
        if hasattr(module, 'context_prediction'):           # JAHP
            conv = module.entropy_parameters[-1]
            conv.weight[:m] = conv.weight[:m].abs()
            conv.weight[m:] *= 0.1
            conv.bias.zero_()

            def scales():
                z = module.h_a(y)
                feat = torch.cat([module.h_s(torch.round(z)),
                                  module.context_prediction(torch.round(y))],
                                 dim=1)
                return module.entropy_parameters(feat)[:, :m]
        else:
            conv = module.h_s[-2] if not module.mean_scale else module.h_s[-1]
            conv.weight[:m] = conv.weight[:m].abs()
            if module.mean_scale:
                conv.weight[m:] *= 0.1
            conv.bias.zero_()

            def scales():
                z = module.h_a(module.hyper_input(y))
                return module.gaussian_params(
                    module.h_s(torch.round(z)))[0]
        conv.weight[:m] *= median / float(scales().median())
    return module


def codec_cli(torch, kernels, config, n, tmp, device, codec=None, hw=HW,
              phase='phase 13'):
    """The test CLI on a wrapper config at full width (its classifier with
    random weights), `n` synthetic hw x hw images of 1000 classes; a
    neural codec's weights from `codec` (saved as the config's codec
    ckpt). Checks: every image accounted, no kernel launched (host
    coders), the top-1/top-5 in [0, 1]. Returns the CLI's output with its
    wall seconds."""
    from sc2bench_tpu_torch.tasks.image_classification import main as cli
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    over = {'test': {'test_data_loader': synthetic_split(n, 1, seed=0,
                                                         hw=hw)}}
    if codec is not None:
        ckpt = os.path.join(tmp, os.path.basename(config) + '.ckpt')
        save_ckpt(ckpt, codec.state_dict())
        over['models'] = {'wrapper': {'compression_model': {'ckpt': ckpt}}}
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = cli(['--config', os.path.join(REPO, config), '--json',
               json.dumps(over), '-test_only', '--device', str(device)])
    wall = time.perf_counter() - t0
    tag = os.path.basename(config)
    check(all(v == 0 for v in kernels.LAUNCHES.values()),
          f'{tag}: the host coders launched {dict(kernels.LAUNCHES)}')
    summary = out['summaries'][0]
    check(summary['num_samples'] == n and summary['mean'] > 0,
          f'{tag}: data size {summary}')
    res = out['result']
    check(all(0.0 <= res[k] <= 1.0 for k in ('acc1', 'acc5')),
          f'{tag}: result {res}')
    rt = getattr(out['engine'].wrapper, 'compression_model', None)
    host = '' if rt is None else ', host coding ' + ', '.join(
        f'{k} {1e3 * v / n:.3f}' for k, v in sorted(rt.timings.items())) \
        + ' ms an image'
    log(f'{phase}: {config}: {n} images of {hw} px, acc1 {res["acc1"]}, '
        f'acc5 '
        f'{res["acc5"]}, {summary["mean"]:.6f} KB an image (std '
        f'{summary["std"]:.6f}), {1 / res["model_time"]:.2f} img/s '
        f'(model_time {res["model_time"]:.6f} s){host}; CLI wall {wall:.2f} s')
    return dict(out, wall=wall)


# The share of a codec's symbols and indexes on which the card's encoder
# may differ from the CPU's (PERF.md section 4): cuDNN's and the CPU's
# convolutions round differently in the last bits, so a latent on a rounding
# boundary (or a scale on a table boundary) may land one step away on either.
# Each device's own round trip stays exact.
CARD_CPU_MISMATCH_SHARE = 1e-3


def codec_reference(torch, rt, module, x):
    """The card's codec against the CPU on one image: the symbols (and
    indexes) of `encode_ops` equal but for at most
    `CARD_CPU_MISMATCH_SHARE` of them, and the card's round trip exact:
    `decompress(compress(x))` equals the decoder on the encoder's own
    symbols."""
    import copy
    from sc2bench_tpu_torch.models.runtime import _exact_cudnn
    cpu = copy.deepcopy(module).cpu()
    ops = {}
    for dev, mod in (('card', module), ('cpu', cpu)):
        med = rt._medians.to(next(mod.parameters()).device)
        xx = x.to(med.device)
        with torch.no_grad():
            ops[dev] = mod.encode_ops(xx, med, rt._scale_table.to(
                med.device)) if rt.hyper else mod.encode_ops(xx, med)
    total = equal = 0
    for k, v in ops['card'].items():
        total += v.numel()
        equal += int((v.cpu() == ops['cpu'][k]).sum())
    check(total - equal <= CARD_CPU_MISMATCH_SHARE * total,
          f'card and CPU symbols agree on only {equal} of {total}')
    comp = rt.compress(x)
    img = rt.decompress(**comp)
    with torch.no_grad():
        if rt.hyper:
            card = ops['card']
            with _exact_cudnn():
                _, means = module.decode_scales(
                    card['z_symbols'], rt._medians, rt._scale_table)
            want = module.decode_ops(card['y_symbols'], means)
        else:
            want = module.decode_ops(ops['card']['symbols'], rt._medians)
    check(tuple(img.shape) == tuple(x.shape) and bool(torch.isfinite(img)
                                                      .all()),
          f'reconstruction {tuple(img.shape)}')
    worst = float((img - want).abs().max())
    check(worst <= 1e-4 * float(want.abs().max()),
          f'the host round trip is off the encoder\'s symbols by {worst}')
    return equal, total


def masked_costs(vc, idx, act, m, tables, decode, lengths=None):
    """(bound ms, bound_by) of one masked launch: the encode over all T
    fronts, or one decode front (`vc`, `idx` of that front). Each input
    read once, each output written once: the activity bytes, the table
    entries the data codes (cdf[row, v] and cdf[row, v + 1]); for the
    encode the int32 values and rows of the active lanes, the (N, T)
    int32 streams, the int32 lengths and the int64 final states (written);
    for a decode step the int32 row of each active lane, the int64 states
    (read and written), the chunks the step reads (`lengths`: lanes that
    renormalise), the rows' lengths and offsets and the int32 symbols out
    (the values are what it computes, not what it reads). Integer
    operations as for the indexed kernels, the bisection by the probes
    each active symbol's row needs."""
    cols = tables.quantized_cdf.shape[1]
    m_act = np.repeat(act.cpu().numpy().astype(bool), m, axis=-1)
    v = vc.cpu().numpy().astype(np.int64)[m_act]
    rows = idx.cpu().numpy().astype(np.int64)[m_act]
    pos = rows * cols + v
    entries = np.unique(np.concatenate([pos, pos + 1])).size
    lanes = vc.shape[-1]
    nbytes = 4 * entries + act.numel()
    if decode:
        probes = np.ceil(np.log2(np.maximum(
            tables.cdf_length[rows] - 1, 2))).sum()
        nbytes += 4 * rows.size + 16 * lanes + 4 * lanes \
            + 4 * int(lengths) + 8 * np.unique(rows).size
        ops = 4 * probes + DECODE_OPS_PER_SYMBOL * v.size
    else:
        nbytes += 8 * v.size + 4 * vc.numel() + 4 * lanes + 8 * lanes
        ops = ENCODE_OPS_PER_SYMBOL * v.size
    return bound(nbytes, ops)


def zero_frequency_tables():
    """(cdf, cdf_length, offset) of four 700-column CDF rows with
    zero-frequency entries (repeated values) at the front, in the middle
    and before the end, a row of frequency-1 symbols and a row as wide as
    the table, padded with zeros past each cdf_length."""
    cols = 700
    cdf = np.zeros((4, cols), np.int32)
    cdf[0, :8] = [0, 0, 0, 300, 300, 65000, 65536, 65536]
    cdf[1, :7] = [0, 5, 5, 5, 40000, 40000, 65536]
    cdf[2, :602] = np.concatenate([np.arange(600), [65535, 65536]])
    w = np.random.default_rng(3).uniform(0.0, 1.0, cols - 1) ** 8
    freqs = (w / w.sum() * 65000).astype(np.int64)         # some are 0
    freqs[np.argmax(freqs)] += 65536 - freqs.sum()
    cdf[3, 1:] = np.cumsum(freqs)
    return cdf, np.asarray([7, 7, 602, cols], np.int32), \
        np.asarray([0, -3, -300, 11], np.int32)


def masked_zero_frequency(torch, td, kernels, sch, m, device):
    """The masked encoder on the JAHP schedule `sch` with `m` lanes a slot,
    on `zero_frequency_tables`, each value drawn evenly over its row's
    coded support, so active lanes code zero-frequency entries (where
    max(freq, 1) decides), with the tables' prepared form and without:
    (its largest difference from the plain version, the active lanes on a
    zero-frequency entry)."""
    from sc2bench_tpu_torch.ops.rans.indexed_tables import \
        prepare_indexed_tables
    cdf, cdf_len, off = zero_frequency_tables()
    rng = np.random.default_rng(15)
    steps, slots = sch.active.shape
    ix = rng.integers(0, cdf.shape[0], (steps, slots * m)).astype(np.int32)
    vals = rng.integers(0, cdf_len[ix] - 2).astype(np.int32)
    lane_act = np.repeat(sch.active.cpu().numpy().astype(bool), m, axis=1)
    zero = int(((cdf[ix, vals + 1] == cdf[ix, vals]) & lane_act).sum())
    check(zero > 0, 'masked zero-frequency case: no active lane codes a '
          'zero-frequency entry')
    cdf, cdf_len, off, vc, ix = (torch.from_numpy(a).to(device) for a in (
        cdf, cdf_len, off, vals, ix))
    want = td.masked_encode_plain(cdf, vc, ix, sch.active, m)
    err = 0
    for extra in ({'prepared': prepare_indexed_tables(cdf, cdf_len, off)},
                  {}):
        got = kernels.masked_encode_aligned(cdf, vc, ix, sch.active, m,
                                            **extra)
        err = max([err] + [int((a - b).abs().max())
                           for a, b in zip(got, want)])
    return err, zero


def jahp_phase(torch, kernels, td, images):
    """Phase 13 (JAHP): the joint autoregressive codec q1 (192, 192) at
    256 px on the host wire and on the device wire. Checks: every image in
    support (`ok`), the device decode `valid` and its y_hat equal to the
    encoder's and to the host path's (bit for bit), the host round trip
    exact; the masked kernels launch once (encode) and once a front
    (decode) an image, both handed the tables `update()` prepared, the
    aligned cyclic pair once each for z; on the last image every kernel of
    the path equals its plain version, the front decoder on every front,
    and the masked encoder also on tables with zero-frequency entries
    (`masked_zero_frequency`). The masked kernels' timings come with their
    launch floor: an empty kernel on their grid, timed the same way.
    Returns (launches, kernel stats of the two masked kernels)."""
    import pickle
    from sc2bench_tpu_torch.models import zoo
    from sc2bench_tpu_torch.models.zoo_jahp import JointAutoregressiveRuntime
    device = images[0].device
    torch.manual_seed(3)
    module = zoo.registry_get('model', JAHP_KEY)(quality=1, device=device)
    codec_weights(torch, module, 3, images[0])
    rt = JointAutoregressiveRuntime(module, device=device)
    rt.update()
    prepared = rt._g_prepared
    check(prepared.cdf is rt._g_tables_dev[0],
          'JAHP: update() did not prepare its Gaussian tables')
    n = len(images)
    # warm-up (cuBLAS/cuDNN handles, the schedule), then the timed runs
    rt.decode_device_latent(rt.encode_device_wire(images[0]))
    rt.decompress_latent(**rt.compress(images[0]))
    rt.timings.clear()
    # the earlier phases' garbage collected before the host coder is timed
    gc.collect()
    # host wire
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, sizes = [], []
    for x in images:
        comp, y_hat = rt.compress_latent(x)
        check(torch.equal(rt.decompress_latent(**comp), y_hat),
              'JAHP host wire: the round trip changed y_hat')
        sizes.append(len(pickle.dumps(comp)))
        host.append(y_hat)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # device wire
    kernels.reset_launches()
    handed, restore = prepared_calls(kernels, 'masked_encode_aligned')
    t0 = time.perf_counter()
    dev_sizes, enc_s = [], 0.0
    for x, y_host in zip(images, host):
        t1 = time.perf_counter()
        ops = rt.encode_device_wire(x)
        check(bool(ops['ok']), 'JAHP device wire: a symbol out of support')
        torch.cuda.synchronize()
        enc_s += time.perf_counter() - t1
        y_hat, valid = rt.decode_device_latent(ops)
        check(bool(valid), 'JAHP device wire: valid=False')
        check(torch.equal(y_hat, ops['y_hat']),
              'JAHP device wire: decoded y_hat differs from the encoder\'s')
        check(torch.equal(y_hat, y_host),
              'JAHP device wire: y_hat differs from the host path\'s')
        dev_sizes.append(int(ops['nbytes']))
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    restore()
    launches = dict(kernels.LAUNCHES)
    check(len(handed) == n and all(p is prepared for p in handed),
          'JAHP: the masked encoder was not handed the tables update() '
          'prepared on each image')
    sch = rt.schedule(*ops['shape'])
    want = {'rans_masked_encode_aligned': n,
            'rans_masked_decode_front': n * sch.steps,
            'rans_cyclic_encode_aligned': n, 'rans_cyclic_decode_aligned': n}
    check(launches == {k: want.get(k, 0) for k in kernels.ALL_KERNELS},
          f'JAHP device wire launched {launches}, expected {want}')
    with torch.no_grad():
        img = module.decode_image(y_hat)
    check(tuple(img.shape) == (1, 3, CODEC_HW, CODEC_HW)
          and bool(torch.isfinite(img).all()), 'JAHP: bad reconstruction')
    # every kernel of the path against its plain version, last image
    y, z_symbols, hyper = rt._encode_ops(images[-1])
    syms, idxs, _ = rt.forward_scan(y, hyper)
    vc, idx, _ = rt.masked_values(syms, idxs, sch)
    cdf, cdf_len, off = rt._g_tables_dev
    m = module.m
    got = kernels.masked_encode_aligned(cdf, vc, idx, sch.active, m,
                                        prepared=prepared)
    ref = td.masked_encode_plain(cdf, vc, idx, sch.active, m)
    errs = {'rans_masked_encode_aligned': max(
        int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
        for a, b in zip(got, ref))}
    zero_freq = masked_zero_frequency(torch, td, kernels, sch, m, device)
    errs['rans_masked_encode_aligned'] = max(
        errs['rans_masked_encode_aligned'], zero_freq[0])
    streams, lengths, states = got
    x_k = x_p = states
    err, mid = 0, sch.steps // 2
    for t in range(sch.steps):
        if t == mid:
            front = (t, x_k, idx[t])
        s_k, x_k = kernels.masked_decode_front(
            streams, t, x_k, cdf, cdf_len, off, idx[t], sch.active[t], m,
            prepared=prepared)
        s_p, x_p = td.masked_decode_front_plain(
            streams, t, x_p, cdf, cdf_len, off, idx[t], sch.active[t], m)
        err = max(err, int((s_k - s_p).abs().max()),
                  int((x_k - x_p).abs().max()))
    errs['rans_masked_decode_front'] = err
    check(bool((x_k == td.RANS_L).all()), 'masked decode: valid=False')
    zflat = z_symbols.permute(0, 2, 3, 1).reshape(-1)
    zkw = dict(num_lanes=rt._z_lanes(*z_symbols.shape[2:]),
               cyclic_channels=module.n, aligned=True)
    z_tables = (rt.codec.tables.quantized_cdf, rt.codec.tables.cdf_length,
                rt.codec.tables.offset)
    zk = td.device_rans_encode(zflat, *z_tables, **zkw)
    zp = td.device_rans_encode(zflat.cpu(), *z_tables, **zkw)
    errs['rans_cyclic_encode_aligned'] = max(
        int((zk[name].cpu() - zp[name]).abs().max())
        for name in ('streams', 'lengths', 'states'))
    dk = td.device_rans_decode(zk['streams'], zk['states'], *z_tables,
                               n_symbols=zflat.numel(), **zkw)
    dp = td.device_rans_decode(zp['streams'], zp['states'], *z_tables,
                               n_symbols=zflat.numel(), **zkw)
    check(bool(dk[1]) and bool(dp[1]), 'z decode: valid=False')
    errs['rans_cyclic_decode_aligned'] = int(
        (dk[0].cpu() - dp[0]).abs().max())
    check(torch.equal(dk[0].cpu(), zflat.cpu()), 'z decode lost symbols')
    for name, e in errs.items():
        check(e == 0, f'{name} differs from its plain version on the JAHP '
              f'path by {e}')
    # timings of the two masked kernels at the path's shapes
    t, x_t, idx_t = front
    g = rt.g_tables
    renorm = int(((td.masked_decode_front_plain(
        streams, t, x_t, cdf, cdf_len, off, idx_t, sch.active[t], m)[1]
        != x_t)).sum())
    specs = {
        'rans_masked_encode_aligned': (
            lambda: kernels.masked_encode_aligned(cdf, vc, idx, sch.active,
                                                  m, prepared=prepared),
            lambda: td.masked_encode_plain(cdf, vc, idx, sch.active, m),
            masked_costs(vc, idx, sch.active, m, g, False)),
        'rans_masked_decode_front': (
            lambda: kernels.masked_decode_front(
                streams, t, x_t, cdf, cdf_len, off, idx_t, sch.active[t], m,
                prepared=prepared),
            lambda: td.masked_decode_front_plain(
                streams, t, x_t, cdf, cdf_len, off, idx_t, sch.active[t], m),
            masked_costs(vc[t], idx_t, sch.active[t], m, g, True,
                         lengths=renorm)),
    }
    stats = {}
    for name, (kern, plain, (bound_ms, bound_by)) in specs.items():
        stats[name] = dict(
            ms=per_call_ms(torch, kern, reps=30),
            device_ms=device_ms(torch, kern, reps=100),
            plain_ms=per_call_ms(torch, plain, reps=3), bound_ms=bound_ms,
            bound_by=bound_by, max_abs_err=errs[name])
        log(f'phase 13: {name}: kernel {stats[name]["ms"]:.4f} ms per call '
            f'({stats[name]["device_ms"]:.4f} ms on the card), plain '
            f'{stats[name]["plain_ms"]:.3f} ms, bound {bound_ms:.6f} ms '
            f'({bound_by})')
    lanes = streams.shape[0]
    floor = device_ms(torch, lambda: kernels.launch_floor(lanes, device),
                      reps=100)
    for name in kernels.MASKED_KERNELS:
        stats[name]['launch_floor_ms'] = floor
    log(f'phase 13: launch floor of the masked kernels ({lanes} lanes, an '
        f'empty kernel on their grid): {floor:.4f} ms on the card; the '
        f'masked encoder equals its plain version on tables with '
        f'zero-frequency entries ({zero_freq[1]} active lanes coding one)')
    active = int(sch.active.sum()) * m
    log(f'phase 13: JAHP q1 (192, 192), {n} images of {CODEC_HW}x{CODEC_HW}: '
        f'y 16x16x192 on {sch.slots * m} masked lanes x {sch.steps} fronts '
        f'({active} symbols), z {"x".join(map(str, z_symbols.shape[2:]))}'
        f'x{module.n} on {zkw["num_lanes"]} cyclic lanes; host wire '
        f'{n / host_s:.2f} img/s (round trip), '
        f'{statistics.mean(sizes) / 1024:.6f} KB an image (pickled), host '
        f'coding ' + ', '.join(f'{k} {1e3 * v / n:.3f}'
                               for k, v in sorted(rt.timings.items()))
        + f' ms an image; device wire {n / dev_s:.2f} img/s (encode '
        f'{1e3 * enc_s / n:.2f} ms an image), '
        f'{statistics.mean(dev_sizes) / 1024:.6f} KB an image; valid, y_hat '
        f'equal to the host path\'s; launches {launches}')
    return launches, stats


def wrapper_phase(torch, kernels, td, device):
    """Phase 13: the input- and feature-compression wrappers at full
    width through the test CLI (PIL is on the machine: JPEG and WebP on
    the input, JPEG on the layer2 feature), the neural codecs q1 (FP and
    MSHP at 16 images, SHP at 4, each checked against the CPU on one
    image), then the JAHP's two wires. Returns the JAHP path's launches,
    the masked kernels' stats and the CLI runs' launches."""
    import tempfile
    from sc2bench_tpu_torch.models import zoo
    rng = np.random.default_rng(13)
    x256 = [torch.from_numpy(rng.normal(0, 1, (1, 3, CODEC_HW, CODEC_HW))
                             .astype(np.float32)).to(device)
            for _ in range(N_JAHP)]
    cli_launches, references = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for cfg, n in ((INPUT_CFG + 'jpeg-resnet50.yaml', N_CODEC),
                       (INPUT_CFG + 'webp-resnet50.yaml', N_CODEC_SMALL),
                       (FEATURE_CFG + 'jpeg-resnet50.yaml', N_CODEC)):
            codec_cli(torch, kernels, cfg, n, tmp, device)
            cli_launches.append(dict(kernels.LAUNCHES))
        for key, n in (('factorized_prior', N_CODEC),
                       ('mean_scale_hyperprior', N_CODEC),
                       ('scale_hyperprior', N_CODEC_SMALL)):
            torch.manual_seed(5)
            module = zoo.registry_get('model', key)(quality=1, device=device)
            codec_weights(torch, module, 5, x256[0])
            out = codec_cli(torch, kernels, f'{INPUT_CFG}{key}-resnet50.yaml',
                            n, tmp, device, codec=module)
            cli_launches.append(dict(kernels.LAUNCHES))
            references.append((key, out['engine'].wrapper.compression_model))
    launches, stats = jahp_phase(torch, kernels, td, x256)
    # the CPU references last: their thread pool would slow the timed
    # host coders above
    for key, rt in references:
        equal, total = codec_reference(torch, rt, rt.module, x256[0])
        log(f'phase 13: {key}: card vs CPU encoder on one 256 px image: '
            f'{equal} of {total} symbols and indexes equal (at most '
            f'{int(CARD_CPU_MISMATCH_SHARE * total)} may differ); the host '
            'round trip gives the decoder on the encoder\'s symbols')
    return launches, stats, cli_launches


# ---- phase 14: the RegNetY and hybrid-ViT students, EfficientNet-L2 -----

def build_student(torch, device, config, seed):
    """The student of `config` at full width, built by the registry on the
    card, with `build_model`'s seeded weights (He-normal convolutions, BN
    near identity, the last encoder conv halved); the other modules keep
    their seeded default init."""
    from sc2bench_tpu_torch.config import load_config
    from sc2bench_tpu_torch.models.registry import load_classification_model
    spec = load_config(os.path.join(REPO, config))['models']['student_model']
    torch.manual_seed(seed)
    model = load_classification_model(spec, device=device)
    randomize_weights(torch, model, seed, device)
    return halve_last_encoder_conv(torch, model)


def fp_serve(torch, kernels, rt, images, tag, name):
    """An FP student's deploy loop, batch 1 then `wire_batch`, launches
    counted in each run: the batch-1 pair once an image, the aligned pair
    once a group, no escape, equal sizes, logits within LOGIT_TOL; two
    images' wires equal to the plain coder on the same symbols and their
    logits equal to `forward_tail` on the decoded feature (as phase 3).
    Returns (batch-1 launches, wire_batch launches)."""
    from sc2bench_tpu_torch.analysis import get_binary_object_size
    from sc2bench_tpu_torch.ops.rans.device import (device_rans_encode,
                                                    pack_stream)
    rt.stream_deploy_device(images[:2])
    rt.stream_deploy_device(images[:WIRE_BATCH], wire_batch=WIRE_BATCH)
    runs = {}
    for wire_batch in (None, WIRE_BATCH):
        rt.clear_analysis()
        rt.activate_analysis()
        rt.escapes = {'ok': 0, 'valid': 0}
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = rt.stream_deploy_device(images, wire_batch=wire_batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[wire_batch] = dict(logits=logits, dt=dt,
                                launches=dict(kernels.LAUNCHES),
                                sizes=list(rt.analyzers[0].file_size_list),
                                summary=rt.summarize()[0],
                                escapes=dict(rt.escapes))
    b1, bk = runs[None], runs[WIRE_BATCH]
    n = len(images)
    groups = -(-n // WIRE_BATCH)
    want1 = expected_launches(kernels, FP_BATCH1, n)
    wantk = expected_launches(kernels, [k + '_aligned' for k in FP_BATCH1],
                              groups)
    check(b1['launches'] == want1, f'{name} batch 1 launched '
          f'{b1["launches"]}, expected {want1}')
    check(bk['launches'] == wantk, f'{name} wire_batch launched '
          f'{bk["launches"]}, expected {wantk}')
    for run in (b1, bk):
        check(run['escapes'] == {'ok': 0, 'valid': 0},
              f'{name}: images escaped: {run["escapes"]}')
        for lg in run['logits']:
            check(tuple(lg.shape) == (1, 1000)
                  and bool(torch.isfinite(lg).all()),
                  f'{name}: bad logits {tuple(lg.shape)}')
    check(bk['sizes'] == b1['sizes'] and bk['summary'] == b1['summary'],
          f'{name}: wire_batch sizes differ from batch 1')
    worst = max(float((a - b).abs().max())
                for a, b in zip(b1['logits'], bk['logits']))
    check(worst <= LOGIT_TOL, f'{name}: wire_batch logits differ by {worst}')
    cdf, cdf_len, off = (rt.codec.tables.quantized_cdf,
                         rt.codec.tables.cdf_length, rt.codec.tables.offset)
    for i in (0, n - 1):
        flat, shape = rt._symbols_nhwc(images[i])
        lanes = rt._auto_wire_lanes(shape)
        ref = device_rans_encode(flat.reshape(-1).cpu(), cdf, cdf_len, off,
                                 num_lanes=lanes, cyclic_channels=shape[-1])
        wire = rt._pull_device_wire(rt.encode_device_wire(images[i]))
        check(wire == pack_stream(ref), f'{name} image {i}: wire differs '
              'from the plain coder on the same symbols')
        check(b1['sizes'][i] == get_binary_object_size(
            {'strings': [[wire]], 'shape': shape[:2]}),
              f'{name} image {i}: accounted size differs from the wire')
        with torch.no_grad():
            direct = rt._decode_tail(flat, shape)
        check(torch.allclose(direct, b1['logits'][i], rtol=1e-5, atol=1e-5),
              f'{name} image {i}: served logits differ from forward_tail '
              'on the decoded feature')
    steps = -(-int(np.prod(shape)) // lanes)
    log(f'{tag}: {name} + FP-{shape[-1]}, {n} float 224x224 images: '
        f'latent {"x".join(map(str, shape))} on {lanes} cyclic lanes x '
        f'{steps} steps; batch 1 {n / b1["dt"]:.2f} img/s, wire_batch='
        f'{WIRE_BATCH} {n / bk["dt"]:.2f} img/s; data size {b1["summary"]} '
        f'(equal at both); max |logit diff| batch 1 vs wire_batch '
        f'{worst:.3e}; wires equal the plain coder, logits equal '
        f'forward_tail on the decoded feature; launches batch 1 '
        f'{b1["launches"]}, wire_batch {bk["launches"]}')
    return b1['launches'], bk['launches']


def backbone_kernels(torch, td, kernels, fp_tables, mshp_codec, device):
    """The rANS kernels at the 64-channel students' shapes, each against
    its plain version on the card: the four cyclic kernels at FP-64
    (55x55x64 on auto lanes, k = 1 and WIRE_BATCH), the four indexed ones
    at the MSHP y (55x55x64, the default Gaussian tables) and the cyclic
    pair on MSHP's z (14x14x16); timings at the FP-64 and MSHP-y shapes.
    Returns {kernel: stats}."""
    rng = np.random.default_rng(14)
    n = 55 * 55 * 64
    lanes = td.auto_lanes(n, cyclic_channels=64)
    fp = kernel_case(torch, td, kernels, fp_tables, lanes, n, WIRE_BATCH,
                     rng, device)
    g = mshp_codec.g_tables
    y_lanes = td.auto_lanes(n)
    prepared, _ = prepare_tables(torch, g, device, reps=0)
    y8 = indexed_case(torch, td, kernels, g, y_lanes, n, WIRE_BATCH, rng,
                      device, prepared)
    y1 = indexed_case(torch, td, kernels, g, y_lanes, n, 1, rng, device,
                      prepared)
    log_plans([y8, y1], tag='phase 14')
    zn = 14 * 14 * 16
    z_lanes = td.auto_lanes(zn, cyclic_channels=16)
    z = kernel_case(torch, td, kernels, mshp_codec.tables, z_lanes, zn,
                    WIRE_BATCH, rng, device)
    log(f'phase 14: kernels equal their plain versions at the 64-channel '
        f'shapes: cyclic FP-64 {lanes} lanes x {fp["steps"]} steps, indexed '
        f'MSHP y {y_lanes} lanes x {y8["steps"]} steps (k = 1 and '
        f'{WIRE_BATCH}), cyclic MSHP z {z_lanes} lanes x {z["steps"]} steps')
    stats = cyclic_stats(torch, td, kernels, fp, tag='phase 14')
    for name, st in stats.items():
        st['max_abs_err'] = max(st['max_abs_err'], z['errs'].get(name, 0))
    stats.update(indexed_stats(torch, td, kernels, g, y8, y1,
                               tag='phase 14'))
    return stats


def backbone_train(torch, kernels, model, family, kind):
    """The train-then-test CLI on a family's config at batch 32: stage 1
    and stage 2 two steps each (the tables built after stage 1), then 8
    test images on the device wire. Stage 1 must leave the frozen tail and
    every buffer as they were and move the encoder; stage 2 the encoder
    side and the density. Returns the test's launches."""
    import tempfile
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    config = BACKBONE_CONFIGS[family][kind]
    tag = f'{BACKBONE_NAMES[family]} {kind.upper()}'
    loaders = {'train_data_loader': synthetic_split(
        N_TRAIN, TRAIN_BATCH, seed=1000, shuffle=True, drop_last=True),
        'val_data_loader': synthetic_split(N_VAL, TRAIN_BATCH, seed=2000)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'student.ckpt')
        save_ckpt(ckpt, model.state_dict())
        run = train_cli(torch, kernels, config, {
            'allow_missing_teacher': True,
            'models': {'student_model': {'ckpt': ckpt}},
            'train': {**loaders,
                      'stage1': {'num_epochs': 1, 'epoch_to_update': 1},
                      'stage2': {'num_epochs': 1}},
            'test': {'test_data_loader': synthetic_split(N_E2E_TEST, 1,
                                                         seed=0)}},
            N_E2E_TEST)
    steps = N_TRAIN // TRAIN_BATCH
    got = [(r['name'], len(r['steps'])) for r in run['records']]
    check(got == [('stage1', steps), ('stage2', steps)],
          f'{tag}: stages and steps {got}')
    s0, s1 = run['records'][0]['student'], run['records'][1]['student']
    s2 = snapshot(run['engine'].student)
    teacher_moved = changed(run['records'][0]['teacher'],
                            snapshot(run['engine'].teacher),
                            run['records'][0]['teacher'])
    check(not teacher_moved, f'{tag}: teacher changed: {teacher_moved[:3]}')
    buffers = {k for k, _ in run['engine'].student.named_buffers()}
    frozen1 = [k for k in s0 if k.split('.')[0] in BACKBONE_TAILS[family]
               or k in buffers]
    moved = changed(s0, s1, frozen1)
    check(not moved, f'{tag}: stage 1 changed its frozen tail or a buffer: '
          f'{moved[:3]}')
    encoder = r'bottleneck_layer\.(encoder|g_a)\.'
    check(changed(s0, s1, [k for k in s0 if re.match(encoder, k)]),
          f'{tag}: stage 1 left the encoder unchanged')
    frozen2 = [k for k in s1 if re.match(
        r'bottleneck_layer\.(encoder|g_a|h_a|h_s)\.', k) or re.search(
        r'entropy_bottleneck\._(matrix|bias|factor)\d', k)]
    moved = changed(s1, s2, frozen2)
    check(not moved, f'{tag}: stage 2 changed the encoder side or the '
          f'density: {moved[:3]}')
    check(changed(s1, s2, [k for k in s1 if re.match(
        r'bottleneck_layer\.(decoder|g_s)\.', k)]),
          f'{tag}: stage 2 left the decoder unchanged')
    per_image = MSHP_BATCH1 if kind == 'mshp' else FP_BATCH1
    run['escapes'] = check_test_of_training(torch, kernels, run, N_E2E_TEST,
                                            tag, per_image=per_image)
    log_stages(run, tag, phase='phase 14')
    log(f'phase 14: {tag}: teacher unchanged; stage 1 left '
        f'{"/".join(BACKBONE_TAILS[family])} and every buffer as they were '
        'and moved the encoder; stage 2 left the encoder side and the '
        'density as they were and moved the decoder; test sizes equal a '
        'direct stream_deploy_device')
    return run['launches']


def l2_phase(torch, kernels, device):
    """EfficientNet-L2 (full width, random weights) behind JPEG and the
    MSHP codec q1 (`codec_weights`) through the test CLI on N_L2 synthetic
    475 px images. Returns the runs' launches."""
    import tempfile
    from sc2bench_tpu_torch.models import zoo
    from sc2bench_tpu_torch.models.efficientnet import EfficientNet
    rng = np.random.default_rng(15)
    x256 = torch.from_numpy(rng.normal(0, 1, (1, 3, CODEC_HW, CODEC_HW))
                            .astype(np.float32)).to(device)
    launches = []
    with tempfile.TemporaryDirectory() as tmp:
        for cfg in L2_CONFIGS:
            module = None
            if cfg.startswith('mean_scale_hyperprior'):
                torch.manual_seed(5)
                module = zoo.registry_get('model', 'mean_scale_hyperprior')(
                    quality=1, device=device)
                codec_weights(torch, module, 5, x256)
            torch.cuda.reset_peak_memory_stats()
            out = codec_cli(torch, kernels, INPUT_CFG + cfg, N_L2, tmp,
                            device, codec=module, hw=L2_HW, phase='phase 14')
            launches.append(dict(kernels.LAUNCHES))
            model = out['engine'].wrapper.classifier
            count = sum(p.numel() for p in model.parameters())
            check(isinstance(model, EfficientNet) and count == L2_PARAMS,
                  f'{cfg}: the classifier is not EfficientNet-L2')
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f'phase 14: {cfg}: EfficientNet-L2 ({count} parameters,'
                f' {sum(len(st) for st in model.blocks)} blocks) on the card;'
                f' peak memory {peak:.3f} GiB')
            del out, model
            gc.collect()
            torch.cuda.empty_cache()
    return launches


def backbone_phase(torch, td, kernels, device, images):
    """Phase 14: the RegNetY-6.4GF and hybrid-ViT students at full width
    (FP and MSHP with the configs' 64-channel bottlenecks, seeded
    weights): serving on both wires, the kernels at their shapes, the
    test CLI on each config, two steps of each stage of the RegNet MSHP
    and hybrid-ViT FP configs; then EfficientNet-L2 behind JPEG and MSHP.
    Returns ({path: launches}, kernel stats at the 64-channel shapes)."""
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    paths, stats = {}, {}
    for family in ('regnet', 'hybrid_vit'):
        name = BACKBONE_NAMES[family]
        fp = build_student(torch, device, BACKBONE_CONFIGS[family]['fp'], 0)
        rt = SplitClassifierRuntime(fp, device=device)
        rt.update()
        rt.eval()
        mshp = spread_mshp_scales(torch, build_student(
            torch, device, BACKBONE_CONFIGS[family]['mshp'], 1), images[0],
            median=MSHP64_MEDIAN_SCALE)
        rt_m = SplitClassifierRuntime(mshp, device=device)
        rt_m.update()
        rt_m.eval()
        (hy, wy, cy), (hz, wz, cz) = rt_m._latent_shape((1, 3, HW, HW))
        log(f'phase 14: {name}: FP-64 student '
            f'{sum(p.numel() for p in fp.parameters())} parameters, MSHP-64 '
            f'{sum(p.numel() for p in mshp.parameters())}; MSHP y {hy}x{wy}x'
            f'{cy} on {rt_m._default_lanes((1, 3, HW, HW))} lanes, z {hz}x'
            f'{wz}x{cz}')
        paths[f'{family}_fp_batch1'], paths[f'{family}_fp_wire_batch'] = \
            fp_serve(torch, kernels, rt, images[:N_BACKBONE], 'phase 14',
                     name)
        paths[f'{family}_mshp_batch1'], paths[f'{family}_mshp_wire_batch'] = \
            mshp_serve_phase(torch, kernels, rt_m, images[:N_BACKBONE_MSHP],
                             phase='phase 14', label=f'{name} + MSHP-64/16')
        if family == 'regnet':
            stats = backbone_kernels(torch, td, kernels, rt.codec.tables,
                                     rt_m.codec, device)
        for kind, model, per_image in (('fp', fp, FP_BATCH1),
                                       ('mshp', mshp, MSHP_BATCH1)):
            paths[f'{family}_{kind}_cli'] = cli_phase(
                torch, kernels, model, config=BACKBONE_CONFIGS[family][kind],
                per_image=per_image, tag=f'phase 14 ({name} {kind.upper()})',
                n=N_BACKBONE_CLI)
        kind, model = ('mshp', mshp) if family == 'regnet' else ('fp', fp)
        paths[f'{family}_{kind}_train'] = backbone_train(
            torch, kernels, model, family, kind)
        del rt, rt_m, fp, mshp, model
        gc.collect()
        torch.cuda.empty_cache()
    for cfg, counts in zip(L2_CONFIGS, l2_phase(torch, kernels, device)):
        paths[f'l2_{cfg.split("-")[0]}_cli'] = counts
    return paths, stats


# ---- phase 15: PASCAL VOC segmentation (DeepLabv3-ResNet-50 + FP-24) -------

def seg_split(n, batch, seed, hw=SEG_HW, **extra):
    """A loader config of `n` synthetic hw images and masks of 21
    classes."""
    return {'dataset': {'key': 'SyntheticSegmentationDataset',
                        'kwargs': {'num_samples': n, 'image_size': list(hw),
                                   'num_classes': SEG_CLASSES, 'seed': seed}},
            'batch_size': batch, **extra}


def seg_images(torch, n, device, hw=SEG_HW, seed=0):
    """The images of `seg_split(n, 1, seed, hw)`, NCHW on `device`."""
    from sc2bench_tpu_torch.datasets.voc import SyntheticSegmentationDataset
    data = SyntheticSegmentationDataset(num_samples=n, image_size=hw,
                                        num_classes=SEG_CLASSES, seed=seed)
    return [torch.from_numpy(np.ascontiguousarray(
        data[i][0].transpose(2, 0, 1)[None])).to(device) for i in range(n)]


def build_seg_student(torch, device, seed=0):
    """The `-fp-beta0.16` config's student (DeepLabv3-ResNet-50 + FP-24
    with the aux head) at full width on the card, with `build_model`'s
    seeded weights and halved last encoder conv."""
    from sc2bench_tpu_torch.config import load_config
    from sc2bench_tpu_torch.models.segmentation.registry import \
        load_segmentation_model
    spec = load_config(os.path.join(REPO, SEG_ES_CONFIG))['models'][
        'student_model']
    torch.manual_seed(seed)
    model = load_segmentation_model({**spec, 'ckpt': None}, device=device)
    randomize_weights(torch, model, seed, device)
    halve_last_encoder_conv(torch, model.backbone)
    return model


def seg_serve(torch, kernels, rt, images, voc):
    """The segmentation deploy loop: `images` (512x512) on the device wire
    at batch 1 and `wire_batch`, the first N_SEG_HOST on the host wire,
    and `voc` (500x375) at batch 1; each run's launches counted from 0.
    Checks: the batch-1 pair once an image, the aligned pair once a group,
    nothing on the host wire, no escape, equal sizes at batch 1 and
    `wire_batch`, logits of every run within LOGIT_TOL of batch 1; for
    three images the wire equals the plain coder on the same symbols and
    the logits equal the direct decode -> tail -> head -> upsampling.
    Returns {run: launches}."""
    from sc2bench_tpu_torch.analysis import get_binary_object_size
    from sc2bench_tpu_torch.ops.rans.device import (device_rans_encode,
                                                    pack_stream)
    rt.stream_deploy_device(images[:1])
    rt.stream_deploy_device(images[:WIRE_BATCH], wire_batch=WIRE_BATCH)
    rt.stream_deploy(images[:1])
    rt.stream_deploy_device(voc[:1])
    runs = {}
    for name, fn, xs, kw in (
            ('batch1', rt.stream_deploy_device, images, {}),
            ('wire_batch', rt.stream_deploy_device, images,
             {'wire_batch': WIRE_BATCH}),
            ('host', rt.stream_deploy, images[:N_SEG_HOST], {}),
            ('voc', rt.stream_deploy_device, voc, {})):
        rt.clear_analysis()
        rt.activate_analysis()
        rt.escapes = {'ok': 0, 'valid': 0}
        timings = {}
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(xs, timings=timings, **kw)
        torch.cuda.synchronize()
        runs[name] = dict(out=out, dt=time.perf_counter() - t0,
                          launches=dict(kernels.LAUNCHES), timings=timings,
                          sizes=list(rt.analyzers[0].file_size_list),
                          summary=rt.summarize()[0],
                          escapes=dict(rt.escapes), n=len(xs))
    n, groups = len(images), -(-len(images) // WIRE_BATCH)
    aligned = [k + '_aligned' for k in FP_BATCH1]
    for name, want in (
            ('batch1', expected_launches(kernels, FP_BATCH1, n)),
            ('wire_batch', expected_launches(kernels, aligned, groups)),
            ('host', expected_launches(kernels, (), 0)),
            ('voc', expected_launches(kernels, FP_BATCH1, len(voc)))):
        run = runs[name]
        check(run['launches'] == want, f'segmentation {name} launched '
              f'{run["launches"]}, expected {want}')
        check(run['escapes'] == {'ok': 0, 'valid': 0},
              f'segmentation {name}: images escaped: {run["escapes"]}')
        hw = (voc if name == 'voc' else images)[0].shape[-2:]
        for lg in run['out']:
            check(tuple(lg.shape) == (1, SEG_CLASSES, *hw)
                  and bool(torch.isfinite(lg).all()),
                  f'segmentation {name}: bad logits {tuple(lg.shape)}')
    b1, bk = runs['batch1'], runs['wire_batch']
    check(bk['sizes'] == b1['sizes'] and bk['summary'] == b1['summary'],
          'segmentation wire_batch sizes differ from batch 1')
    worst = {name: max(float((a - b).abs().max()) for a, b in zip(
        b1['out'], runs[name]['out'])) for name in ('wire_batch', 'host')}
    for name, w in worst.items():
        check(w <= LOGIT_TOL, f'segmentation {name} logits differ from '
              f'batch 1 by {w}')
    t = rt.codec.tables
    shapes = {}
    for x, run, i in ((images[0], b1, 0), (images[-1], b1, n - 1),
                      (voc[0], runs['voc'], 0)):
        flat, shape = rt._symbols_nhwc(x)
        lanes = rt._auto_wire_lanes(shape)
        shapes[tuple(x.shape[-2:])] = (shape, lanes)
        ref = device_rans_encode(flat.reshape(-1).cpu(), t.quantized_cdf,
                                 t.cdf_length, t.offset, num_lanes=lanes,
                                 cyclic_channels=shape[-1])
        wire = rt._pull_device_wire(rt.encode_device_wire(x))
        check(wire == pack_stream(ref), f'segmentation {tuple(x.shape)}: '
              'wire differs from the plain coder on the same symbols')
        check(run['sizes'][i] == get_binary_object_size(
            {'strings': [[wire]], 'shape': shape[:2]}),
              'segmentation: accounted size differs from the packed wire')
        with torch.no_grad():
            direct = rt._decode_tail(flat, shape, tuple(x.shape[-2:]))
        check(torch.allclose(direct, run['out'][i], rtol=1e-5, atol=1e-5),
              'segmentation: served logits differ from the decode -> tail '
              '-> head -> upsampling on the encoder\'s symbols')
    for hw, (shape, lanes) in shapes.items():
        log(f'phase 15: {hw[0]}x{hw[1]} image: latent '
            f'{"x".join(map(str, shape))} = {int(np.prod(shape))} symbols on '
            f'{lanes} cyclic lanes x {-(-int(np.prod(shape)) // lanes)} '
            'steps')
    for name, run in runs.items():
        log(f'phase 15: DeepLabv3-ResNet-50 + FP-24, {name}, {run["n"]} '
            f'images: {run["n"] / run["dt"]:.2f} img/s; data size '
            f'{run["summary"]}; launches {run["launches"]}; host ms an '
            'image: ' + ', '.join(f'{k} {1e3 * v / run["n"]:.3f}'
                                  for k, v in sorted(run['timings'].items())))
    log(f'phase 15: wires equal the plain coder; logits equal the direct '
        f'decode -> tail -> head -> upsampling; max |logit diff| vs batch 1: '
        f'wire_batch {worst["wire_batch"]:.3e}, host {worst["host"]:.3e}')
    return {f'seg_{name}': run['launches'] for name, run in runs.items()}


def seg_kernels(torch, td, kernels, rt, device):
    """The four cyclic kernels at the segmentation shapes, against their
    plain versions on the card: 127x127x24 (512x512) on its auto lanes at
    k = 1 and WIRE_BATCH, 93x124x24 (500x375) at k = 2; timings at the
    512x512 shape. Returns {kernel: stats}."""
    rng = np.random.default_rng(15)
    cases = []
    for (h, w), k in ((SEG_HW, WIRE_BATCH), (SEG_VOC_HW, 2)):
        shape = rt._latent_shape((1, 3, h, w))
        n = int(np.prod(shape))
        lanes = rt._auto_wire_lanes(shape)
        cases.append(kernel_case(torch, td, kernels, rt.codec.tables, lanes,
                                 n, k, rng, device))
        log(f'phase 15: kernels equal their plain versions at the '
            f'{h}x{w} latent ({n} symbols, {lanes} lanes x '
            f'{cases[-1]["steps"]} steps, k=1 and {k})')
    stats = cyclic_stats(torch, td, kernels, cases[0], tag='phase 15')
    for name, st in stats.items():
        st['max_abs_err'] = max(c['errs'].get(name, 0) for c in cases)
    return stats


def seg_cli_phase(torch, kernels, model):
    """The segmentation test CLI on the `-fp-beta0.16` config, N_SEG_CLI
    images of 512x512, the host wire then the device wire: every image
    accounted, the device wire's launches once an image, no escape, its
    sizes equal a direct `stream_deploy_device`, the two wires' mIoU within
    1e-3. Returns the device-wire run's launches."""
    import tempfile
    from sc2bench_tpu_torch.tasks.semantic_segmentation import main as cli
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    n = N_SEG_CLI
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'student.ckpt')
        save_ckpt(ckpt, model.state_dict())
        over = {'models': {'student_model': {'ckpt': ckpt}},
                'test': {'test_data_loader': seg_split(n, 1, seed=0)}}
        for wire in ('host', 'device'):
            args = ['--config', os.path.join(REPO, SEG_ES_CONFIG), '--json',
                    json.dumps({**over, 'deploy_wire': wire}), '-test_only']
            if wire == 'device':
                args.append('-student_only')
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = cli(args)
            runs[wire] = dict(out, wall=time.perf_counter() - t0,
                              launches=dict(kernels.LAUNCHES))
    host, dev = runs['host'], runs['device']
    rt = dev['engine'].runtime
    check(all(v == 0 for v in host['launches'].values()),
          f'segmentation CLI host wire launched {host["launches"]}')
    want = expected_launches(kernels, FP_BATCH1, n)
    check(dev['launches'] == want, f'segmentation CLI device wire launched '
          f'{dev["launches"]}, expected {want}')
    check(rt.escapes == {'ok': 0, 'valid': 0},
          f'segmentation CLI images escaped: {rt.escapes}')
    for wire, run in runs.items():
        check(run['summaries'][0]['num_samples'] == n
              and 0.0 <= run['result']['miou'] <= 1.0,
              f'segmentation CLI {wire} wire: {run["result"]}, '
              f'{run["summaries"]}')
    gap = abs(host['result']['miou'] - dev['result']['miou'])
    check(gap <= 1e-3, f'segmentation CLI wires\' mIoU differ by {gap}')
    sizes = list(rt.analyzers[0].file_size_list)
    rt.clear_analysis()
    rt.stream_deploy_device(seg_images(torch, n, rt.device))
    check(list(rt.analyzers[0].file_size_list) == sizes,
          'segmentation CLI sizes differ from a direct stream_deploy_device')
    for wire, run in runs.items():
        res = run['result']
        log(f'phase 15: CLI {os.path.basename(SEG_ES_CONFIG)}, {wire} wire,'
            f' {n} images of 512x512: mIoU {res["miou"]:.6f}, global acc '
            f'{res["acc_global"]:.6f}, data size {run["summaries"][0]}, '
            f'model_time {res["model_time"]:.6f} s '
            f'({1 / res["model_time"]:.2f} img/s); CLI wall '
            f'{run["wall"]:.2f} s')
    log(f'phase 15: CLI teacher (random weights) mIoU '
        f'{host["teacher"]["miou"]:.6f}; device wire launches '
        f'{dev["launches"]}, escapes {rt.escapes}, sizes equal a direct '
        'stream_deploy_device')
    return dev['launches']


def log_seg_stages(run, tag):
    for rec in run['records']:
        steps = rec['steps']
        for i, (loss, _, _) in enumerate(steps):
            check(all(np.isfinite(v) for v in loss.values()),
                  f'{tag} {rec["name"]} step {i}: loss {loss}')
        later = steps[1:]
        rate = sum(n for _, _, n in later) / sum(t for _, t, _ in later)
        log(f'phase 15: {tag} {rec["name"]}: {len(steps)} steps of '
            f'{steps[0][2]} images of 512x512; loss detail, first step '
            f'{steps[0][0]}, last {steps[-1][0]}; {rate:.2f} img/s over '
            f'steps 2-{len(steps)} (first step {steps[0][1]:.3f} s); peak '
            f'memory {rec["peak"] / 2 ** 30:.3f} GiB')
    res = run['result']
    log(f'phase 15: {tag} test, device wire: mIoU {res["miou"]:.6f}, data '
        f'size {run["summaries"][0]}, launches {run["launches"]}; CLI wall '
        f'{run["wall"]:.2f} s')


def seg_train_phase(torch, kernels, model):
    """Two steps of each stage of the `-fp-beta0.16` config (batch 16) and
    of the end-to-end config (batch 8), 512x512, through the CLI, then 4
    test images on the device wire. Stage 1 must leave the encoder, the
    density, layer3, layer4 and every buffer as they were and move the
    decoder; stage 2 the encoder and the density, and move the decoder
    and the aux head; the teacher never changes. Returns the launches of
    the two tests."""
    import tempfile
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    val = seg_split(2, 1, seed=2000)
    test = {'test_data_loader': seg_split(N_SEG_SMALL, 1, seed=0)}
    with tempfile.TemporaryDirectory() as tmp:
        state = model.state_dict()
        ckpts = {}
        for name, keep in (('es', state), ('e2e', {
                k: v for k, v in state.items()
                if not k.startswith('aux_classifier.')})):
            ckpts[name] = os.path.join(tmp, f'{name}.ckpt')
            save_ckpt(ckpts[name], keep)
        es = train_cli(torch, kernels, SEG_ES_CONFIG, {
            'models': {'student_model': {'ckpt': ckpts['es']}},
            'train': {'train_data_loader': seg_split(
                2 * SEG_ES_BATCH, SEG_ES_BATCH, seed=1000, shuffle=True,
                drop_last=True), 'val_data_loader': val,
                'stage1': {'num_epochs': 1}, 'stage2': {'num_epochs': 1}},
            'test': test}, N_SEG_SMALL, segmentation=True)
        e2e = train_cli(torch, kernels, SEG_E2E_CONFIG, {
            'models': {'model': {'ckpt': ckpts['e2e']}},
            'train': {'train_data_loader': seg_split(
                2 * SEG_E2E_BATCH, SEG_E2E_BATCH, seed=1000, shuffle=True,
                drop_last=True), 'val_data_loader': val, 'num_epochs': 1},
            'test': test}, N_SEG_SMALL, segmentation=True)
    for tag, run, want in (('entropic student', es,
                            [('stage1', 2), ('stage2', 2)]),
                           ('end-to-end', e2e, [('train', 2)])):
        got = [(r['name'], len(r['steps'])) for r in run['records']]
        check(got == want, f'segmentation {tag}: stages and steps {got}')
    s0, s1 = es['records'][0]['student'], es['records'][1]['student']
    s2 = snapshot(es['engine'].student)
    moved = changed(es['records'][0]['teacher'],
                    snapshot(es['engine'].teacher),
                    es['records'][0]['teacher'])
    check(not moved, f'segmentation teacher changed: {moved[:3]}')
    buffers = {k for k, _ in es['engine'].student.named_buffers()}
    encoder = r'backbone\.bottleneck_layer\.encoder\.'
    density = r'backbone\.bottleneck_layer\.entropy_bottleneck\._(matrix|' \
        r'bias|factor)\d'
    frozen1 = [k for k in s0 if re.match(
        encoder + '|' + density + r'|backbone\.layer[34]\.', k)
        or k in buffers]
    moved = changed(s0, s1, frozen1)
    check(not moved, f'segmentation stage 1 changed a frozen tensor or a '
          f'buffer: {moved[:3]}')
    decoder = [k for k in s0 if '.decoder.' in k and k not in buffers]
    check(changed(s0, s1, decoder), 'segmentation stage 1 left the decoder '
          'unchanged')
    moved = changed(s1, s2, [k for k in s1
                             if re.match(encoder + '|' + density, k)])
    check(not moved, f'segmentation stage 2 changed the encoder or the '
          f'density: {moved[:3]}')
    check(changed(s1, s2, decoder) and changed(s1, s2, [
        k for k in s1 if k.startswith('aux_classifier.')]),
          'segmentation stage 2 left the decoder or the aux head unchanged')
    for tag, run in (('entropic student', es), ('end-to-end', e2e)):
        rt = run['engine'].runtime
        check(rt.bottleneck_updated, f'segmentation {tag}: no tables')
        want = expected_launches(kernels, FP_BATCH1, N_SEG_SMALL)
        check(run['launches'] == want, f'segmentation {tag} test launched '
              f'{run["launches"]}, expected {want}')
        check(rt.escapes['valid'] == 0, f'segmentation {tag}: valid=False')
        sizes = list(rt.analyzers[0].file_size_list)
        rt.clear_analysis()
        rt.stream_deploy_device(run['images'])
        check(list(rt.analyzers[0].file_size_list) == sizes,
              f'segmentation {tag}: CLI sizes differ from a direct '
              'stream_deploy_device')
        log_seg_stages(run, tag)
    log('phase 15: teacher unchanged; stage 1 left the encoder, the '
        'density, layer3-4 and every buffer as they were and moved the '
        'decoder; stage 2 left the encoder and the density and moved the '
        'decoder and the aux head; test sizes equal a direct '
        'stream_deploy_device')
    return [es['launches'], e2e['launches']]


def seg_cli_small(torch, kernels, config, tmp, device, codec=None):
    """The segmentation test CLI on a wrapper or CR+BQ config at full
    width (random weights; a neural codec's from `codec`, saved as the
    config's codec ckpt), N_SEG_SMALL images of 512x512: no kernel
    launched, every image accounted (none for CR+BQ, which has no
    bitstream), mIoU in [0, 1]. Returns the launches."""
    from sc2bench_tpu_torch.tasks.semantic_segmentation import main as cli
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    n = N_SEG_SMALL
    over = {'test': {'test_data_loader': seg_split(n, 1, seed=0)}}
    if codec is not None:
        ckpt = os.path.join(tmp, os.path.basename(config) + '.ckpt')
        save_ckpt(ckpt, codec.state_dict())
        over['models'] = {'wrapper': {'compression_model': {'ckpt': ckpt}}}
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = cli(['--config', os.path.join(REPO, config), '--json',
               json.dumps(over), '-test_only', '-student_only'])
    wall = time.perf_counter() - t0
    tag = os.path.basename(config)
    check(all(v == 0 for v in kernels.LAUNCHES.values()),
          f'{tag}: launched {dict(kernels.LAUNCHES)}')
    summary, res = out['summaries'][0], out['result']
    bq = out['engine'].wrapper is None
    check(summary['num_samples'] == (0 if bq else n),
          f'{tag}: data size {summary}')
    check(0.0 <= res['miou'] <= 1.0, f'{tag}: result {res}')
    rt = getattr(out['engine'].wrapper, 'compression_model', None)
    host = '' if rt is None else ', host coding ' + ', '.join(
        f'{k} {1e3 * v / n:.3f}' for k, v in sorted(rt.timings.items())) \
        + ' ms an image'
    log(f'phase 15: CLI {tag}: {n} images of 512x512, mIoU '
        f'{res["miou"]:.6f}, global acc {res["acc_global"]:.6f}, data size '
        f'{summary}, {1 / res["model_time"]:.2f} img/s (model_time '
        f'{res["model_time"]:.6f} s){host}; CLI wall {wall:.2f} s')
    return dict(kernels.LAUNCHES)


def seg_phase(torch, td, kernels, device):
    """Phase 15: DeepLabv3-ResNet-50 + FP-24 at full width: serving on
    both wires at 512x512 and 500x375, the cyclic kernels at those shapes,
    the test CLI on both wires, two training steps a stage of the Entropic
    Student and end-to-end configs, then the JPEG/ResNet-101, MSHP-codec
    and CR+BQ configs through the CLI. Returns ({path: launches}, kernel
    stats at the 512x512 shape)."""
    import tempfile
    from sc2bench_tpu_torch.models import zoo
    from sc2bench_tpu_torch.models.segmentation.wrapper import \
        SplitSegmentationRuntime
    model = build_seg_student(torch, device)
    rt = SplitSegmentationRuntime(model, device=device)
    rt.update()
    rt.eval()
    log(f'phase 15: DeepLabv3-ResNet-50 + FP-24 (aux head), '
        f'{sum(p.numel() for p in model.parameters())} parameters')
    images = seg_images(torch, N_SEG, device)
    voc = seg_images(torch, N_SEG_VOC, device, hw=SEG_VOC_HW, seed=100)
    paths = seg_serve(torch, kernels, rt, images, voc)
    stats = seg_kernels(torch, td, kernels, rt, device)
    paths['seg_cli'] = seg_cli_phase(torch, kernels, model)
    train = seg_train_phase(torch, kernels, model)
    paths['seg_train_es'], paths['seg_train_e2e'] = train
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for cfg in SEG_SMALL_CONFIGS:
            codec = None
            if cfg.split('/')[-1].startswith('mean_scale_hyperprior'):
                torch.manual_seed(5)
                codec = zoo.registry_get('model', 'mean_scale_hyperprior')(
                    quality=1, device=device)
                codec_weights(torch, codec, 5, images[0])
            paths[f'seg_{os.path.basename(cfg)}'] = seg_cli_small(
                torch, kernels, cfg, tmp, device, codec=codec)
    for name, counts in paths.items():
        log(f'phase 15: launches on {name}: ' + ', '.join(
            f'{k} {v}' for k, v in counts.items() if v))
    return paths, stats


# ---- phase 16: COCO detection (Faster R-CNN R50-FPN + FP-24) ---------------

def det_split(n, batch, seed, hw=DET_LAND, **extra):
    """A loader config of `n` synthetic images of `hw` with 1-5 boxes of
    the 91 COCO labels."""
    return {'dataset': {'key': 'SyntheticDetectionDataset',
                        'kwargs': {'num_samples': n, 'image_size': list(hw),
                                   'num_classes': DET_CLASSES,
                                   'seed': seed}},
            'batch_size': batch, **extra}


def det_canvases(torch, n, device, hw=DET_LAND, seed=0):
    """The images of `det_split(n, 1, seed, hw)` resized and padded as the
    engine does (the configs' 800/1344 canvas buckets), NCHW on
    `device`."""
    from sc2bench_tpu_torch.datasets.coco import SyntheticDetectionDataset
    from sc2bench_tpu_torch.models.detection.transform import RCNNTransform
    data = SyntheticDetectionDataset(num_samples=n, image_size=hw,
                                     num_classes=DET_CLASSES, seed=seed)
    transform = RCNNTransform(min_size=800, max_size=DET_SQUARE[0][0],
                              canvas_buckets=True)
    return [torch.from_numpy(np.ascontiguousarray(
        transform([data[i][0]])[0].transpose(0, 3, 1, 2))).to(device)
        for i in range(n)]


def build_det_student(torch, device, seed=0):
    """The `-fp-beta0.08` config's student (Faster R-CNN R50-FPN + FP-24,
    91 classes) at full width on the card: `build_model`'s seeded weights
    and halved last encoder conv, and the RPN and box predictors
    initialized as torchvision initializes them (normal with std 0.01,
    0.01 and 0.001, zero biases)."""
    from sc2bench_tpu_torch.config import load_config
    from sc2bench_tpu_torch.models.detection.registry import \
        load_detection_model
    spec = load_config(os.path.join(REPO, DET_ES_CONFIG))['models'][
        'student_model']
    torch.manual_seed(seed)
    model = load_detection_model({**spec, 'ckpt': None}, device=device)
    randomize_weights(torch, model, seed, device)
    halve_last_encoder_conv(torch, model.backbone.body)
    gen = torch.Generator(device='cpu').manual_seed(seed + 1)
    heads = ((model.rpn.head.cls_logits, 0.01),
             (model.rpn.head.bbox_pred, 0.01),
             (model.roi_heads.box_predictor.cls_score, 0.01),
             (model.roi_heads.box_predictor.bbox_pred, 0.001))
    with torch.no_grad():
        for layer, std in heads:
            layer.weight.copy_(torch.randn(layer.weight.shape,
                                           generator=gen).to(device) * std)
            layer.bias.zero_()
    return model


def det_mismatch(a, b):
    """(share of the slots whose label or validity differ, largest
    |score| and |box| difference over the other slots) of two images'
    detections."""
    same = (a['labels'] == b['labels']) & (a['valid'] == b['valid'])
    share = 1.0 - float(same.float().mean())
    if not bool(same.any()):
        return share, 0.0
    return share, max(float((a['scores'] - b['scores'])[same].abs().max()),
                      float((a['boxes'] - b['boxes'])[same].abs().max()))


def det_serve(torch, kernels, rt, images):
    """The detection deploy loop: `images` on the device wire at batch 1
    and `wire_batch=DET_WIRE_BATCH` (groups of one canvas), the first
    N_DET_HOST on the host wire; each run's launches counted from 0.
    Checks: the batch-1 pair once an image (the latent fits the batch-1
    kernels), the aligned pair once a group, nothing on the host wire, no
    escape, equal sizes at batch 1 and `wire_batch`, detections of the
    fixed shape and finite; for three images the wire equals the plain
    coder on the same symbols and the detections equal the direct decode
    -> tail -> postprocess; the other runs' detections agree with batch
    1's (float sums differ at a batch of 4). Returns {run: launches}."""
    from sc2bench_tpu_torch.analysis import get_binary_object_size
    from sc2bench_tpu_torch.ops.rans.device import (device_rans_encode,
                                                    pack_stream)
    rt.stream_detect_device(images[:1])
    rt.stream_detect_device(images[-1:])
    rt.stream_detect_device(images[:DET_WIRE_BATCH],
                            wire_batch=DET_WIRE_BATCH)
    rt.stream_detect(images[:1])
    runs = {}
    for name, fn, xs, kw in (
            ('batch1', rt.stream_detect_device, images, {}),
            ('wire_batch', rt.stream_detect_device, images,
             {'wire_batch': DET_WIRE_BATCH}),
            ('host', rt.stream_detect, images[:N_DET_HOST], {})):
        rt.clear_analysis()
        rt.activate_analysis()
        rt.escapes = {'ok': 0, 'valid': 0}
        timings = {}
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(xs, timings=timings, **kw)
        torch.cuda.synchronize()
        runs[name] = dict(out=out, dt=time.perf_counter() - t0,
                          launches=dict(kernels.LAUNCHES), timings=timings,
                          sizes=list(rt.analyzers[0].file_size_list),
                          summary=rt.summarize()[0],
                          escapes=dict(rt.escapes), n=len(xs))
    shapes = {}
    for x in images:
        shape = rt._latent_shape(x.shape)
        lanes = rt._auto_wire_lanes(shape)
        steps = -(-int(np.prod(shape)) // lanes)
        check(kernels.batch1_fits(steps, x.device),
              f'detection latent {shape}: {steps} steps beyond the batch-1 '
              'kernels')
        shapes[tuple(x.shape[-2:])] = (shape, lanes, steps)
    groups = -(-N_DET_LAND // DET_WIRE_BATCH) \
        + -(-N_DET_PORT // DET_WIRE_BATCH)
    aligned = [k + '_aligned' for k in FP_BATCH1]
    for name, want in (
            ('batch1', expected_launches(kernels, FP_BATCH1, len(images))),
            ('wire_batch', expected_launches(kernels, aligned, groups)),
            ('host', expected_launches(kernels, (), 0))):
        run = runs[name]
        check(run['launches'] == want, f'detection {name} launched '
              f'{run["launches"]}, expected {want}')
        check(run['escapes'] == {'ok': 0, 'valid': 0},
              f'detection {name}: images escaped: {run["escapes"]}')
        for det in run['out']:
            check(tuple(det['boxes'].shape) == (1, 100, 4)
                  and bool(torch.isfinite(det['boxes']).all())
                  and bool(torch.isfinite(det['scores']).all()),
                  f'detection {name}: bad detections '
                  f'{tuple(det["boxes"].shape)}')
    b1, bk = runs['batch1'], runs['wire_batch']
    check(bk['sizes'] == b1['sizes'] and bk['summary'] == b1['summary'],
          'detection wire_batch sizes differ from batch 1')
    worst = {}
    for name in ('wire_batch', 'host'):
        diffs = [det_mismatch(a, b) for a, b in zip(b1['out'],
                                                    runs[name]['out'])]
        worst[name] = (max(d[0] for d in diffs), max(d[1] for d in diffs))
        check(worst[name][0] <= 0.05 and worst[name][1] <= 1e-2,
              f'detection {name} differs from batch 1: {worst[name]}')
    t = rt.codec.tables
    n = len(images)
    for i in (0, N_DET_LAND - 1, n - 1):
        x = images[i]
        flat, shape = rt._symbols_nhwc(x)
        lanes = rt._auto_wire_lanes(shape)
        ref = device_rans_encode(flat.reshape(-1).cpu(), t.quantized_cdf,
                                 t.cdf_length, t.offset, num_lanes=lanes,
                                 cyclic_channels=shape[-1])
        wire = rt._pull_device_wire(rt.encode_device_wire(x))
        check(wire == pack_stream(ref), f'detection {tuple(x.shape)}: wire '
              'differs from the plain coder on the same symbols')
        check(b1['sizes'][i] == get_binary_object_size(
            {'strings': [[wire]], 'shape': shape[:2]}),
              'detection: accounted size differs from the packed wire')
        with torch.no_grad():
            direct = rt._decode_tail(flat, shape, tuple(x.shape[-2:]))
        share, diff = det_mismatch(direct, b1['out'][i])
        check(share == 0.0 and diff <= 1e-4, 'detection: served detections '
              'differ from the decode -> tail -> postprocess on the '
              f"encoder's symbols ({share}, {diff})")
    for hw, (shape, lanes, steps) in shapes.items():
        log(f'phase 16: {hw[0]}x{hw[1]} canvas: latent '
            f'{"x".join(map(str, shape))} = {int(np.prod(shape))} symbols on '
            f'{lanes} cyclic lanes x {steps} steps')
    for name, run in runs.items():
        valid = sum(int(d['valid'].sum()) for d in run['out'])
        log(f'phase 16: Faster R-CNN R50-FPN + FP-24, {name}, {run["n"]} '
            f'images: {run["n"] / run["dt"]:.2f} img/s; data size '
            f'{run["summary"]}; valid detections {valid}; launches '
            f'{run["launches"]}; host ms an image: ' + ', '.join(
                f'{k} {1e3 * v / run["n"]:.3f}'
                for k, v in sorted(run['timings'].items())))
    log('phase 16: wires equal the plain coder; detections equal the direct '
        'decode -> tail -> postprocess; vs batch 1 (share of slots '
        'differing, largest score/box difference elsewhere): ' + ', '.join(
            f'{k} {v[0]:.4f} / {v[1]:.3e}' for k, v in worst.items()))
    return {f'det_{name}': run['launches'] for name, run in runs.items()}


def det_kernels(torch, td, kernels, rt, land_hw, device):
    """The four cyclic kernels at the detection shapes, against their
    plain versions on the card: the landscape canvas's latent (800x1344:
    199x335x24 on 3,072 lanes x 521 steps) at k = 1 and DET_WIRE_BATCH,
    the square canvas's (1344x1344: 335x335x24, 3,072 x 877) at k = 1
    and 2; timings at the landscape shape. Returns {kernel: stats}."""
    rng = np.random.default_rng(16)
    side = max(land_hw)
    cases = []
    for hw, k in ((land_hw, DET_WIRE_BATCH), ((side, side), 2)):
        shape = rt._latent_shape((1, 3, *hw))
        n = int(np.prod(shape))
        lanes = rt._auto_wire_lanes(shape)
        cases.append(kernel_case(torch, td, kernels, rt.codec.tables, lanes,
                                 n, k, rng, device))
        log(f'phase 16: kernels equal their plain versions at the '
            f'{"x".join(map(str, shape))} latent ({n} symbols, {lanes} '
            f'lanes x {cases[-1]["steps"]} steps, k=1 and {k})')
    stats = cyclic_stats(torch, td, kernels, cases[0], tag='phase 16')
    for name, st in stats.items():
        st['max_abs_err'] = max(c['errs'].get(name, 0) for c in cases)
    return stats


def det_cli_phase(torch, kernels, model):
    """The detection test CLI on the `-fp-beta0.08` config, N_DET_CLI
    images of 480x640, the host wire (with the teacher's metrics) then the
    device wire: every image accounted, the device wire's launches once an
    image, no escape, its sizes equal a direct `stream_detect_device`, the
    two wires' mAP within 1e-3. Returns the device-wire run's launches."""
    import tempfile
    from sc2bench_tpu_torch.tasks.object_detection import main as cli
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    n = N_DET_CLI
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'student.ckpt')
        save_ckpt(ckpt, model.state_dict())
        over = {'models': {'student_model': {'ckpt': ckpt}},
                'test': {'test_data_loader': det_split(n, 1, seed=0)}}
        for wire in ('host', 'device'):
            args = ['--config', os.path.join(REPO, DET_ES_CONFIG), '--json',
                    json.dumps({**over, 'deploy_wire': wire}), '-test_only']
            if wire == 'device':
                args.append('-student_only')
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = cli(args)
            runs[wire] = dict(out, wall=time.perf_counter() - t0,
                              launches=dict(kernels.LAUNCHES))
    host, dev = runs['host'], runs['device']
    rt = dev['engine'].runtime
    check(all(v == 0 for v in host['launches'].values()),
          f'detection CLI host wire launched {host["launches"]}')
    want = expected_launches(kernels, FP_BATCH1, n)
    check(dev['launches'] == want, f'detection CLI device wire launched '
          f'{dev["launches"]}, expected {want}')
    check(rt.escapes == {'ok': 0, 'valid': 0},
          f'detection CLI images escaped: {rt.escapes}')
    for wire, run in runs.items():
        check(run['summaries'][0]['num_samples'] == n
              and -1.0 <= run['result']['AP'] <= 1.0,
              f'detection CLI {wire} wire: {run["result"]}, '
              f'{run["summaries"]}')
    gap = abs(host['result']['AP'] - dev['result']['AP'])
    check(gap <= 1e-3, f'detection CLI wires\' mAP differ by {gap}')
    sizes = list(rt.analyzers[0].file_size_list)
    rt.clear_analysis()
    rt.stream_detect_device(det_canvases(torch, n, rt.device))
    check(list(rt.analyzers[0].file_size_list) == sizes,
          'detection CLI sizes differ from a direct stream_detect_device')
    for wire, run in runs.items():
        res = run['result']
        log(f'phase 16: CLI {os.path.basename(DET_ES_CONFIG)}, {wire} wire, '
            f'{n} images of 480x640: mAP {res["AP"]:.6f}, AP50 '
            f'{res["AP50"]:.6f}, data size {run["summaries"][0]}, '
            f'model_time {res["model_time"]:.6f} s '
            f'({1 / res["model_time"]:.2f} img/s); CLI wall '
            f'{run["wall"]:.2f} s')
    log(f'phase 16: CLI teacher (random weights) mAP '
        f'{host["teacher"]["AP"]:.6f}; device wire launches '
        f'{dev["launches"]}, escapes {rt.escapes}, sizes equal a direct '
        'stream_detect_device')
    return dev['launches']


def det_train_cli(torch, kernels, config, over, n_test):
    """One train-then-test run of the detection CLI on the device wire;
    returns its output, the stage records, the launches of its test and
    the test canvases."""
    import sc2bench_tpu_torch.train.det_engine as engine_module
    from sc2bench_tpu_torch.tasks.object_detection import main as cli
    records = []
    base = engine_module.DetectionBox
    try:
        engine_module.DetectionBox = recording(torch, base, records)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = cli(['--config', os.path.join(REPO, config), '--json',
                   json.dumps({**over, 'deploy_wire': 'device'}),
                   '-student_only'])
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        engine_module.DetectionBox = base
    return dict(out, wall=wall, launches=launches, records=records)


def det_train_phase(torch, kernels, model):
    """Two steps of each stage of the `-fp-beta0.08` config and of the
    end-to-end config at batch DET_BATCH on the 1344x1344 canvas, through
    the CLI, then N_DET_SMALL test images on the device wire. Stage 1
    (hints only) must leave the encoder, the density, the FPN, the heads
    and every buffer as they were and move the decoder and layer2-4;
    stage 2 the encoder and the density, and move the decoder and the
    heads; the teacher never changes. Returns the launches of the two
    tests."""
    import tempfile
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    val = det_split(2, 1, seed=2000)
    test = {'test_data_loader': det_split(N_DET_SMALL, 1, seed=0)}
    train = det_split(2 * DET_BATCH, DET_BATCH, seed=1000, shuffle=True,
                      drop_last=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'student.ckpt')
        save_ckpt(ckpt, model.state_dict())
        common = {'canvas_buckets': DET_SQUARE, 'test': test}
        es = det_train_cli(torch, kernels, DET_ES_CONFIG, {
            **common, 'models': {'student_model': {'ckpt': ckpt}},
            'train': {'train_data_loader': train, 'val_data_loader': val,
                      'stage1': {'num_epochs': 1},
                      'stage2': {'num_epochs': 1}}}, N_DET_SMALL)
        e2e = det_train_cli(torch, kernels, DET_E2E_CONFIG, {
            **common, 'models': {'model': {'ckpt': ckpt}},
            'train': {'train_data_loader': train, 'val_data_loader': val,
                      'num_epochs': 1}}, N_DET_SMALL)
    for tag, run, want in (('entropic student', es,
                            [('stage1', 2), ('stage2', 2)]),
                           ('end-to-end', e2e, [('train', 2)])):
        got = [(r['name'], len(r['steps'])) for r in run['records']]
        check(got == want, f'detection {tag}: stages and steps {got}')
    s0, s1 = es['records'][0]['student'], es['records'][1]['student']
    s2 = snapshot(es['engine'].student)
    moved = changed(es['records'][0]['teacher'],
                    snapshot(es['engine'].teacher),
                    es['records'][0]['teacher'])
    check(not moved, f'detection teacher changed: {moved[:3]}')
    buffers = {k for k, _ in es['engine'].student.named_buffers()}
    bneck = r'backbone\.body\.bottleneck_layer\.'
    encoder = bneck + r'encoder\.'
    density = bneck + r'entropy_bottleneck\._(matrix|bias|factor)\d'
    heads = r'backbone\.fpn\.|rpn\.|roi_heads\.'
    frozen1 = [k for k in s0 if re.match(
        '|'.join((encoder, density, heads)), k) or k in buffers]
    moved = changed(s0, s1, frozen1)
    check(not moved, f'detection stage 1 changed a frozen tensor, a head or '
          f'a buffer: {moved[:3]}')
    decoder = [k for k in s0 if '.decoder.' in k and k not in buffers]
    tail = [k for k in s0 if re.match(r'backbone\.body\.layer[234]\.', k)
            and k not in buffers]
    check(changed(s0, s1, decoder) and changed(s0, s1, tail),
          'detection stage 1 left the decoder or layer2-4 unchanged')
    moved = changed(s1, s2, [k for k in s1
                             if re.match(encoder + '|' + density, k)])
    check(not moved, f'detection stage 2 changed the encoder or the '
          f'density: {moved[:3]}')
    check(changed(s1, s2, decoder) and changed(s1, s2, [
        k for k in s1 if re.match(heads, k)]),
          'detection stage 2 left the decoder or the heads unchanged')
    for tag, run in (('entropic student', es), ('end-to-end', e2e)):
        rt = run['engine'].runtime
        want = expected_launches(kernels, FP_BATCH1, N_DET_SMALL)
        check(run['launches'] == want, f'detection {tag} test launched '
              f'{run["launches"]}, expected {want}')
        check(rt.escapes['valid'] == 0, f'detection {tag}: valid=False')
        check(run['summaries'][0]['num_samples'] == N_DET_SMALL,
              f'detection {tag}: summary {run["summaries"]}')
        for rec in run['records']:
            steps = rec['steps']
            for i, (loss, _, _) in enumerate(steps):
                check(all(np.isfinite(v) for v in loss.values()),
                      f'detection {tag} {rec["name"]} step {i}: {loss}')
            log(f'phase 16: {tag} {rec["name"]}: {len(steps)} steps of '
                f'{steps[0][2]} images on the 1344x1344 canvas; loss '
                f'detail, first step {steps[0][0]}, last {steps[-1][0]}; '
                f'{steps[-1][2] / steps[-1][1]:.2f} img/s at step '
                f'{len(steps)} (first step {steps[0][1]:.3f} s); peak '
                f'memory {rec["peak"] / 2 ** 30:.3f} GiB')
        res = run['result']
        log(f'phase 16: {tag} test, device wire: mAP {res["AP"]:.6f}, data '
            f'size {run["summaries"][0]}, launches {run["launches"]}; CLI '
            f'wall {run["wall"]:.2f} s')
    log('phase 16: teacher unchanged; stage 1 left the encoder, the '
        'density, the FPN, the heads and every buffer as they were and '
        'moved the decoder and layer2-4; stage 2 left the encoder and the '
        'density and moved the decoder and the heads')
    return [es['launches'], e2e['launches']]


def det_bq_cli(torch, kernels):
    """The detection test CLI on the `ghnd-bq` bq12ch config at full width
    (random weights), N_DET_BQ images of 480x640: no kernel launched,
    nothing accounted (no bitstream), mAP in range. Returns the
    launches."""
    from sc2bench_tpu_torch.tasks.object_detection import main as cli
    over = {'test': {'test_data_loader': det_split(N_DET_BQ, 1, seed=0)}}
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = cli(['--config', os.path.join(REPO, DET_BQ_CONFIG), '--json',
               json.dumps(over), '-test_only', '-student_only'])
    wall = time.perf_counter() - t0
    tag = os.path.basename(DET_BQ_CONFIG)
    check(all(v == 0 for v in kernels.LAUNCHES.values()),
          f'{tag}: launched {dict(kernels.LAUNCHES)}')
    summary, res = out['summaries'][0], out['result']
    check(summary['num_samples'] == 0, f'{tag}: data size {summary}')
    check(-1.0 <= res['AP'] <= 1.0, f'{tag}: result {res}')
    log(f'phase 16: CLI {tag}: {N_DET_BQ} images of 480x640, mAP '
        f'{res["AP"]:.6f}, data size {summary}, '
        f'{1 / res["model_time"]:.2f} img/s (model_time '
        f'{res["model_time"]:.6f} s); CLI wall {wall:.2f} s')
    return dict(kernels.LAUNCHES)


def det_phase(torch, td, kernels, device):
    """Phase 16: Faster R-CNN R50-FPN + FP-24 at full width: serving on
    both wires at the 800x1344 and 1344x800 canvases, the cyclic kernels
    at the detection shapes, the test CLI on both wires, two training
    steps a stage of the Entropic Student and end-to-end configs, then the
    CR+BQ config through the CLI. Returns ({path: launches}, kernel stats
    at 3,072 x 521)."""
    from sc2bench_tpu_torch.models.detection.wrapper import \
        SplitDetectionRuntime
    model = build_det_student(torch, device)
    rt = SplitDetectionRuntime(model, device=device)
    rt.update()
    rt.eval()
    log(f'phase 16: Faster R-CNN R50-FPN + FP-24 (91 classes), '
        f'{sum(p.numel() for p in model.parameters())} parameters')
    images = det_canvases(torch, N_DET_LAND, device) + det_canvases(
        torch, N_DET_PORT, device, hw=DET_PORT, seed=100)
    paths = det_serve(torch, kernels, rt, images)
    stats = det_kernels(torch, td, kernels, rt, tuple(images[0].shape[-2:]),
                        device)
    paths['det_cli'] = det_cli_phase(torch, kernels, model)
    paths['det_train_es'], paths['det_train_e2e'] = det_train_phase(
        torch, kernels, model)
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    paths['det_bq_cli'] = det_bq_cli(torch, kernels)
    for name, counts in paths.items():
        log(f'phase 16: launches on {name}: ' + ', '.join(
            f'{k} {v}' for k, v in counts.items() if v))
    return paths, stats


# ---- phase 17: COCO input compression before Faster R-CNN -----------------

def det_ic_phase(torch, kernels, device):
    """Phase 17: each runnable COCO input-compression config through the
    detection CLI at full width on `N_DET_IC` synthetic 480x640 images
    (the detector with its fresh weights, as in JAX; a neural codec's
    `codec_weights` saved as its ckpt). Checks: every image accounted with
    a positive size, the 12 metrics in range, no kernel launched (host
    coders). Returns each config's {'AP', 'KB', 'model_time', 'wall'}."""
    import tempfile
    from sc2bench_tpu_torch.models import zoo
    from sc2bench_tpu_torch.tasks.object_detection import main as cli
    from sc2bench_tpu_torch.utils.ckpt import save_ckpt
    calib = torch.rand((1, 3, CODEC_HW, CODEC_HW),
                       generator=torch.Generator().manual_seed(17)).to(device)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key in DET_IC_CODECS:
            config = f'{DET_IC}{key}-faster_rcnn_resnet50_fpn.yaml'
            over = {'test': {'test_data_loader': det_split(N_DET_IC, 1,
                                                          seed=17)}}
            if key not in ('jpeg', 'webp'):
                torch.manual_seed(17)
                module = zoo.registry_get('model', key)(quality=1,
                                                        device=device)
                codec_weights(torch, module, 17, calib)
                ckpt = os.path.join(tmp, key + '.ckpt')
                save_ckpt(ckpt, module.state_dict())
                over['models'] = {'wrapper': {'compression_model': {
                    'ckpt': ckpt}}}
                del module
            kernels.reset_launches()
            t0 = time.perf_counter()
            run = cli(['--config', os.path.join(REPO, config), '--json',
                       json.dumps(over), '-test_only'])
            wall = time.perf_counter() - t0
            check(all(v == 0 for v in kernels.LAUNCHES.values()),
                  f'{config}: launched {dict(kernels.LAUNCHES)}')
            summary, res = run['summaries'][0], run['result']
            check(summary['num_samples'] == N_DET_IC and summary['mean'] > 0,
                  f'{config}: data size {summary}')
            check(all(-1.0 <= res[k] <= 1.0 for k in ('AP', 'AP50', 'AR_100')),
                  f'{config}: result {res}')
            rt = getattr(run['engine'].wrapper.transform, 'compression_model',
                         None)
            host = '' if rt is None else ', host coding ' + ', '.join(
                f'{k} {1e3 * v / N_DET_IC:.3f}'
                for k, v in sorted(rt.timings.items())) + ' ms an image'
            log(f'phase 17: {config}: {N_DET_IC} images of 480x640 on the '
                f'1344x1344 canvas, mAP {res["AP"]:.6f} (AP50 '
                f'{res["AP50"]:.6f}), {summary["mean"]:.6f} KB an image '
                f'(std {summary["std"]:.6f}), {1 / res["model_time"]:.2f} '
                f'img/s (model_time {res["model_time"]:.6f} s){host}; CLI '
                f'wall {wall:.2f} s')
            out[key] = {'AP': res['AP'], 'KB': summary['mean'],
                        'model_time': res['model_time'], 'wall': wall}
            del run
            gc.collect()
    return out


# ---- phase 18: the bfloat16 options, dtype and the bench ---------------------

def _top1(outputs):
    return [int(o.argmax()) for o in outputs]


def _serve_rate(torch, fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, n / (time.perf_counter() - t0)


def _encoder_symbols(torch, rt, x, module):
    """Flat symbols of every latent `module`'s encoder sends for `x`."""
    if rt.hyper:
        ops = rt._hyper_ops(x, rt._split_bottleneck(module))
        return torch.cat([ops[k].reshape(-1)
                          for k in ('y_symbols', 'z_symbols')])
    return rt._symbols_nhwc(x, module)[0].reshape(-1)


def bf16_runtime_phase(torch, kernels, model, tag, images):
    """Phase 18 on one model: the float32 runtime against
    `deploy_bf16_decode` (batch 1 and `wire_batch`), `deploy_bf16_tail`
    (host wire) and `deploy_bf16_encode` (with the bf16 decode), each on
    `images`, every run from 0 launches. Returns the launches of the
    bfloat16 device-wire runs."""
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    n = len(images)

    def runtime(**options):
        rt = SplitClassifierRuntime(model, device=images[0].device,
                                    **options)
        rt.update()
        rt.eval()
        rt.activate_analysis()
        return rt

    rt32, rt16 = runtime(), runtime(deploy_bf16_decode=True)
    rtt = runtime(deploy_bf16_tail=True)
    rte = runtime(deploy_bf16_decode=True, deploy_bf16_encode=True)
    launches = dict.fromkeys(kernels.ALL_KERNELS, 0)
    for wire_batch in (None, WIRE_BATCH):
        runs = {}
        for name, rt in (('f32', rt32), ('bf16_decode', rt16),
                         ('bf16_encode', rte)):
            rt.stream_deploy_device(images[:WIRE_BATCH],
                                    wire_batch=wire_batch)      # warm
            rt.clear_analysis()
            rt.escapes = {'ok': 0, 'valid': 0}
            kernels.reset_launches()
            out, ips = _serve_rate(torch, lambda: rt.stream_deploy_device(
                images, wire_batch=wire_batch), n)
            if name != 'f32':
                for k, v in kernels.LAUNCHES.items():
                    launches[k] += v
            check(rt.escapes == {'ok': 0, 'valid': 0},
                  f'{tag} {name} wire_batch={wire_batch}: escapes '
                  f'{rt.escapes}')
            runs[name] = (out, list(rt.analyzers[0].file_size_list), ips)
        (o32, s32, ips32), (o16, s16, ips16), (oe, se, ipse) = (
            runs['f32'], runs['bf16_decode'], runs['bf16_encode'])
        check(s16 == s32, f'{tag} bf16_decode wire_batch={wire_batch}: '
              f'sizes {s16} differ from float32 {s32}')
        agree = sum(a == b for a, b in zip(_top1(o32), _top1(o16)))
        check(agree >= BF16_TOP1, f'{tag} bf16_decode: top-1 agrees on '
              f'{agree} of {n}')
        check(all(o.dtype == torch.float32 for o in o16),
              f'{tag} bf16_decode: logits not float32')
        drift = abs(sum(se) - sum(s32)) / sum(s32)
        check(drift <= 1e-3, f'{tag} bf16_encode: wire size {sum(se)} KB '
              f'against {sum(s32)} KB (drift {drift:.2e})')
        agree_e = sum(a == b for a, b in zip(_top1(o32), _top1(oe)))
        log(f'phase 18: {tag} device wire, wire_batch={wire_batch}, {n} '
            f'images: img/s float32 {ips32:.2f}, bf16_decode {ips16:.2f}, '
            f'bf16_encode {ipse:.2f}; bf16_decode sizes equal, top-1 '
            f'{agree}/{n}; bf16_encode wire drift {drift:.3e}, top-1 '
            f'{agree_e}/{n}')
    moved = total = 0
    for x in images:
        a = _encoder_symbols(torch, rte, x, rte._encode_module())
        b = _encoder_symbols(torch, rt32, x, rt32.module)
        d = (a - b).abs()
        check(int(d.max()) <= 1, f'{tag} bf16_encode: a symbol moved by '
              f'{int(d.max())}')
        moved += int((d > 0).sum())
        total += d.numel()
    check(moved <= 0.01 * total, f'{tag} bf16_encode: {moved} of {total} '
          'symbols moved')
    for name, rt in (('f32', rt32), ('bf16_tail', rtt)):
        rt.stream_deploy(images[:2])
        rt.clear_analysis()
    o32, ips32 = _serve_rate(torch, lambda: rt32.stream_deploy(images), n)
    ot, ipst = _serve_rate(torch, lambda: rtt.stream_deploy(images), n)
    s32 = list(rt32.analyzers[0].file_size_list)
    st = list(rtt.analyzers[0].file_size_list)
    check(st == s32, f'{tag} bf16_tail: sizes {st} differ from {s32}')
    agree = sum(a == b for a, b in zip(_top1(o32), _top1(ot)))
    check(agree >= BF16_TOP1, f'{tag} bf16_tail: top-1 agrees on {agree} '
          f'of {n}')
    log(f'phase 18: {tag} bf16_encode: {moved} of {total} symbols '
        f'({moved / total:.4%}) one step from the float32 encoder\'s, each '
        f'stream decoded exactly (valid, no escape); host wire img/s float32 '
        f'{ips32:.2f}, bf16_tail {ipst:.2f}, sizes equal, top-1 '
        f'{agree}/{n}')
    return launches


def bf16_dense_phase(torch, device):
    """DeepLabv3-ResNet-50 + FP-24 (512x512) and Faster R-CNN R50-FPN +
    FP-24 (the 800x1344 canvas) at `dtype='bfloat16'` beside float32 on
    the same seeded weights, one image each: float32 finite outputs, the
    agreement, img/s of 8 forwards."""
    from sc2bench_tpu_torch.config import load_config
    from sc2bench_tpu_torch.models.detection.rcnn import \
        postprocess_detections
    from sc2bench_tpu_torch.models.detection.registry import \
        load_detection_model
    from sc2bench_tpu_torch.models.segmentation.registry import \
        load_segmentation_model
    seg_spec = load_config(os.path.join(REPO, SEG_ES_CONFIG))['models'][
        'student_model']
    det_spec = load_config(os.path.join(REPO, DET_ES_CONFIG))['models'][
        'student_model']
    x_seg = torch.from_numpy(np.random.default_rng(18).normal(
        0, 1, (1, 3, *SEG_HW)).astype(np.float32)).to(device)
    x_det = det_canvases(torch, 1, device, seed=18)[0]
    for name, spec, load, x in (
            ('DeepLabv3', seg_spec, load_segmentation_model, x_seg),
            ('Faster R-CNN', det_spec, load_detection_model, x_det)):
        models = {}
        for dtype in ('float32', 'bfloat16'):
            torch.manual_seed(18)
            m = load({**spec, 'ckpt': None, 'kwargs': {
                **spec.get('kwargs', {}), 'dtype': dtype}}, device=device)
            randomize_weights(torch, m, 18, device)
            models[dtype] = m.eval()
        outs, rates = {}, {}
        for dtype, m in models.items():
            with torch.no_grad():
                fwd = (lambda m=m: m(x, mode='finetune')) \
                    if name == 'DeepLabv3' else \
                    (lambda m=m: postprocess_detections(m(x, mode='finetune')))
                fwd()
                outs[dtype], rates[dtype] = _serve_rate(
                    torch, lambda: [fwd() for _ in range(8)][-1], 8)
        if name == 'DeepLabv3':
            a, b = outs['float32']['out'], outs['bfloat16']['out']
            check(b.dtype == torch.float32 and bool(torch.isfinite(b).all()),
                  'DeepLabv3 bfloat16: logits not finite float32')
            agree = float((a.argmax(1) == b.argmax(1)).float().mean())
            what = f'{agree:.4f} of pixels agree'
        else:
            a, b = outs['float32'], outs['bfloat16']
            check(b['boxes'].dtype == torch.float32
                  and bool(torch.isfinite(b['boxes']).all()),
                  'Faster R-CNN bfloat16: boxes not finite float32')
            agree = float((a['labels'] == b['labels']).float().mean())
            what = (f'{int(b["valid"].sum())} valid detections (float32 '
                    f'{int(a["valid"].sum())}), {agree:.4f} of the label '
                    'slots agree')
        log(f'phase 18: {name} dtype=bfloat16 on {tuple(x.shape[-2:])}: '
            f'{what}; img/s float32 {rates["float32"]:.2f}, bfloat16 '
            f'{rates["bfloat16"]:.2f} (8 forwards)')
        del models, outs
        gc.collect()
        torch.cuda.empty_cache()


def bench_phase(torch, kernels):
    """`sc2bench_tpu_torch.bench` in this process with short loops: its
    JSON line (printed by it on a line of its own), the MFU fields
    present and below 1, the launches of its run."""
    from sc2bench_tpu_torch import bench
    kernels.reset_launches()
    line = bench.main(BENCH_ARGS)
    launches = dict(kernels.LAUNCHES)
    for k in ('deploy_device_mfu_vs_bf16_peak',
              'throughput_device_mfu_vs_bf16_peak',
              'throughput_bf16enc_mfu_vs_bf16_peak',
              'train_mfu_vs_bf16_peak'):
        check(line[k] is not None and 0 < line[k] < 1,
              f'bench: {k} = {line[k]}')
    check(line['device_wire_rans_backend'] == 'cuda',
          f'bench: backend {line["device_wire_rans_backend"]}')
    log(f'phase 18: bench (short loops) launched ' + ', '.join(
        f'{k} {v}' for k, v in launches.items() if v))
    return launches


def bf16_phase(torch, kernels, model, mshp, images, device):
    """Phase 18: the bfloat16 runtime options on FP and MSHP, the dense
    models' `dtype`, and the bench. Returns the launches of the
    bfloat16 device-wire runs and of the bench."""
    fp = bf16_runtime_phase(torch, kernels, model, 'FP-24',
                            images[:N_BF16])
    hyper = bf16_runtime_phase(torch, kernels, mshp, 'MSHP',
                               images[:N_BF16])
    bf16_dense_phase(torch, device)
    wire = {k: fp[k] + hyper[k] for k in fp}
    return wire, bench_phase(torch, kernels)


def smi_query(fields):
    out = subprocess.run(
        ['nvidia-smi', '--id=0', f'--query-gpu={fields}',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip()


def run():
    try:
        import torch
    except ImportError as e:
        raise SmokeFailure(f'PyTorch is not installed: {e}') from e
    check(torch.cuda.is_available(), 'no CUDA device is available')
    check(os.path.isdir(os.path.join(REPO, 'sc2bench_tpu_torch')),
          f'{REPO} is not a checkout of the repository '
          '(sc2bench_tpu_torch/ is missing)')
    sys.path.insert(0, REPO)
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    from sc2bench_tpu_torch.ops.rans import device as td
    from sc2bench_tpu_torch.ops.rans import kernels
    device = torch.device('cuda', 0)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    libs = kernels.build_libraries()
    log(f'phase 1: built ' + ', '.join(os.path.relpath(lib, REPO)
                                      for lib in libs)
        + f' in {time.perf_counter() - t0:.1f} s (one nvcc per source, '
        'started together)')
    for lib in libs:
        with open(str(lib)[:-3] + '.log') as f:
            for line in f:
                if 'registers' in line or 'spill' in line:
                    log(f'  ptxas ({os.path.basename(lib)}): '
                        + line.strip())

    model = build_model(torch, device, seed=0)
    rt = SplitClassifierRuntime(model, device=device)
    rt.update()
    rt.eval()
    rt_u8 = SplitClassifierRuntime(model, input_norm=NORM, device=device)
    rt_u8.update()
    rt_u8.eval()
    tables = rt.codec.tables
    log(f'model: ResNet-50 + FP-24, latent {rt._latent_shape((1, 3, HW, HW))}'
        f', tables {tables.quantized_cdf.shape}')
    rng = np.random.default_rng(2024)
    images = [torch.from_numpy(rng.normal(0, 1, (1, 3, HW, HW))
                               .astype(np.float32)).to(device)
              for _ in range(N_FLOAT)]
    images_u8 = [torch.from_numpy(rng.integers(0, 256, (1, 3, HW, HW),
                                               dtype=np.uint8)).to(device)
                 for _ in range(N_UINT8)]
    mshp = spread_mshp_scales(torch, build_model(
        torch, device, seed=1, key='MSHPBasedResNetBottleneck'), images[0])
    rt_m = SplitClassifierRuntime(mshp, device=device)
    rt_m.update()
    rt_m.eval()
    log(f'model: ResNet-50 + MSHP-24/256/16, latents '
        f'{rt_m._latent_shape((1, 3, HW, HW))}, y on '
        f'{rt_m._default_lanes((1, 3, HW, HW))} lanes, Gaussian tables '
        f'{rt_m.codec.g_tables.quantized_cdf.shape}, bottleneck parameters '
        f'{sum(p.numel() for p in mshp.bottleneck_layer.parameters())}')

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log(f'{name}: done in {time.perf_counter() - t0:.1f} s')
        return out

    # ---- phase 2 ----
    stats = timed('phase 2 (cyclic)', kernel_phase, torch, td, kernels,
                  tables, device)
    stats.update(timed('phase 2 (indexed)', indexed_phase, torch, td,
                       kernels, rt_m.codec.g_tables, device))

    # ---- phases 3 and 4 ----
    launches = timed('phases 3-4', main_path, torch, kernels, rt, rt_u8,
                     images, images_u8)

    # ---- phase 5 ----
    timed('phase 5', escape_phase, torch, rt, images)

    # ---- phase 6 ----
    cli_launches = timed('phase 6', cli_phase, torch, kernels, model)

    # ---- phase 7 ----
    train_launches, e2e_launches = timed('phase 7', train_phase, torch,
                                         kernels, model)

    # ---- phase 8: the batch-1 wire beyond the batch-1 kernels' limit ----
    timed('phase 8', big_image_phase, torch, kernels, rt)

    # ---- phase 9: MSHP serving ----
    mshp_b1, mshp_bk = timed('phase 9', mshp_serve_phase, torch, kernels,
                             rt_m, images)

    # ---- phase 10: MSHP test CLI and training ----
    mshp_cli = timed('phase 10 (CLI)', cli_phase, torch, kernels, mshp,
                     config=MSHP_CONFIG, per_image=MSHP_BATCH1,
                     tag='phase 10')
    mshp_train = timed('phase 10 (training)', mshp_train_phase, torch,
                       kernels, mshp)

    # ---- phase 11: fine-tuning serving at every split, host wire ----
    ft_serve = timed('phase 11', finetune_serve_phase, torch, kernels,
                     images[:N_FT])

    # ---- phase 12: the CLI on both families, the SplitClassifier ----
    ft_cli, bq_cli, bq_wrap = timed('phase 12', bq_phase, torch, kernels)
    new_paths = list(ft_serve.values()) + [ft_cli, bq_cli, bq_wrap]

    # ---- phase 13: the input- and feature-compression wrappers ----
    jahp, masked_stats, codec_clis = timed('phase 13', wrapper_phase, torch,
                                           kernels, td, device)
    stats.update(masked_stats)

    # ---- phase 14: RegNetY and hybrid-ViT students, EfficientNet-L2 ----
    backbone_paths, backbone_stats = timed('phase 14', backbone_phase, torch,
                                           td, kernels, device, images)
    for name, counts in backbone_paths.items():
        log(f'phase 14: launches on {name}: ' + ', '.join(
            f'{k} {v}' for k, v in counts.items() if v))

    # ---- phase 15: PASCAL VOC segmentation ----
    seg_paths, seg_stats = timed('phase 15', seg_phase, torch, td, kernels,
                                 device)

    # ---- phase 16: COCO detection ----
    det_paths, det_stats = timed('phase 16', det_phase, torch, td, kernels,
                                 device)

    # ---- phase 17: COCO input compression before Faster R-CNN ----
    timed('phase 17', det_ic_phase, torch, kernels, device)

    # ---- phase 18: the bfloat16 options, dtype and the bench ----
    bf16_wire, bench_launches = timed('phase 18', bf16_phase, torch, kernels,
                                      model, mshp, images, device)

    # ---- phase 19: the kernels line ----

    rows = []
    for name in kernels.ALL_KERNELS:
        indexed = name in kernels.INDEXED_KERNELS
        masked = name in kernels.MASKED_KERNELS
        aligned = name.endswith('_aligned')
        main = jahp if masked else (mshp_bk if aligned else mshp_b1) \
            if indexed else launches
        row = dict(name=name, route='cuda',
                   source=SOURCES['cyclic' if name in kernels.KERNELS
                                  else 'indexed'],
                   replaces=REPLACES[name], launches=main[name],
                   max_abs_err=stats[name]['max_abs_err'],
                   ms=stats[name]['ms'], device_ms=stats[name]['device_ms'],
                   plain_ms=stats[name]['plain_ms'],
                   bound_ms=stats[name]['bound_ms'],
                   bound_by=stats[name]['bound_by'], library_ms=None,
                   launches_mshp_batch1=mshp_b1[name],
                   launches_mshp_wire_batch=mshp_bk[name],
                   launches_mshp_cli=mshp_cli[name],
                   launches_mshp_train=mshp_train[name],
                   launches_finetune_bq=sum(c[name] for c in new_paths),
                   launches_jahp=jahp[name],
                   launches_codec_clis=sum(c[name] for c in codec_clis),
                   launches_backbones=sum(c[name]
                                          for c in backbone_paths.values()),
                   launches_seg=sum(c[name] for c in seg_paths.values()),
                   launches_det=sum(c[name] for c in det_paths.values()),
                   launches_bf16=bf16_wire[name],
                   launches_bench=bench_launches[name],
                   **{key: stats[name][key]
                      for key in ('device_ms_k128', 'bound_ms_k128',
                                  'launch_floor_ms', 'images_per_block',
                                  'tile_steps', 'prepare_ms')
                      if key in stats[name]})
        if name in backbone_stats:
            b = backbone_stats[name]
            row['max_abs_err'] = max(row['max_abs_err'], b['max_abs_err'])
            row.update({f'{key}_64ch': b[key] for key in (
                'ms', 'device_ms', 'plain_ms', 'bound_ms')})
        if name in seg_stats:
            g = seg_stats[name]
            row['max_abs_err'] = max(row['max_abs_err'], g['max_abs_err'])
            row.update({f'{key}_seg': g[key] for key in (
                'ms', 'device_ms', 'plain_ms', 'bound_ms')})
        if name in det_stats:
            g = det_stats[name]
            row['max_abs_err'] = max(row['max_abs_err'], g['max_abs_err'])
            row.update({f'{key}_det': g[key] for key in (
                'ms', 'device_ms', 'plain_ms', 'bound_ms')})
        if name in kernels.KERNELS:
            row.update(launches_cli=cli_launches[name],
                       launches_train=train_launches[name],
                       launches_train_e2e=e2e_launches[name])
        rows.append(row)
    for r in rows:
        check(r['launches'] > 0, f'{r["name"]} never launched on the path')
        if r['name'] not in kernels.MASKED_KERNELS:
            check(r['launches_backbones'] > 0, f'{r["name"]} never launched '
                  'on the RegNetY and hybrid-ViT paths')
        if r['name'] not in kernels.MASKED_KERNELS:
            check(r['launches_bf16'] > 0, f'{r["name"]} never launched on '
                  'the bfloat16 device wire')
        if r['name'] in kernels.KERNELS:
            check(r['launches_bench'] > 0, f'{r["name"]} never launched in '
                  'the bench')
            check(r['launches_seg'] > 0, f'{r["name"]} never launched on '
                  'the segmentation path')
            check(r['launches_det'] > 0, f'{r["name"]} never launched on '
                  'the detection path')
        check(r['max_abs_err'] == 0, f'{r["name"]} differs from its plain '
              f'version by {r["max_abs_err"]}')
    print(json.dumps({'kernels': rows}), flush=True)
    print(smi_query('name,power.limit'), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def main():
    try:
        run()
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
