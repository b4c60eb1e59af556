"""Detection engine (counterpart of `sc2bench_tpu/train/det_engine.py`):
COCO Faster R-CNN (and Mask and Keypoint R-CNN), trained and tested as
the JAX engine does.

From a config it builds the teacher and the student
(`load_detection_model`; the teacher of the COCO configs has no ckpt, so
it keeps its seeded weights, as in JAX) on `device`, and the input
transform: each batch resized and padded to a canvas bucket, by default
the landscape, portrait and square canvases of (`min_size` 800,
`canvas_size`), or the config's `canvas_buckets`.

`train()` runs the config's stages, each a `DetectionBox`: the
distillation step (the teacher's backbone features for the hint terms)
plus, with `detection_loss_weight` > 0, the RPN and RoI losses on the
padded targets (at most `max_boxes` an image, scaled to the canvas), the
box head run on the 512 sampled proposals only. A stage with
`epoch_to_update: 0` switches the student to the 'finetune' forward
before its first step, as the JAX engine does. Each epoch ends with the
validation mAP of the plain forward; the best is kept (`save_ckpt` to
`dst_ckpt`). The draws (the 'train' forward's noise and the samplers')
come from a generator on the engine's device seeded with `seed`.

`test()` builds the coding tables from the student's current entropy
bottleneck and scores it at batch 1 through the real bitstream in
16-image chunks, on the host wire (`stream_detect`) or with `deploy_wire:
device` the device-rANS wire (`stream_detect_device`): the 12 COCO bbox
metrics, `model_time` (host seconds an image) and the data-size summary.
A student without an entropy model (CR+BQ) is scored with the plain
forward and nothing accounted, as in JAX. A `models.wrapper` config (the
input-compression family, `InputCompressionDetectionModel`) is test-only:
the engine builds the wrapper alone, `train()` raises, and `test()` runs
the COCO evaluator over the wrapper's detections of each loader batch
(its own transform: every image compressed, then on the square canvas),
the data size from its analyzer.

Loaders yield (images, targets) tuples (`coco_collate_fn`); detections
are scaled back to each image's own coordinates before scoring.

The evaluation types are the config's `iou_types` (the CLI's
`--iou_types`), else bbox, then 'segm' for a `MaskRCNN` student and
'keypoints' for a `KeypointRCNN` (the reference's `get_iou_types`). The
plain forward scores each with its own `CocoEvaluator`: for every one of
the 100 detection slots of an image the mask head's probabilities (then
the valid slots' masks pasted at the image's original size) or the
keypoint heatmaps (decoded in original coordinates). The deploy path
scores bbox only, as in JAX. `evaluate` returns bbox's metrics on top and
the others under their type ('segm', 'keypoints').

In a data-parallel group the training and validation loaders are sharded
over the processes and the test loader is whole on each, as in JAX; the
COCO evaluator gathers every process's detections and ground truths by
image id before it scores. The Faster R-CNN losses are means over the
images of per-image ratios (as in JAX), so the gradients' average over
the group is the global batch's. The RPN and RoI samplers, like the
quantizer's noise, draw for the global batch and keep each rank's block,
so a step of the group equals one process's step on the global batch
where the ranks' canvases agree.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..config import train_stage_configs
from ..datasets.coco import pad_detection_targets
from ..datasets.image import build_sharded_loader
from ..device import resolve_device
from ..models.detection.rcnn import (KeypointRCNN, MaskRCNN,
                                     detection_loss, postprocess_detections)
from ..models.detection.registry import load_detection_model
from ..models.detection.transform import RCNNTransform
from ..models.detection.wrapper import (SplitDetectionRuntime,
                                        get_wrapped_detection_model)
from ..parallel.dist import world_size
from ..registry import import_dependencies
from ..transforms.collator import coco_collate_fn
from ..utils.ckpt import save_ckpt
from ..utils.coco_eval import (CocoEvaluator, keypoints_from_heatmaps,
                               paste_mask)
from ..utils.metrics import MetricLogger
from . import engine as cls_engine
from .box import DistillationBox, factorized_aux_loss

logger = logging.getLogger(__name__)

# the deploy path serves the test images in chunks of this many
STREAM_CHUNK = 16


class DetectionBox(DistillationBox):
    """A `DistillationBox` whose batch is (canvas images, padded targets)
    and whose step adds the Faster R-CNN losses. The hint terms read the
    student's captured backbone features and the teacher's, from its
    backbone alone (no config reads the teacher's heads). 'output' is the
    box head's class logits: of the sampled proposals when the task
    losses are on, else of the full proposal set."""

    def __init__(self, student, stage_config, detection_loss_weight=0.0,
                 **kwargs):
        super().__init__(student, stage_config, **kwargs)
        self.detection_loss_weight = float(detection_loss_weight)

    def _teacher_io(self, x) -> dict:
        if self.teacher is None:
            return {}
        sub = {}
        with torch.no_grad():
            self.teacher.backbone.body(x, io=sub)
        return {f'backbone.{k}': v for k, v in sub.items()}

    def train_step(self, x: torch.Tensor, targets: dict | None,
                   uniforms: dict | None = None) -> dict:
        """One optimizer step on a canvas batch (NCHW) and its padded
        targets (device tensors); `uniforms` replaces the samplers' draws
        (`detection_loss`). Returns the step's metrics as device
        tensors."""
        teacher_io = self._teacher_io(x)
        self.student.train(self.train_bn)
        try:
            io = {}
            use_sampled = bool(self.detection_loss_weight) \
                and targets is not None
            out = self.student(x, mode=self.student_mode,
                               generator=self.generator, io=io,
                               rpn_only=use_sampled)
            detail, main_loss = {}, 0.0
            if use_sampled:
                det, roi_out = detection_loss(
                    out, targets, self.generator,
                    apply_roi=lambda f, p: self.student.roi_predict(
                        f, p, out['image_hw']),
                    return_roi_outputs=True, uniforms=uniforms)
                io['output'] = roi_out[0]
                detail.update(det)
                main_loss = self.detection_loss_weight * sum(det.values())
            else:
                io['output'] = out['class_logits']
            crit_loss, crit_detail = self.criterion(io, teacher_io, None)
            detail.update(crit_detail)
            main_loss = main_loss + crit_loss
            aux = factorized_aux_loss(self.student)
            self.optim.zero_grad()
            (main_loss + aux).backward()
            self.optim.step()
        finally:
            self.student.eval()
        return {'loss': {k: v.detach() for k, v in detail.items()},
                'aux_loss': aux.detach()}


class DetectionEngine:
    """Builds the models, transform and loaders from a config dict, trains
    and runs the test protocol, on `device` (CUDA unless asked otherwise).
    `seed` seeds the training draws."""

    def __init__(self, config, device=None, seed: int = 42):
        import_dependencies(config.get('dependencies'))
        self.config = config
        self.device = resolve_device(device)
        self.seed = int(seed)
        models_config = config.get('models', {})
        canvas_size = int(config.get('canvas_size', 1333))
        min_size = int(config.get('min_size', 800))
        buckets = config.get('canvas_buckets')
        if buckets is None and canvas_size > min_size:
            buckets = True
        self.transform = RCNNTransform(min_size=min_size,
                                       max_size=canvas_size,
                                       size_divisible=32,
                                       canvas_buckets=buckets)
        self.max_boxes = int(config.get('max_boxes', 64))
        self.teacher = None
        self.wrapper = None
        if 'wrapper' in models_config:
            self.wrapper = get_wrapped_detection_model(
                models_config['wrapper'], device=self.device)
            return
        if 'teacher_model' in models_config:
            torch.manual_seed(7)
            self.teacher = load_detection_model(
                models_config['teacher_model'], device=self.device).eval()
        torch.manual_seed(0)
        self.student = load_detection_model(
            models_config.get('student_model', models_config.get('model')),
            device=self.device).eval()
        self.runtime = SplitDetectionRuntime(self.student, device=self.device)
        self.bottleneck_updated = False
        if 'iou_types' in config:
            self.iou_types = [str(t) for t in config['iou_types']]
        else:
            self.iou_types = ['bbox']
            if isinstance(self.student, MaskRCNN):
                self.iou_types.append('segm')
            if isinstance(self.student, KeypointRCNN):
                self.iou_types.append('keypoints')

    # ---- data -----------------------------------------------------------
    def build_loader(self, split_config, shard_over_processes=False):
        return build_sharded_loader(
            split_config, collate_fn=coco_collate_fn,
            shard_over_processes=shard_over_processes)

    def _canvas(self, images):
        """(NCHW canvas batch on the device, scales, original (h, w)
        sizes) of a list of HWC images."""
        batch, scales, origs = self.transform(list(images))
        return torch.from_numpy(np.ascontiguousarray(
            batch.transpose(0, 3, 1, 2))).to(self.device), scales, origs

    def _prepare_batch(self, images, targets):
        """(canvas batch, padded targets with boxes on the canvas, as
        device tensors)."""
        x, scales, _ = self._canvas(images)
        padded = pad_detection_targets(list(targets), self.max_boxes)
        padded['boxes'] = padded['boxes'] * scales[:, None, None]
        return x, {k: torch.from_numpy(v).to(self.device)
                   for k, v in padded.items()}

    # ---- evaluation -----------------------------------------------------
    @staticmethod
    def _record(evaluators, dets, targets, scales, origs=None, extras=None):
        """Each image's valid detections, in its own coordinates, into
        every evaluator: with `extras`' 'mask_probs' (N, D, 28, 28) the
        masks pasted at its original size, with 'kp_heatmaps' (N, D, 56,
        56, K) the keypoints decoded."""
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        extras = {k: v.cpu().numpy() for k, v in (extras or {}).items()}
        for i, target in enumerate(targets):
            valid = dets['valid'][i]
            boxes = dets['boxes'][i][valid] / scales[i]
            pred = {'boxes': boxes, 'scores': dets['scores'][i][valid],
                    'labels': dets['labels'][i][valid]}
            if 'mask_probs' in extras:
                oh, ow = origs[i]
                pred['masks'] = [paste_mask(p, b, oh, ow) for p, b in zip(
                    extras['mask_probs'][i][valid], boxes)]
            if 'kp_heatmaps' in extras:
                pred['keypoints'] = keypoints_from_heatmaps(
                    extras['kp_heatmaps'][i][valid], boxes)
            for evaluator in evaluators.values():
                evaluator.add_gt(target)
                evaluator.update({target['image_id']: pred})

    @staticmethod
    def _head_extras(model, out, dets, iou_types) -> dict:
        """The mask probabilities and keypoint heatmaps of every detection
        slot of each image, for the types `model` has a head for."""
        extras = {}
        feats = out['features'][:4]
        n = dets['boxes'].shape[0]
        if 'segm' in iou_types and isinstance(model, MaskRCNN):
            extras['mask_probs'] = torch.stack([model.predict_masks(
                [f[i] for f in feats], dets['boxes'][i], dets['labels'][i],
                out['image_hw']) for i in range(n)])
        if 'keypoints' in iou_types and isinstance(model, KeypointRCNN):
            extras['kp_heatmaps'] = torch.stack([model.predict_keypoints(
                [f[i] for f in feats], dets['boxes'][i], out['image_hw'])
                for i in range(n)])
        return extras

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def evaluate(self, data_loader, use_deploy_path=False,
                 use_teacher=False):
        """The 12 COCO bbox metrics and `model_time` (host seconds an
        image), with those of the other `iou_types` under their names.
        The deploy path codes every image through the runtime's bitstream
        (see `test`) and scores bbox only; otherwise the plain 'finetune'
        forward of the student, or with `use_teacher` of the teacher (None
        without one), scores the loader's batches on every type."""
        if use_teacher and self.teacher is None:
            return None
        iou_types = ['bbox'] if use_deploy_path else self.iou_types
        evaluators = {t: CocoEvaluator(iou_type=t) for t in iou_types}
        meter = MetricLogger()
        if use_deploy_path:
            stream = self.runtime.stream_detect_device \
                if self.config.get('deploy_wire') == 'device' \
                else self.runtime.stream_detect
            chunk = []

            def drain():
                if not chunk:
                    return
                t0 = time.time()
                results = stream([x for x, _, _ in chunk])
                self._sync()
                meter.meters['model_time'].update(
                    (time.time() - t0) / len(chunk), n=len(chunk))
                for dets, (_, targets, scales) in zip(results, chunk):
                    self._record(evaluators, dets, targets, scales)
                chunk.clear()

            for images, targets in data_loader:
                x, scales, _ = self._canvas(images)
                chunk.append((x, targets, scales))
                if len(chunk) == STREAM_CHUNK:
                    drain()
            drain()
        else:
            model = self.teacher if use_teacher else self.student
            for images, targets in data_loader:
                x, scales, origs = self._canvas(images)
                t0 = time.time()
                out = model(x, mode='finetune')
                dets = postprocess_detections(out)
                extras = self._head_extras(model, out, dets, iou_types)
                self._sync()
                meter.update(model_time=time.time() - t0)
                self._record(evaluators, dets, targets, scales, origs,
                             extras)
        for evaluator in evaluators.values():
            evaluator.synchronize_between_processes()
            evaluator.accumulate()
        primary = 'bbox' if 'bbox' in evaluators else iou_types[0]
        stats = evaluators[primary].summarize()
        for t, evaluator in evaluators.items():
            if t != primary:
                stats[t] = evaluator.summarize()
        if 'model_time' in meter.meters:
            stats['model_time'] = meter.meters['model_time'].global_avg
        logger.info('detection eval%s: mAP %.4f AP50 %.4f',
                    ' (teacher)' if use_teacher else '', stats['AP'],
                    stats['AP50'])
        for t in iou_types:
            if t != primary:
                logger.info('detection eval%s, %s: AP %.4f AP50 %.4f',
                            ' (teacher)' if use_teacher else '', t,
                            stats[t]['AP'], stats[t]['AP50'])
        return stats

    # ---- training -------------------------------------------------------
    def _box(self, stage_cfg, steps_per_epoch, generator):
        return DetectionBox(
            self.student, stage_cfg, teacher=self.teacher,
            detection_loss_weight=float(
                stage_cfg.get('detection_loss_weight', 0.0)),
            steps_per_epoch=steps_per_epoch,
            student_mode='finetune' if self.bottleneck_updated else 'train',
            generator=generator)

    def train(self, dst_ckpt=None):
        """Run the config's training stages; returns the best validation
        mAP."""
        if self.wrapper is not None:
            raise ValueError('input-compression detection configs are '
                             'test-only: run with -test_only')
        train_config = self.config.get('train', {})
        stages = train_stage_configs(train_config)
        if self.config.get('adjust_lr'):
            stages = cls_engine.scale_stage_lrs(stages, world_size())
        train_loader = self.build_loader(train_config['train_data_loader'],
                                         shard_over_processes=True)
        val_loader = self.build_loader(train_config['val_data_loader'],
                                       shard_over_processes=True)
        nan_check_interval = int(train_config.get('nan_check_interval', 50))
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        best = -1.0
        for stage_cfg in stages:
            name = stage_cfg.get('name')
            logger.info('=== stage %s ===', name)
            box = self._box(stage_cfg, max(len(train_loader), 1), generator)
            if stage_cfg.get('epoch_to_update') == 0 \
                    and not self.bottleneck_updated:
                self.bottleneck_updated = True
                box.student_mode = 'finetune'
            for epoch in range(int(stage_cfg.get('num_epochs', 1))):
                meter = MetricLogger()
                acc = cls_engine.MetricAccumulator(meter, nan_check_interval)
                for images, targets in train_loader:
                    metrics = box.train_step(
                        *self._prepare_batch(images, targets))
                    acc.push(sum(metrics['loss'].values()),
                             metrics['aux_loss'])
                acc.drain()
                stats = self.evaluate(val_loader)
                if stats['AP'] > best:
                    best = stats['AP']
                    if dst_ckpt:
                        save_ckpt(dst_ckpt, self.student.state_dict(),
                                  meta={'best_map': best})
                logger.info('stage %s epoch %d: %s (best mAP %.4f)', name,
                            epoch, str(meter), best)
        return best

    @torch.no_grad()
    def _test_wrapper(self, loader):
        """The 12 COCO bbox metrics of the input-compression wrapper, one
        call a loader batch, with `model_time` (host seconds an image) and
        `data_size` (the wrapper's analysis summary)."""
        self.wrapper.activate_analysis()
        evaluator = CocoEvaluator(iou_type='bbox')
        meter = MetricLogger()
        for images, targets in loader:
            t0 = time.time()
            results = self.wrapper(list(images))
            self._sync()
            meter.meters['model_time'].update(
                (time.time() - t0) / len(results), n=len(results))
            for target, res in zip(targets, results):
                evaluator.add_gt(target)
                evaluator.update({target['image_id']: res})
        evaluator.synchronize_between_processes()
        evaluator.accumulate()
        stats = evaluator.summarize()
        if 'model_time' in meter.meters:
            stats['model_time'] = meter.meters['model_time'].global_avg
        stats['data_size'] = self.wrapper.summarize()
        logger.info('wrapper detection eval: mAP %.4f', stats['AP'])
        return stats

    def test(self):
        """(metrics, data-size summaries) of the student on the test
        loader, through the bitstream when it has an entropy model; of the
        wrapper for a `models.wrapper` config."""
        loader = self.build_loader(self.config['test']['test_data_loader'])
        if self.wrapper is not None:
            stats = self._test_wrapper(loader)
            return stats, stats['data_size']
        if not self.runtime.update():
            logger.info('no entropy bottleneck: testing the plain forward')
            return self.evaluate(loader), self.runtime.summarize()
        self.runtime.clear_analysis()
        self.runtime.activate_analysis()
        stats = self.evaluate(loader, use_deploy_path=True)
        summaries = self.runtime.summarize()
        for s in summaries:
            logger.info('analysis: %s', s)
        return stats, summaries
