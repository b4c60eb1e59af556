"""Detection engine (counterpart of `sc2bench_tpu/train/det_engine.py`):
COCO Faster R-CNN, trained and tested as the JAX engine does.

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
from ..models.detection.rcnn import detection_loss, postprocess_detections
from ..models.detection.registry import load_detection_model
from ..models.detection.transform import RCNNTransform
from ..models.detection.wrapper import (SplitDetectionRuntime,
                                        get_wrapped_detection_model)
from ..registry import import_dependencies
from ..transforms.collator import coco_collate_fn
from ..utils.ckpt import save_ckpt
from ..utils.coco_eval import CocoEvaluator
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

    # ---- data -----------------------------------------------------------
    def build_loader(self, split_config):
        return build_sharded_loader(split_config, collate_fn=coco_collate_fn)

    def _canvas(self, images):
        """(NCHW canvas batch on the device, scales) of a list of HWC
        images."""
        batch, scales, _ = self.transform(list(images))
        return torch.from_numpy(np.ascontiguousarray(
            batch.transpose(0, 3, 1, 2))).to(self.device), scales

    def _prepare_batch(self, images, targets):
        """(canvas batch, padded targets with boxes on the canvas, as
        device tensors)."""
        x, scales = self._canvas(images)
        padded = pad_detection_targets(list(targets), self.max_boxes)
        padded['boxes'] = padded['boxes'] * scales[:, None, None]
        return x, {k: torch.from_numpy(v).to(self.device)
                   for k, v in padded.items()}

    # ---- evaluation -----------------------------------------------------
    @staticmethod
    def _record(evaluator, dets, targets, scales):
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        for i, target in enumerate(targets):
            evaluator.add_gt(target)
            valid = dets['valid'][i]
            evaluator.update({target['image_id']: {
                'boxes': dets['boxes'][i][valid] / scales[i],
                'scores': dets['scores'][i][valid],
                'labels': dets['labels'][i][valid]}})

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def evaluate(self, data_loader, use_deploy_path=False,
                 use_teacher=False):
        """The 12 COCO bbox metrics and `model_time` (host seconds an
        image). The deploy path codes every image through the runtime's
        bitstream (see `test`); otherwise the plain 'finetune' forward of
        the student, or with `use_teacher` of the teacher (None without
        one), scores the loader's batches."""
        if use_teacher and self.teacher is None:
            return None
        evaluator = CocoEvaluator(iou_type='bbox')
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
                    self._record(evaluator, dets, targets, scales)
                chunk.clear()

            for images, targets in data_loader:
                x, scales = self._canvas(images)
                chunk.append((x, targets, scales))
                if len(chunk) == STREAM_CHUNK:
                    drain()
            drain()
        else:
            model = self.teacher if use_teacher else self.student
            for images, targets in data_loader:
                x, scales = self._canvas(images)
                t0 = time.time()
                dets = postprocess_detections(model(x, mode='finetune'))
                self._sync()
                meter.update(model_time=time.time() - t0)
                self._record(evaluator, dets, targets, scales)
        evaluator.synchronize_between_processes()
        evaluator.accumulate()
        stats = evaluator.summarize()
        if 'model_time' in meter.meters:
            stats['model_time'] = meter.meters['model_time'].global_avg
        logger.info('detection eval%s: mAP %.4f AP50 %.4f',
                    ' (teacher)' if use_teacher else '', stats['AP'],
                    stats['AP50'])
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
            stages = cls_engine.scale_stage_lrs(stages)
        train_loader = self.build_loader(train_config['train_data_loader'])
        val_loader = self.build_loader(train_config['val_data_loader'])
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
