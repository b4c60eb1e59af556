"""Segmentation engine (counterpart of `sc2bench_tpu/train/seg_engine.py`):
PASCAL VOC DeepLabv3, trained and tested as the JAX engine does.

From a config it builds the teacher and the student
(`load_segmentation_model`: the 'model' registry and the `ckpt`; the
teacher of the VOC configs has none, so it keeps its seeded weights, as
in JAX) and wraps the student in a `SplitSegmentationRuntime`.

`train()` runs the config's stages: a `DistillationBox` with a teacher
(Entropic Student, CR+BQ), else a `TrainingBox` (end to end); a stage
with `epoch_to_update: 0` builds the tables before its first step, and
with `epoch_to_update: k` after its k-th epoch, and from then on the box
runs the 'finetune' forward. Each epoch ends with the validation mIoU of
the 'finetune' forward; the best is kept (`save_ckpt` to `dst_ckpt`). The
'train' forward's noise comes from a generator on the engine's device
seeded with `seed`.

`test()` builds the tables (unless training did) and scores the student
at batch 1 through the real bitstream in 16-image chunks, on the host
wire (`stream_deploy`) or with `deploy_wire: device` the device-rANS wire
(`stream_deploy_device`): mIoU, global accuracy, `model_time` and the
data-size summary. A student without an entropy model (CR+BQ) is scored
with the runtime's 'train' forward ('out' head) and nothing accounted.
The JAX engine cannot test such a student (its loop takes the argmax of
the forward's dict); the port scores the main head.

A `models.wrapper` config (the input-compression family) builds the
wrapper alone and is test-only, as in JAX: `train()` raises.

Loaders yield NHWC numpy batches (`pascal_seg_collate_fn`: images padded
with 0, masks with 255); the engine hands the models NCHW float32
tensors on its device and counts the confusion matrix there.

In a data-parallel group the training and validation loaders are sharded
over the processes and the test loader is whole on each, as in JAX; the
confusion matrix is summed over the group before the mIoU is taken.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..config import train_stage_configs
from ..datasets.image import build_sharded_loader
from ..device import resolve_device
from ..models.segmentation.registry import load_segmentation_model
from ..models.segmentation.wrapper import (SplitSegmentationRuntime,
                                           get_wrapped_segmentation_model)
from ..parallel.dist import world_size
from ..registry import import_dependencies
from ..transforms.collator import pascal_seg_collate_fn
from ..utils.ckpt import save_ckpt
from ..utils.metrics import MetricLogger
from ..utils.seg_eval import SegEvaluator
from . import engine as cls_engine
from .box import DistillationBox, TrainingBox

logger = logging.getLogger(__name__)

# the deploy path serves the test images in chunks of this many
STREAM_CHUNK = 16


class SegmentationEngine:
    """Builds the models and loaders from a config dict, trains and runs
    the test protocol, on `device` (CUDA unless asked otherwise). `seed`
    seeds the training noise."""

    def __init__(self, config, device=None, seed: int = 42):
        import_dependencies(config.get('dependencies'))
        self.config = config
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.num_classes = int(config.get('num_classes', 21))
        models_config = config.get('models', {})
        self.wrapper = None
        self.teacher = None
        if 'wrapper' in models_config:
            torch.manual_seed(0)
            self.wrapper = get_wrapped_segmentation_model(
                models_config['wrapper'], device=self.device)
            return
        if 'teacher_model' in models_config:
            torch.manual_seed(7)
            self.teacher = load_segmentation_model(
                models_config['teacher_model'], device=self.device).eval()
        torch.manual_seed(0)
        self.student = load_segmentation_model(
            models_config.get('student_model', models_config.get('model')),
            device=self.device)
        self.runtime = SplitSegmentationRuntime(self.student,
                                                device=self.device)

    # ---- data -----------------------------------------------------------
    def build_loader(self, split_config, shard_over_processes=False):
        return build_sharded_loader(
            split_config, collate_fn=pascal_seg_collate_fn,
            shard_over_processes=shard_over_processes)

    def _to_device(self, x) -> torch.Tensor:
        """An NHWC numpy batch as an NCHW float32 tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.float32).transpose(0, 3, 1, 2))).to(self.device)

    def _targets(self, y) -> torch.Tensor:
        return torch.from_numpy(np.asarray(y, np.int64)).to(self.device)

    def _result(self, evaluator, meter=None):
        evaluator.reduce_from_all_processes()
        acc_global, _, iou = evaluator.compute()
        result = {'acc_global': float(acc_global), 'miou': float(iou.mean())}
        if meter is not None and 'model_time' in meter.meters:
            result['model_time'] = meter.meters['model_time'].global_avg
        return result

    # ---- evaluation -----------------------------------------------------
    @torch.no_grad()
    def evaluate(self, data_loader, use_deploy_path=False,
                 use_teacher=False):
        """{'acc_global', 'miou'} (and `model_time`, host seconds an image,
        on the deploy path). The deploy path codes every image at batch 1
        through the real bitstream (see `test`); otherwise the 'finetune'
        forward of the student, or with `use_teacher` the teacher's
        forward (None without a teacher), scores the loader's batches."""
        evaluator = SegEvaluator(self.num_classes, device=self.device)
        if use_teacher and self.teacher is None:
            return None
        meter = MetricLogger()
        if use_deploy_path:
            self.runtime.eval()
            if self.runtime.bottleneck_updated:
                stream = self.runtime.stream_deploy_device \
                    if self.config.get('deploy_wire') == 'device' \
                    else self.runtime.stream_deploy
                chunk_x, chunk_y = [], []

                def drain():
                    if not chunk_x:
                        return
                    t0 = time.time()
                    outs = stream(chunk_x)
                    for out, y in zip(outs, chunk_y):
                        evaluator.update(y, out.argmax(1))
                    if self.device.type == 'cuda':
                        torch.cuda.synchronize(self.device)
                    k = len(chunk_x)
                    meter.meters['model_time'].update(
                        (time.time() - t0) / k, n=k)
                    chunk_x.clear()
                    chunk_y.clear()

                for x, y in data_loader:
                    chunk_x.append(self._to_device(x))
                    chunk_y.append(self._targets(y))
                    if len(chunk_x) == STREAM_CHUNK:
                        drain()
                drain()
            else:
                for x, y in data_loader:
                    t0 = time.time()
                    out = self.runtime(self._to_device(x))['out']
                    evaluator.update(self._targets(y), out.argmax(1))
                    meter.update(model_time=time.time() - t0)
        else:
            model = self.teacher if use_teacher else self.student
            for x, y in data_loader:
                out = model(self._to_device(x), mode='finetune')['out']
                evaluator.update(self._targets(y), out.argmax(1))
        result = self._result(evaluator, meter)
        logger.info('seg eval%s: %s', ' (teacher)' if use_teacher else '',
                    result)
        return result

    def _box(self, stage_cfg, steps_per_epoch, generator):
        mode = 'finetune' if self.runtime.bottleneck_updated else 'train'
        kwargs = dict(steps_per_epoch=steps_per_epoch, student_mode=mode,
                      generator=generator)
        if self.teacher is not None:
            return DistillationBox(self.student, stage_cfg,
                                   teacher=self.teacher, **kwargs)
        return TrainingBox(self.student, stage_cfg, **kwargs)

    def _update_tables(self, box):
        if not self.runtime.bottleneck_updated and self.runtime.update():
            box.student_mode = 'finetune'
            logger.info('bottleneck updated (tables built)')

    def train(self, dst_ckpt=None):
        """Run the config's training stages; returns the best validation
        mIoU."""
        if self.wrapper is not None:
            raise ValueError('input-compression segmentation configs are '
                             'test-only — run with -test_only')
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
            epoch_to_update = stage_cfg.get('epoch_to_update')
            if epoch_to_update == 0:
                self._update_tables(box)
            for epoch in range(int(stage_cfg.get('num_epochs', 1))):
                meter = MetricLogger()
                acc = cls_engine.MetricAccumulator(meter, nan_check_interval)
                for x, y in train_loader:
                    metrics = box.train_step(self._to_device(x),
                                             self._targets(y))
                    acc.push(sum(metrics['loss'].values()),
                             metrics['aux_loss'])
                acc.drain()
                if epoch_to_update and epoch + 1 >= int(epoch_to_update):
                    self._update_tables(box)
                miou = self.evaluate(val_loader)['miou']
                if miou > best:
                    best = miou
                    if dst_ckpt:
                        save_ckpt(dst_ckpt, self.student.state_dict(),
                                  meta={'best_miou': best})
                logger.info('stage %s epoch %d: %s (best mIoU %.4f)', name,
                            epoch, str(meter), best)
        if not self.runtime.bottleneck_updated:
            self.runtime.update()
        return best

    def test(self):
        """(metrics, data-size summaries) of the student on the test
        loader, or of the wrapper for a wrapper config."""
        loader = self.build_loader(self.config['test']['test_data_loader'])
        if self.wrapper is not None:
            return self._test_wrapper(loader)
        if not self.runtime.bottleneck_updated:
            self.runtime.update()
        self.runtime.activate_analysis()
        result = self.evaluate(loader, use_deploy_path=True)
        return result, self.runtime.summarize()

    @torch.no_grad()
    def _test_wrapper(self, loader):
        """(metrics, summaries) of a wrapper: analysis on, each batch to the
        wrapper as a list of HWC images, `model_time` the host seconds of a
        batch."""
        self.wrapper.activate_analysis()
        evaluator = SegEvaluator(self.num_classes, device=self.device)
        meter = MetricLogger()
        for x, y in loader:
            t0 = time.time()
            out = self.wrapper([np.asarray(img) for img in np.asarray(x)])
            evaluator.update(self._targets(y), out['out'].argmax(1))
            meter.update(model_time=time.time() - t0)
        result = self._result(evaluator, meter)
        logger.info('wrapper seg eval: %s', result)
        return result, self.wrapper.summarize()
