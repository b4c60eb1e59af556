"""Classification engine (counterpart of
`sc2bench_tpu/train/engine.py:ClassificationEngine`).

From a config it builds the teacher and the student (registry builders,
checkpoints), copies the teacher's layer2-4 and fc into the student as the
JAX engine does, and wraps the student in a `SplitClassifierRuntime`.

`train()` runs the config's stages (`train.stage1..N`, or the flat train
config as one stage): a `DistillationBox` with a teacher (Entropic
Student), else a `TrainingBox` (end to end). At `epoch_to_update` the
runtime builds the tables and the box switches to the 'finetune' forward.
Each epoch ends with the 'finetune' validation; the best acc1 is saved
with `save_ckpt` and the resume state with `save_train_state` when a
destination is given. The 'train' forward's noise comes from a generator
on the engine's device seeded with the engine's `seed`.

`test()` builds the tables (unless training did) and scores the student
at batch 1 through the real bitstream, with the data size of every image
accounted: on the host coder (`stream_deploy`, the default) or, with
`deploy_wire: device` in the config, on the device-rANS kernels
(`stream_deploy_device`). A student without an entropy model (the CR+BQ
family's `SimpleBottleneck`) has no bitstream: it is scored with the
'finetune' forward and no data size, as in the JAX engine, which also
ignores the top-level `wrapper:` key of those configs.

Loaders yield NHWC numpy batches; the engine hands the runtime and the
models NCHW tensors on its device.

In a data-parallel group (`parallel/dist.py`, the CLI under `torchrun`)
the training and validation loaders are sharded over the processes and
the test loader stays whole on every process, as in JAX; the metrics are
summed over the group (`MetricLogger.synchronize_between_processes`), so
the validation numbers are the global shard's and the test numbers equal
one process's. `-adjust_lr` scales by the group's size. A process drives
one device, so the JAX CLI's `-no_dp_eval` (not sharding an eval batch
over a process's own devices) has nothing to switch off here.

A `models.wrapper` config (the input- and feature-compression families)
builds the wrapper alone (`models/wrapper.py`: a classifier behind a host
codec, a neural image codec, or a codec on a split feature) and is
test-only, as in the JAX engine: `train()` raises, and `test()` hands the
wrapper each batch as a list of HWC images, giving top-1/top-5 and the
wrapper's data-size summaries. For a neural input-compression wrapper
whose codec has a device wire (the joint autoregressive codec),
`deploy_wire: device` codes every image on that wire
(`NeuralInputCompressionClassifier` with `wire='device'`); any other
wrapper raises. The data-size summary then measures the device wire's
lane format (with its lanes' states and lengths: about 29 % more than
the host wire at quality 8 on 224 px images), which is not comparable
with the host wire's sizes or the paper's.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..config import train_stage_configs
from ..datasets.image import build_sharded_loader
from ..device import resolve_device
from ..models.registry import load_classification_model
from ..models.runtime import SplitClassifierRuntime
from ..models.wrapper import get_wrapped_classification_model
from ..parallel.dist import world_size
from ..registry import import_dependencies
from ..utils.ckpt import (load_ckpt, load_train_state, save_ckpt,
                          save_train_state)
from ..utils.metrics import MetricLogger
from .box import DistillationBox, TrainingBox

logger = logging.getLogger(__name__)

# the teacher's layers that initialize the student's tail, as the JAX
# engine names them; a RegNet (s2-s4, head) or hybrid-ViT student has none
# of them, so it gets nothing from its teacher, as in JAX
TAIL_PREFIXES = ('layer2', 'layer3', 'layer4', 'fc')
# a stream_deploy call serves at most this many images
STREAM_CHUNK = 64
DEFAULT_TEST_LOADER = {'dataset': {'key': 'SyntheticClassificationDataset',
                                   'kwargs': {}}, 'batch_size': 1}
DEFAULT_TRAIN_LOADER = {'dataset': {'key': 'SyntheticClassificationDataset',
                                    'kwargs': {}},
                        'batch_size': 8, 'shuffle': True}
DEFAULT_VAL_LOADER = {'dataset': {'key': 'SyntheticClassificationDataset',
                                  'kwargs': {}}, 'batch_size': 8}


def scale_stage_lrs(stages, world_size: int = 1):
    """The reference's `-adjust_lr`: every stage's optimizer learning rate
    times the number of data-parallel processes, in copies (the input
    shares subtrees with the loaded config); one process gets the stages
    back unchanged."""
    if world_size <= 1:
        return stages
    out = []
    for stage_cfg in stages:
        stage_cfg = dict(stage_cfg)
        opt = stage_cfg.get('optimizer')
        if opt and 'lr' in opt.get('kwargs', {}):
            kwargs = dict(opt['kwargs'])
            kwargs['lr'] = float(kwargs['lr']) * world_size
            stage_cfg['optimizer'] = {**opt, 'kwargs': kwargs}
            logger.info('adjust_lr: stage %s lr %s -> %s (world=%d)',
                        stage_cfg.get('name'), opt['kwargs']['lr'],
                        kwargs['lr'], world_size)
        out.append(stage_cfg)
    return out


class MetricAccumulator:
    """Running sums of the step losses on the device: `push` adds a
    step's loss and aux scalars without a host transfer; every `interval`
    steps `drain` reads them once, aborts on a non-finite sum (NaN and Inf
    propagate through it, so no step is missed) and feeds the meter."""

    def __init__(self, meter, interval: int = 50):
        self.meter = meter
        self.interval = max(int(interval), 1)
        self._sums = None
        self._pending = 0

    def push(self, loss, aux):
        step = torch.stack([torch.as_tensor(loss, dtype=torch.float32),
                            torch.as_tensor(aux, dtype=torch.float32)])
        self._sums = step if self._sums is None else self._sums + step
        self._pending += 1
        if self._pending >= self.interval:
            self.drain()

    def drain(self):
        if self._pending == 0:
            return
        ls, axs = (float(v) for v in self._sums.cpu())
        n = self._pending
        self._sums = None
        self._pending = 0
        if not np.isfinite(ls):
            raise ValueError(f'loss sum over the last {n} steps is {ls}; '
                             'aborting')
        self.meter.meters['loss'].update(ls / n, n=n)
        self.meter.meters['aux'].update(axs / n, n=n)


def top_k_accuracy(logits, targets, ks=(1, 5)):
    """Share of rows whose target is among the k largest logits, as float32
    scalars. Equal logits rank as in the JAX package: a stable ascending
    sort, reversed, so of two equal logits the higher class ranks first."""
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    return {f'acc{k}': (order[:, :k] == targets[:, None]).any(dim=-1)
            .to(torch.float32).mean() for k in ks}


def transfer_matching_subtrees(student, teacher, prefixes):
    """Copy the teacher's parameters and buffers under `prefixes` into the
    student where the student has the same names."""
    s = student.state_dict()
    student.load_state_dict(
        {k: v for k, v in teacher.state_dict().items()
         if k.split('.')[0] in prefixes and k in s}, strict=False)


def _eval_loop_accumulated(meter, data_loader, logits_fn):
    """Top-k sums weighted by batch size, on the device, read once at the
    end. `logits_fn(x) -> (logits, batch_size)`."""
    sums, names, n_total = None, None, 0
    for x, y in data_loader:
        logits, n = logits_fn(x)
        accs = top_k_accuracy(logits, torch.as_tensor(y,
                                                      device=logits.device))
        if names is None:
            names = sorted(accs)
        vec = torch.stack([accs[k] for k in names]) * n
        sums = vec if sums is None else sums + vec
        n_total += n
    if names:
        vals = sums.cpu().numpy() / max(n_total, 1)
        for name, v in zip(names, vals):
            meter.meters[name].update(float(v), n=n_total)


class ClassificationEngine:
    """Builds the models and loaders from a config dict, trains and runs
    the test protocol, on `device` (CUDA unless asked otherwise). `seed`
    seeds the training noise. The config's `image_size` (224 x 224 by
    default) is the input a hybrid ViT is built for, as the JAX CLI
    initializes its models on it."""

    def __init__(self, config, device=None, seed: int = 42):
        import_dependencies(config.get('dependencies'))
        self.config = config
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.image_size = tuple(config.get('image_size', (224, 224)))
        models_config = config.get('models', {})
        self.teacher = None
        self.wrapper = None
        if 'wrapper' in models_config:
            wire = {}
            if config.get('deploy_wire') == 'device':
                key = models_config['wrapper']['key']
                if key != 'NeuralInputCompressionClassifier':
                    raise ValueError(
                        f'deploy_wire: device applies to the neural '
                        f'input-compression wrapper '
                        f'(NeuralInputCompressionClassifier), not {key}')
                wire['wire'] = 'device'
            torch.manual_seed(0)
            self.wrapper = get_wrapped_classification_model(
                models_config['wrapper'], device=self.device, **wire)
            return
        if 'teacher_model' in models_config:
            tm_cfg = models_config['teacher_model']
            torch.manual_seed(7)
            self.teacher = load_classification_model(
                tm_cfg, device=self.device,
                image_size=self.image_size).eval()
            if tm_cfg.get('ckpt'):
                try:
                    self._load(self.teacher, tm_cfg['ckpt'])
                except FileNotFoundError:
                    # distilling from (or comparing against) random teacher
                    # weights is almost never intended
                    if not config.get('allow_missing_teacher', False):
                        raise FileNotFoundError(
                            f"teacher ckpt {tm_cfg['ckpt']} not found; "
                            'provide it or set allow_missing_teacher: true '
                            'in the config') from None
                    logger.error('teacher ckpt %s missing; RANDOM teacher '
                                 'weights (allow_missing_teacher set)',
                                 tm_cfg['ckpt'])
        sm_cfg = models_config.get('student_model', models_config.get('model'))
        torch.manual_seed(0)
        self.student = load_classification_model(
            sm_cfg, device=self.device, image_size=self.image_size)
        self.student_ckpt = sm_cfg.get('ckpt')
        if self.student_ckpt:
            try:
                self._load(self.student, self.student_ckpt)
                logger.info('loaded student ckpt %s', self.student_ckpt)
            except FileNotFoundError:
                logger.warning('student ckpt %s not found; fresh weights',
                               self.student_ckpt)
        if self.teacher is not None:
            transfer_matching_subtrees(self.student, self.teacher,
                                       TAIL_PREFIXES)
        # config 'input_norm': [mean, std] in 0-1 scale, for uint8 images
        input_norm = config.get('input_norm')
        self.runtime = SplitClassifierRuntime(
            self.student, input_norm=tuple(input_norm) if input_norm else None,
            device=self.device)

    @staticmethod
    def _load(model, path):
        state_dict, _, _ = load_ckpt(path, model)
        model.load_state_dict(state_dict)

    # ---- data -----------------------------------------------------------
    def build_loader(self, split_config, shard_over_processes=False):
        return build_sharded_loader(
            split_config, shard_over_processes=shard_over_processes)

    def _to_device(self, x):
        """An NHWC numpy batch as an NCHW tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).transpose(0, 3, 1, 2))).to(self.device)

    # ---- evaluation -----------------------------------------------------
    @torch.no_grad()
    def evaluate(self, data_loader, use_deploy_path=False):
        """Top-1/top-5, and per-image `model_time` on the deploy path. The
        deploy path codes every image at batch 1 through the real
        bitstream; without it, the 'finetune' forward scores the student
        (no bitstream, batches as the loader gives them)."""
        meter = MetricLogger()
        if use_deploy_path:
            self.runtime.eval()
            stream = self.runtime.stream_deploy_device \
                if self.config.get('deploy_wire') == 'device' \
                else self.runtime.stream_deploy
            chunk_x, chunk_y = [], []

            def drain():
                if not chunk_x:
                    return
                k = len(chunk_x)
                t0 = time.time()
                logits = torch.cat(stream(chunk_x))
                ys = torch.as_tensor(np.concatenate(
                    [np.atleast_1d(np.asarray(y)) for y in chunk_y]),
                    device=logits.device)
                accs = top_k_accuracy(logits, ys)
                meter.meters['model_time'].update((time.time() - t0) / k, n=k)
                for name, v in accs.items():
                    meter.meters[name].update(float(v), n=k)
                chunk_x.clear()
                chunk_y.clear()

            streamable = self.runtime.bottleneck_updated \
                and self.runtime.codec is not None
            for x, y in data_loader:
                x = self._to_device(x)
                if x.shape[0] != 1 or not streamable:
                    # the stream is strictly batch 1 over the bitstream
                    t0 = time.time()
                    logits = self.runtime(x)
                    accs = top_k_accuracy(logits, torch.as_tensor(
                        y, device=logits.device))
                    meter.update(model_time=time.time() - t0,
                                 **{k: float(v) for k, v in accs.items()})
                    continue
                chunk_x.append(x)
                chunk_y.append(y)
                if len(chunk_x) == STREAM_CHUNK:
                    drain()
            drain()
        else:
            def logits_fn(x):
                xb = self._to_device(x)
                return self.student(xb, mode='finetune'), int(xb.shape[0])

            _eval_loop_accumulated(meter, data_loader, logits_fn)
        meter.synchronize_between_processes()
        result = {k: m.global_avg for k, m in meter.meters.items()}
        logger.info('eval: %s', result)
        return result

    @torch.no_grad()
    def evaluate_teacher(self, data_loader):
        """Top-1/top-5 of the teacher; None when no teacher is configured."""
        if self.teacher is None:
            return None
        meter = MetricLogger()

        def logits_fn(x):
            xb = self._to_device(x)
            return self.teacher(xb), int(xb.shape[0])

        _eval_loop_accumulated(meter, data_loader, logits_fn)
        meter.synchronize_between_processes()
        result = {k: m.global_avg for k, m in meter.meters.items()}
        logger.info('teacher eval: %s', result)
        return result

    def _box(self, stage_cfg, steps_per_epoch, generator):
        mode = 'finetune' if self.runtime.bottleneck_updated else 'train'
        kwargs = dict(steps_per_epoch=steps_per_epoch, student_mode=mode,
                      generator=generator)
        if self.teacher is not None:
            return DistillationBox(self.student, stage_cfg,
                                   teacher=self.teacher, **kwargs)
        return TrainingBox(self.student, stage_cfg, **kwargs)

    def train(self, dst_ckpt=None, resume: bool = False):
        """Run the config's training stages; returns the best validation
        acc1. `resume=True` restores the state saved beside `dst_ckpt`
        and, when its stage is the first stage, continues after the saved
        epoch (the JAX engine's rule)."""
        if self.wrapper is not None:
            raise ValueError('wrapper (input/feature compression) configs '
                             'are test-only — run with -test_only '
                             '(reference protocol)')
        train_config = self.config.get('train', {})
        stages = train_stage_configs(train_config)
        if self.config.get('adjust_lr'):
            stages = scale_stage_lrs(stages, world_size())
        train_loader = self.build_loader(train_config.get(
            'train_data_loader', DEFAULT_TRAIN_LOADER),
            shard_over_processes=True)
        val_loader = self.build_loader(train_config.get(
            'val_data_loader', DEFAULT_VAL_LOADER), shard_over_processes=True)
        # the NaN/Inf abort reads a device-side loss sum every k steps
        nan_check_interval = int(train_config.get('nan_check_interval', 50))
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        best_metric, resumed = -1.0, False
        for stage_cfg in stages:
            name = stage_cfg.get('name')
            logger.info('=== stage %s ===', name)
            box = self._box(stage_cfg, max(len(train_loader), 1), generator)
            epoch_to_update = stage_cfg.get('epoch_to_update')
            num_epochs = int(stage_cfg.get('num_epochs', 1))
            start_epoch = 0
            if resume and dst_ckpt and not resumed:
                saved = load_train_state(dst_ckpt, map_location=self.device)
                if saved is not None:
                    resumed = True
                    best_metric = saved['best_metric']
                    if saved['stage'] == name:
                        self.student.load_state_dict(saved['model'])
                        box.optim.load_state_dict(saved['optimizer'])
                        start_epoch = saved['epoch'] + 1
                        logger.info('resumed stage %s at epoch %d', name,
                                    start_epoch)
            for epoch in range(start_epoch, num_epochs):
                meter = MetricLogger()
                acc = MetricAccumulator(meter, nan_check_interval)
                for x, y in train_loader:
                    metrics = box.train_step(
                        self._to_device(x),
                        torch.as_tensor(y, device=self.device))
                    acc.push(sum(metrics['loss'].values()),
                             metrics['aux_loss'])
                acc.drain()
                logger.info('stage %s epoch %d: %s', name, epoch, str(meter))
                if epoch_to_update is not None \
                        and epoch + 1 >= int(epoch_to_update) \
                        and not self.runtime.bottleneck_updated:
                    self.runtime.update()
                    box.student_mode = 'finetune'
                    logger.info('bottleneck updated (tables built)')
                metric = self.evaluate(val_loader).get('acc1', 0.0)
                if metric > best_metric:
                    best_metric = metric
                    if dst_ckpt:
                        save_ckpt(dst_ckpt, self.student.state_dict(),
                                  meta={'best_metric': best_metric})
                if dst_ckpt:
                    save_train_state(dst_ckpt, self.student.state_dict(),
                                     box.optim.state_dict(), epoch, name,
                                     best_metric)
        # the test protocol expects tables
        if not self.runtime.bottleneck_updated and self.runtime.codec:
            self.runtime.update()
        return best_metric

    def test(self):
        """(metrics, data-size summaries) of the student on the test loader:
        tables built, analysis on, every image through the bitstream; a
        student without an entropy model through the 'finetune' forward,
        with nothing accounted."""
        loader = self.build_loader(self.config.get('test', {}).get(
            'test_data_loader', DEFAULT_TEST_LOADER))
        if self.wrapper is not None:
            return self._test_wrapper(loader)
        codec = self.runtime.codec
        if not self.runtime.bottleneck_updated and codec:
            self.runtime.update()
        self.runtime.activate_analysis()
        result = self.evaluate(loader, use_deploy_path=bool(
            codec and self.runtime.bottleneck_updated))
        return result, self.runtime.summarize()

    @torch.no_grad()
    def _test_wrapper(self, loader):
        """(metrics, summaries) of a wrapper: analysis on, each batch to the
        wrapper as a list of HWC images, top-1/top-5 a batch, and
        `model_time`, the host-clock seconds of a batch."""
        self.wrapper.activate_analysis()
        meter = MetricLogger()
        for x, y in loader:
            t0 = time.time()
            logits = self.wrapper([np.asarray(img) for img in np.asarray(x)])
            accs = {k: float(v) for k, v in top_k_accuracy(
                logits, torch.as_tensor(y, device=logits.device)).items()}
            meter.update(model_time=time.time() - t0, **accs)
        meter.synchronize_between_processes()
        result = {k: m.global_avg for k, m in meter.meters.items()}
        logger.info('wrapper eval: %s', result)
        return result, self.wrapper.summarize()
