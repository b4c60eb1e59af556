"""Classification engine, the test-only half (counterpart of
`sc2bench_tpu/train/engine.py:ClassificationEngine`).

From a config it builds the teacher and the student (registry builders,
checkpoints), copies the teacher's layer2-4 and fc into the student as the
JAX engine does, and wraps the student in a `SplitClassifierRuntime`.
`test()` builds the tables and scores the student at batch 1 through the
real bitstream, with the data size of every image accounted: on the host
coder (`stream_deploy`, the default) or, with `deploy_wire: device` in the
config, on the device-rANS kernels (`stream_deploy_device`).

Loaders yield NHWC numpy batches; the engine hands the runtime and the
models NCHW tensors on its device. Training and the wrapper (input- and
feature-compression) configs are not ported yet.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..datasets.image import build_sharded_loader
from ..device import resolve_device
from ..models.registry import load_classification_model
from ..models.runtime import SplitClassifierRuntime
from ..registry import import_dependencies
from ..utils.ckpt import load_ckpt
from ..utils.metrics import MetricLogger

logger = logging.getLogger(__name__)

# the teacher's layers that initialize the student's tail
TAIL_PREFIXES = ('layer2', 'layer3', 'layer4', 'fc')
# a stream_deploy call serves at most this many images
STREAM_CHUNK = 64
DEFAULT_TEST_LOADER = {'dataset': {'key': 'SyntheticClassificationDataset',
                                   'kwargs': {}}, 'batch_size': 1}


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
    """Builds the models and loaders from a config dict and runs the test
    protocol, on `device` (CUDA unless asked otherwise)."""

    def __init__(self, config, device=None):
        import_dependencies(config.get('dependencies'))
        self.config = config
        self.device = resolve_device(device)
        models_config = config.get('models', {})
        if 'wrapper' in models_config:
            raise NotImplementedError(
                'wrapper (input- and feature-compression) configs are not '
                'ported yet (ROADMAP Queue A item 8)')
        self.teacher = None
        if 'teacher_model' in models_config:
            tm_cfg = models_config['teacher_model']
            torch.manual_seed(7)
            self.teacher = load_classification_model(
                tm_cfg, device=self.device).eval()
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
        self.student = load_classification_model(sm_cfg, device=self.device)
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
        state_dict, _, _ = load_ckpt(path)
        model.load_state_dict(state_dict)

    # ---- data -----------------------------------------------------------
    def build_loader(self, split_config):
        return build_sharded_loader(split_config)

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

            for x, y in data_loader:
                x = self._to_device(x)
                if x.shape[0] != 1 or not self.runtime.bottleneck_updated:
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

    def train(self, *args, **kwargs):
        raise NotImplementedError(
            'training is not ported yet (ROADMAP Queue A item 6); run the '
            'test protocol (test(), -test_only)')

    def test(self):
        """(metrics, data-size summaries) of the student on the test loader:
        tables built, analysis on, every image through the bitstream."""
        loader = self.build_loader(self.config.get('test', {}).get(
            'test_data_loader', DEFAULT_TEST_LOADER))
        if not self.runtime.bottleneck_updated:
            self.runtime.update()
        self.runtime.activate_analysis()
        result = self.evaluate(loader, use_deploy_path=True)
        return result, self.runtime.summarize()
