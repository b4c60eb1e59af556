"""Training and distillation boxes (counterpart of
`sc2bench_tpu/train/box.py`).

A box is one training stage: the student, an optional teacher, the
config's criterion and the stage's optimizers. The teacher and the student
run with an explicit `io` dict that their forwards fill with the captured
intermediates under the JAX package's dotted names; that dict is the
criterion's input, as the flattened Flax capture is in JAX.

One step, as the JAX step computes it:
  1. the teacher's forward in eval mode, without gradients;
  2. the student's forward in `student_mode` ('train': noisy latent and
     likelihoods; 'finetune': the dequantized latent), BatchNorm in train
     mode only when the stage sets `train_bn`;
  3. loss = criterion + the aux (quantile) loss of every entropy
     bottleneck;
  4. backward;
  5. the optimizers step (`optim.StageOptimizer`);
  6. metrics {'loss': detail, 'aux_loss', 'acc1'}, tensors on the device
     (`acc1` for a classifier's 2-D logits only).
While a profiler runs, steps 1-5 are the spans `train.teacher_forward`,
`train.student_forward`, `train.loss`, `train.backward` (device-timed) and
`train.optimizer_step`, and `train.steps` counts the steps
(`utils/profiling.py`).
A dict output (segmentation's {'out', 'aux'}) is recorded as 'output' (the
main head) and 'output.<k>' (`record_output`).
A new box, and so new optimizer state, comes with each stage. The
teacher's parameters never change.

In a data-parallel group (`parallel/dist.py`) each rank steps on its
block of the global batch: the box broadcasts the student from rank 0
when the stage starts, and the optimizers average the trainable
gradients over the group before they step; the noise, BatchNorm's
statistics and the losses' denominators are the global batch's.
"""
from __future__ import annotations

import torch

from ..loss import build_criterion
from ..ops.entropy.factorized import EntropyBottleneck
from ..parallel.dist import broadcast_module
from ..utils.profiling import count, span
from .optim import StageOptimizer

DEFAULT_CRITERION = {'key': 'CrossEntropyLoss',
                     'kwargs': {'module_path': 'output'}}
DEFAULT_OPTIMIZER = {'key': 'SGD', 'kwargs': {'lr': 0.01}}


def record_output(io: dict, out) -> None:
    """The model's output into `io`: 'output' itself, or for a dict output
    (segmentation's {'out', 'aux'}) 'output' = the main head ('out', else
    the first) and 'output.<k>' each head, as the JAX box records it."""
    if isinstance(out, dict):
        for k, v in out.items():
            io[f'output.{k}'] = v
        io['output'] = out.get('out', next(iter(out.values())))
    else:
        io['output'] = out


def factorized_aux_loss(model: torch.nn.Module) -> torch.Tensor:
    """Sum of `aux_loss()` over every `EntropyBottleneck` in `model` (only
    `quantiles` get its gradient)."""
    total = None
    for m in model.modules():
        if isinstance(m, EntropyBottleneck):
            a = m.aux_loss()
            total = a if total is None else total + a
    if total is None:
        return torch.zeros((), device=next(model.parameters()).device)
    return total


class DistillationBox:
    """One stage: teacher (frozen, eval) + student + criterion + the
    stage's optimizers. `student_mode` is 'train' before `update()` and
    'finetune' after; `generator` supplies the 'train' mode's noise."""

    def __init__(self, student: torch.nn.Module, stage_config: dict,
                 teacher: torch.nn.Module | None = None,
                 steps_per_epoch: int = 1, student_mode: str = 'train',
                 generator: torch.Generator | None = None):
        self.student = student
        self.teacher = teacher
        self.stage_config = stage_config
        self.student_mode = student_mode
        self.generator = generator
        self.num_epochs = int(stage_config.get('num_epochs', 1))
        self.criterion = build_criterion(
            stage_config.get('criterion', DEFAULT_CRITERION))
        self.train_bn = stage_config.get('train_bn', True)
        self.optim = StageOptimizer(
            student, stage_config.get('optimizer', DEFAULT_OPTIMIZER),
            stage_config.get('scheduler'),
            stage_config.get('frozen_modules', []),
            steps_per_epoch=steps_per_epoch, num_epochs=self.num_epochs,
            grad_accum_step=int(stage_config.get('grad_accum_step', 1)),
            aux_lr=float(stage_config.get('aux_lr', 1e-3)))
        if teacher is not None:
            teacher.eval().requires_grad_(False)
        # a data-parallel group starts each stage from rank 0's student
        broadcast_module(student)

    def _teacher_io(self, x) -> dict:
        if self.teacher is None:
            return {}
        io = {}
        with span('train.teacher_forward'), torch.no_grad():
            record_output(io, self.teacher(x, io=io))
        return io

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> dict:
        """One optimizer step on the batch (x NCHW, y labels); returns the
        step's metrics as device tensors."""
        count('train.steps')
        teacher_io = self._teacher_io(x)
        self.student.train(self.train_bn)
        try:
            io = {}
            with span('train.student_forward'):
                out = self.student(x, mode=self.student_mode,
                                   generator=self.generator, io=io)
                record_output(io, out)
            with span('train.loss'):
                main_loss, detail = self.criterion(io, teacher_io, y)
                aux = factorized_aux_loss(self.student)
            self.optim.zero_grad()
            with span('train.backward', device=True):
                (main_loss + aux).backward()
            self.optim.step()
        finally:
            self.student.eval()
        metrics = {'loss': {k: v.detach() for k, v in detail.items()},
                   'aux_loss': aux.detach()}
        if y is not None and torch.is_tensor(out) and out.ndim == 2:
            metrics['acc1'] = (out.detach().argmax(-1) == y).to(
                torch.float32).mean()
        return metrics


class TrainingBox(DistillationBox):
    """Teacher-free stage."""

    def __init__(self, student, stage_config, **kwargs):
        super().__init__(student, stage_config, teacher=None, **kwargs)
