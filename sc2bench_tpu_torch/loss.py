"""Training losses (counterpart of `sc2bench_tpu/loss.py`): the rate (bpp)
term, the hint and distillation terms, and the config-composed weighted
sum that the training boxes use.

Every term is a callable (student_io, teacher_io, targets) -> scalar
tensor over io dicts of captured intermediates, keyed by the JAX
package's dotted names (`bottleneck_layer_out`, `layer2_out`,
`bottleneck_layer.eb_out`, `output`). Activations are NCHW here, where the
JAX package's are NHWC. Terms register under the 'loss' namespace.

In a data-parallel group of W processes each term returns W times this
rank's share of the global-batch loss, so that the gradients' average
over the group (the box's all-reduce) is the gradient of the global
batch's loss, as JAX computes it on its mesh: a 'sum' reduction is
multiplied by W, a mean over equal shards is left as it is, and a
data-dependent denominator (the valid pixels of `SegCrossEntropyLoss`)
is the group's count. The mean of the ranks' values is the global
loss. One process: W = 1 and nothing changes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .parallel.dist import global_count, world_size
from .registry import get, register_loss


def _lookup_io(io_dict, path: str, key: str = 'output'):
    entry = io_dict[path]
    if isinstance(entry, dict):
        return entry[key]
    return entry


def _integer_label_ce(logits, targets):
    """Per-row softmax cross entropy with integer labels."""
    return -torch.gather(F.log_softmax(logits, dim=-1), -1,
                         targets.long()[:, None])[:, 0]


@register_loss
class BppLoss:
    """Bit-per-pixel rate term: -sum(log2(likelihoods)) with 'sum',
    'batchmean' or 'mean' (divided by n*h*w) reduction. The entropy
    module's captured output is (y_hat, likelihoods), NCHW."""

    def __init__(self, entropy_module_path, reduction='mean'):
        self.entropy_module_path = entropy_module_path
        self.reduction = reduction

    def __call__(self, student_io_dict, teacher_io_dict=None, targets=None,
                 **kwargs):
        features, likelihoods = _lookup_io(student_io_dict,
                                           self.entropy_module_path)
        n, h, w = features.shape[0], features.shape[2], features.shape[3]
        nll = -torch.sum(torch.log2(likelihoods))
        if self.reduction == 'sum':
            return nll * world_size()
        if self.reduction == 'batchmean':
            return nll / n
        return nll / (n * h * w)


@register_loss
class MSELoss:
    """Hint (feature-matching) loss between a student and a teacher
    intermediate activation."""

    def __init__(self, student_module_path, teacher_module_path,
                 reduction='sum', student_io='output', teacher_io='output'):
        self.student_module_path = student_module_path
        self.teacher_module_path = teacher_module_path
        self.reduction = reduction
        self.student_io = student_io
        self.teacher_io = teacher_io

    def __call__(self, student_io_dict, teacher_io_dict, targets=None,
                 **kwargs):
        s = _lookup_io(student_io_dict, self.student_module_path,
                       self.student_io)
        t = _lookup_io(teacher_io_dict, self.teacher_module_path,
                       self.teacher_io)
        if isinstance(s, tuple):
            s = s[0]
        if isinstance(t, tuple):
            t = t[0]
        diff = (s - t) ** 2
        if self.reduction == 'sum':
            return torch.sum(diff) * world_size()
        if self.reduction == 'batchmean':
            return torch.sum(diff) / s.shape[0]
        return torch.mean(diff)


@register_loss
class CrossEntropyLoss:
    """Softmax cross entropy on the output logits; label smoothing as the
    JAX package mixes it: (1 - eps) * CE + eps * CE against the uniform
    distribution."""

    def __init__(self, module_path='.', reduction='mean', label_smoothing=0.0):
        self.module_path = module_path
        self.reduction = reduction
        self.label_smoothing = label_smoothing

    def __call__(self, student_io_dict, teacher_io_dict=None, targets=None,
                 **kwargs):
        logits = _lookup_io(student_io_dict, self.module_path)
        losses = _integer_label_ce(logits, targets)
        if self.label_smoothing:
            smooth = -torch.mean(F.log_softmax(logits, dim=-1), dim=-1)
            losses = (1 - self.label_smoothing) * losses \
                + self.label_smoothing * smooth
        if self.reduction == 'sum':
            return torch.sum(losses) * world_size()
        return torch.mean(losses)


@register_loss
class KDLoss:
    """Hinton distillation: alpha * T^2 * KL(teacher || student), the
    batch mean of sum q * (log clip(q, 1e-30) - log_softmax(s / T)), plus
    (1 - alpha) * CE(student, labels)."""

    def __init__(self, student_module_path='.', teacher_module_path='.',
                 temperature=1.0, alpha=0.5, reduction='batchmean', **kwargs):
        self.student_module_path = student_module_path
        self.teacher_module_path = teacher_module_path
        self.temperature = temperature
        self.alpha = alpha
        self.reduction = reduction

    def __call__(self, student_io_dict, teacher_io_dict, targets=None,
                 **kwargs):
        s_logits = _lookup_io(student_io_dict, self.student_module_path)
        t_logits = _lookup_io(teacher_io_dict, self.teacher_module_path)
        T = self.temperature
        log_p = F.log_softmax(s_logits / T, dim=-1)
        q = F.softmax(t_logits / T, dim=-1)
        kl = torch.sum(q * (torch.log(torch.clamp_min(q, 1e-30)) - log_p),
                       dim=-1)
        soft = torch.mean(kl)
        hard = 0.0
        if targets is not None and self.alpha < 1.0:
            hard = torch.mean(_integer_label_ce(s_logits, targets))
        return self.alpha * (T ** 2) * soft + (1 - self.alpha) * hard


@register_loss
class SegCrossEntropyLoss:
    """Pixel cross entropy with `ignore_index` over NCHW logits (classes on
    axis 1) and (N, H, W) targets, mean over the valid pixels, plus
    `aux_weight` times the same on an auxiliary head when present."""

    def __init__(self, module_path='output', aux_module_path=None,
                 aux_weight=0.5, ignore_index=255):
        self.module_path = module_path
        self.aux_module_path = aux_module_path
        self.aux_weight = aux_weight
        self.ignore_index = ignore_index

    def _ce(self, logits, targets):
        valid = targets != self.ignore_index
        safe_t = torch.where(valid, targets, torch.zeros_like(targets))
        log_probs = F.log_softmax(logits, dim=1)
        ce = -torch.gather(log_probs, 1, safe_t.long()[:, None])[:, 0]
        total = torch.sum(torch.where(valid, ce, torch.zeros_like(ce)))
        return total * world_size() \
            / torch.clamp_min(global_count(torch.sum(valid)), 1)

    def __call__(self, student_io_dict, teacher_io_dict=None, targets=None,
                 **kwargs):
        loss = self._ce(_lookup_io(student_io_dict, self.module_path),
                        targets)
        if self.aux_module_path and self.aux_module_path in student_io_dict:
            loss = loss + self.aux_weight * self._ce(
                _lookup_io(student_io_dict, self.aux_module_path), targets)
        return loss


class WeightedSumLoss:
    """Sum of weight_i * term_i over the config's `sub_terms`. Returns
    (total, {name: term value})."""

    def __init__(self, sub_terms: dict):
        self.terms = {}
        for name, cfg in sub_terms.items():
            criterion_cfg = cfg['criterion']
            cls = get('loss', criterion_cfg['key'])
            self.terms[name] = (cls(**criterion_cfg.get('kwargs', {})),
                                float(cfg.get('weight', 1.0)))

    def __call__(self, student_io_dict, teacher_io_dict=None, targets=None,
                 **kwargs):
        total = 0.0
        detail = {}
        for name, (term, weight) in self.terms.items():
            value = term(student_io_dict, teacher_io_dict, targets, **kwargs)
            detail[name] = value
            total = total + weight * value
        return total, detail


def build_criterion(criterion_config):
    """The criterion of a stage config: a `WeightedSumLoss`, or one
    registered term, both returning (total, detail)."""
    key = criterion_config.get('key', 'WeightedSumLoss')
    if key != 'WeightedSumLoss':
        single = get('loss', key)(**criterion_config.get('kwargs', {}))

        def fn(s, t=None, y=None, **kw):
            v = single(s, t, y, **kw)
            return v, {key: v}
        return fn
    return WeightedSumLoss(criterion_config['kwargs']['sub_terms'])
