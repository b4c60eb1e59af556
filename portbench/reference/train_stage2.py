"""Plain reference of stage 2 of the Entropic Student's training, one step
over the whole global batch of a data-parallel group on one device.

As sc2-benchmark's distillation box computes the config's stage 2, after
`update()`:
  1. the teacher (ResNet-50, eval) gives its logits, no gradient;
  2. the student's frozen encoder gives the latent, rounded about the
     medians (round(y - median) + median), carrying no gradient;
  3. the decoder, layer2-4 with BatchNorm in training mode (the batch's
     own statistics over all the group's images: `train_bn` true), pool
     and fc give the student's logits;
  4. the criterion: Hinton's KD loss, alpha * T^2 * the batch mean of
     KL(teacher || student) at temperature T plus (1 - alpha) * the batch
     mean cross entropy, plus the quantiles' aux loss;
  5. gradients of every trainable tensor: the decoder, layer2-4, fc (the
     encoder and the entropy bottleneck are frozen but for its
     quantiles, which the aux loss alone reaches);
  6. SGD with momentum and coupled weight decay on those, as torch's SGD
     (no dampening, not Nesterov): d = g + wd * p, the buffer
     b = momentum * b + d (b = d on the first step), p - lr * b; Adam at
     the aux rate on the quantiles. The schedule's milestone is five
     epochs away, further than a run steps.

A group of R ranks of b images each averages R gradients of batch means
over b images, with BatchNorm's statistics summed over the group: that is
the gradient of the mean over all R * b images here. Each residual block
(and the decoder) is recomputed in the backward pass
(`torch.utils.checkpoint`), so that a thousand images fit one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import resnet_fp as R
from .train_stage1 import _adam

FROZEN = ('bottleneck_layer.encoder', 'bottleneck_layer.entropy_bottleneck')
TEACHER_BLOCK = 256


def trainable(name):
    """The decoder, layer2-4 and fc, and the quantiles (aux)."""
    if name.endswith(('running_mean', 'running_var', 'num_batches_tracked')):
        return False
    if name.endswith('.quantiles'):
        return True
    return not any(name.startswith(f + '.') for f in FROZEN)


def _bn_train(x, sd, prefix):
    return F.batch_norm(x, None, None, sd[f'{prefix}.weight'],
                        sd[f'{prefix}.bias'], True, 0.0, R.BN_EPS)


def _block(x, sd, prefix, stride):
    y = F.relu(_bn_train(F.conv2d(x, sd[f'{prefix}.conv1.weight']), sd,
                         f'{prefix}.bn1'))
    y = F.relu(_bn_train(F.conv2d(y, sd[f'{prefix}.conv2.weight'],
                                  stride=stride, padding=1), sd,
                         f'{prefix}.bn2'))
    y = _bn_train(F.conv2d(y, sd[f'{prefix}.conv3.weight']), sd,
                  f'{prefix}.bn3')
    if f'{prefix}.downsample.0.weight' in sd:
        x = _bn_train(F.conv2d(x, sd[f'{prefix}.downsample.0.weight'],
                               stride=stride), sd, f'{prefix}.downsample.1')
    return F.relu(y + x)


def _run(fn, x, recompute):
    return checkpoint(fn, x, use_reentrant=False) if recompute else fn(x)


def student_logits(sd, x, recompute=True):
    """The student's logits in training mode (module doc, steps 2-3)."""
    with torch.no_grad():
        y_hat = R.dequantize(sd, R.symbols(sd, x))
    feat = _run(lambda t: R.decode(sd, t), y_hat, recompute)
    for layer, _, blocks in R.STAGES:
        for b in range(blocks):
            feat = _run(lambda t, p=f'layer{layer}.{b}', s=2 if b == 0
                        else 1: _block(t, sd, p, s), feat, recompute)
    return R.head(sd, feat)


@torch.no_grad()
def teacher_logits(tsd, x):
    return torch.cat([R.teacher_forward(tsd, x[i:i + TEACHER_BLOCK], {})
                      for i in range(0, len(x), TEACHER_BLOCK)])


def kd_loss(s, t, y, temperature, alpha):
    """alpha T^2 mean KL(softmax(t/T) || softmax(s/T)) + (1 - alpha) mean
    CE(s, y), the teacher's probabilities clipped below at 1e-30 inside
    the log."""
    log_p = F.log_softmax(s / temperature, dim=-1)
    q = F.softmax(t / temperature, dim=-1)
    kl = torch.sum(q * (torch.log(q.clamp_min(1e-30)) - log_p), dim=-1)
    return alpha * temperature ** 2 * kl.mean() \
        + (1.0 - alpha) * F.cross_entropy(s, y)


def step(init, tsd, x, y, stage, aux_lr=1e-3, recompute=True, opt=None):
    """One step from `init` and the optimizer state `opt` ({name:
    {'momentum_buffer'}} for SGD's leaves, {name: {'step', 'mu', 'nu'}}
    for the quantiles; a first step if None) on the images x (n, 3, h, w)
    and labels y: ({'kd', 'aux'} as floats, {name: gradient}, the stepped
    state)."""
    kw = stage['criterion']['kwargs']
    sgd = stage['optimizer']['kwargs']
    sd = {k: v.detach().clone() for k, v in init.items()}
    names = [k for k in sd if trainable(k)]
    for k in names:
        sd[k].requires_grad_(True)
    t = teacher_logits(tsd, x)
    kd = kd_loss(student_logits(sd, x, recompute), t, y,
                 float(kw['temperature']), float(kw['alpha']))
    aux = R.aux_loss(sd)
    grads = torch.autograd.grad(kd + aux, [sd[k] for k in names],
                                allow_unused=True)
    grads = {k: torch.zeros_like(sd[k]) if g is None else g
             for k, g in zip(names, grads)}
    lr, wd = float(sgd['lr']), float(sgd.get('weight_decay', 0.0))
    momentum = float(sgd.get('momentum', 0.0))
    state = {k: {n: v.clone() if torch.is_tensor(v) else v
                 for n, v in st.items()} for k, st in (opt or {}).items()}
    with torch.no_grad():
        for k in names:
            sd[k] = sd[k].detach()
            if k.endswith('.quantiles'):
                _adam(sd[k], grads[k], state.get(k, {}), aux_lr)
                continue
            d = grads[k] + wd * sd[k]
            buf = state.get(k, {}).get('momentum_buffer')
            if momentum and buf is not None:
                d = momentum * buf + d
            sd[k].add_(d, alpha=-lr)
    return ({'kd': float(kd.detach()), 'aux': float(aux.detach())}, grads,
            {k: v.detach() for k, v in sd.items()})


def flops_of_step(sd, tsd, x, y, stage):
    """One step's forward and backward on meta tensors, for FLOP
    counting (nothing recomputed)."""
    kw = stage['criterion']['kwargs']
    sd = dict(sd)
    names = [k for k in sd if trainable(k)]
    for k in names:
        sd[k] = sd[k].detach().requires_grad_(True)
    loss = kd_loss(student_logits(sd, x, recompute=False),
                   teacher_logits(tsd, x), y, float(kw['temperature']),
                   float(kw['alpha']))
    torch.autograd.grad(loss, [sd[k] for k in names if 'quantiles' not in k],
                        allow_unused=True)
