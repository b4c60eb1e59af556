"""Plain reference of stage 1 of the Entropic Student's training.

One step on a batch x, as sc2-benchmark's distillation box computes it
for the config's stage 1:
  1. the teacher (ResNet-50, eval) gives layer1-4 outputs, no gradient;
  2. the student (BatchNorm on running statistics: `train_bn` false)
     encodes x, adds the uniform noise it is handed (the quantization
     proxy), evaluates the factorized prior's likelihoods, decodes, and
     runs layer2-4 and fc;
  3. the criterion: the weighted sum of the config's terms (MSE with
     reduction 'sum' between named student and teacher outputs, and the
     rate -sum(log2 p) / batch), plus the quantiles' aux loss;
  4. gradients of every trainable tensor (not under a frozen prefix);
  5. Adam (optax's arithmetic: float32 bias corrections, the update
     mu_hat / (sqrt(nu_hat) + eps)) on the main tensors at the config's
     rate and on the quantiles at the aux rate. The schedule's first
     milestone is five epochs of 5,004 steps away, further than a run
     steps, so the rate is the config's base rate.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resnet_fp as R

BETAS, EPS = (0.9, 0.999), 1e-8


def trainable(name, frozen):
    """A parameter (not a BatchNorm statistic) under no frozen prefix."""
    if name.endswith(('running_mean', 'running_var', 'num_batches_tracked')):
        return False
    return not any(name == f or name.startswith(f + '.') for f in frozen)


def forward_terms(sd, tsd, x, noise, stage):
    """{term: value} of the config's criterion and 'aux', and the total
    (criterion + aux)."""
    tio = {}
    with torch.no_grad():
        R.teacher_forward(tsd, x, tio)
    y = R.encode(sd, x)
    y_hat = y + noise
    lik = R.likelihoods(sd, y_hat)
    sio = {'bottleneck_layer_out': R.decode(sd, y_hat)}
    l4 = R.tail(sd, sio['bottleneck_layer_out'], sio)
    R.head(sd, l4)
    terms, total = {}, 0.0
    for name, sub in stage['criterion']['kwargs']['sub_terms'].items():
        crit, kw = sub['criterion']['key'], sub['criterion']['kwargs']
        if crit == 'MSELoss':
            d = sio[kw['student_module_path']] - tio[kw['teacher_module_path']]
            value = torch.sum(d * d) if kw['reduction'] == 'sum' \
                else torch.mean(d * d)
        elif crit == 'BppLoss':
            value = -torch.sum(torch.log2(lik)) / x.shape[0]
        else:
            raise KeyError(f'no reference for {crit}')
        terms[name] = value
        total = total + sub['weight'] * value
    terms['aux'] = R.aux_loss(sd)
    return terms, total + terms['aux']


def _adam(p, g, state, lr):
    b1, b2 = BETAS
    state['step'] = state.get('step', 0) + 1
    mu = state.setdefault('mu', torch.zeros_like(p))
    nu = state.setdefault('nu', torch.zeros_like(p))
    mu.mul_(b1).add_(g, alpha=1.0 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    count = np.float32(state['step'])
    bc1 = float(np.float32(1) - np.float32(b1) ** count)
    bc2 = float(np.float32(1) - np.float32(b2) ** count)
    denom = (nu / bc2).sqrt_().add_(EPS)
    p.add_((mu / bc1).div_(denom), alpha=-lr)


def train(init, tsd, batches, noises, stage, aux_lr=1e-3, opt=None):
    """Follow len(noises) steps from the state `init` and the Adam state
    `opt` ({name: {'step', 'mu', 'nu'}}, fresh if None); step i takes
    batches[i] and noises[i]. Returns (per step {term: float}, the first
    step's gradients {name: tensor}, the trained state)."""
    frozen = stage.get('frozen_modules', [])
    lr = float(stage['optimizer']['kwargs']['lr'])
    sd = {k: v.detach().clone() for k, v in init.items()}
    names = [k for k in sd if trainable(k, frozen)]
    opt = {k: {n: v.clone() if torch.is_tensor(v) else v
               for n, v in st.items()} for k, st in (opt or {}).items()}
    losses, first = [], None
    for x, noise in zip(batches, noises):
        leaves = {k: sd[k].requires_grad_(True) for k in names}
        terms, total = forward_terms(sd, tsd, x, noise, stage)
        grads = torch.autograd.grad(total, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(sd[k]) if g is None else g
                 for k, g in zip(names, grads)}
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in names:
                sd[k] = sd[k].detach()
                _adam(sd[k], grads[k], opt.setdefault(k, {}),
                      aux_lr if k.endswith('quantiles') else lr)
        del terms, total, grads, leaves
    return losses, first, {k: v.detach() for k, v in sd.items()}


def flops_of_step(sd, tsd, x, noise, stage):
    """One step's forward and backward, for FLOP counting on meta
    tensors."""
    frozen = stage.get('frozen_modules', [])
    names = [k for k in sd if trainable(k, frozen)]
    sd = dict(sd)
    for k in names:
        sd[k] = sd[k].detach().requires_grad_(True)
    _, total = forward_terms(sd, tsd, x, noise, stage)
    torch.autograd.grad(total, [sd[k] for k in names], allow_unused=True)
