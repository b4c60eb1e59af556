"""Optimizers and schedules from the reference's config schema (counterpart
of `sc2bench_tpu/train/optim.py`).

Config shapes:
  optimizer: {key: 'SGD'|'Adam'|'AdamW', kwargs: {lr, momentum,
              weight_decay, betas, eps}, module_wise_kwargs: [{module,
              kwargs}]}
  scheduler: {key: 'MultiStepLR'|'CosineAnnealingLR'|'poly'|'LambdaLR'|
              'PolynomialLR'|'StepLR', kwargs}
  frozen_modules: [parameter-path prefixes]
  grad_accum_step: k

Configs name parameters in the JAX package's Flax paths
(`bottleneck_layer.enc_*`); `label_params` labels each torch parameter by
its Flax path (`utils/convert.flax_param_path`): 'aux' (a path ending in
`quantiles`) before 'frozen', then 'mw{i}' (module-wise groups), else
'main'. A frozen parameter takes no gradient and sits in no optimizer;
activation gradients still flow through its layer. The `quantiles` keep
training on the aux loss in a separate Adam at `aux_lr`.

`StageOptimizer` matches the JAX package's optax chain step for step:
  - SGD with momentum is optax's `trace` (torch's momentum at zero
    dampening); `weight_decay` is `add_decayed_weights` ahead of SGD or
    Adam, torch's coupled weight decay; AdamW decays decoupled on both;
  - Adam and AdamW are `Adam` below, optax's arithmetic: its bias
    corrections are float32 (torch's are float64, a 1e-5 relative
    difference in the first updates at beta2 = 0.999);
  - schedules are functions of the count of applied updates, as optax's
    are: epoch milestones fall at `milestone * steps_per_epoch`, and the
    learning rate is set before every update;
  - `grad_accum_step = k` applies the mean gradient every k micro-steps
    (`optax.MultiSteps`, its running mean), the schedule counting applied
    updates; the aux Adam, outside MultiSteps in JAX, steps every
    micro-step;
  - a parameter of the main groups that the loss does not reach gets a
    zero gradient, as it does in JAX (so weight decay and momentum still
    act on it).
"""
from __future__ import annotations

import math
from fnmatch import fnmatchcase
from typing import Callable, Sequence

import numpy as np
import torch

from ..parallel.dist import average_gradients
from ..utils.convert import flax_param_path
from ..utils.profiling import span


def _matches(path_str: str, prefix: str) -> bool:
    """True when `prefix` (dotted) appears as consecutive full path
    segments, so 'fc' does not also match 'fc_head.*'. Segments may be
    fnmatch globs (`bottleneck_layer.enc_*`)."""
    segs = path_str.split('.')
    pre = prefix.split('.')

    def seg_eq(s, p):
        return fnmatchcase(s, p) if any(ch in p for ch in '*?[') else s == p

    return any(all(seg_eq(s, p) for s, p in zip(segs[i:], pre))
               for i in range(len(segs) - len(pre) + 1))


def label_params(model: torch.nn.Module, frozen_prefixes: Sequence[str] = (),
                 module_wise: Sequence[dict] = ()) -> dict:
    """{torch parameter name: 'aux' | 'frozen' | 'mw{i}' | 'main'}, matched
    on each parameter's Flax path."""
    labels = {}
    for name, _ in model.named_parameters():
        path = flax_param_path(name, model)
        if path.endswith('quantiles'):
            labels[name] = 'aux'
        elif any(_matches(path, p) for p in frozen_prefixes):
            labels[name] = 'frozen'
        else:
            labels[name] = next(
                (f'mw{i}' for i, entry in enumerate(module_wise)
                 if _matches(path, entry['module'])), 'main')
    return labels


def build_schedule(scheduler_config, base_lr: float,
                   steps_per_epoch: int = 1, num_epochs: int = 1
                   ) -> Callable[[int], float]:
    """The learning rate as a function of the count of applied updates,
    optax's schedule for the config."""
    if not scheduler_config:
        return lambda count: base_lr
    key = scheduler_config['key']
    kwargs = dict(scheduler_config.get('kwargs', {}))
    if key == 'MultiStepLR':
        gamma = kwargs.get('gamma', 0.1)
        boundaries = {int(m * steps_per_epoch): gamma
                      for m in kwargs.get('milestones', [])}

        def multistep(count):
            lr = base_lr
            for bound, scale in sorted(boundaries.items()):
                if count >= bound:
                    lr *= scale
            return lr
        return multistep
    if key == 'CosineAnnealingLR':
        t_max = kwargs.get('T_max', num_epochs) * steps_per_epoch
        if not t_max > 0:
            raise ValueError(f'CosineAnnealingLR needs T_max > 0, got {t_max}')
        alpha = kwargs.get('eta_min', 0.0) / max(base_lr, 1e-12)

        def cosine(count):
            c = min(count, t_max)
            decay = 0.5 * (1 + math.cos(math.pi * c / t_max))
            return base_lr * ((1 - alpha) * decay + alpha)
        return cosine
    if key in ('poly', 'LambdaLR', 'PolynomialLR'):
        # lr * (1 - iter/total) ** power, to 0 at `total_iters`
        power = kwargs.get('power', 0.9)
        total = kwargs.get('total_iters', num_epochs * steps_per_epoch)
        if total <= 0:
            return lambda count: base_lr

        def poly(count):
            c = min(max(count, 0), total)
            return base_lr * (1 - c / total) ** power
        return poly
    if key == 'StepLR':
        step = kwargs.get('step_size', 1) * steps_per_epoch
        gamma = kwargs.get('gamma', 0.1)
        if step <= 0 or gamma == 0:
            return lambda count: base_lr
        return lambda count: base_lr if count <= 0 \
            else base_lr * gamma ** math.floor(count / step)
    raise KeyError(f'unknown scheduler `{key}`')


class Adam(torch.optim.Optimizer):
    """optax's `adam` (and `adamw` with `decoupled=True`) as a torch
    optimizer: moments mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2)
    g^2, bias corrections 1 - b^count in float32, the update
    mu_hat / (sqrt(nu_hat) + eps), plus weight_decay * p when decoupled,
    times -lr. Coupled `weight_decay` adds weight_decay * p to the
    gradient first (optax's `add_decayed_weights` ahead of `adam`)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decoupled: bool = False):
        super().__init__(params, {'lr': lr, 'betas': tuple(betas),
                                  'eps': eps, 'weight_decay': weight_decay,
                                  'decoupled': decoupled})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group['betas']
            wd, lr = group['weight_decay'], group['lr']
            grads = [p.grad for p in params]
            if wd and not group['decoupled']:
                grads = torch._foreach_add(grads, params, alpha=wd)
            states = [self.state[p] for p in params]
            for st, p in zip(states, params):
                if not st:
                    st['step'] = 0
                    st['mu'] = torch.zeros_like(p)
                    st['nu'] = torch.zeros_like(p)
                st['step'] += 1
            mus = [st['mu'] for st in states]
            nus = [st['nu'] for st in states]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            count = np.float32(states[0]['step'])
            bc1 = float(np.float32(1) - np.float32(b1) ** count)
            bc2 = float(np.float32(1) - np.float32(b2) ** count)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group['eps'])
            updates = torch._foreach_div(mus, bc1)
            torch._foreach_div_(updates, denom)
            if wd and group['decoupled']:
                torch._foreach_add_(updates, params, alpha=wd)
            torch._foreach_add_(params, updates, alpha=-lr)


def _group_options(key: str, kwargs: dict) -> tuple[type, dict, float]:
    """(optimizer class, per-group options without lr, lr) for one group's
    merged optimizer kwargs; keys the JAX builder does not read are
    ignored there and here."""
    lr = float(kwargs.get('lr', 1e-3))
    wd = float(kwargs.get('weight_decay', 0.0))
    if key in ('SGD', 'sgd'):
        return torch.optim.SGD, {'momentum': float(kwargs.get('momentum')
                                                   or 0.0),
                                 'weight_decay': wd}, lr
    if key in ('Adam', 'adam', 'AdamW', 'adamw'):
        return Adam, {'betas': tuple(kwargs.get('betas', (0.9, 0.999))),
                      'eps': float(kwargs.get('eps', 1e-8)),
                      'weight_decay': wd,
                      'decoupled': key in ('AdamW', 'adamw')}, lr
    raise KeyError(f'unknown optimizer `{key}`')


class StageOptimizer:
    """The optimizers of one training stage over `model`'s parameters:
    the main optimizer (one param group for 'main' and one per
    module-wise group, each with its own schedule), the aux Adam over the
    `quantiles`, nothing for frozen parameters (their `requires_grad` is
    turned off here). Call `zero_grad()`, backward, then `step()`. In a
    data-parallel group `step()` first averages the trainable gradients
    over the group (`parallel.dist.average_gradients`)."""

    def __init__(self, model: torch.nn.Module, optimizer_config: dict,
                 scheduler_config: dict | None = None,
                 frozen_modules: Sequence[str] = (),
                 steps_per_epoch: int = 1, num_epochs: int = 1,
                 grad_accum_step: int = 1, aux_lr: float = 1e-3):
        module_wise = list(optimizer_config.get('module_wise_kwargs', ()))
        self.labels = label_params(model, frozen_modules, module_wise)
        params = dict(model.named_parameters())
        for name, p in params.items():
            p.requires_grad_(self.labels[name] != 'frozen')
        key = optimizer_config['key']
        base_kwargs = dict(optimizer_config.get('kwargs', {}))
        groups, self._schedules = [], []
        for label, extra in [('main', {})] + [
                (f'mw{i}', entry.get('kwargs', {}))
                for i, entry in enumerate(module_wise)]:
            members = [p for n, p in params.items()
                       if self.labels[n] == label]
            if not members:
                continue
            cls, options, lr = _group_options(key, {**base_kwargs, **extra})
            groups.append({'params': members, 'lr': lr, **options})
            self._schedules.append(build_schedule(
                scheduler_config, lr, steps_per_epoch, num_epochs))
        self.main = cls(groups) if groups else None
        aux = [p for n, p in params.items() if self.labels[n] == 'aux']
        self.aux = Adam(aux, lr=aux_lr) if aux else None
        self.grad_accum_step = max(int(grad_accum_step), 1)
        self.count = 0          # applied updates of the main optimizer
        self.mini_step = 0      # micro-steps accumulated toward the next
        self._acc = None

    def _trainable(self):
        return [p for opt in (self.main, self.aux) if opt is not None
                for g in opt.param_groups for p in g['params']]

    def _main_params(self):
        return [p for g in self.main.param_groups for p in g['params']]

    def zero_grad(self) -> None:
        for opt in (self.main, self.aux):
            if opt is not None:
                opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> bool:
        """One micro-step: the aux Adam steps; the main optimizer steps on
        this gradient, or on the mean of the last `grad_accum_step` ones
        when this micro-step completes them. Returns whether the main
        parameters were updated."""
        with span('train.optimizer_step'):
            average_gradients(self._trainable())
            if self.aux is not None:
                self.aux.step()
            if self.main is None:
                return False
            params = self._main_params()
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            k = self.grad_accum_step
            if k > 1:
                if self._acc is None:
                    self._acc = [torch.zeros_like(p) for p in params]
                for p, acc in zip(params, self._acc):
                    acc.add_((p.grad - acc) / (self.mini_step + 1))
                self.mini_step += 1
                if self.mini_step < k:
                    return False
                self.mini_step = 0
                for p, acc in zip(params, self._acc):
                    p.grad = acc.clone()
                    acc.zero_()
            for group, schedule in zip(self.main.param_groups,
                                       self._schedules):
                group['lr'] = schedule(self.count)
            self.main.step()
            self.count += 1
            return True

    def state_dict(self) -> dict:
        return {'main': self.main.state_dict() if self.main else None,
                'aux': self.aux.state_dict() if self.aux else None,
                'count': self.count, 'mini_step': self.mini_step,
                'acc': self._acc}

    def load_state_dict(self, state: dict) -> None:
        for opt, key in ((self.main, 'main'), (self.aux, 'aux')):
            if opt is not None:
                opt.load_state_dict(state[key])
        self.count = int(state['count'])
        self.mini_step = int(state['mini_step'])
        self._acc = None if state['acc'] is None else [
            a.to(p.device) for a, p in zip(state['acc'], self._main_params())]
