"""Stage 1 of the Entropic Student's training on the program's
`DistillationBox.train_step`: the teacher (ResNet-50) and the student
(ResNet-50 + FP bottleneck) with the benchmark's weights, the config's
stage (Adam, hint MSE terms and the rate, layer2-4 frozen, BatchNorm on
running statistics, its learning-rate schedule counted in epochs of the
config's ImageNet loader), the noise drawn from a generator on the
device seeded from the run's seed.

Set-up drives the box through its first `followed_steps` steps on
batches that all differ, through the window's own call, and keeps what
the check reads: each step's loss terms, the generator's state before
each step (the noise the reference is handed), the Adam moments after
the first step and the parameters after the last. The window then steps
the same box on. Once it has closed, the box takes one more step through
the same call (`check_step`), warm as the window left it: the reference
follows that step from the program's own parameters and Adam moments.

`correct` compares, over the followed steps (module `check`):
    loss_gap         max over the steps and the criterion's terms (and
                     the aux loss) of |program - reference| / |reference|
    grad_norm_gap    the first step's gradient, as the program's Adam got
                     it (its first moment / (1 - beta1)): the worst
                     leaf's |norm - the reference's norm| over the larger
                     of that leaf's and the median leaf's reference norm
    update_norm_gap  the same of each leaf's change over the followed
                     steps
and over the step after the window:
    warm_loss_gap         as `loss_gap`
    warm_update_norm_gap  as `update_norm_gap`, of that step's change
Leaves whose reference gradient is under a thousandth of the median
leaf's (the fc, which no term reaches) are left out of the norm gaps.
"""
from __future__ import annotations

import torch

from ..reference import resnet_fp as R
from ..reference import train_stage1 as T
from ..roofline import count_flops
from ..weights import load_into, make_state
from .split_classifier import build_student, tf32

NEGLIGIBLE_GRAD = 1e-3


class Stage1Trainer:
    ranges = ()

    def __init__(self, config, traffic, seed, device):
        from sc2bench_tpu_torch.models.resnet import resnet50
        from sc2bench_tpu_torch.train.box import DistillationBox
        self.cfg = config['model']
        self.stage = dict(config['stage1'])
        self.device = torch.device(device)
        self.batch = int(traffic['batches']['batch'])
        self.state = make_state(R.student_specs(self.cfg), seed, self.device)
        self.tstate = make_state(R.teacher_specs(config['teacher']),
                                 int(seed) ^ 0x5EED, self.device)
        student = build_student(self.cfg, self.state, self.device)
        teacher = load_into(resnet50(num_classes=config['teacher'][
            'num_classes']).to(self.device), self.tstate)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        loader = config['train_loader']
        steps_per_epoch = (loader['images'] // loader['batch_size']
                           if loader['drop_last']
                           else -(-loader['images'] // loader['batch_size']))
        self.box = DistillationBox(student, self.stage, teacher=teacher,
                                   generator=self.gen,
                                   steps_per_epoch=steps_per_epoch)

    # ---- the driver's calls -------------------------------------------------
    def follow(self, batches):
        """The first steps, which the reference follows."""
        names = {p: n for n, p in self.box.student.named_parameters()}
        self.noise_states, self.losses = [], []
        for i, (x, y) in enumerate(batches):
            self.noise_states.append(self.gen.get_state())
            m = self.box.train_step(x, y)
            self.losses.append(dict(m['loss'], aux=m['aux_loss']))
            if i == 0:
                self.mu = {names[p]: st['mu'].clone()
                           for opt in (self.box.optim.main,
                                       self.box.optim.aux)
                           if opt is not None
                           for p, st in opt.state.items() if 'mu' in st}
        self.followed = [x for x, _ in batches]
        self.after = {n: p.detach().clone()
                      for n, p in self.box.student.named_parameters()}
        self.losses = [{k: float(v) for k, v in s.items()}
                       for s in self.losses]

    def step(self, x, y):
        return self.box.train_step(x, y)

    def check_step(self, x, y):
        """One step after the window, from the state the window left,
        which the reference follows from the same parameters and Adam
        moments."""
        names = {p: n for n, p in self.box.student.named_parameters()}
        self.warm_from = {k: v.detach().clone() for k, v in
                          self.box.student.state_dict().items()}
        self.warm_opt = {names[p]: {k: v.clone() if torch.is_tensor(v)
                                    else v for k, v in st.items()}
                         for opt in (self.box.optim.main, self.box.optim.aux)
                         if opt is not None for p, st in opt.state.items()}
        self.warm_noise = self.gen.get_state()
        m = self.box.train_step(x, y)
        self.warm_x = x
        self.warm_loss = {k: float(v) for k, v in
                          dict(m['loss'], aux=m['aux_loss']).items()}
        self.warm_after = {n: p.detach().clone()
                           for n, p in self.box.student.named_parameters()}

    def spans(self):
        return [(self.box, '_teacher_io', 'teacher_forward'),
                (self.box.student, 'forward', 'student_forward'),
                (self.box.optim, 'step', 'optimizer_step')]

    def finish(self):
        """Free the program before the reference runs."""
        self.box = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ---- the yardstick ------------------------------------------------------
    def flops_per_step(self):
        sd = {k: v.to('meta') for k, v in self.state.items()}
        tsd = {k: v.to('meta') for k, v in self.tstate.items()}
        h, w = self.cfg['input_size']
        x = torch.empty((self.batch, 3, h, w), device='meta')
        noise = torch.empty(self._latent(x.shape), device='meta')
        return count_flops(lambda: T.flops_of_step(sd, tsd, x, noise,
                                                   self.stage))

    def _latent(self, shape):
        n, _, h, w = shape
        for _ in range(2):
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        return (n, self.cfg['bottleneck_channels'], h - 1, w - 1)

    def _noise(self, state, x):
        g = torch.Generator(device=self.device)
        g.set_state(state)
        return torch.empty(self._latent(x.shape), device=self.device
                           ).uniform_(-0.5, 0.5, generator=g)

    def _reference(self, stand_in=None):
        with tf32(stand_in == 'tf32'):
            return T.train(self.state, self.tstate, self.followed,
                           [self._noise(s, x) for s, x in
                            zip(self.noise_states, self.followed)],
                           self.stage)

    def _reference_warm(self, stand_in=None):
        with tf32(stand_in == 'tf32'):
            return T.train(self.warm_from, self.tstate, [self.warm_x],
                           [self._noise(self.warm_noise, self.warm_x)],
                           self.stage, opt=self.warm_opt)

    def check(self, stand_in=None):
        """The numbers of the module doc. `stand_in` 'tf32' puts the
        reference, computed with TF32 on, in the program's place (the
        control)."""
        losses, grads, after = self._reference()
        (w_loss,), w_grads, w_after = self._reference_warm()
        if stand_in:
            p_losses, p_grads, p_after = self._reference(stand_in)
            (p_w_loss,), _, p_w_after = self._reference_warm(stand_in)
        else:
            b1 = T.BETAS[0]
            p_losses = self.losses
            p_grads = {k: self.mu[k] / (1.0 - b1) if k in self.mu
                       else torch.zeros_like(g) for k, g in grads.items()}
            p_after = self.after
            p_w_loss, p_w_after = self.warm_loss, self.warm_after
        counted, w_counted = _counted(grads), _counted(w_grads)
        return {'loss_gap': _loss_gap(p_losses, losses),
                'grad_norm_gap': _worst(p_grads, grads, counted),
                'update_norm_gap': _worst(
                    {k: p_after[k] - self.state[k] for k in counted},
                    {k: after[k] - self.state[k] for k in counted}, counted),
                'warm_loss_gap': _loss_gap([p_w_loss], [w_loss]),
                'warm_update_norm_gap': _worst(
                    {k: p_w_after[k] - self.warm_from[k] for k in w_counted},
                    {k: w_after[k] - self.warm_from[k] for k in w_counted},
                    w_counted)}


def _loss_gap(got, want):
    """max over the steps and terms of |got - want| / |want|."""
    return max(abs(p[k] - r[k]) / abs(r[k]) for p, r in zip(got, want)
               for k in r)


def _counted(grads):
    """The leaves whose gradient norm is at least a thousandth of the
    median leaf's."""
    norms = {k: float(g.norm()) for k, g in grads.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return [k for k, v in norms.items() if v >= NEGLIGIBLE_GRAD * median]


def _worst(got, want, names):
    """max over `names` of |‖got‖ - ‖want‖| / max(‖want‖, median ‖want‖)."""
    wn = {k: float(want[k].norm()) for k in names}
    median = float(torch.tensor(list(wn.values())).median())
    return max(abs(float(got[k].norm()) - wn[k]) / max(wn[k], median)
               for k in names)
