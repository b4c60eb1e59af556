"""Stage 2 of the Entropic Student's training over a data-parallel group
of ranks, one device a rank: the program's `DistillationBox.train_step`
in each rank's process, BatchNorm on the group's statistics
(`parallel/dist.py` `group_sum`) and the gradients averaged over the
group in one coalesced all-reduce (`average_gradients`) before SGD steps.

The configuration names `split_classifier` as its family, whose system
serves or trains on one device; the traffic mix's driver
(`drivers/train_group.py`) builds this group in its place from the
configuration's model and the mix, which carries what the
configuration's file lacks: stage 2 of its YAML (SGD, momentum, weight
decay, KD loss, the encoder and entropy bottleneck frozen, `train_bn`)
and the training set's size (the schedule's epochs). Rank 0 is the
harness's own process on its device; `GroupTrainer` starts ranks 1 ...
R-1 (`spawn`), each on the next device, and every rank joins the group
(NCCL on the cards, gloo on the CPU) at a free port of this host. Each
rank builds the benchmark's weights from the seed (the student as
`split_classifier.build_student`, the teacher ResNet-50), the stage in
the 'finetune' forward, and its share
of every global batch from `build_sharded_loader` over a seeded
`SyntheticClassificationDataset`, held on its device. Rank 0 tells the
others what to do over a pipe each: follow the first steps, step on
batch i (and report its losses), compare the parameters, close. After
the window the group takes one more step (`check_step`), warm as the
window left it, which the reference follows from rank 0's parameters,
momentum buffers and aux Adam moments. A rank that dies ends the run at
once with exit code 5 (a watchdog thread on the others' process
sentinels), joining the group and every join of a rank time out, and a
rank whose parent died exits: a broken rank never hangs a run.

`correct` compares (module `check`):
    loss_gap         the group's first step: |program - reference| /
                     |reference| of the KD loss (the ranks' mean) and of
                     the aux loss, the larger
    grad_norm_gap    that step's gradient as the program's SGD got it
                     (rank 0's, averaged over the group): the worst
                     leaf's |norm - the reference's norm| over the larger
                     of that leaf's and the median leaf's reference norm
    update_norm_gap  the same of each leaf's change in that step
    rank_param_gap   max |a rank's parameter or buffer - rank 0's| after
                     the window, exact
and over the step after the window, whose update carries SGD's momentum
(on the first step the momentum buffer is the gradient itself):
    warm_loss_gap         as `loss_gap`
    warm_update_norm_gap  as `update_norm_gap`, of that step's change
The reference (`reference/train_stage2.py`) takes each of those steps
over all the group's images of its global batch at once, on rank 0's
device once the program has freed it. Leaves whose reference gradient is under
a thousandth of the median leaf's are left out of the norm gaps.
"""
from __future__ import annotations

import datetime
import itertools
import multiprocessing as mp
import multiprocessing.connection
import os
import socket
import sys
import threading
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..reference import resnet_fp as R
from ..reference import train_stage2 as S
from ..roofline import count_flops
from ..weights import load_into, make_state
from .split_classifier import build_student, tf32
from .stage1_trainer import _counted, _worst

# seconds a rank may take to join the group, a collective may wait, and
# a rank may take to exit once told to
JOIN_SECONDS = 300
EXIT_SECONDS = 60
RANK_LOST = 5


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _device_of(rank, device0):
    d = torch.device(device0)
    if d.type != 'cuda':
        return d
    return torch.device('cuda', (d.index or 0) + rank)


def _split(traffic, seed, world):
    """The loader config of every rank's shard: the global batches of a
    seeded synthetic set, `count` of them."""
    b = traffic['batches']
    return {'dataset': {'key': 'SyntheticClassificationDataset',
                        'kwargs': {'num_samples': int(b['count'])
                                   * int(b['batch']) * world,
                                   'image_size': list(b['size']),
                                   'num_classes': int(b['classes']),
                                   'seed': int(seed)}},
            'batch_size': int(b['batch']), 'shuffle': False,
            'drop_last': True}


def _on(batch, device):
    x, y = batch
    return (torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).to(device),
        torch.from_numpy(y).to(device))


class Rank:
    """One rank's share of the group: its model, box and batches."""

    def __init__(self, rank, world, port, model_cfg, traffic, seed, device):
        from sc2bench_tpu_torch.datasets.image import build_sharded_loader
        from sc2bench_tpu_torch.models.resnet import resnet50
        from sc2bench_tpu_torch.train.box import DistillationBox
        self.rank, self.device = rank, torch.device(device)
        if self.device.type == 'cuda':
            torch.cuda.set_device(self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            'nccl' if self.device.type == 'cuda' else 'gloo',
            init_method=f'tcp://localhost:{port}', world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=JOIN_SECONDS))
        classes = int(model_cfg['num_classes'])
        self.state = make_state(R.student_specs(model_cfg), seed,
                                self.device)
        self.tstate = make_state(R.teacher_specs({'num_classes': classes}),
                                 int(seed) ^ 0x5EED, self.device)
        student = build_student(model_cfg, self.state, self.device)
        teacher = load_into(resnet50(num_classes=classes).to(self.device),
                            self.tstate)
        batch = int(traffic['batches']['batch'])
        steps_per_epoch = int(traffic['train_images']) // (batch * world)
        self.box = DistillationBox(student, traffic['stage2'],
                                   teacher=teacher,
                                   steps_per_epoch=steps_per_epoch,
                                   student_mode='finetune')
        self.batches = [_on(b, self.device) for b in build_sharded_loader(
            _split(traffic, seed, world), shard_over_processes=True)]

    def step(self, i):
        x, y = self.batches[i % len(self.batches)]
        m = self.box.train_step(x, y)
        return m

    def losses(self, i):
        """Step on global batch i: its {term: float} and 'aux'."""
        m = self.step(i)
        return dict({n: float(v) for n, v in m['loss'].items()},
                    aux=float(m['aux_loss']))

    def param_gap(self):
        """max |this rank's state - rank 0's| over the group, on rank 0."""
        gap = torch.zeros((), dtype=torch.float64, device=self.device)
        tensors = [t for t in self.box.student.state_dict().values()]
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                              for t in tensors if t.dtype == dtype])
            ref = flat.clone()
            dist.broadcast(ref, 0)
            gap = torch.maximum(gap, (flat - ref).abs().max())
        dist.reduce(gap, 0, op=dist.ReduceOp.MAX)
        return float(gap)

    def close(self):
        self.box = self.batches = None
        dist.destroy_process_group()


def _watch_parent():
    parent = mp.parent_process()
    multiprocessing.connection.wait([parent.sentinel])
    os._exit(RANK_LOST)


def worker(rank, world, port, model_cfg, traffic, seed, device, conn):
    """Ranks 1 ... R-1: build, then follow rank 0's commands."""
    threading.Thread(target=_watch_parent, daemon=True).start()
    try:
        me = Rank(rank, world, port, model_cfg, traffic, seed, device)
        while True:
            cmd = conn.recv()
            if cmd[0] == 'step':
                me.step(cmd[1])
            elif cmd[0] == 'losses':
                conn.send(me.losses(cmd[1]))
            elif cmd[0] == 'gap':
                me.param_gap()
            else:
                break
        me.close()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class GroupTrainer:
    """Rank 0 and the group it leads; see the module doc."""

    ranges = ()

    def __init__(self, model_cfg, traffic, seed, device):
        self.world = int(traffic['ranks'])
        self.stage = traffic['stage2']
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.batch = self.world * int(traffic['batches']['batch'])
        port = _free_port()
        ctx = mp.get_context('spawn')
        self.workers, self.pipes = [], []
        for r in range(1, self.world):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=worker, daemon=True, args=(
                r, self.world, port, model_cfg, traffic, seed,
                _device_of(r, device), theirs))
            p.start()
            theirs.close()
            self.workers.append(p)
            self.pipes.append(mine)
        self._closing = False
        threading.Thread(target=self._watch, daemon=True).start()
        self.me = Rank(0, self.world, port, model_cfg, traffic, seed,
                       self.device)
        self.state, self.tstate = self.me.state, self.me.tstate

    def _watch(self):
        """End the run when a rank dies before it is told to close."""
        multiprocessing.connection.wait([p.sentinel for p in self.workers])
        if not self._closing:
            print('portbench: a rank of the group died; ending the run',
                  file=sys.stderr, flush=True)
            os._exit(RANK_LOST)

    def _tell(self, *cmd):
        for c in self.pipes:
            c.send(cmd)

    def _answers(self):
        out = []
        for c in self.pipes:
            if not c.poll(JOIN_SECONDS):
                raise TimeoutError('a rank did not answer')
            out.append(c.recv())
        return out

    # ---- the driver's calls -------------------------------------------------
    def follow(self, k):
        """The group's first k steps, which the reference follows (its
        first): each rank's losses, and rank 0's gradients and state."""
        params = dict(self.me.box.student.named_parameters())
        self.losses = self._losses(0)
        self.grads = {n: p.grad.detach().clone() for n, p in params.items()
                      if p.grad is not None}
        self.after = {n: p.detach().clone() for n, p in params.items()}
        for i in range(1, k):
            self.step(i)

    def _losses(self, i):
        """Every rank's losses of a step on global batch i, rank 0's
        first."""
        self._tell('losses', i)
        mine = self.me.losses(i)
        return [mine] + self._answers()

    def check_step(self, i):
        """One step on global batch i after the window, from the state the
        window left, which the reference follows from rank 0's parameters
        and optimizer state (SGD's momentum buffers, the aux Adam's
        moments)."""
        box = self.me.box
        names = {p: n for n, p in box.student.named_parameters()}
        self.warm_i = i
        self.warm_from = {k: v.detach().clone()
                          for k, v in box.student.state_dict().items()}
        self.warm_opt = {names[p]: {k: v.clone() if torch.is_tensor(v)
                                    else v for k, v in st.items()}
                         for opt in (box.optim.main, box.optim.aux)
                         if opt is not None for p, st in opt.state.items()}
        self.warm_losses = self._losses(i)
        self.warm_after = {n: p.detach().clone()
                           for n, p in box.student.named_parameters()}

    def step(self, i):
        self._tell('step', i)
        return self.me.step(i)

    def spans(self):
        return []

    def finish(self):
        """Compare the ranks' states, close the group and free the
        program before the reference runs. Every rank leaves the group
        at once: NCCL's teardown waits for the others."""
        self._tell('gap')
        self._rank_gap = self.me.param_gap()
        self._closing = True
        self._tell('close')
        self.me.close()
        self.me = None
        for p in self.workers:
            p.join(EXIT_SECONDS)
            if p.is_alive():
                p.kill()
                raise TimeoutError(f'rank {p.name} did not exit')
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ---- the yardstick ------------------------------------------------------
    def _global_batch(self, i):
        """The group's global batch i (cycled), the ranks' shares in rank
        order, as each rank's loader gives it."""
        from sc2bench_tpu_torch.datasets.image import DataLoader, \
            build_dataset
        split = _split(self.traffic, self.seed, self.world)
        i %= int(self.traffic['batches']['count'])
        parts = [_on(next(itertools.islice(DataLoader(
            build_dataset(split['dataset']), batch_size=split['batch_size'],
            drop_last=True, prefetch=False, num_shards=self.world,
            shard_index=r), i, None)),
            self.device) for r in range(self.world)]
        return torch.cat([x for x, _ in parts]), torch.cat(
            [y for _, y in parts])

    def check(self, stand_in=None):
        """The numbers of the module doc. `stand_in` 'tf32' puts the
        reference, computed with TF32 on, in the program's place (the
        control)."""
        x, y = self._global_batch(0)
        losses, grads, after = S.step(self.state, self.tstate, x, y,
                                      self.stage)
        wx, wy = self._global_batch(self.warm_i)
        w_losses, w_grads, w_after = S.step(
            self.warm_from, self.tstate, wx, wy, self.stage,
            opt=self.warm_opt)
        if stand_in:
            with tf32(True):
                p_losses, p_grads, p_after = S.step(
                    self.state, self.tstate, x, y, self.stage)
                p_w_losses, _, p_w_after = S.step(
                    self.warm_from, self.tstate, wx, wy, self.stage,
                    opt=self.warm_opt)
            rank_gap = 0.0
        else:
            p_losses = _mean_losses(self.losses)
            p_grads = {k: self.grads.get(k, torch.zeros_like(g))
                       for k, g in grads.items()}
            p_after, rank_gap = self.after, self._rank_gap
            p_w_losses, p_w_after = (_mean_losses(self.warm_losses),
                                     self.warm_after)
        counted, w_counted = _counted(grads), _counted(w_grads)
        return {'loss_gap': _gap(p_losses, losses),
                'grad_norm_gap': _worst(p_grads, grads, counted),
                'update_norm_gap': _worst(
                    {k: p_after[k] - self.state[k] for k in counted},
                    {k: after[k] - self.state[k] for k in counted}, counted),
                'rank_param_gap': rank_gap,
                'warm_loss_gap': _gap(p_w_losses, w_losses),
                'warm_update_norm_gap': _worst(
                    {k: p_w_after[k] - self.warm_from[k] for k in w_counted},
                    {k: w_after[k] - self.warm_from[k] for k in w_counted},
                    w_counted)}


def _mean_losses(ranks):
    """The group's KD loss (the ranks' mean) and rank 0's aux loss of one
    step, from each rank's {term: float, 'aux'}."""
    return {'kd': float(np.mean([sum(v for k, v in r.items() if k != 'aux')
                                 for r in ranks])),
            'aux': ranks[0]['aux']}


def _gap(got, want):
    """max over the losses of |got - want| / |want|."""
    return max(abs(got[k] - want[k]) / abs(want[k]) for k in want)


def flops_per_step(model_cfg, traffic):
    """A group step's FLOPs: the reference's step over the global batch
    of `traffic`, on meta tensors."""
    classes = {'num_classes': int(model_cfg['num_classes'])}
    sd, tsd = ({name: torch.empty(shape, device='meta') if init[0] != 'count'
                else torch.zeros((), dtype=torch.int64, device='meta')
                for name, shape, init in specs}
               for specs in (R.student_specs(model_cfg),
                             R.teacher_specs(classes)))
    b = traffic['batches']
    n = int(traffic['ranks']) * int(b['batch'])
    x = torch.empty((n, 3, *b['size']), device='meta')
    y = torch.zeros((n,), dtype=torch.int64, device='meta')
    return count_flops(lambda: S.flops_of_step(sd, tsd, x, y,
                                               traffic['stage2']))
