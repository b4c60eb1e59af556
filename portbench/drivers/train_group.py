"""Training steps of a data-parallel group back to back, each rank on its
own fixed batches (the group holds them: `group.step(i)` steps every
rank on its share of global batch i, cycled).

The configuration's family builds a system for one device; its model
settings (`system.cfg`) and the traffic mix build the group
(`families/stage2_group.py` `GroupTrainer`) in its place, once that
system is closed.

Set-up drives the group through its first `followed_steps` steps, which
the reference follows (`group.follow`). The window then steps on until
`seconds` have passed, one step queued behind the one running on rank
0's device, as `train_steps` does, and ends when the last step has
finished; a step's images are the whole group's (`group.batch`). A
traced run has two windows of `trace_seconds`, rank 0's device alone and
then its host too. Once the window has closed and the peak memory is
read, the group takes one more step on the next global batch of the
cycle (`group.check_step`), which the check follows from the state the
window left. `group.finish()` then compares the ranks and closes the
group before the check.
"""
from __future__ import annotations

import sys
import time

import torch

from ..families.stage2_group import GroupTrainer
from ..tracing import Trace, merge, spans
from .train_steps import _fence, _wait


def run(system, mix, seed, seconds, trace, t_start):
    model_cfg, device = system.cfg, system.device
    system.close()
    system = GroupTrainer(model_cfg, mix, seed, device)
    k = int(mix.get('followed_steps', 1))
    system.follow(k)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    state = {'i': k}

    def window(duration):
        steps, prev = 0, None
        start = time.perf_counter()
        while True:
            system.step(state['i'])
            ev = _fence(device)
            _wait(prev)
            prev = ev
            steps += 1
            state['i'] += 1
            if time.perf_counter() - start >= duration:
                break
        _wait(prev)
        return steps, time.perf_counter() - start

    setup_s = time.perf_counter() - t_start
    summary = None
    if trace:
        seconds = float(mix['trace_seconds'])
        with Trace(device, host=False) as dev_only:
            steps, window_s = window(seconds)
        with spans(system.spans()), Trace(device, system.ranges) as full:
            window(seconds)
        summary = merge(dev_only.summary, full.summary)
    else:
        steps, window_s = window(seconds)
    n = system.batch
    print(f'window: {steps} steps of {n} images over the group in '
          f'{window_s:.3f} s', file=sys.stderr)
    counters = {'attempted': state['i'] - k, 'steps': steps,
                'images': steps * n, 'window_s': window_s,
                'memory_peak_bytes': int(torch.cuda.max_memory_allocated(
                    device)) if device.type == 'cuda' else 0}
    system.check_step(state['i'])
    system.finish()
    return {'setup_s': setup_s,
            'end_to_end': {'train_images_per_s': steps * n / window_s},
            'counters': counters, 'trace': summary,
            'check': lambda stand_in=None: system.check(stand_in)}
