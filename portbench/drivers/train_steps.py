"""Training steps back to back on a fixed set of seeded batches.

The traffic mix gives the batches (`traffic.training_batches`: `count`
distinct batches of `batch` images, cycled) and `followed_steps`, the
first steps that set-up drives and the reference follows, each on its own
batch. The window then steps on until `seconds` have passed, one step
queued behind the one running: it waits for step i - 1 to finish before
it queues step i + 1, and ends when the last step has finished. A traced
run has two windows of `trace_seconds`, as the serving driver's. Once
the window has closed and the peak memory is read, the system takes one
more step on the next batch of the cycle (`check_step`), which the check
follows from the state the window left.
"""
from __future__ import annotations

import sys
import time

import torch

from .. import traffic as gen
from ..tracing import Trace, merge, spans


def _fence(device):
    if device.type != 'cuda':
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _wait(ev):
    if ev is not None:
        ev.synchronize()


def run(system, mix, seed, seconds, trace, t_start):
    device = system.device
    batches = gen.training_batches(mix['batches'], seed, device)
    k = int(mix.get('followed_steps', 3))
    system.follow(batches[:k])
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    state = {'i': k}

    def window(duration):
        steps, prev = 0, None
        start = time.perf_counter()
        while True:
            x, y = batches[state['i'] % len(batches)]
            system.step(x, y)
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
    print(f'window: {steps} steps of {n} images in {window_s:.3f} s',
          file=sys.stderr)
    counters = {'attempted': state['i'] - k, 'steps': steps,
                'images': steps * n, 'window_s': window_s,
                'memory_peak_bytes': int(torch.cuda.max_memory_allocated(
                    device)) if device.type == 'cuda' else 0}
    system.check_step(*batches[state['i'] % len(batches)])
    system.finish()
    return {'setup_s': setup_s,
            'end_to_end': {'train_images_per_s': steps * n / window_s},
            'counters': counters, 'trace': summary,
            'check': lambda stand_in=None: system.check(stand_in)}
