"""Closed-loop serving: one client, one request in flight.

The traffic mix gives the image pool (`traffic.image_pool`), the images a
request (`request_images`, taken from the pool in turn) and the serving
call's arguments (`serve`). Set-up serves `warm_requests` requests and
one of each distinct image shape, so that nothing builds or compiles in
the window. The window then sends request after request until
`seconds` have passed; each request is timed from its call until its
outputs are on the host, and the window ends when the last one is back.
`check_share` of the window's requests (and always its first), drawn
from the seed, are captured for the check.

A traced run has two windows of `trace_seconds` each: the first records
the device alone (busy time, kernels, the rate and the runtime's
counters the per-layer metrics read), the second also the host, with the
layer ranges (`system.spans()`), for the ranges' device time and for
what the host was doing in each idle gap.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import traffic as gen
from ..tracing import Trace, merge, spans


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(system, mix, seed, seconds, trace, t_start):
    device = system.device
    pool = gen.image_pool(mix['pool'], seed, device)
    n = int(mix['request_images'])
    shapes = {}
    for i, img in enumerate(pool):
        shapes.setdefault(tuple(img.shape), i)
    for r in range(int(mix.get('warm_requests', 1))):
        system.serve(gen.request(pool, r, n))
    for i in shapes.values():
        system.serve([pool[i]] * n)
    _sync(device)
    system.reset()
    rng = np.random.default_rng(int(seed) % (1 << 63))
    share = float(mix.get('check_share', 0.05))
    records = []
    state = {'r': 0}

    def window(duration):
        latencies = []
        start = time.perf_counter()
        while not latencies or time.perf_counter() - start < duration:
            req = gen.request(pool, state['r'], n)
            t0 = time.perf_counter()
            _, rec = system.serve(req, capture=state['r'] == 0
                                  or rng.random() < share)
            latencies.append(time.perf_counter() - t0)
            if rec is not None:
                records.append(rec)
            state['r'] += 1
        return latencies, time.perf_counter() - start

    setup_s = time.perf_counter() - t_start
    summary = None
    if trace:
        seconds = float(mix['trace_seconds'])
        with Trace(device, host=False) as dev_only:
            latencies, window_s = window(seconds)
        counters = system.counters()
        with spans(system.spans()), Trace(device, system.ranges) as full:
            range_latencies, _ = window(seconds)
        counters['range_images'] = len(range_latencies) * n
        summary = merge(dev_only.summary, full.summary)
    else:
        latencies, window_s = window(seconds)
        counters = system.counters()
    r = len(latencies)
    lat_ms = np.asarray(latencies) * 1e3
    print(f'window: {r} requests of {n} images in {window_s:.3f} s; latency '
          f'p50 {np.percentile(lat_ms, 50):.3f} ms, p95 '
          f'{np.percentile(lat_ms, 95):.3f} ms over {r} samples; '
          f'{len(records)} requests captured', file=sys.stderr)
    counters.update(attempted=state['r'], requests=r, images=r * n,
                    window_s=window_s, memory_peak_bytes=_peak(device))
    served = state['r'] * n
    system.finish()
    return {'setup_s': setup_s,
            'end_to_end': {'images_per_s': r * n / window_s,
                           'latency_p95_ms': p95_ms(latencies)},
            'counters': counters, 'trace': summary,
            'check': lambda stand_in=None: system.check(
                records, served, pool, stand_in=stand_in)}


def p95_ms(latencies):
    """The 95th percentile of all the window's request latencies (s), in
    ms, linear between order statistics."""
    return float(np.percentile(np.asarray(latencies) * 1e3, 95))


def _peak(device):
    if device.type == 'cuda':
        return int(torch.cuda.max_memory_allocated(device))
    return 0
