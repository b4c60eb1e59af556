"""Metric logging with windowed smoothing (counterpart of
`sc2bench_tpu/utils/metrics.py`). In a data-parallel group
`synchronize_between_processes` sums each meter's count and total over
the processes; in one process it does nothing."""
from __future__ import annotations

import time
from collections import defaultdict, deque

import numpy as np

from ..parallel.dist import is_multi, sync_metric


class SmoothedValue:
    """Track a series with a smoothing window + global total/count."""

    def __init__(self, window_size=20, fmt='{median:.4f} ({global_avg:.4f})'):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum (count, total) over the group, in float64."""
        if not is_multi():
            return
        count, total = sync_metric([self.count, self.total]).tolist()
        self.count = int(count)
        self.total = float(total)

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter='  '):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, 'item'):
                v = float(v)
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f'{name}: {meter}' for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq, logger, header=''):
        """Yield each item of `iterable`; after item i, with i a multiple
        of `print_freq`, log the meters and the mean time the caller spent
        on an item; at the end, the total seconds."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt='{avg:.4f}')
        for obj in iterable:
            t0 = time.time()
            yield obj
            iter_time.update(time.time() - t0)
            if i % print_freq == 0:
                logger.info('%s [%d]  %s  iter_time: %s', header, i,
                            str(self), str(iter_time))
            i += 1
        logger.info('%s done in %.1fs', header, time.time() - start)
