"""Tracing and per-stage timers (counterpart of
`sc2bench_tpu/utils/profiling.py`): `trace` records a `torch.profiler`
trace of a block (the JAX package's `jax.profiler` trace), `StageTimer`
accumulates wall-clock time per named stage."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    when a card is visible) and write a Chrome trace into `log_dir`,
    one file a process (`trace_rank<r>.json`; view it in Perfetto or
    chrome://tracing). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.dist import rank
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f'trace_rank{rank()}.json'))


class StageTimer:
    """Accumulates wall-clock per named stage; summarize() returns
    mean/total ms per stage."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def summarize(self):
        return {
            name: {'mean_ms': float(np.mean(v) * 1000),
                   'total_ms': float(np.sum(v) * 1000),
                   'count': len(v)}
            for name, v in self.times.items()}

    def clear(self):
        self.times.clear()
