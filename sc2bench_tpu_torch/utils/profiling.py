"""Tracing, spans and counters (counterpart of
`sc2bench_tpu/utils/profiling.py`).

`trace(log_dir)` records a `torch.profiler` trace of a block (the JAX
package's `jax.profiler` trace). `recorder`, the process's one
`StageTimer`, holds the port's program spans and counters; `span` and
`count` are its methods.

Tracing is on exactly while a `torch.profiler` profile is running
(`torch.autograd._profiler_enabled()`): inside `trace`, the benchmark's
traced windows, or any profiler a caller starts. With it off, `span(name)`
is one flag check and a shared null context, and `count` one flag check:
no profiler range, no allocation, no CUDA event. With it on, a span

  - opens a profiler range of its name, on the profiler's clock beside
    the device's events, so a gap in the device's activity can be named
    by the innermost span around it;
  - adds to the totals of its name: calls, host seconds, host self
    seconds (less its child spans'), and the host seconds of the wait
    spans inside it (`wait=True` marks a span in which the host blocks on
    the device; all of a wait span's own time is waiting);
  - with `device=True`, records a CUDA event pair, whose device time
    between the span's ends (any idle time of the device between them
    included) `summarize()` adds.

A range costs tens to hundreds of us amid a serving loop's work on an
H100's host (more than in an empty loop), so a span covers a unit of
work, such as a coding launch, and not each image of a batch.

A counter adds an integer, only while tracing is on. `timings` and `key`
add a span's host seconds to a caller's dict, whether tracing is on or
off (the runtimes' `timings`). Names are dotted by layer: `deploy.*`,
`detect.*`, `nms.*`, `train.*`, `dist.*`, `codec.*`.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path

import torch

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    when a card is visible) and write into `log_dir`, one pair of files a
    process: the Chrome trace (`trace_rank<r>.json`; view it in Perfetto
    or chrome://tracing) and the recorder's totals over the block
    (`spans_rank<r>.json`, `StageTimer.summarize`). Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.dist import rank
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    recorder.clear()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f'trace_rank{rank()}.json'))
    (out / f'spans_rank{rank()}.json').write_text(
        json.dumps(recorder.summarize(), indent=1, sort_keys=True))


def _cuda_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """One span's extent (see the module doc)."""

    __slots__ = ('rec', 'name', 'timings', 'key', 'wait', 'device',
                 'range', 'recorded', 'start', 't0', 'child', 'waited')

    def __init__(self, rec, name, timings, key, wait, device, ranged,
                 recorded):
        self.rec, self.name, self.timings, self.key = rec, name, timings, key
        self.wait, self.device, self.recorded = wait, device, recorded
        self.range = torch.profiler.record_function(name) if ranged \
            else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.recorded:
            self.child = self.waited = 0.0
            self.start = _cuda_event() if self.device \
                and torch.cuda.is_initialized() else None
            self.rec._stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.timings is not None:
            self.timings[self.key] = self.timings.get(self.key, 0.0) + dt
        if self.recorded:
            stack = self.rec._stack()
            stack.pop()
            waited = dt if self.wait else self.waited
            if stack:
                stack[-1].child += dt
                stack[-1].waited += waited
            end = _cuda_event() if self.start is not None else None
            self.rec._add(self.name, dt, dt - self.child, waited, self.wait,
                          (self.start, end) if end else None)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class StageTimer:
    """Host time per named span, counters, and the device time of the
    spans marked `device=True` (the module doc). `stage(name)` records
    whether tracing is on or off, as the JAX package's `StageTimer` does;
    `span` only while it is on. `summarize()` returns one entry per name:
    a span's {'count', 'total_ms', 'mean_ms', 'self_ms', 'wait_ms',
    'wait'} (and 'device_ms' once a device-timed span has timed the
    device), a counter's {'count'}."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.clear()

    def span(self, name: str, timings: dict | None = None,
             key: str | None = None, wait: bool = False,
             device: bool = False):
        """The context of one span of `name`."""
        on = _enabled()
        if not on and timings is None:
            return _NULL
        return _Span(self, name, timings, key, wait, device, on, on)

    def stage(self, name: str):
        """A span recorded whether tracing is on or off."""
        return _Span(self, name, None, None, False, False, _enabled(), True)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` while tracing is on."""
        if _enabled():
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n

    def _stack(self) -> list:
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name, host, own, waited, wait, events):
        with self._lock:
            t = self._spans.get(name)
            if t is None:
                t = self._spans[name] = [0, 0.0, 0.0, 0.0, 0.0, wait, 0]
            t[0] += 1
            t[1] += host
            t[2] += own
            t[3] += waited
            if events is not None:
                t[6] += 1
                self._pending.append((t, *events))

    def summarize(self) -> dict:
        with self._lock:
            pending, self._pending = self._pending, []
        for t, start, end in pending:
            end.synchronize()
            t[4] += start.elapsed_time(end) * 1e-3
        out = {}
        for name, (n, host, own, waited, dev, wait, timed) in \
                self._spans.items():
            out[name] = {'count': n, 'total_ms': host * 1e3,
                         'mean_ms': host * 1e3 / n, 'self_ms': own * 1e3,
                         'wait_ms': waited * 1e3, 'wait': wait}
            if timed:
                out[name]['device_ms'] = dev * 1e3
        out.update({name: {'count': n}
                    for name, n in self._counters.items()})
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans, self._counters, self._pending = {}, {}, []


recorder = StageTimer()
span = recorder.span
count = recorder.count
