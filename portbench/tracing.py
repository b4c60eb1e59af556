"""Spans and the device trace of a `--trace 1` run.

`spans(names)` wraps program attributes from outside in named
`torch.profiler.record_function` ranges (the layer boundaries the
program does not mark itself yet). `Trace` runs `torch.profiler` over
the traced window and reduces its events:

    busy_s       the union of the device's operation intervals (kernels,
                 copies, sets), so overlapping operations count once
    window_s     the traced window's length on the host clock
    by_kernel    {operation name: summed device seconds}, launches
    by_range     {range name: device seconds of the operations launched
                 inside that host range}
    idle_gaps    {what the host was doing: idle device seconds}, each gap
                 of the union named by the innermost harness range and
                 host operation that cover its middle
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch



@contextlib.contextmanager
def spans(targets):
    """Wrap each (owner, attribute, range name) in a profiler range for
    the duration of the block."""
    undo = []
    try:
        for owner, attr, label in targets:
            fn = getattr(owner, attr)

            def wrapper(*args, _fn=fn, _label=label, **kwargs):
                with torch.profiler.record_function(_label):
                    return _fn(*args, **kwargs)

            had = attr in vars(owner)
            setattr(owner, attr, wrapper)
            undo.append((owner, attr, fn, had))
        yield
    finally:
        for owner, attr, fn, had in reversed(undo):
            if had:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def innermost(events, times):
    """For each time of `times`, the name of the innermost of the nested
    host `events` (start, end, name) that covers it, or None."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    stack, j = [], 0
    events = sorted(events)
    for i in order:
        t = times[i]
        while j < len(events) and events[j][0] <= t:
            while stack and stack[-1][1] < events[j][0]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


class Trace:
    """`with Trace(device, ranges, host) as tr:` profiles the block; after
    it, `tr.summary` holds the reduction of the module doc. `ranges` are
    the host range names whose operations `by_range` sums. Without `host`
    only the device's activity is recorded: the host's operations then
    run at their own speed (recording them slows a loop that the host
    paces), and `by_range` and `idle_gaps` stay empty."""

    def __init__(self, device, ranges=(), host=True):
        self.device = torch.device(device)
        self.ranges = tuple(ranges)
        self.host = host
        self.summary = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU] if self.host else []
        if self.device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        else:
            # the CPU tests: the host is the device
            acts = [torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = self.reduce(self._prof.profiler.kineto_results
                                       .events(), window)
        return False

    def reduce(self, events, window_s):
        device, host, launches = [], [], {}
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # kernels, copies and sets; a range's device-side
                # annotation spans the gaps between them and is none
                if not e.is_user_annotation():
                    device.append((start, end, e.name(),
                                   e.correlation_id()))
                continue
            host.append((start, end, e.name(), e.is_user_annotation(),
                         e.start_thread_id()))
            if e.name().startswith('cu') and e.correlation_id():
                launches[e.correlation_id()] = start
        busy = union([(s, e) for s, e, _, _ in device])
        by_kernel, count = {}, {}
        for s, e, name, _ in device:
            by_kernel[name] = by_kernel.get(name, 0.0) + (e - s) * 1e-9
            count[name] = count.get(name, 0) + 1
        by_range = {}
        for label in self.ranges:
            spans_ = sorted((h[0], h[1]) for h in host
                            if h[3] and h[2] == label)
            starts = [s for s, _ in spans_]
            total = 0.0
            for s, e, _, corr in device:
                t = launches.get(corr)
                i = bisect.bisect_right(starts, t) - 1 if t else -1
                if i >= 0 and spans_[i][1] >= t:
                    total += (e - s) * 1e-9
            if spans_:
                by_range[label] = total
        # the host thread that ran the harness's ranges
        threads = [h[4] for h in host if h[3]] or [h[4] for h in host]
        main = max(set(threads), key=threads.count) if threads else None
        mine = [h for h in host if h[4] == main]
        gaps = {}
        if busy:
            edges = sorted(((a[1], b[0]) for a, b in zip(busy, busy[1:])),
                           key=lambda g: g[0] - g[1])[:5000]
            mids = [(s + e) // 2 for s, e in edges]
            ann = innermost([h[:3] for h in mine if h[3]], mids)
            ops = innermost([h[:3] for h in mine if not h[3]], mids)
            for (s, e), a, o in zip(edges, ann, ops):
                label = f'{a}: {o}'
                gaps[label] = gaps.get(label, 0.0) + (e - s) * 1e-9
        busy_s = sum(e - s for s, e in busy) * 1e-9
        return {'busy_s': busy_s, 'window_s': window_s,
                'by_kernel': by_kernel, 'launches': count,
                'by_range': by_range, 'idle_gaps': gaps,
                'n_device_ops': len(device)}


def merge(device, host):
    """One summary of a traced run: the device's numbers from the window
    traced without the host (`device`), the ranges and idle gaps from the
    one traced with it (`host`)."""
    return dict(device, by_range=host['by_range'],
                idle_gaps=host['idle_gaps'])


def breakdown(summary, top=10):
    """The `breakdown` of a result line: the device operations that took
    most time and the idle time by what the host was doing."""
    def head(d):
        return [[k[:160], v] for k, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:top]]
    return {'device_ops': head(summary['by_kernel']),
            'idle_gaps': head(summary['idle_gaps'])}
