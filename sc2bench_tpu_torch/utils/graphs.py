"""A chain of small kernels replayed as one CUDA graph.

`GraphCache` runs `fn(inputs)`, a function of a list of tensors, either
eagerly or as the replay of a CUDA graph of it. Per key (the caller's
key, each input's shape and dtype, and the cuDNN and matmul flags), the
first `CAPTURE_AFTER - 1` calls run eagerly: the first is the warm-up a
capture needs (cuDNN's algorithm choice and workspace, lazily built
handles), and a shape seen once never pays for a capture. The next call
captures `fn` over a static copy of the inputs and replays it; every
later call copies its inputs into those static tensors (one multi-tensor
copy) and replays. The graph's kernels are the eager call's, launched on
the same shapes under the same flags, so a replay computes what the
eager call computes, bit for bit.

A replay writes the same static output tensors every time: whatever the
caller reads of launch g must be read (or copied) before launch g+1's
replay is queued, except through stream order on the same stream.

A graph reads its weights (the parameters and buffers `fn` uses besides
its inputs) where they lay when it was captured: an in-place update is
read by the next replay, and a weight given new storage makes the next
call capture again. Keys still running eagerly are counted apart from the
graphs (at most `SEEN_LIMIT`, least recently used first out), so a stream
of new shapes never pushes a graph out; an eager call that raises is not
counted. At most `GRAPH_LIMIT` graphs are kept, least recently used first
out; a key whose graph went out starts its count again. Inputs a graph
cannot hold stay eager and leave the cache as it is: tensors on another
device type or on several devices, not contiguous, or not 16-byte
aligned (cuDNN's choice of kernels depends on its operands' alignment,
so a static copy must match it; the caching allocator aligns each one to
512 bytes).

A capture does not run `fn`'s kernels, but `fn`'s host code runs once:
what it adds to a dict of counts (`tally`, say the rANS kernels'
`LAUNCHES`) is taken back after the capture and added again after each
replay, so that the counts follow the launches a replay makes, as the
eager call's do.

The attributes `captures` and `replays` count captures and the rows
(images) served by a replay; with a profiler running
(`utils/profiling.py`) the counter `<name>.replays` counts those rows too.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .profiling import count

GRAPH_LIMIT = 4
SEEN_LIMIT = 64
CAPTURE_AFTER = 2


def capture_cuda_graph(fn, rows):
    """Capture `fn(rows)` as a CUDA graph on the current device, on a side
    stream that waits for the current one. Returns (replay, output):
    `replay()` relaunches the captured kernels on the current stream, and
    `output` is `fn`'s result, rewritten by each replay. Unlike
    `torch.cuda.graph` it neither synchronizes the device nor empties the
    allocator's cache, which would make every later allocation of the
    serving loop a fresh `cudaMalloc`."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # other threads (a serving pool's replicas) may keep launching
        graph.capture_begin(capture_error_mode='thread_local')
        try:
            output = fn(rows)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph.replay, output


def _backend_flags():
    """The flags under which the captured kernels were chosen."""
    cudnn = torch.backends.cudnn
    return (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


class _Graph:
    """One captured key: the static inputs, the replay and its output,
    where its weights lay, and the counts of `tally` a replay adds."""

    def __init__(self, weights_at, inputs, fn, capture, tally):
        self.rows = [torch.empty_like(t) for t in inputs]
        self.weights_at = weights_at
        self.load(inputs)
        before = dict(tally or {})
        self.replay, self.output = capture(fn, self.rows)
        self.tallied = {k: v - before.get(k, 0)
                        for k, v in (tally or {}).items()
                        if v != before.get(k, 0)}
        for k, v in self.tallied.items():
            tally[k] -= v

    def load(self, inputs):
        torch._foreach_copy_(self.rows, list(inputs))


class GraphCache:
    """CUDA graphs of a function of tensors, by key (the module doc);
    `name` prefixes its counter, and `tally` is a dict of counts that
    `fn` adds to. `capture(fn, rows) -> (replay, output)` records `fn`;
    `device_type` is the device type whose inputs it takes (another
    capture and device type let the CPU tests drive the cache)."""

    def __init__(self, name: str, capture=capture_cuda_graph,
                 device_type: str = 'cuda', tally: dict | None = None):
        self.name = name
        self._capture = capture
        self._device_type = device_type
        self._tally = tally
        # key -> eager calls so far, and key -> _Graph; least recent first
        self._seen = OrderedDict()
        self._graphs = OrderedDict()
        self.captures = 0
        self.replays = 0

    def _holds(self, inputs) -> bool:
        x = inputs[0]
        if not isinstance(x, torch.Tensor) \
                or x.device.type != self._device_type:
            return False
        if x.device.type == 'cuda' \
                and x.device.index != torch.cuda.current_device():
            return False
        return all(isinstance(t, torch.Tensor) and t.device == x.device
                   and t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in inputs)

    def __call__(self, key, weights, inputs, fn, rows=None):
        """`fn(inputs)`, eagerly or replayed (the module doc); `weights`
        the tensors `fn` reads besides `inputs`, and `key` what else
        decides its kernels (the module that runs, say). `rows`: the rows
        (images) a call serves, by default the inputs' first dimensions
        summed. The result of a replay is the graph's static output."""
        inputs = list(inputs)
        if not inputs or not self._holds(inputs):
            return fn(inputs)
        key = (key, tuple((tuple(t.shape), t.dtype) for t in inputs),
               _backend_flags())
        entry = self._graphs.pop(key, None)
        if entry is None:
            calls = self._seen.pop(key, 0) + 1
            if calls < CAPTURE_AFTER:
                out = fn(inputs)
                self._seen[key] = calls
                if len(self._seen) > SEEN_LIMIT:
                    self._seen.popitem(last=False)
                return out
        weights_at = tuple(t.data_ptr() for t in weights)
        if entry is None or entry.weights_at != weights_at:
            entry = None    # free a stale graph before its successor
            entry = _Graph(weights_at, inputs, fn, self._capture,
                           self._tally)
            self.captures += 1
        else:
            entry.load(inputs)
        self._graphs[key] = entry
        if len(self._graphs) > GRAPH_LIMIT:
            self._graphs.popitem(last=False)
        entry.replay()
        for k, v in entry.tallied.items():
            self._tally[k] += v
        if rows is None:
            rows = sum(t.shape[0] for t in inputs)
        self.replays += rows
        count(f'{self.name}.replays', rows)
        return entry.output
