"""Batch-1 serving over several devices (counterpart of
`sc2bench_tpu/models/serving_pool.py`).

The data-size protocol codes one image at a time on a device. A host
with several cards serves a stream with one replica runtime a card: the
images go round-robin to the replicas, each replica runs its own deploy
loop (host coder or device-rANS wire) on its own thread, and the outputs
come back in input order. Each replica accounts its own images' bytes;
`summarize()` pools them. Per image, bytes and logits are those of a
single runtime.

Works with any runtime with the `SplitClassifierRuntime` surface
(`update()`, `eval()`, `stream_deploy`/`stream_deploy_device`,
`analyzers`).
"""
from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class ServingPool:
    """`replicas[d]` is a runtime over a copy of `model` on `devices[d]`
    (every visible card by default), its tables built. `stream(images)`
    keeps the input order."""

    def __init__(self, runtime_factory, model: torch.nn.Module,
                 devices=None, wire: str = 'host'):
        """`runtime_factory(model, device) -> runtime`, e.g.
        `lambda m, d: SplitClassifierRuntime(m, device=d)`; `wire` is
        'host' or 'device' (the device-rANS wire)."""
        if devices is None:
            devices = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError('no devices to serve on')
        if wire not in ('host', 'device'):
            raise ValueError(f"wire is 'host' or 'device', not {wire!r}")
        self.wire = wire
        self.replicas = []
        for d in self.devices:
            rt = runtime_factory(copy.deepcopy(model).to(d), d)
            rt.update()
            rt.eval()
            self.replicas.append(rt)

    def activate_analysis(self):
        for rt in self.replicas:
            rt.activate_analysis()

    def summarize(self):
        """The pooled byte accounting: every replica's per-image sizes
        merged (mean, std, num_samples, unit)."""
        sizes, unit = [], 'KB'
        for rt in self.replicas:
            for a in rt.analyzers:
                sizes.extend(a.file_size_list)
                unit = getattr(a, 'unit', unit)
        arr = np.asarray(sizes, np.float64)
        return {'mean': float(arr.mean()) if len(arr) else 0.0,
                'std': float(arr.std()) if len(arr) else 0.0,
                'num_samples': len(arr), 'unit': unit}

    def stream(self, images, depth: int = 8, workers: int = 4,
               wire_batch: int | None = None):
        """Round-robin `images` over the replicas, each on its own thread
        and device; the outputs in input order. `wire_batch=k` (device
        wire only) groups k images a dispatch on each replica."""
        if wire_batch is not None and self.wire != 'device':
            raise ValueError('wire_batch grouping requires wire="device"')
        images = list(images)
        k = len(self.replicas)
        shards = [[img.to(self.devices[d]) for img in images[d::k]]
                  for d in range(k)]

        def run(d):
            rt = self.replicas[d]
            if not shards[d]:
                return []
            if self.devices[d].type == 'cuda':
                torch.cuda.set_device(self.devices[d])
            if self.wire == 'device':
                return rt.stream_deploy_device(shards[d], depth=depth,
                                               workers=workers,
                                               wire_batch=wire_batch)
            return rt.stream_deploy(shards[d], depth=depth)

        results = [None] * len(images)
        with ThreadPoolExecutor(k) as ex:
            for d, outs in enumerate(ex.map(run, range(k))):
                for j, out in enumerate(outs):
                    results[d + j * k] = out
        return results
