#!/usr/bin/env python3
"""Where the device time of the port's deploy loop goes, on one GPU.

Builds the flagship model as `chip_smoke.py` does (ResNet-50 + FP-24, or
with `--model mshp` ResNet-50 + MSHP-24/256/16 with its scales spread as in
`chip_smoke.py` phase 9, or with `--model seg` the VOC DeepLabv3-ResNet-50
+ FP-24 student of phase 15 on 512x512 images, or with `--model det` the
COCO Faster R-CNN R50-FPN + FP-24 student of phase 16 on 8 images of
480x640 on the 800x1344 canvas; seeded random weights), warms up, then
traces `stream_deploy_device` with `torch.profiler` over N images at
batch 1 and at `wire_batch=8` (4 for `det`). For each mode it prints one
JSON line: wall seconds, images/s, device busy time (sum of kernel times
on the card), the idle share of the wall window, the rANS kernels' share
of device time (cyclic and indexed, and the indexed kernels' device ms and
share alone), and the top kernels by device time;
for `det` also the device ms and shares of NMS (`batched_nms_mask`),
RoIAlign (`multiscale_roi_align`) and the convolutions (the kernels under
`aten::convolution`), each traced as a named range.

    python3 profile_deploy.py [--model fp|mshp|seg|det] [--out profile.json]

Needs a CUDA device; it exits with an error without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RANS = ('rans_encode', 'rans_decode', 'rans_indexed')
N_IMAGES = 32


# the named ranges whose device time is reported (NMS and RoIAlign are
# traced on the detection path only)
RANGES = ('nms', 'roi_align', 'aten::convolution')


def traced(torch, module, name, label):
    """Wrap `module.name` in a `torch.profiler.record_function(label)`
    range; returns a function that restores it."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def profile_mode(torch, rt, images, wire_batch):
    from torch.profiler import ProfilerActivity, profile
    rt.stream_deploy_device(images[:8], wire_batch=wire_batch)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.stream_deploy_device(images, wire_batch=wire_batch)
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    by_name, ranges = {}, {}
    for evt in prof.key_averages():
        if evt.key in RANGES:
            # the range's kernels, summed on its host side; its device-side
            # annotation spans the gaps between them and is no kernel
            if evt.device_type == DeviceType.CPU:
                ranges[evt.key] = evt.device_time_total
            continue
        # kernels only: a CPU op's self device time repeats its kernels'
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us
    busy_us = sum(by_name.values())
    rans_us = sum(v for k, v in by_name.items() if any(r in k for r in RANS))
    indexed_us = sum(v for k, v in by_name.items() if 'rans_indexed' in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    shares = {f'{k.split("::")[-1]}_device_ms': v / 1e3
              for k, v in ranges.items()}
    shares.update({f'{k.split("::")[-1]}_share_of_device':
                   v / busy_us if busy_us else None
                   for k, v in ranges.items()})
    return {**shares,
        'mode': f'wire_batch={wire_batch}' if wire_batch else 'batch 1',
        'images': len(images), 'wall_s': wall,
        'images_per_s': len(images) / wall,
        'device_busy_ms': busy_us / 1e3,
        'device_idle_share': max(0.0, 1.0 - busy_us / 1e6 / wall),
        'rans_share_of_device': rans_us / busy_us if busy_us else None,
        'rans_indexed_device_ms': indexed_us / 1e3,
        'rans_indexed_share_of_device':
            indexed_us / busy_us if busy_us else None,
        'top_kernels_ms': [[k[:90], v / 1e3] for k, v in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--model', choices=('fp', 'mshp', 'seg', 'det'),
                    default='fp',
                    help='the bottleneck of the ResNet-50 classifier, the '
                    'DeepLabv3 segmentation student or the Faster R-CNN '
                    'detection student')
    ap.add_argument('--out', help='also write the results to this JSON '
                    'file')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('profile_deploy: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import (DET_WIRE_BATCH, HW, N_DET_LAND, N_SEG, SEG_HW,
                            build_det_student, build_model,
                            build_seg_student, det_canvases, smi_query,
                            spread_mshp_scales)
    from sc2bench_tpu_torch.models.detection import rcnn
    from sc2bench_tpu_torch.models.detection.wrapper import \
        SplitDetectionRuntime
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    from sc2bench_tpu_torch.models.segmentation.wrapper import \
        SplitSegmentationRuntime
    device = torch.device('cuda', 0)
    if args.model == 'det':
        images = det_canvases(torch, N_DET_LAND, device)
    else:
        rng = np.random.default_rng(2024)
        hw, n = (SEG_HW, N_SEG) if args.model == 'seg' \
            else ((HW, HW), N_IMAGES)
        images = [torch.from_numpy(rng.normal(0, 1, (1, 3, *hw))
                                   .astype(np.float32)).to(device)
                  for _ in range(n)]
    runtime, wire_batch, restore = SplitClassifierRuntime, 8, []
    if args.model == 'det':
        model = build_det_student(torch, device)
        runtime, wire_batch = SplitDetectionRuntime, DET_WIRE_BATCH
        restore = [traced(torch, rcnn, 'batched_nms_mask', 'nms'),
                   traced(torch, rcnn, 'multiscale_roi_align', 'roi_align')]
    elif args.model == 'seg':
        model = build_seg_student(torch, device)
        runtime = SplitSegmentationRuntime
    elif args.model == 'mshp':
        model = spread_mshp_scales(torch, build_model(
            torch, device, seed=1, key='MSHPBasedResNetBottleneck'),
            images[0])
    else:
        model = build_model(torch, device, seed=0)
    rt = runtime(model, device=device)
    rt.update()
    rt.eval()
    card = smi_query('name,power.limit')
    results = []
    for k in (None, wire_batch):
        r = profile_mode(torch, rt, images, k)
        r['card'] = card
        r['model'] = args.model
        results.append(r)
        print(json.dumps(r), flush=True)
    for undo in restore:
        undo()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
