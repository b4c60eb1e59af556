"""Benchmark of the port's flagship deploy path (counterpart of the
repository's `bench.py`): ResNet-50 + FP-24 at 224x224, seeded random
weights, 8 seeded images, on one card.

    python -m sc2bench_tpu_torch.bench [--device cuda] [--n_iter 120] ...

Prints ONE JSON line with the keys of `bench.py`'s, plus `device` (the
card's name and power limit as `nvidia-smi` gives them), `peak_bf16_flops`
and `flops_counted`. Sections, each taking its loop lengths from the
arguments:

  bench_deploy           the host-coder loop (`stream_deploy`), batch 1
  bench_serving          the same with `decode_batch=8`
  bench_device_wire      the device-rANS wire, batch 1 and `wire_batch=8`
  bench_fresh_upload     a new uint8 image each iteration, normalized on
                         the device (`input_norm`)
  bench_device_programs  the host wire's encoder and decoder programs:
                         FLOPs and device-loop rates
  bench_throughput_mode  `wire_batch=128` on the `deploy_bf16_decode`
                         runtime, end to end and as a device loop
  bf16 encode            the same device loop with `deploy_bf16_encode`
  bench_train            one stage-1 `DistillationBox` step of the bfloat16
                         teacher and student at batch 128 on 224x224

Rates are device-loop rates: every call queued, one final
`torch.cuda.synchronize()`. FLOPs come from
`torch.utils.flop_counter.FlopCounterMode` over one call of each program:
convolutions and matrix products only (no elementwise work, no rANS
coding), so the `*_mfu_vs_bf16_peak` fields, FLOPs times rate over
`peak_bf16_flops` (the H100 SXM dense BF16 tensor peak, 989.4 TFLOP/s,
NVIDIA's datasheet), count less work than XLA's cost analysis does. A
failing section fails the run. There is no baseline (`vs_baseline` and
`baseline_ips_torch_cpu` are null: `BASELINE.json` was measured on
another host), and one coding backend, CUDA (`--device cpu` runs the
kernels' plain versions, and the MFU fields are null).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .device import resolve_device

H100_PEAK_BF16_FLOPS = 989.4e12
PEAK_SOURCE = 'H100 SXM dense BF16 tensor peak (NVIDIA H100 datasheet)'
FLOPS_COUNTED = ('torch.utils.flop_counter.FlopCounterMode: convolutions '
                 'and matrix products only')
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
# stage 1 of the Entropic Student (the repository's script/bench_train.py)
STAGE1 = {
    'num_epochs': 1, 'train_bn': False,
    'frozen_modules': ['layer2', 'layer3', 'layer4', 'fc'],
    'optimizer': {'key': 'Adam', 'kwargs': {'lr': 1e-3}},
    'criterion': {'key': 'WeightedSumLoss', 'kwargs': {'sub_terms': {
        'l1': {'criterion': {'key': 'MSELoss', 'kwargs': {
            'student_module_path': 'bottleneck_layer_out',
            'teacher_module_path': 'layer1_out', 'reduction': 'sum'}},
            'weight': 1.0},
        'l4': {'criterion': {'key': 'MSELoss', 'kwargs': {
            'student_module_path': 'layer4_out',
            'teacher_module_path': 'layer4_out', 'reduction': 'sum'}},
            'weight': 1.0},
        'bpp': {'criterion': {'key': 'BppLoss', 'kwargs': {
            'entropy_module_path': 'bottleneck_layer.eb_out',
            'reduction': 'batchmean'}}, 'weight': 0.08},
    }}},
}


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def device_loop_rate(dispatch, device, n=30) -> float:
    """Calls a second with all `n` calls queued and one final
    synchronization, after one warm-up call."""
    dispatch()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        dispatch()
    sync(device)
    return n / (time.perf_counter() - t0)


def program_flops(fn) -> float:
    """The FLOPs `FlopCounterMode` counts in one call of `fn`."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def randomize_weights(model, seed) -> None:
    """He-normal convolutions, BatchNorm affine and statistics near
    identity (bn3 scales not zero), drawn on the CPU from `seed`; the
    bottleneck's last encoder convolution halved, so that the latent of a
    unit-normal image stays inside the fresh quantiles' support."""
    gen = torch.Generator(device='cpu').manual_seed(seed)

    def rand(t, lo, hi):
        return (torch.rand(t.shape, generator=gen) * (hi - lo) + lo).to(t)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = m.weight if isinstance(m, torch.nn.Conv2d) \
                    else m.weight.transpose(0, 1)
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / w[0].numel()) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(rand(m.weight, 0.2, 0.6))
                m.bias.copy_(rand(m.bias, -0.1, 0.1))
                m.running_mean.copy_(rand(m.running_mean, -0.1, 0.1))
                m.running_var.copy_(rand(m.running_var, 0.5, 1.5))
        bneck = getattr(model, 'bottleneck_layer', None)
        if bneck is not None:
            bneck.encoder[-1].weight.mul_(0.5)


def build_model(device, stage_sizes=(3, 4, 6, 3), bottleneck=24,
                classes=1000, seed=0):
    """The flagship student, ResNet-50 + FP-`bottleneck`, with seeded
    random weights, on `device`."""
    from .models.backbone import SplittableResNet
    from .models.layer import FPBasedResNetBottleneck
    torch.manual_seed(seed)
    model = SplittableResNet(
        FPBasedResNetBottleneck(num_bottleneck_channels=bottleneck),
        stage_sizes=tuple(stage_sizes), num_classes=classes)
    randomize_weights(model, seed)
    return model.to(device).eval()


def build_runtime(model, device, input_norm=None, deploy_bf16_decode=False,
                  deploy_bf16_encode=False):
    from .models.runtime import SplitClassifierRuntime
    rt = SplitClassifierRuntime(model, input_norm=input_norm, device=device,
                                deploy_bf16_decode=deploy_bf16_decode,
                                deploy_bf16_encode=deploy_bf16_encode)
    rt.update()
    rt.eval()
    return rt


def _stream(images, n):
    return [images[i % len(images)] for i in range(n)]


def bench_deploy(rt, images, n_iter=120, n_trials=5, depth=16):
    """The host-coder loop at batch 1: img/s of each trial and the
    timings of the fastest."""
    rt.stream_deploy(_stream(images, 10))
    trials, best_timings = [], {}
    for _ in range(n_trials):
        timings = {}
        t0 = time.perf_counter()
        results = rt.stream_deploy(_stream(images, n_iter), depth=depth,
                                   timings=timings)
        assert len(results) == n_iter
        trials.append(n_iter / (time.perf_counter() - t0))
        if trials[-1] == max(trials):
            best_timings = timings
    return trials, best_timings


def bench_serving(rt, images, n_iter=120, n_trials=3, depth=16):
    """The host-coder loop with the decoder and tail run once per 8
    images (each image still coded and accounted alone)."""
    rt.stream_deploy(_stream(images, 16), decode_batch=8)
    trials = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        rt.stream_deploy(_stream(images, n_iter), depth=depth,
                         decode_batch=8)
        trials.append(n_iter / (time.perf_counter() - t0))
    return trials


def bench_device_wire(rt, images, n_iter=120, n_trials=3, wire_batch=None,
                      depth=16):
    """The device-rANS wire, batch 1 or `wire_batch` images a coding
    launch."""
    rt.stream_deploy_device(_stream(images, 16), wire_batch=wire_batch)
    trials = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        rt.stream_deploy_device(_stream(images, n_iter), depth=depth,
                                wire_batch=wire_batch)
        trials.append(n_iter / (time.perf_counter() - t0))
    return trials


def bench_fresh_upload(model, device, image=224, n_iter=96, depth=16):
    """A new uint8 image (host memory) every iteration through the host
    wire, converted and normalized on the device."""
    rt = build_runtime(model, device, input_norm=NORM)
    rng = np.random.default_rng(7)
    frames = [torch.from_numpy(rng.integers(0, 256, (1, 3, image, image),
                                            dtype=np.uint8))
              for _ in range(n_iter)]
    rt.stream_deploy(frames[:1])
    t0 = time.perf_counter()
    rt.stream_deploy(frames, depth=depth)
    return n_iter / (time.perf_counter() - t0)


def bench_device_programs(rt, image, peak, n=30):
    """The host wire's two device programs, the encoder (to int16
    symbols) and the decoder and tail (to logits): FLOPs a call and
    device-loop rates; one image is one of each, back to back."""
    ops = rt.encode_device(image)
    sym = ops['symbols']
    flat, shape = sym.reshape(len(sym), -1), tuple(sym.shape[1:])

    def enc():
        return rt.encode_device(image)

    def dec():
        return rt._host_decode_tail(flat, shape)

    enc_flops, dec_flops = program_flops(enc), program_flops(dec)
    enc_rate = device_loop_rate(enc, rt.device, n)
    dec_rate = device_loop_rate(dec, rt.device, n)
    pair_rate = 1.0 / (1.0 / enc_rate + 1.0 / dec_rate)
    return {
        'deploy_program_gflops_per_image':
            round((enc_flops + dec_flops) / 1e9, 2),
        'deploy_device_ips': round(pair_rate, 1),
        'deploy_device_mfu_vs_bf16_peak':
            _mfu((enc_flops + dec_flops) * pair_rate, peak),
    }


def fused_pair_stats(rt, images, wire_batch, n=100):
    """(img/s, FLOPs an image) of the device wire's encode-and-code and
    decode-and-tail calls at `wire_batch` images a call, as device
    loops."""
    grp = _stream(images, wire_batch)
    ops = rt.encode_device_wire_batch(grp)

    def enc():
        return rt.encode_device_wire_batch(grp)

    def dec():
        return rt.decode_device_streams_batch(ops['streams'], ops['states'],
                                              ops['shape'])

    _, valid = dec()
    assert bool(valid.all()) and bool(ops['ok'].all()), \
        'a throughput group left the tables\' support'
    flops = program_flops(enc) + program_flops(dec)
    enc_rate = device_loop_rate(enc, rt.device, n) * wire_batch
    dec_rate = device_loop_rate(dec, rt.device, n) * wire_batch
    return 1.0 / (1.0 / enc_rate + 1.0 / dec_rate), flops / wire_batch


def bench_throughput_mode(rt, images, peak, wire_batch=128, n_iter=512,
                          n_trials=3, depth=16, n_loop=100):
    """`wire_batch` images a coding launch on `rt` (the
    `deploy_bf16_decode` runtime: bytes equal to the float32 wire's),
    end to end, and the device-loop rate and MFU of its call pair."""
    rt.stream_deploy_device(_stream(images, wire_batch * 2),
                            wire_batch=wire_batch)
    trials = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        rt.stream_deploy_device(_stream(images, n_iter), depth=depth,
                                wire_batch=wire_batch)
        trials.append(n_iter / (time.perf_counter() - t0))
    pair_rate, flops_per_img = fused_pair_stats(rt, images, wire_batch,
                                                n_loop)
    return {
        'throughput_mode_wire_batch': wire_batch,
        'throughput_mode_ips': round(max(trials), 2),
        'throughput_mode_trials': [round(t, 2) for t in trials],
        'throughput_mode_median_ips': round(float(np.median(trials)), 2),
        'throughput_device_ips': round(pair_rate, 1),
        'throughput_device_mfu_vs_bf16_peak':
            _mfu(flops_per_img * pair_rate, peak),
        'throughput_gflops_per_image': round(flops_per_img / 1e9, 2),
    }


def build_train(dtype, batch, image, device, stage_sizes=(3, 4, 6, 3),
                bottleneck=24, classes=1000, seed=0):
    """(stage-1 `DistillationBox` of the ResNet teacher and the FP
    student, both of compute `dtype`, seeded weights; an input batch)."""
    from .models.backbone import SplittableResNet
    from .models.layer import FPBasedResNetBottleneck
    from .models.resnet import ResNet
    from .train.box import DistillationBox
    torch.manual_seed(seed)
    teacher = ResNet(tuple(stage_sizes), num_classes=classes, dtype=dtype)
    student = SplittableResNet(
        FPBasedResNetBottleneck(num_bottleneck_channels=bottleneck,
                                dtype=dtype),
        stage_sizes=tuple(stage_sizes), num_classes=classes, dtype=dtype)
    box = DistillationBox(
        student.to(device), STAGE1, teacher=teacher.to(device),
        steps_per_epoch=100,
        generator=torch.Generator(device=device).manual_seed(seed))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (batch, 3, image, image)).astype(np.float32)).to(device)
    return box, x


def bench_train(device, peak, batch=128, image=224, steps=8,
                dtype='bfloat16', **build_kwargs):
    """One stage-1 step a call: img/s over `steps` queued steps after one
    warm-up, the counted FLOPs of a step, and the peak memory."""
    dev = torch.device(device)
    box, x = build_train(dtype, batch, image, dev, **build_kwargs)
    y = torch.zeros(batch, dtype=torch.int64, device=dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    box.train_step(x, y)
    flops = program_flops(lambda: box.train_step(x, y))
    rate = device_loop_rate(lambda: box.train_step(x, y), dev, steps)
    out = {
        'train_step_img_per_sec': round(batch * rate, 1),
        'train_step_gflops': round(flops / 1e9, 1),
        'train_mfu_vs_bf16_peak': _mfu(flops * rate, peak),
        'train_batch': batch, 'train_image': image,
    }
    if dev.type == 'cuda':
        out['train_peak_memory_gib'] = round(
            torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)
    return out


def _mfu(flops_per_s, peak):
    return None if peak is None else round(flops_per_s / peak, 4)


def card_name_and_power_limit():
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(
        ['nvidia-smi', '--id=0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def get_argparser():
    p = argparse.ArgumentParser(
        description='Throughput of the flagship deploy path (one JSON line)')
    p.add_argument('--device', default='cuda')
    p.add_argument('--image', type=int, default=224)
    p.add_argument('--stage_sizes', type=int, nargs=4, default=[3, 4, 6, 3])
    p.add_argument('--bottleneck', type=int, default=24)
    p.add_argument('--classes', type=int, default=1000)
    p.add_argument('--n_images', type=int, default=8)
    p.add_argument('--n_iter', type=int, default=120,
                   help='images a trial of the deploy, serving and '
                   'device-wire loops')
    p.add_argument('--n_trials', type=int, default=5,
                   help="trials of the deploy loop (the others take 3)")
    p.add_argument('--depth', type=int, default=16)
    p.add_argument('--loop_n', type=int, default=30,
                   help='calls of a device loop (the wire_batch pairs take '
                   '100 unless this is lower)')
    p.add_argument('--fresh_n_iter', type=int, default=96)
    p.add_argument('--throughput_wire_batch', type=int, default=128)
    p.add_argument('--throughput_n_iter', type=int, default=512)
    p.add_argument('--train_batch', type=int, default=128)
    p.add_argument('--train_image', type=int, default=224)
    p.add_argument('--train_steps', type=int, default=8)
    p.add_argument('--f32_reference', action='store_true',
                   help='also time the float32 runtime at the throughput '
                   'mode\'s wire_batch and the float32 train step')
    return p


def main(argv=None) -> dict:
    """Run every section and print the JSON line; returns its dict."""
    args = get_argparser().parse_args(argv)
    device = resolve_device(args.device)
    peak = H100_PEAK_BF16_FLOPS if device.type == 'cuda' else None
    shape = {'stage_sizes': tuple(args.stage_sizes),
             'bottleneck': args.bottleneck, 'classes': args.classes}
    model = build_model(device, **shape)
    rt = build_runtime(model, device)
    rng = np.random.default_rng(0)
    images = [torch.from_numpy(rng.normal(
        0, 1, (1, 3, args.image, args.image)).astype(np.float32)).to(device)
        for _ in range(args.n_images)]
    rt(images[0])
    rt.activate_analysis()
    n_iter, depth, n_pair = args.n_iter, args.depth, min(args.loop_n, 100)

    trials, best_timings = bench_deploy(rt, images, n_iter, args.n_trials,
                                        depth)
    serving = bench_serving(rt, images, n_iter, 3, depth)
    wire = bench_device_wire(rt, images, n_iter, 3, None, depth)
    wire8 = bench_device_wire(rt, images, n_iter, 3, 8, depth)
    fresh = bench_fresh_upload(model, device, args.image, args.fresh_n_iter,
                               depth)
    programs = bench_device_programs(rt, images[0], peak, args.loop_n)
    k = args.throughput_wire_batch
    rt16 = build_runtime(model, device, deploy_bf16_decode=True)
    rt16.activate_analysis()
    throughput = bench_throughput_mode(rt16, images, peak, k,
                                       args.throughput_n_iter, 3, depth,
                                       n_pair)
    rte = build_runtime(model, device, deploy_bf16_decode=True,
                        deploy_bf16_encode=True)
    pair, fpi = fused_pair_stats(rte, images, k, n_pair)
    bf16enc = {'throughput_bf16enc_device_ips': round(pair, 1),
               'throughput_bf16enc_mfu_vs_bf16_peak': _mfu(fpi * pair, peak)}
    extra = {}
    if args.f32_reference:
        pair32, fpi32 = fused_pair_stats(rt, images, k, n_pair)
        extra['throughput_f32_device_ips'] = round(pair32, 1)
        extra['throughput_f32_mfu_vs_bf16_peak'] = _mfu(fpi32 * pair32,
                                                        peak)
    del rt16, rte
    train = bench_train(device, peak, args.train_batch, args.train_image,
                        args.train_steps, **shape)
    if args.f32_reference:
        f32 = bench_train(device, peak, args.train_batch, args.train_image,
                          args.train_steps, dtype='float32', **shape)
        extra['train_f32_step_img_per_sec'] = f32['train_step_img_per_sec']
        extra['train_f32_mfu_vs_bf16_peak'] = f32['train_mfu_vs_bf16_peak']

    med = lambda ts: float(np.median(ts))  # noqa: E731
    modes = {'host_coder_pipelined': med(trials),
             'device_wire_rans': med(wire)}
    headline_mode = max(modes, key=modes.get)
    best_of = {'host_coder_pipelined': max(trials),
               'device_wire_rans': max(wire)}
    line = {
        'metric': 'deploy_images_per_sec_batch1',
        'value': round(modes[headline_mode], 2),
        'unit': 'images/sec',
        'vs_baseline': None,
        'headline_mode': headline_mode,
        'headline_is_median': True,
        'best_ips': round(best_of[headline_mode], 2),
        'host_coder_ips': round(max(trials), 2),
        'host_coder_median_ips': round(med(trials), 2),
        'baseline_ips_torch_cpu': None,
        'trials': [round(t, 2) for t in trials],
        'serving_mode_ips_decode_batch8': round(max(serving), 2),
        'serving_mode_median_ips': round(med(serving), 2),
        'serving_trials': [round(t, 2) for t in serving],
        'fresh_upload_uint8_ips': round(fresh, 2),
        'device_wire_rans_backend':
            'cuda' if device.type == 'cuda' else 'cpu-plain',
        'device_wire_rans_ips': round(max(wire), 2),
        'device_wire_median_ips': round(med(wire), 2),
        'device_wire_trials': [round(t, 2) for t in wire],
        'device_wire_batch8_ips': round(max(wire8), 2),
        'device_wire_batch8_median_ips': round(med(wire8), 2),
        'device_wire_batch8_trials': [round(t, 2) for t in wire8],
        'stage_ms_per_image': {
            key: round(v / n_iter * 1000, 2)
            for key, v in sorted(best_timings.items())},
        **programs, **throughput, **bf16enc, **train, **extra,
        'device': card_name_and_power_limit() if device.type == 'cuda'
        else 'cpu',
        'peak_bf16_flops': peak,
        'peak_bf16_source': PEAK_SOURCE if peak else None,
        'flops_counted': FLOPS_COUNTED,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main(sys.argv[1:])
