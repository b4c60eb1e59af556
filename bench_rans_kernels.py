#!/usr/bin/env python3
"""Times the port's ten rANS kernels at the flagship shapes on one GPU.

    python3 bench_rans_kernels.py

Run from a checkout's root; it times that checkout's `sc2bench_tpu_torch`
and takes its timing helpers from the `chip_smoke.py` beside it. To compare
two commits on one card, copy both scripts into an unpacked copy of the
other commit and run parent, change, change, parent in one run.

Inputs: coding tables of a fresh `EntropyBottleneck(24)` (23-column rows,
as the flagship's), symbols drawn from them (numpy seed 1234), 55x55x24
latents on 384 lanes x 190 steps; one image for the batch-1 kernels, eight
for the aligned ones.

Two times per kernel, in milliseconds:
  per_call_ms  median over REPS of CUDA events around ONE wrapper call
               on an idle card: the host's dispatch (argument checks,
               allocation, the ctypes call) plus the kernel; the `ms` of
               `chip_smoke.py`'s kernels line;
  device_ms    CUDA events around REPS calls queued back to back behind
               a sleep kernel that outlasts their dispatch, divided by
               REPS: the card's time per launch, host excluded.
Also `steps_sweep`: each kernel's device_ms on 384 lanes at T = 32, 190
and 600 steps (one image for the batch-1 kernels, eight for the aligned
ones), whose slope is the time of one step of the chain and whose
intercept is the fixed cost of a launch (prologue, write-out, launch gap);
`wire_batch_sweep`: the aligned kernels' device_ms at the flagship
shape for k = 1, 8, 32, 64 and 128 images a launch, whose slope is the
cost of one more image in the throughput regime; `wide_rows`: each
kernel's device_ms at the flagship shape with synthetic CDF rows of 600
and 1,200 columns (`chip_smoke.synthetic_tables`), beyond the shared-memory
table plans, with the bytes of the device table buffer each launch read
(`kernels.table_bytes`; 0 = shared tables); `indexed`: the four general
per-index kernels at the MSHP y shape (55x55x24 on 512 lanes x 142 steps,
the default Gaussian tables, rows and symbols from
`chip_smoke.indexed_inputs`, numpy seed 4321): per_call_ms and device_ms
of the batch-1 pair at k = 1 (and `device_ms_64ch` at the 64-channel
students' y, 55x55x64 on 1,024 lanes x 190 steps), device_ms of the
aligned pair at k = 1, 8 and 128, and `steps_sweep`: the batch-1 pair's
device_ms on 512 lanes at T = 32, 142 and 600 (as the cyclic sweep).
Where the checkout has them
(`ops/rans/indexed_tables.py`), the batch-1 pair reads the tables'
prepared form, built once outside the timing, and `prepare_ms` is what
building it took; so do the aligned decoder and the masked front decoder
where their wrappers take `prepared`. `aligned_decode`: the aligned
decoder's device_ms at k = 1, 8 and 128 on the MSHP y (512 x 142) and the
64-channel students' y (1,024 x 190), with the images a block (G) each
launch used where the checkout reports it; `group_sweep`: the same at G
= 1, 2, 4, 8 and 16 images a block (capped by shared memory and k), each
from a copy of `csrc/rans_indexed.cu` whose G rule (`aligned_group_rule`)
returns that G, built beside the checkout's library, its output checked
against the checkout's kernel; `masked_front`: per_call_ms and device_ms
of `rans_masked_decode_front` at the JAHP q1 shape (a 16x16x192 latent
at 256 px: 1,152 lanes, front 30 of 61, rows and values drawn from the
default Gaussian tables, numpy seed 61) and `launch_floor_ms`, the
device_ms of an empty kernel on its grid (where the checkout has one);
`jahp_fronts`: the same kernel's device_ms on the JAHP path's own fronts
(`chip_smoke.py` phase 13's q1 module, seeded weights and first image):
every front of one image's decode, on the streams the masked encoder
wrote for it, `image_ms` their sum and `fronts_ms` each; and the
masked encoder's per_call_ms and device_ms on that image's own rows and
activity (`encode_*`, on the tables `update()` prepared where its wrapper
takes them) beside `launch_floor_ms`, an empty kernel on its grid.
`aligned_encode`: the aligned indexed encoder's device_ms at k = 1, 8 and
128 on the MSHP y (512 x 142) and the 64-channel students' y (1,024 x
190), masks off and on, on prepared entries where its wrapper takes them,
with the plan (steps a tile, images a block) each launch used where the
checkout reports it; `encode_sweep`: the same, and the masked encoder on
the JAHP image, on copies of `csrc/rans_indexed.cu` whose plan rule
(`encode_plan_rule`) returns tiles of 8 or 16 steps and G = 1, 2, 4 or 8
(capped by shared memory and k), each checked against the checkout's
kernel, with the plan each aligned indexed launch took.
Prints one JSON line with the card's name and power limit. Needs a CUDA
device.
"""
from __future__ import annotations

import functools
import inspect
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 200
# the aligned indexed decoder: (lanes, n) of the MSHP y and of the
# 64-channel students' y; the images a launch; the groups of the sweep
ALIGNED_SHAPES = ((512, 55 * 55 * 24), (1024, 55 * 55 * 64))
ALIGNED_KS = (1, 8, 128)
SWEEP_GROUPS = (1, 2, 4, 8, 16)
# the aligned indexed encoder's sweep: steps a staged tile, images a block
ENCODE_TILES = (8, 16)
ENCODE_GROUPS = (1, 2, 4, 8)


def flagship_inputs(torch, td, device, images, n=55 * 55 * 24,
                    tables=None):
    """Lane tables and in-support symbol blocks (k, T, 384) drawn from
    `tables` (by default a fresh EntropyBottleneck(24)'s); T = 190 at the
    default n."""
    from sc2bench_tpu_torch.ops.entropy.factorized import EntropyBottleneck
    from sc2bench_tpu_torch.ops.entropy.tables import build_factorized_tables
    if tables is None:
        torch.manual_seed(0)
        tables = build_factorized_tables(EntropyBottleneck(24))
    cdf, cdf_len, off = (tables.quantized_cdf, tables.cdf_length,
                         tables.offset)
    c = cdf.shape[0]
    lanes = td.auto_lanes(55 * 55 * 24, cyclic_channels=c)
    rng = np.random.default_rng(1234)
    idx = np.arange(n) % c
    rows = np.empty((images, n), np.int32)
    for i in range(images):
        u = rng.integers(0, 1 << 16, n)
        for ch in range(c):
            m = idx == ch
            v = np.searchsorted(cdf[ch][:cdf_len[ch]], u[m], side='right') - 1
            rows[i, m] = np.clip(v, 0, cdf_len[ch] - 3) + off[ch]
    cdf_lane, len_lane, off_lane = td.lane_tables(cdf, cdf_len, off, lanes, c,
                                                  device)
    sym3, _, _ = td._blocks(torch.from_numpy(rows).to(device), lanes,
                            off_lane)
    return (sym3 - off_lane).contiguous(), cdf_lane, len_lane, off_lane


def kernel_calls(torch, td, kernels, device, wire_batch=8,
                 n=55 * 55 * 24, tables=None):
    """name -> zero-argument call of each kernel at the flagship shapes
    (or at `n` symbols per image on the flagship's 384 lanes), with the
    CDF rows of `tables` (by default the flagship's)."""
    vc8, cdf_lane, len_lane, off_lane = flagship_inputs(torch, td, device,
                                                        wire_batch, n, tables)
    vc1 = vc8[:1].contiguous()
    steps = vc1.shape[1]
    streams, _, states = kernels.cyclic_encode(cdf_lane, vc1)
    astreams, _, astates, _ = kernels.cyclic_encode_aligned(cdf_lane, vc8)
    return {
        'rans_cyclic_encode': lambda: kernels.cyclic_encode(cdf_lane, vc1),
        'rans_cyclic_decode': lambda: kernels.cyclic_decode(
            streams, states, cdf_lane, len_lane, off_lane, steps),
        'rans_cyclic_encode_aligned':
            lambda: kernels.cyclic_encode_aligned(cdf_lane, vc8),
        'rans_cyclic_decode_aligned': lambda: kernels.cyclic_decode_aligned(
            astreams, astates, cdf_lane, len_lane, off_lane, steps),
    }


def aligned_calls(kernels, vc, cdf_lane, len_lane, off_lane):
    """name -> zero-argument call of each aligned kernel on `vc`."""
    steps = vc.shape[1]
    streams, _, states, _ = kernels.cyclic_encode_aligned(cdf_lane, vc)
    return {
        'rans_cyclic_encode_aligned':
            lambda: kernels.cyclic_encode_aligned(cdf_lane, vc),
        'rans_cyclic_decode_aligned': lambda: kernels.cyclic_decode_aligned(
            streams, states, cdf_lane, len_lane, off_lane, steps),
    }


def indexed_calls(torch, td, kernels, device, indexed_inputs, per_call_ms,
                  device_ms):
    """Times of the indexed kernels at the MSHP y shape (see the module
    doc)."""
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    tables = build_gaussian_tables()
    n = 55 * 55 * 24
    lanes = td.auto_lanes(n)
    inp = indexed_inputs(torch, td, tables, lanes, n, 128,
                         np.random.default_rng(4321), device)
    cdf, cdf_len, off, steps = (inp['cdf'], inp['cdf_len'], inp['off'],
                                inp['steps'])
    out = {}
    batch1 = {}
    try:
        from sc2bench_tpu_torch.ops.rans.indexed_tables import \
            prepare_indexed_tables
    except ImportError:                 # a checkout before prepared tables
        prepare_indexed_tables = None
    if prepare_indexed_tables is not None:
        prepare_indexed_tables(cdf, cdf_len, off)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prep = prepare_indexed_tables(cdf, cdf_len, off)
        torch.cuda.synchronize()
        out['prepare_ms'] = (time.perf_counter() - t0) * 1e3
        batch1 = {'prepared': prep}

    def batch1_calls(vc, idx, steps):
        streams, _, states = kernels.indexed_encode(cdf, vc, idx, **batch1)
        return (('rans_indexed_encode',
                 lambda: kernels.indexed_encode(cdf, vc, idx, **batch1)),
                ('rans_indexed_decode',
                 lambda: kernels.indexed_decode(streams, states, cdf,
                                                cdf_len, off, idx, steps,
                                                **batch1)))

    vc1, idx1 = inp['vc'][:1].contiguous(), inp['idx3'][:1].contiguous()
    for name, fn in batch1_calls(vc1, idx1, steps):
        out[name] = {'per_call_ms': per_call_ms(torch, fn, REPS),
                     'device_ms': device_ms(torch, fn, REPS)}
    # the 64-channel students' y: 55x55x64 on 1,024 lanes x 190 steps
    n64 = 55 * 55 * 64
    y64 = indexed_inputs(torch, td, tables, td.auto_lanes(n64), n64, 1,
                         np.random.default_rng(64), device)
    for name, fn in batch1_calls(y64['vc'], y64['idx3'], y64['steps']):
        out[name]['device_ms_64ch'] = device_ms(torch, fn, REPS)
    sweep = {}
    for t in (32, 142, 600):
        sw = indexed_inputs(torch, td, tables, lanes, lanes * t, 1,
                            np.random.default_rng(t), device)
        for name, fn in batch1_calls(sw['vc'], sw['idx3'], sw['steps']):
            sweep.setdefault(name, {})[t] = device_ms(torch, fn, REPS)
    out['steps_sweep'] = sweep
    aligned = batch1 if _takes_prepared(kernels.indexed_decode_aligned) \
        else {}
    encoder = batch1 if _takes_prepared(kernels.indexed_encode_aligned) \
        else {}
    for k in (1, 8, 128):
        vc, idx = inp['vc'][:k].contiguous(), inp['idx3'][:k].contiguous()
        astreams, _, astates, _ = kernels.indexed_encode_aligned(cdf, vc,
                                                                 idx)
        for name, fn in (
                ('rans_indexed_encode_aligned',
                 lambda: kernels.indexed_encode_aligned(cdf, vc, idx,
                                                        **encoder)),
                ('rans_indexed_decode_aligned',
                 lambda: kernels.indexed_decode_aligned(
                     astreams, astates, cdf, cdf_len, off, idx, steps,
                     **aligned))):
            out.setdefault(name, {})[k] = device_ms(torch, fn, 50)
    return out


def _takes_prepared(fn) -> bool:
    return 'prepared' in inspect.signature(fn).parameters


def aligned_decode_cases(torch, td, kernels, device, indexed_inputs):
    """{shape: {k: zero-argument call}} of the aligned indexed decoder at
    ALIGNED_SHAPES x ALIGNED_KS on the plain-equal kernel encoder's
    streams, and {shape: {k: G}} where the checkout reports G."""
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    tables = build_gaussian_tables()
    calls, groups, prepared = {}, {}, None
    for lanes, n in ALIGNED_SHAPES:
        inp = indexed_inputs(torch, td, tables, lanes, n, max(ALIGNED_KS),
                             np.random.default_rng(lanes), device)
        cdf, cdf_len, off, steps = (inp['cdf'], inp['cdf_len'], inp['off'],
                                    inp['steps'])
        extra = {}
        if _takes_prepared(kernels.indexed_decode_aligned):
            from sc2bench_tpu_torch.ops.rans.indexed_tables import \
                prepare_indexed_tables
            prepared = prepare_indexed_tables(cdf, cdf_len, off)
            extra = {'prepared': prepared}
        shape = f'{lanes}x{steps}'
        for k in ALIGNED_KS:
            vc = inp['vc'][:k].contiguous()
            idx = inp['idx3'][:k].contiguous()
            streams, _, states, _ = kernels.indexed_encode_aligned(cdf, vc,
                                                                   idx)
            calls.setdefault(shape, {})[k] = functools.partial(
                kernels.indexed_decode_aligned, streams, states, cdf,
                cdf_len, off, idx, steps, **extra)
            if hasattr(kernels, 'indexed_aligned_group'):
                groups.setdefault(shape, {})[k] = \
                    kernels.indexed_aligned_group(
                        k, lanes, prepared.dec.numel(), device)
    return calls, groups


def aligned_encode_cases(torch, td, kernels, device, indexed_inputs):
    """{shape: {case: zero-argument call}} of the aligned indexed encoder
    at ALIGNED_SHAPES x ALIGNED_KS, masks off ('k=8') and on ('k=8
    masks'), on the tables' prepared entries where the wrapper takes
    them, and {shape: {k: (tile, G)}} where the checkout reports them."""
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    tables = build_gaussian_tables()
    calls, groups, extra = {}, {}, {}
    for lanes, n in ALIGNED_SHAPES:
        inp = indexed_inputs(torch, td, tables, lanes, n, max(ALIGNED_KS),
                             np.random.default_rng(lanes + 1), device)
        cdf = inp['cdf']
        if _takes_prepared(kernels.indexed_encode_aligned):
            from sc2bench_tpu_torch.ops.rans.indexed_tables import \
                prepare_indexed_tables
            extra = {'prepared': prepare_indexed_tables(
                cdf, inp['cdf_len'], inp['off'])}
        shape = f'{lanes}x{inp["steps"]}'
        for k in ALIGNED_KS:
            vc = inp['vc'][:k].contiguous()
            idx = inp['idx3'][:k].contiguous()
            for masks in (False, True):
                case = f'k={k}' + (' masks' if masks else '')
                calls.setdefault(shape, {})[case] = functools.partial(
                    kernels.indexed_encode_aligned, cdf, vc, idx, masks,
                    **extra)
            if hasattr(kernels, 'indexed_encode_aligned_plan'):
                groups.setdefault(shape, {})[k] = \
                    kernels.indexed_encode_aligned_plan(k, lanes, device)
    return calls, groups


def encode_variants(kernels):
    """{'tile=T G=G': path} of copies of `csrc/rans_indexed.cu` whose
    aligned encoders' plan rule (`encode_plan_rule`) returns tiles of T
    steps and G images a block (capped by shared memory and k), built
    beside the checkout's library; {} for a checkout without the rule."""
    source = kernels.INDEXED_SOURCE.read_text()
    rule = re.compile(r'(inline EncodePlan encode_plan_rule\([^)]*\) \{)')
    if not rule.search(source):
        return {}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variants = {}
    for t in ENCODE_TILES:
        for g in ENCODE_GROUPS:
            path = kernels.BUILD_DIR / f'rans_indexed_etile{t}_g{g}.cu'
            path.write_text(rule.sub(
                lambda m: f'{m.group(1)}\n  return {{{t}, std::min({g}, '
                          f'encode_gmax({t}, num_images, act_bytes))}};',
                source, count=1))
            variants[f'tile={t} G={g}'] = path
    kernels.build_libraries(tuple(variants.values()))
    return variants


def encode_sweep(torch, kernels, calls, device, device_ms):
    """{variant: {shape: {case: device_ms}}} of the aligned encoders built
    with each tile and G (`encode_variants`), and the plan (tile, G) each
    aligned indexed launch took ({variant: {shape: {k: plan}}})."""
    flat = {(shape, case): fn for shape, cases in calls.items()
            for case, fn in cases.items()}

    def plans():
        return {(shape, case): kernels.indexed_encode_aligned_plan(
            int(case.split()[0][2:]), int(shape.split('x')[0]), device)
            for shape, case in flat if case.startswith('k=')}
    sweep, used = {}, {}
    for variant, (times, plan) in on_variants(
            torch, kernels, encode_variants(kernels), flat, device_ms,
            probe=plans).items():
        for (shape, case), ms in times.items():
            sweep.setdefault(variant, {}).setdefault(shape, {})[case] = ms
            if (shape, case) in plan:
                used.setdefault(variant, {}).setdefault(shape, {})[
                    case.split()[0]] = plan[shape, case]
    return sweep, used


def group_variants(kernels):
    """{G: path} of copies of `csrc/rans_indexed.cu` whose G rule
    (`aligned_group_rule`) returns G (capped by shared memory and k),
    built (nvcc at once) beside the checkout's library; {} for a checkout
    without the rule."""
    source = kernels.INDEXED_SOURCE.read_text()
    rule = re.compile(r'(inline int aligned_group_rule\([^)]*\) \{)')
    if not rule.search(source):
        return {}
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variants = {}
    for g in SWEEP_GROUPS:
        path = kernels.BUILD_DIR / f'rans_indexed_group{g}.cu'
        path.write_text(rule.sub(
            lambda m: f'{m.group(1)}\n  return gmax < {g} ? gmax : {g};',
            source, count=1))
        variants[g] = path
    kernels.build_libraries(tuple(variants.values()))
    return variants


def on_variants(torch, kernels, variants, calls, device_ms, probe=None):
    """{value: {case: device_ms}} of each zero-argument call in `calls`
    ({case: fn}) on each variant library; each variant's outputs equal
    the checkout's kernel's. With `probe`, {value: (times, probe())},
    `probe` called with the variant's library loaded."""
    want = {case: fn() for case, fn in calls.items()}
    checkout = (kernels.INDEXED_SOURCE, kernels._indexed_lib)
    out = {}
    try:
        for value, path in variants.items():
            kernels.INDEXED_SOURCE, kernels._indexed_lib = path, None
            for case, fn in calls.items():
                if not all(a is b or torch.equal(a, b)
                           for a, b in zip(fn(), want[case])):
                    raise SystemExit(f'bench_rans_kernels: {path.name} '
                                     f'differs at {case}')
                out.setdefault(value, {})[case] = device_ms(torch, fn, 50)
            if probe is not None:
                out[value] = (out[value], probe())
    finally:
        kernels.INDEXED_SOURCE, kernels._indexed_lib = checkout
    return out


def group_sweep(torch, kernels, calls, device_ms):
    """{G: {shape: {k: device_ms}}} of the aligned indexed decoder built
    with its G rule returning G (`group_variants`)."""
    flat = {(shape, k): fn for shape, ks in calls.items()
            for k, fn in ks.items()}
    sweep = {}
    for g, times in on_variants(torch, kernels, group_variants(kernels),
                                flat, device_ms).items():
        for (shape, k), ms in times.items():
            sweep.setdefault(g, {}).setdefault(shape, {})[k] = ms
    return sweep


def masked_front(torch, td, kernels, device, gaussian_symbols, per_call_ms,
                 device_ms):
    """Times of one masked front decode at the JAHP q1 shape (see the
    module doc), and the launch floor of its grid."""
    from sc2bench_tpu_torch.models.zoo_jahp import front_arrays, wavefronts
    from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
    tables = build_gaussian_tables()
    m = 192
    _, _, act = front_arrays(wavefronts(16, 16))
    steps, slots = act.shape
    idx, rows = gaussian_symbols(tables, steps * slots * m,
                                 np.random.default_rng(61))
    cdf, cdf_len, off = (torch.from_numpy(a).to(device) for a in (
        tables.quantized_cdf, tables.cdf_length, tables.offset))
    idx = torch.from_numpy(idx.reshape(steps, slots * m)).to(device)
    vc = (torch.from_numpy(rows.reshape(steps, slots * m)).to(device)
          - off[idx.long()]).contiguous()
    act = torch.from_numpy(act.astype(np.uint8)).to(device)
    streams, _, x = kernels.masked_encode_aligned(cdf, vc, idx, act, m)
    extra = {}
    if _takes_prepared(kernels.masked_decode_front):
        from sc2bench_tpu_torch.ops.rans.indexed_tables import \
            prepare_indexed_tables
        extra = {'prepared': prepare_indexed_tables(cdf, cdf_len, off)}
    front = steps // 2
    for t in range(front):
        _, x = kernels.masked_decode_front(streams, t, x, cdf, cdf_len, off,
                                           idx[t], act[t], m, **extra)

    def fn():
        return kernels.masked_decode_front(streams, front, x, cdf, cdf_len,
                                           off, idx[front], act[front], m,
                                           **extra)
    out = {'lanes': slots * m, 'front': front,
           'per_call_ms': per_call_ms(torch, fn, REPS),
           'device_ms': device_ms(torch, fn, REPS)}
    if hasattr(kernels, 'launch_floor'):
        out['launch_floor_ms'] = device_ms(
            torch, lambda: kernels.launch_floor(slots * m, device), REPS)
    return out


def jahp_fronts(torch, kernels, device, per_call_ms, device_ms):
    """device_ms of the masked front decoder on every front of one JAHP
    image's decode, and the masked encoder's times on that image (see the
    module doc); and a zero-argument call of that encode."""
    from chip_smoke import CODEC_HW, JAHP_KEY, codec_weights
    from sc2bench_tpu_torch.models import zoo
    from sc2bench_tpu_torch.models.zoo_jahp import JointAutoregressiveRuntime
    from sc2bench_tpu_torch.ops.rans.device import RANS_L
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(0, 1, (1, 3, CODEC_HW, CODEC_HW))
                         .astype(np.float32)).to(device)
    torch.manual_seed(3)
    module = zoo.registry_get('model', JAHP_KEY)(quality=1, device=device)
    codec_weights(torch, module, 3, x)
    rt = JointAutoregressiveRuntime(module, device=device)
    rt.update()
    sch = rt.schedule(*rt.encode_device_wire(x)['shape'])
    y, _, hyper = rt._encode_ops(x)
    syms, idxs, _ = rt.forward_scan(y, hyper)
    vc, idx, _ = rt.masked_values(syms, idxs, sch)
    cdf, cdf_len, off = rt._g_tables_dev
    m = module.m
    streams, _, x_t = kernels.masked_encode_aligned(cdf, vc, idx, sch.active,
                                                    m)
    extra = {'prepared': rt._g_prepared} \
        if _takes_prepared(kernels.masked_decode_front) else {}
    fronts = []
    for t in range(sch.steps):
        def fn(t=t, x_t=x_t):
            return kernels.masked_decode_front(streams, t, x_t, cdf, cdf_len,
                                               off, idx[t], sch.active[t], m,
                                               **extra)
        fronts.append(device_ms(torch, fn, 50))
        _, x_t = fn()
    if not bool((x_t == RANS_L).all()):
        raise SystemExit('bench_rans_kernels: the JAHP decode is not valid')
    encoder = {'prepared': rt._g_prepared} \
        if _takes_prepared(kernels.masked_encode_aligned) else {}

    def encode():
        return kernels.masked_encode_aligned(cdf, vc, idx, sch.active, m,
                                             **encoder)
    lanes = sch.slots * m
    out = {'lanes': lanes, 'image_ms': sum(fronts), 'fronts_ms': fronts,
           'encode_per_call_ms': per_call_ms(torch, encode, REPS),
           'encode_device_ms': device_ms(torch, encode, REPS)}
    if hasattr(kernels, 'launch_floor'):
        out['launch_floor_ms'] = device_ms(
            torch, lambda: kernels.launch_floor(lanes, device), REPS)
    return out, encode


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('bench_rans_kernels: no CUDA device is available')
    sys.path.insert(0, HERE)
    from chip_smoke import (device_ms, gaussian_symbols, indexed_inputs,
                            per_call_ms, synthetic_tables)
    from sc2bench_tpu_torch.ops.rans import device as td
    from sc2bench_tpu_torch.ops.rans import kernels
    device = torch.device('cuda', 0)
    kernels.build_libraries()
    out = {}
    for name, fn in kernel_calls(torch, td, kernels, device).items():
        out[name] = {'per_call_ms': per_call_ms(torch, fn, REPS),
                     'device_ms': device_ms(torch, fn, REPS)}
    sweep = {}
    for steps in (32, 190, 600):
        calls = kernel_calls(torch, td, kernels, device, n=384 * steps)
        for name, fn in calls.items():
            sweep.setdefault(name, {})[steps] = device_ms(torch, fn, REPS)
    vc128, cdf_lane, len_lane, off_lane = flagship_inputs(torch, td, device,
                                                          128)
    batches = {k: vc128[:k].contiguous() for k in (1, 8, 32, 64, 128)}
    wire_sweep = {}
    for k, vc in batches.items():
        calls = aligned_calls(kernels, vc, cdf_lane, len_lane, off_lane)
        for name, fn in calls.items():
            wire_sweep.setdefault(name, {})[k] = device_ms(torch, fn, REPS)
    wide = {}
    if hasattr(kernels, 'table_bytes'):
        for cols in (600, 1200):
            tables = synthetic_tables(24, cols - 2, cols)
            calls = kernel_calls(torch, td, kernels, device, tables=tables)
            for name, fn in calls.items():
                k = 1 if name in ('rans_cyclic_encode',
                                  'rans_cyclic_decode') else 8
                wide.setdefault(name, {})[cols] = {
                    'device_ms': device_ms(torch, fn, REPS),
                    'table_bytes': kernels.table_bytes(
                        name, cols, 190, 190, k, 384, device)}
    indexed = indexed_calls(torch, td, kernels, device, indexed_inputs,
                            per_call_ms, device_ms)
    calls, groups = aligned_decode_cases(torch, td, kernels, device,
                                         indexed_inputs)
    aligned = {shape: {k: device_ms(torch, fn, 50) for k, fn in ks.items()}
               for shape, ks in calls.items()}
    gsweep = group_sweep(torch, kernels, calls, device_ms)
    masked = masked_front(torch, td, kernels, device, gaussian_symbols,
                          per_call_ms, device_ms)
    fronts, jahp_encode = jahp_fronts(torch, kernels, device, per_call_ms,
                                      device_ms)
    ecalls, egroups = aligned_encode_cases(torch, td, kernels, device,
                                           indexed_inputs)
    aligned_enc = {shape: {case: device_ms(torch, fn, 50)
                           for case, fn in cases.items()}
                   for shape, cases in ecalls.items()}
    ecalls[f'jahp {fronts["lanes"]} lanes'] = {'masked': jahp_encode}
    esweep, esweep_groups = encode_sweep(torch, kernels, ecalls, device,
                                         device_ms)
    smi = subprocess.run(
        ['nvidia-smi', '--id=0', '--query-gpu=name,power.limit,clocks.sm',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({'repo': HERE, 'card': smi,
                      'kernels': out, 'steps_sweep': sweep,
                      'wire_batch_sweep': wire_sweep, 'wide_rows': wide,
                      'indexed': indexed, 'aligned_decode': aligned,
                      'aligned_groups': groups, 'group_sweep': gsweep,
                      'masked_front': masked, 'jahp_fronts': fronts,
                      'aligned_encode': aligned_enc,
                      'aligned_encode_groups': egroups,
                      'encode_sweep': esweep,
                      'encode_sweep_groups': esweep_groups}),
          flush=True)


if __name__ == '__main__':
    main()
