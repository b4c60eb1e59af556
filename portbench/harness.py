"""Run one cell of `BENCHMARK.json` once and build its result line.

A cell names a configuration and a traffic mix; the harness finds each by
that name: `configs/<config>.json` (its `family` is the module under
`families/` that builds the system and decides `correct`),
`workloads/<traffic>.json` (its `driver` is the module under `drivers/`
that runs the window) and `limits/<cell>.json` (the limit of each number
that `correct` compares). A per-layer metric is read by
`metrics/<metric>.py`. An end-to-end metric named `<quantity>.<suffix>`
reports the driver's `<quantity>`, so that cells whose runs spread
differently can hold one quantity to bounds of their own. Nothing here
branches on a cell's name.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'sc2bench_tpu')


def forbidden_modules(modules=None):
    """The forbidden top-level names among loaded modules."""
    names = {m.split('.')[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(kind, name):
    with open(os.path.join(HERE, kind, f'{name}.json')) as f:
        return json.load(f)


def benchmark(path=None):
    with open(path or os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def cell(bench, workload):
    """The cell's entry, its end-to-end and per-layer metric entries."""
    matches = [w for w in bench['workloads'] if w['name'] == workload]
    if not matches:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get('workloads', [workload])]
    return matches[0], mine(bench['end_to_end']), mine(bench['per_layer'])


def metric_reader(name):
    """`metrics/<name>.py`'s `read(ctx)`."""
    path = os.path.join(HERE, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'portbench.metrics.{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _merge(base, over):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def _drive(workload, seed, seconds, trace, device, t_start, bench,
           overrides):
    import torch
    bench = bench or benchmark()
    entry, e2e, per_layer = cell(bench, workload)
    overrides = overrides or {}
    config = _merge(load_json('configs', entry['config']),
                    overrides.get('config'))
    mix = _merge(load_json('workloads', entry['traffic']),
                 overrides.get('traffic'))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family = importlib.import_module(f'portbench.families.{config["family"]}')
    system = family.build(config, mix, seed, torch.device(device))
    out = importlib.import_module(f'portbench.drivers.{mix["driver"]}').run(
        system, mix, seed, seconds, trace, t_start)
    return entry, e2e, per_layer, config, mix, system, out


def run_cell(workload, seed, seconds, trace, device, t_start,
             bench=None, overrides=None):
    """Build the cell's system, drive its window, check it and read its
    metrics. Returns the result line as a dict (`checks` last).
    `overrides` ({'config': {...}, 'traffic': {...}}) resize a cell for
    the CPU tests."""
    import torch
    entry, e2e, per_layer, config, mix, system, out = _drive(
        workload, seed, seconds, trace, device, t_start, bench, overrides)
    device = torch.device(device)
    limits = load_json('limits', workload)
    checks = {k: {'value': v, 'limit': limits[k]}
              for k, v in out['check']().items()}
    correct = all(c['value'] <= c['limit'] for c in checks.values())
    counters = out['counters']
    metrics = {}
    if trace:
        ctx = {'trace': out['trace'], 'counters': counters, 'system': system,
               'traffic': mix, 'config': config}
        for m in per_layer:
            value = metric_reader(m['name'])(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = dict(out['end_to_end'], setup_s=out['setup_s'])
        for m in e2e:
            # `<quantity>.<cells>` reports the driver's `<quantity>`
            key = m['name'] if m['name'] in values \
                else m['name'].split('.')[0]
            if key in values:
                metrics[m['name']] = {'value': values[key],
                                      'unit': m['unit']}
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': torch.cuda.get_device_name(device)
           if device.type == 'cuda' else 'cpu',
           'count': int(entry.get('chips', 1)),
           'memory_peak_bytes': counters['memory_peak_bytes']}
    result = {'correct': correct, 'attempted': counters['attempted'],
              'failed': counters.get('failed', 0), 'metrics': metrics,
              'device': dev}
    if trace:
        from .tracing import breakdown
        dev.update(busy_s=out['trace']['busy_s'],
                   window_s=out['trace']['window_s'])
        result['breakdown'] = breakdown(out['trace'])
    result['checks'] = checks
    return result


def calibration_run(workload, seed, seconds, device, t_start, stand_ins,
                    bench=None, overrides=None):
    """The numbers `correct` compares for the program and for each
    stand-in of the reference (`calibrate.py`)."""
    _, _, _, _, _, _, out = _drive(workload, seed, seconds, False, device,
                                   t_start, bench, overrides)
    line = {'program': out['check'](), 'end_to_end': out['end_to_end'],
            'setup_s': out['setup_s']}
    for kind in stand_ins:
        line[kind] = out['check'](kind)
    return line


def _card():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi not readable'


def main(args, t_start):
    import torch
    bench = benchmark()
    entry, _, _ = cell(bench, args.workload)
    need = int(entry.get('chips', 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f'portbench: the cell needs {need} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 3
    print(f'card: {_card()}', file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), 'cuda:0', t_start, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f'portbench: forbidden modules loaded: {bad}', file=sys.stderr)
        return 4
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
