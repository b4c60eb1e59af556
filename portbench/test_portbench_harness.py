"""The harness's arithmetic, its files found by name, and the guard on
what a run may import."""
import ast
import json
import math
import os

import pytest
import torch

from portbench import harness, roofline, tracing
from portbench.drivers.serve_closed import p95_ms
from portbench.reference import resnet_fp as R

HERE = os.path.dirname(os.path.abspath(__file__))


def test_p95_is_over_all_requests():
    lat = [i / 1000 for i in range(1, 201)]         # 1 ... 200 ms
    assert p95_ms(lat) == pytest.approx(190.05)
    assert p95_ms([0.5] * 19 + [2.0]) == pytest.approx(575.0)


def test_busy_time_counts_overlaps_once():
    merged = tracing.union([(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)])
    assert merged == [[0, 15], [20, 31], [40, 40]]
    assert sum(e - s for s, e in merged) == 26


def test_idle_gaps_take_the_innermost_host_range():
    events = [(0, 100, 'request'), (10, 50, 'wire_encode'),
              (60, 90, 'wire_decode')]
    assert tracing.innermost(events, [5, 20, 55, 70, 95, 200]) == [
        'request', 'wire_encode', 'request', 'wire_decode', 'request', None]


def test_rans_costs():
    k, lanes, steps, cols = 32, 384, 190, 23
    nbytes, ops = roofline.cyclic_encode_cost(k, lanes, steps, cols)
    assert nbytes == 2 * 4 * k * steps * lanes + 4 * lanes * cols \
        + 12 * k * lanes
    assert ops == 10 * k * steps * lanes
    search = lanes * 23
    nbytes, ops = roofline.cyclic_decode_cost(k, lanes, steps, cols, search)
    assert nbytes == 8 * k * lanes * steps + 16 * k * lanes \
        + 4 * lanes * cols + 8 * lanes
    assert ops == k * steps * (2 * search + 9 * lanes)
    assert roofline.bound_s(3.35e12, 1) == pytest.approx(1.0)
    assert roofline.bound_s(1, 67e12) == pytest.approx(1.0)


def test_flops_are_counted_on_meta_tensors():
    w = torch.empty(64, 3, 7, 7, device='meta')
    x = torch.empty(2, 3, 32, 32, device='meta')
    flops = roofline.count_flops(
        lambda: torch.nn.functional.conv2d(x, w, stride=2, padding=3))
    assert flops == 2 * (2 * 16 * 16) * 64 * 3 * 49


def test_flops_of_the_served_resnet():
    sd = {k: torch.empty(s, device='meta') if init[0] != 'count'
          else torch.zeros((), dtype=torch.int64)
          for k, s, init in R.student_specs(
              {'bottleneck_channels': 24, 'target_channels': 256,
               'num_classes': 1000})}
    x = torch.empty(1, 3, 224, 224, device='meta')
    flops = roofline.count_flops(lambda: R.logits_from_symbols(
        sd, R.symbols(sd, x).to(torch.float32)))
    # the encoder's, decoder's and layer2-4's convolutions and fc
    assert 14e9 < flops < 16e9


def test_every_cell_finds_its_files():
    bench = harness.benchmark()
    names = {c['name'] for c in bench['configs']}
    for c in bench['configs']:
        assert os.path.exists(os.path.join(harness.ROOT, c['file']))
    for w in bench['workloads']:
        assert w['config'] in names
        config = harness.load_json('configs', w['config'])
        mix = harness.load_json('workloads', w['traffic'])
        limits = harness.load_json('limits', w['name'])
        assert config['family'] and mix['driver'] and limits
        _, e2e, per_layer = harness.cell(bench, w['name'])
        assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2
        assert per_layer
        moved = {m['name'] for m in e2e}
        assert {m['moves'] for m in per_layer} <= moved
    for m in bench['per_layer']:
        assert callable(harness.metric_reader(m['name']))


def test_readers_find_nothing_where_nothing_was_traced():
    bench = harness.benchmark()
    empty = {'trace': None, 'counters': {}, 'system': None}
    for m in bench['per_layer']:
        assert harness.metric_reader(m['name'])(empty) is None, m['name']


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def _sources(*parts):
    top = os.path.join(HERE, *parts)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py') and not f.startswith('test_'):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: `sc2bench_tpu_torch` is allowed,
    `sc2bench_tpu` is not."""
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, f'{path} imports {bad}'


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources('reference'):
        names = set(_imports(path))
        assert 'sc2bench_tpu_torch' not in names, path
        assert not names & set(harness.FORBIDDEN), path


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(
        ['sc2bench_tpu_torch', 'sc2bench_tpu_torch.models', 'jaxtyping',
         'flaxen', 'numpy']) == []
    assert harness.forbidden_modules(
        ['sc2bench_tpu.models', 'jax.numpy', 'flax', 'jaxlib']) == [
        'flax', 'jax', 'jaxlib', 'sc2bench_tpu']


def test_benchmark_json_keeps_to_its_shape():
    bench = harness.benchmark()
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert len(json.dumps(bench)) < 64 * 1024
    for m in bench['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    for m in bench['per_layer']:
        if m['name'].endswith('_roofline') or 'mfu' in m['name'] \
                or '_roofline.' in m['name']:
            assert m['unit'] == '%'
    for w in bench['workloads']:
        assert len(w['why']) <= 200 and w['chips'] in (1, 4)
    assert not math.isnan(bench['run_seconds'])
