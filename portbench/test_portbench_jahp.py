"""The joint autoregressive codec's cell (`families/jahp_classifier.py`):
its plain reference loads alone, a sound run at a small size is correct,
the masked kernels' costs add up, and on the card the control (the
reference with TF32 on in the program's place) is not correct."""
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, roofline, roofline_masked
from portbench.reference import jahp as J

CELL = 'jahp-q8-r50-serve-r8'
SMALL = {'config': {'model': {'n': 8, 'm': 12, 'input_size': [48, 40],
                              'num_classes': 10}},
         'traffic': {'pool': {'count': 3, 'sizes': [[48, 40]],
                              'canvas': {'min_size': 40, 'max_size': 48}},
                     'request_images': 2, 'check_share': 1.0}}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('module', ['portbench.reference.jahp',
                                    'portbench.reference.train_stage2'])
def test_the_references_load_without_the_program_or_jax(module):
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            f'import {module}; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"sc2bench_tpu_torch", "sc2bench_tpu", "jax", "jaxlib", '
            '"flax"}))')
    out = subprocess.run([sys.executable, '-c', code, ROOT], check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == '[]'


def test_a_sound_run_is_correct():
    result = harness.run_cell(CELL, 2 ** 31 + 5, 0.3, 0, 'cpu',
                              time.perf_counter(), overrides=SMALL)
    assert result['correct'], result['checks']
    assert set(result['metrics']) == {'images_per_s', 'latency_p95_ms',
                                      'setup_s'}


def test_the_fronts_and_the_masked_costs():
    rows, cols, act = J.lane_layout(16, 16)
    counts = act.sum(dim=1).tolist()
    assert len(counts) == 61 and max(counts) == 6 and sum(counts) == 256
    for t in range(len(counts)):
        d = 3 * rows[t, :counts[t]] + cols[t, :counts[t]]
        assert len(set(d.tolist())) == 1
    steps, slots, m = 61, 6, 320
    nbytes, ops = roofline_masked.masked_encode_cost(steps, slots, m,
                                                     256 * m)
    lanes = slots * m
    assert nbytes == 8 * steps * lanes + steps * slots + 16 * 256 * m \
        + 4 * lanes * steps + 12 * lanes
    assert ops == roofline.ENCODE_OPS_PER_SYMBOL * 256 * m
    bounds = roofline_masked.masked_bounds(counts, m)
    assert set(bounds) == {'rans_indexed_encode_aligned_warp_kernel',
                           'rans_masked_decode_front_kernel'}
    assert all(0 < b < 1e-4 for b in bounds.values())


def test_the_gaussian_tables_keep_compressai_s_shape():
    t = J.gaussian_tables()
    assert t['quantized_cdf'].shape[0] == 64
    assert (t['quantized_cdf'][:, 0] == 0).all()
    last = t['quantized_cdf'][range(64), t['cdf_length'] - 1]
    assert (last == 1 << 16).all()
    assert t['offset'][0] == -1 and t['offset'][-1] == -1565


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('the control runs on a CUDA card (TF32)')
    return 'cuda:0'


@pytest.mark.cuda
def test_the_control_is_not_correct(card):
    line = harness.calibration_run(CELL, 2 ** 31 + 9, 0.5, card,
                                   time.perf_counter(), ['tf32'],
                                   overrides={'traffic': {
                                       'check_share': 1.0}})
    limits = harness.load_json('limits', CELL)
    assert all(v <= limits[k] for k, v in line['program'].items()), line
    assert any(v > limits[k] for k, v in line['tf32'].items()), line
