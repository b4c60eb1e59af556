"""`correct` separates: a sound run of each cell comes out correct, a run
with the timed path broken underneath (`faults.py`) does not, and on the
card the control (the reference with TF32 on in the program's place)
does not either. The CPU runs skip the harness's look for a chip and
shrink the cells (`overrides`); the checks and their limits are the
cells' own."""
import time

import pytest
import torch

from portbench import faults, harness

SMALL = {
    'r50fp24-serve-wb32': {'traffic': {
        'pool': {'count': 8, 'sizes': [[32, 32]]}, 'request_images': 4,
        'serve': {'wire_batch': 2}, 'check_share': 1.0}},
    'frcnn-fp24-serve-b1': {'traffic': {
        'pool': {'count': 2, 'sizes': [[48, 64], [64, 48]],
                 'canvas': {'min_size': 64, 'max_size': 96}},
        'check_share': 1.0}},
    'r50fp24-train-stage1': {
        'traffic': {'batches': {'batch': 2, 'size': [32, 32]}},
        'config': {'model': {'input_size': [32, 32]}}},
}
# the faults each cell can have (no cell spans chips; the detection cell
# serves one image a request, so it has no batch to halve)
FAULTS = [('r50fp24-serve-wb32', 'answer_altered'),
          ('r50fp24-serve-wb32', 'half_batch'),
          ('frcnn-fp24-serve-b1', 'answer_altered'),
          ('r50fp24-train-stage1', 'state_unchanged'),
          ('r50fp24-train-stage1', 'state_unchanged_once_warm'),
          ('r50fp24-train-stage1', 'half_batch')]


def _run(cell, seed=2 ** 31 + 5):
    return harness.run_cell(cell, seed, 0.3, 0, 'cpu', time.perf_counter(),
                            overrides=SMALL[cell])


@pytest.mark.parametrize('cell', sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result['correct'], result['checks']
    _, e2e, _ = harness.cell(harness.benchmark(), cell)
    assert set(result['metrics']) == {m['name'] for m in e2e}


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    undo = faults.plant(fault)
    try:
        result = _run(cell)
    finally:
        undo()
    assert not result['correct'], result['checks']


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('the control runs on a CUDA card (TF32)')
    return 'cuda:0'


@pytest.mark.cuda
@pytest.mark.parametrize('cell', sorted(SMALL))
def test_the_control_is_not_correct(card, cell):
    line = harness.calibration_run(cell, 2 ** 31 + 9, 0.5, card,
                                   time.perf_counter(), ['tf32'],
                                   overrides=SMALL[cell])
    limits = harness.load_json('limits', cell)
    assert all(v <= limits[k] for k, v in line['program'].items()), line
    assert any(v > limits[k] for k, v in line['tf32'].items()), line
