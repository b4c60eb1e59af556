"""The four-rank stage-2 training cell (`drivers/train_group.py`,
`families/stage2_group.py`) shrunk to two gloo ranks on the CPU, each run
a process of its own (the ranks start with `spawn`, and a lost rank ends
the whole process): a sound run keeps the ranks equal and the reference's
loss, and a run whose rank 0 leaves its gradients out of the average, or
whose rank 0's SGD drops its momentum (which only the step after the
window shows: a first step's buffer is its gradient), is not correct.
The limits are the cell's own."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = '''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from portbench import harness
if sys.argv[2] == 'unaveraged':
    import sc2bench_tpu_torch.train.optim as optim
    average = optim.average_gradients
    def leave_mine_out(params):
        for p in params:
            if p.grad is not None:
                p.grad.zero_()
        average(params)
    optim.average_gradients = leave_mine_out
if sys.argv[2] == 'no_momentum':
    import sc2bench_tpu_torch.train.optim as optim
    options = optim._group_options
    def without_momentum(key, kwargs):
        cls, opts, lr = options(key, kwargs)
        return cls, dict(opts, momentum=0.0), lr
    optim._group_options = without_momentum
small = {'traffic': {'ranks': 2, 'batches': {'batch': 2, 'size': [32, 32],
                                             'count': 2}}}
print(json.dumps(harness.run_cell('r50fp24-train-stage2-dp4', 2 ** 31 + 7,
                                  0.3, 0, 'cpu', time.perf_counter(),
                                  overrides=small)))
'''


def _run(mode):
    proc = subprocess.run([sys.executable, '-c', CODE, ROOT, mode],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_sound_run_keeps_the_ranks_equal():
    r = _run('sound')
    assert r['correct'], r['checks']
    assert r['checks']['rank_param_gap']['value'] == 0.0


def test_a_rank_left_out_of_the_average_is_not_correct():
    r = _run('unaveraged')
    assert not r['correct']
    assert r['checks']['grad_norm_gap']['value'] > 0.1


def test_sgd_without_momentum_is_not_correct():
    r = _run('no_momentum')
    assert not r['correct']
    assert r['checks']['loss_gap']['value'] <= r['checks']['loss_gap'][
        'limit']
    assert r['checks']['warm_update_norm_gap']['value'] > 0.1
