"""The benchmark's data-parallel stage-2 cell (`portbench/families/
stage2_group.py`, `drivers/train_group.py`) over two gloo ranks on the
CPU at a small size (2 images of 32 px a rank, ResNet-50 + FP-24 student
and teacher at full width), each run a process of its own
(`torch_port_stage2_group_run.py`):

- a sound run is correct by the cell's own limits: the ranks' parameters
  and buffers bitwise equal after the window, the group's first loss,
  gradient and update norms against the plain reference's step over both
  ranks' images at once (at this size the step's gradient is about 2e-3
  from a float64 reference in float32 itself, the program and the
  reference alike: BatchNorm's backward magnifies rounding);
- rank 0's gradients left out of the group's average: the gradient gap
  reads far above any limit;
- rank 1 killed in the window: the run ends with exit code 5 within the
  test's time, and prints no result.
This file imports neither JAX nor `sc2bench_tpu`."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUN = os.path.join(HERE, 'torch_port_stage2_group_run.py')


def _run(mode, timeout=240):
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, RUN, mode], cwd=os.path.dirname(
        HERE), capture_output=True, text=True, timeout=timeout)
    return proc, time.monotonic() - t0


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_sound_group_run_keeps_the_ranks_equal_and_the_reference():
    r = _result(_run('sound')[0])
    assert r['correct'], r['checks']
    assert r['checks']['rank_param_gap']['value'] == 0.0
    assert r['attempted'] >= 1 and r['device']['count'] == 4
    assert set(r['metrics']) == {'train_images_per_s', 'setup_s'}


def test_a_rank_left_out_of_the_average_fails_the_check():
    r = _result(_run('unaveraged')[0])
    assert not r['correct']
    assert r['checks']['grad_norm_gap']['value'] > 0.1
    assert r['checks']['rank_param_gap']['value'] == 0.0


def test_a_killed_rank_ends_the_run_with_an_error():
    proc, seconds = _run('killed')
    assert proc.returncode == 5, proc.stderr[-2000:]
    assert 'a rank of the group died' in proc.stderr
    assert not proc.stdout.strip()
    assert seconds < 200
