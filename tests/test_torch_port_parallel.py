"""The port's scale-out (`sc2bench_tpu_torch/parallel/`, the group
BatchNorm, the metric syncs, the multi-process checkpoint, the profiler
and `models/serving_pool.py`) on the CPU over gloo.

One two-process job (`torchrun --standalone`, a fresh port per job)
starts when this module's first test runs and does every multi-rank
check (`tests/torch_port_parallel_worker.py`) while the single-process
tests run: one `DistillationBox` step of stage 1 and of stage 2 and one
end-to-end `DetectionBox` step on each rank's half of the batch, the
segm and keypoint evaluators' sync, the FP encoder with its image rows
sharded over a ('data', 'model') mesh of (1, 2), and the three CLIs over
the group. The tests then hold its results against JAX's `DistillationBox`
on a 2-device mesh at the global batch (the same variables, batch and
noise), against JAX's unsharded encoder, and against the port in one
process."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu.ops.entropy.factorized as jax_factorized
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.config import \
    train_stage_configs as jax_train_stage_configs
from sc2bench_tpu.datasets.image import DataLoader as JaxDataLoader
from sc2bench_tpu.models.layer import FPBasedResNetBottleneck as JaxFP
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.parallel.mesh import get_mesh
from sc2bench_tpu.train.box import DistillationBox as JaxDistillationBox
from sc2bench_tpu_torch.config import load_config, train_stage_configs
from sc2bench_tpu_torch.datasets.image import DataLoader
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.models.serving_pool import ServingPool
from sc2bench_tpu_torch.utils.ckpt import save_ckpt
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax
from sc2bench_tpu_torch.utils.profiling import StageTimer, count, span, trace
from test_torch_port_detection import (CANVAS, CLASSES, COCO, FP, STAGES,
                                       det_variables, jax_small, nchw,
                                       random_boxes)
from test_torch_port_detection_heads import _eval_targets
from test_torch_port_model import _nchw, _randomize
from test_torch_port_train import SMALL, TINY, _flat, _jax_variables, _to_flax
from torch_port_parallel_worker import (box_steps, cli_runs, coco_sync,
                                        det_step, seg_loss)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / 'tests' / 'torch_port_parallel_worker.py'
WORLD = 2
BATCH, PX = 8, 32                      # the global batch, 4 a rank
SEEDS = (11, 12)                       # each stage's noise generator
SMALL_CLS = {'models': {
    'teacher_model': {'key': 'resnet', 'kwargs': {'stage_sizes': [1] * 4}},
    'student_model': {'kwargs': {'stage_sizes': [1] * 4}}}}
SEG = str(REPO / 'configs/sample/tiny_segmentation.yaml')
DET = str(REPO / 'configs/sample/tiny_detection.yaml')
DEVICE_WIRE = json.dumps({'deploy_wire': 'device'})
DET_E2E = COCO / ('end-to-end/faster_rcnn_splittable_resnet50-fp-beta1.28e-8_'
                  'fpn.yaml')
DET_BATCH, DET_BOXES = 4, 8            # the detection step's global batch
MESH_CH, MESH_PX = 8, 128              # the sharded encoder's test case


def _cli_spec(d: Path) -> list:
    """(name, task, argv) of the CLI runs: train one epoch of stage 1 and
    test on the device wire (a profile of the test), resume that state
    into a second epoch and stage 2 with `-adjust_lr`, test a checkpoint
    (teacher too), and test the tiny VOC and COCO configs."""
    ckpt = str(d / 'cls' / 'student.ckpt')
    fresh = str(d / 'fresh' / 'student.ckpt')
    small = SMALL_CLS['models']
    tested = {'models': {**small, 'student_model': {
        **small['student_model'], 'ckpt': fresh}}, 'deploy_wire': 'device'}
    return [
        ('train', 'cls', ['--config', TINY, '--json', json.dumps({
            **SMALL_CLS, 'deploy_wire': 'device',
            'train': {'stage2': {'num_epochs': 0}}}), '-student_only',
            '--dst_ckpt', ckpt, '--profile_dir', str(d / 'profile')]),
        ('resume', 'cls', ['--config', TINY, '--json', json.dumps({
            **SMALL_CLS, 'train': {'stage1': {'num_epochs': 2}}}),
            '-student_only', '--dst_ckpt', ckpt, '-resume', '-adjust_lr']),
        ('test', 'cls', ['--config', TINY, '--json', json.dumps(tested),
                         '-test_only']),
        ('seg', 'seg', ['--config', SEG, '--json', DEVICE_WIRE, '-test_only']),
        ('det', 'det', ['--config', DET, '--json', DEVICE_WIRE, '-test_only'])]


def _box_spec() -> tuple:
    """The box steps' inputs (port state dicts, NCHW batches) and the
    Flax variables they come from."""
    cfg = load_config(TINY, SMALL)
    jcfg = jax_load_config(TINY, SMALL)
    rng = np.random.default_rng(21)
    js = jax_load_model(jcfg['models']['student_model'])
    jt = jax_load_model(jcfg['models']['teacher_model'])
    s_vars = _jax_variables(js, rng, mode='train')
    t_vars = _jax_variables(jt, rng, train=False)
    xs = [rng.normal(0, 1, (BATCH, PX, PX, 3)).astype(np.float32)
          for _ in SEEDS]
    ys = [rng.integers(0, 10, BATCH) for _ in SEEDS]
    spec = {'teacher_cfg': cfg['models']['teacher_model'],
            'student_cfg': cfg['models']['student_model'],
            'teacher': state_dict_from_flax(t_vars),
            'student': state_dict_from_flax(s_vars),
            'stages': train_stage_configs(cfg['train']), 'seeds': SEEDS,
            'x': [_nchw(x) for x in xs],
            'y': [torch.from_numpy(y) for y in ys]}
    jax_side = {'student': js, 'teacher': jt, 's_vars': s_vars,
                't_vars': t_vars, 'x': xs, 'y': ys,
                'stages': jax_train_stage_configs(jcfg['train'])}
    return spec, jax_side


def _det_spec() -> dict:
    """The detection step's inputs: the small Faster R-CNN (FP 8/256, 5
    classes) from randomized Flax variables, the end-to-end recipe's
    stage, four 96 px canvases and their padded targets (1-6 boxes)."""
    variables = det_variables(jax_small({'bottleneck_config': FP}), 20)
    rng = np.random.default_rng(24)
    x = rng.normal(0, 0.5, (DET_BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
    boxes = np.zeros((DET_BATCH, DET_BOXES, 4), np.float32)
    labels = np.zeros((DET_BATCH, DET_BOXES), np.int64)
    valid = np.zeros((DET_BATCH, DET_BOXES), bool)
    for i in range(DET_BATCH):
        k = int(rng.integers(1, 7))
        boxes[i, :k] = random_boxes(rng, k, 60.0, 12.0, 40.0)
        labels[i, :k] = rng.integers(1, CLASSES, k)
        valid[i, :k] = True
    return {'bottleneck': FP, 'stages': STAGES, 'classes': CLASSES,
            'state': state_dict_from_flax(variables),
            'stage': load_config(DET_E2E)['train'], 'seed': 13,
            'x': nchw(x), 'targets': {
                'boxes': torch.from_numpy(boxes),
                'labels': torch.from_numpy(labels),
                'boxes_valid': torch.from_numpy(valid)}}


def _mesh_spec() -> tuple:
    """The sharded encoder's inputs: an FP-8 bottleneck's randomized Flax
    variables (as a port state dict) and two 128 px images, as JAX's
    `test_spatial_sharding_of_encoder` takes; and the JAX side."""
    bneck = JaxFP(num_bottleneck_channels=MESH_CH)
    shapes = jax.eval_shape(lambda: bneck.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((2, MESH_PX, MESH_PX, 3)), mode='train'))
    variables = _randomize({'params': {'bottleneck_layer': shapes['params']}},
                           np.random.default_rng(25))
    state = {k.split('.', 1)[1]: v
             for k, v in state_dict_from_flax(variables).items()}
    x = np.random.default_rng(26).normal(
        0, 1, (2, MESH_PX, MESH_PX, 3)).astype(np.float32)
    return ({'channels': MESH_CH, 'state': state, 'x': _nchw(x)},
            {'module': bneck, 'params': variables['params'][
                'bottleneck_layer'], 'x': x})


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp('parallel')
    box, jax_side = _box_spec()
    mesh, jax_side['mesh'] = _mesh_spec()
    cfg = load_config(TINY, SMALL_CLS)
    torch.manual_seed(0)
    fresh = load_classification_model(cfg['models']['student_model'],
                                      device='cpu')
    save_ckpt(d / 'fresh' / 'student.ckpt', fresh.state_dict())
    rng = np.random.default_rng(22)
    targets = rng.integers(0, 5, (BATCH, 8, 8))
    targets[:2] = 255                  # rank 0 holds fewer valid pixels
    targets[4, :3] = 255
    seg = {'logits': torch.from_numpy(
        rng.normal(0, 1, (BATCH, 5, 8, 8)).astype(np.float32)),
        'targets': torch.from_numpy(targets)}
    spec = {'world': WORLD, 'box': box, 'det': _det_spec(), 'seg_loss': seg,
            'coco': {t: _eval_targets(t) for t in ('segm', 'keypoints')},
            'mesh': mesh, 'cli': _cli_spec(d)}
    torch.save(spec, d / 'spec.pt')
    return d, spec, jax_side


@pytest.fixture(scope='module', autouse=True)
def job(setup):
    """The two-process job, started once and waited for by `ranks`."""
    d, _, _ = setup
    env = {**os.environ, 'OMP_NUM_THREADS': '1',
           'PYTHONPATH': os.pathsep.join(
               [str(REPO), os.environ.get('PYTHONPATH', '')])}
    log = open(d / 'job.log', 'w')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', str(WORLD), str(WORKER), str(d / 'spec.pt'),
         str(d)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    log.close()


@pytest.fixture(scope='module')
def ranks(setup, job):
    d, _, _ = setup
    rc = job.wait(timeout=300)
    assert rc == 0, (d / 'job.log').read_text()[-4000:]
    return [torch.load(d / f'rank{r}.pt', weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope='module')
def one_process(setup):
    """The same box steps and CLI test runs in this one process."""
    d, spec, _ = setup
    tests = [c for c in spec['cli'] if c[0] in ('test', 'seg', 'det')]
    return {'box': box_steps(spec['box']),
            'det': det_step(spec['det']),
            'seg_loss': seg_loss(spec['seg_loss']),
            'coco': coco_sync(spec['coco']),
            'cli': cli_runs({'cli': tests}, 1)}


def _torch_noise(seed, shape_nhwc):
    """The noise the port's first draw from a generator seeded `seed`
    gives for the NHWC global batch `shape_nhwc`, in NHWC."""
    n, h, w, c = shape_nhwc
    g = torch.Generator().manual_seed(seed)
    return torch.empty((n, c, h, w)).uniform_(-0.5, 0.5, generator=g) \
        .permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope='module')
def jax_mesh_steps(setup):
    """JAX's box on a 2-device mesh, one jitted step a stage at the
    global batch, with the port's noise."""
    _, _, j = setup
    variables = jax.tree.map(jnp.asarray, j['s_vars'])
    teacher = jax.tree.map(jnp.asarray, j['t_vars'])
    out = []
    for stage_cfg, seed, x, y in zip(j['stages'], SEEDS, j['x'], j['y']):
        box = JaxDistillationBox(
            j['student'], variables, stage_cfg, teacher_module=j['teacher'],
            teacher_variables=teacher, steps_per_epoch=1,
            student_mode='train', mesh=get_mesh(WORLD))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_factorized, 'quantize_noise',
                       lambda v, rng, seed=seed: v + jnp.asarray(
                           _torch_noise(seed, v.shape)))
            metrics = box.train_step(jnp.asarray(x), jnp.asarray(y),
                                     jax.random.key(0))
        variables = box.student_variables
        out.append({'loss': {k: float(v) for k, v in
                             metrics['loss'].items()},
                    'aux_loss': float(metrics['aux_loss']),
                    'vars': _flat(jax.device_get(variables))})
    return out


# ---- in one process -------------------------------------------------------

def _range_dataset(n):
    class _DS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return np.full((2, 2, 3), i, np.float32), i
    return _DS()


@pytest.mark.parametrize('n,world,epoch',
                         [(10, 3, 0), (10, 3, 2), (8, 2, 1), (7, 4, 3)])
def test_loader_shards_equal_jax(n, world, epoch):
    """Each shard's batches equal the JAX loader's (its seed 0), index
    for index: one shuffle of the epoch on every shard, wrapped to equal
    lengths, the shard_index-strided slice."""
    ds = _range_dataset(n)
    seen = []
    for shard in range(world):
        kw = dict(batch_size=2, shuffle=True, num_shards=world,
                  shard_index=shard)
        port, ref = DataLoader(ds, **kw), JaxDataLoader(ds, prefetch=False,
                                                        seed=0, **kw)
        port.epoch = ref.epoch = epoch
        got = [y.tolist() for _, y in port]
        assert got == [y.tolist() for _, y in ref]
        assert len(port) == len(got)
        seen += sum(got, [])
    assert len(seen) == world * -(-n // world)
    assert set(seen) == set(range(n))


@pytest.mark.parametrize('wire', ['host', 'device'])
def test_serving_pool_matches_the_runtime(wire):
    """Five images over two CPU replicas: the logits in input order equal
    one runtime's, every image is accounted once with a positive size,
    and the pooled mean equals the runtime's (tolerance: equal logits
    to 1e-6, equal sizes)."""
    cfg = load_config(TINY, SMALL_CLS)['models']['student_model']
    torch.manual_seed(0)
    model = load_classification_model(cfg, device='cpu')
    rng = np.random.default_rng(4)
    images = [torch.from_numpy(rng.normal(0, 1, (1, 3, PX, PX)).astype(
        np.float32)) for _ in range(5)]
    single = SplitClassifierRuntime(model, device='cpu')
    single.update()
    single.activate_analysis()
    serve = 'stream_deploy_device' if wire == 'device' else 'stream_deploy'
    want = getattr(single, serve)(images)
    pool = ServingPool(lambda m, dev: SplitClassifierRuntime(m, device=dev),
                       model, devices=['cpu', 'cpu'], wire=wire)
    pool.activate_analysis()
    got = pool.stream(images, depth=2)
    assert len(got) == len(images)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)
    summary = pool.summarize()
    ref = single.summarize()[0]
    assert summary['num_samples'] == ref['num_samples'] == 5
    assert sorted(s for rt in pool.replicas for a in rt.analyzers
                  for s in a.file_size_list) \
        == sorted(single.analyzers[0].file_size_list)
    assert min(single.analyzers[0].file_size_list) > 0
    assert summary['mean'] == pytest.approx(ref['mean'], rel=1e-12)
    with pytest.raises(ValueError, match='wire_batch'):
        ServingPool(lambda m, dev: SplitClassifierRuntime(m, device=dev),
                    model, devices=['cpu'], wire='host').stream(
                        images, wire_batch=2)


def test_trace_and_stage_timer_in_one_process(tmp_path):
    """`trace` writes rank 0's Chrome trace of the block and the program
    recorder's spans and counters of the block (cleared on entry);
    `StageTimer` counts each stage's calls and their milliseconds, with or
    without a profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        count('test.before')
    timer = StageTimer()
    with trace(tmp_path / 'prof'):
        for _ in range(2):
            with timer.stage('conv'), span('test.conv'):
                torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                                           torch.ones(4, 3, 3, 3))
        count('test.images', 2)
    events = json.loads((tmp_path / 'prof' / 'trace_rank0.json')
                        .read_text())['traceEvents']
    assert {'aten::conv2d', 'conv', 'test.conv'} <= {e.get('name')
                                                     for e in events}
    summary = timer.summarize()['conv']
    assert summary['count'] == 2 and summary['total_ms'] > 0
    assert summary['mean_ms'] == pytest.approx(summary['total_ms'] / 2)
    spans = json.loads((tmp_path / 'prof' / 'spans_rank0.json').read_text())
    assert spans['test.conv']['count'] == 2
    assert 0 < spans['test.conv']['total_ms'] <= summary['total_ms']
    assert spans['test.images'] == {'count': 2}
    assert 'test.before' not in spans
    with timer.stage('conv'):
        pass
    assert timer.summarize()['conv']['count'] == 3
    timer.clear()
    assert timer.summarize() == {}


# ---- the two-process job --------------------------------------------------

def test_the_job_runs_two_ranks_over_gloo(ranks):
    assert [(r['rank'], r['world'], r['backend']) for r in ranks] == [
        (0, WORLD, 'gloo'), (1, WORLD, 'gloo')]


def test_box_steps_equal_jax_on_a_two_device_mesh(ranks, jax_mesh_steps):
    """Stage 1 (the 'train' forward's noise, hint MSE 'sum' and bpp,
    Adam, BatchNorm on running statistics) and stage 2 (KD, SGD with
    momentum, BatchNorm training on the group's statistics) at 4 images
    a rank equal JAX's step at the global batch of 8: parameters,
    BatchNorm statistics (rtol 1e-4, atol 1e-5) and the losses, the
    mean of the ranks' values (rtol 1e-4)."""
    for stage, want in enumerate(jax_mesh_steps):
        steps = [r['box'][stage] for r in ranks]
        for k, v in want['loss'].items():
            got = np.mean([s['loss'][k] for s in steps])
            np.testing.assert_allclose(got, v, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(steps[0]['aux_loss'], want['aux_loss'],
                                   rtol=1e-4)
        state = _to_flax(steps[0]['state'])
        assert state.keys() == want['vars'].keys()
        for k, v in want['vars'].items():
            np.testing.assert_allclose(state[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=f'stage {stage + 1} {k}')


def test_box_steps_equal_one_process_and_ranks_stay_equal(ranks,
                                                          one_process):
    """The two ranks' states after each step are bitwise equal, and equal
    the one-process step at the global batch (rtol 1e-4, atol 1e-5, the
    tolerance against JAX: the group's BatchNorm sums its statistics in
    float32 in another order); the losses' mean over the ranks is the
    one-process loss (rtol 1e-5)."""
    for stage, want in enumerate(one_process['box']):
        steps = [r['box'][stage] for r in ranks]
        for k, v in steps[0]['state'].items():
            assert torch.equal(v, steps[1]['state'][k]), k
            np.testing.assert_allclose(
                v.numpy(), want['state'][k].numpy(), rtol=1e-4, atol=1e-5,
                err_msg=f'stage {stage + 1} {k}')
        for k, v in want['loss'].items():
            np.testing.assert_allclose(
                np.mean([s['loss'][k] for s in steps]), v, rtol=1e-5,
                err_msg=k)


def test_detection_step_equals_one_process_and_ranks_stay_equal(
        setup, ranks, one_process):
    """One end-to-end `DetectionBox` step at 2 canvases a rank equals the
    one-process step at 4: each rank's RPN and RoI samplers draw for the
    global batch and keep its block, as the quantizer's noise does, and
    the gradients are averaged over the group. The losses' mean over the
    ranks within rtol 1e-5; the ranks' states bitwise equal; parameters
    and BatchNorm statistics within rtol 1e-4, atol 1e-5 of one process
    (the group's BatchNorm sums in another order), and each tensor's
    update within 1e-2 of its largest update (one SGD step moves the
    weights by little, so the states alone would hide a sampler that
    drew other rows: such a step's updates differ by half)."""
    want = one_process['det']
    steps = [r['det'] for r in ranks]
    init = setup[1]['det']['state']
    assert {'loss_objectness', 'loss_rpn_box_reg', 'loss_classifier',
            'loss_box_reg', 'bpp'} <= set(want['loss'])
    for k, v in want['loss'].items():
        np.testing.assert_allclose(np.mean([s['loss'][k] for s in steps]),
                                   v, rtol=1e-5, err_msg=k)
    for k, v in steps[0]['state'].items():
        assert torch.equal(v, steps[1]['state'][k]), k
        w = want['state'][k]
        np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        if v.is_floating_point():
            update = (w - init[k]).numpy()
            np.testing.assert_allclose(
                (v - init[k]).numpy(), update, rtol=0,
                atol=1e-2 * float(np.abs(update).max()), err_msg=k)


def test_seg_loss_takes_the_global_valid_pixel_count(ranks, one_process):
    """The pixel cross entropy divides by the valid pixels of the global
    batch (as JAX's over its mesh), not of each rank's half: the mean of
    the ranks' values is the one-process loss and each rank's gradient,
    over the group's size, is its block of the one-process gradient
    (rtol 1e-6)."""
    want = one_process['seg_loss']
    np.testing.assert_allclose(
        np.mean([r['seg_loss']['loss'] for r in ranks]), want['loss'],
        rtol=1e-6)
    n = BATCH // WORLD
    for r in ranks:
        np.testing.assert_allclose(
            r['seg_loss']['grad'].numpy() / WORLD,
            want['grad'][r['rank'] * n:(r['rank'] + 1) * n].numpy(),
            rtol=1e-6, atol=1e-9)


def test_segm_and_keypoint_sync_equals_one_process(ranks, one_process):
    """The segm and keypoint evaluators, each rank holding half of the
    images, gather the masks and keypoints of both with the boxes: every
    rank's 12 metrics of each type equal one process's over all
    images."""
    want = one_process['coco']
    assert set(want) == {'segm', 'keypoints'}
    for r in ranks:
        assert r['coco'] == want
    assert all(0.0 < w['AP'] < 1.0 for w in want.values())


def test_sharded_encoder_equals_jax_unsharded(setup, ranks):
    """The FP-8 encoder on two 128 px images with their rows sharded over
    'model' = 2 (each rank 64 rows; the halo rows traded over gloo)
    equals JAX's unsharded encoder on every rank (rtol = atol = 1e-5, the
    tolerance of JAX's sharded test); each rank's own rows, 16 and 15
    (the 2x2 convolution's last row has no rank below), are its block of
    that latent at their offset."""
    j = setup[2]['mesh']
    want = np.asarray(jax.jit(lambda v, x: j['module'].apply(
        v, x, method=lambda m, x: m.encoder(x)))(
            {'params': jax.tree.map(jnp.asarray, j['params'])}, j['x']))
    assert want.shape == (2, 31, 31, MESH_CH)
    for r in ranks:
        got = r['mesh']['latent'].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        shard, off = r['mesh']['shard'], r['mesh']['offset']
        assert (off, shard.shape[2]) == ((0, 16), (16, 15))[r['rank']]
        np.testing.assert_allclose(
            shard.permute(0, 2, 3, 1).numpy(),
            want[:, off:off + shard.shape[2]], rtol=1e-5, atol=1e-5)


def test_two_ranks_make_a_one_by_two_mesh_and_refuse_an_odd_h(ranks):
    """Two ranks on ('data', 'model') are JAX's (1, 2) mesh: one 'model'
    line of both ranks, each rank its own 'data' line, every rank holding
    64 of the 128 rows; shards of 62 rows (H = 124, not a multiple of 4 x
    2) raise instead of running unsharded."""
    for r in ranks:
        m = r['mesh']
        assert m['shape'] == {'data': 1, 'model': 2}
        assert (m['model_line'], m['data_line'], m['rows']) \
            == ([0, 1], [r['rank']], 64)
        assert 'a multiple of 8' in m['refused']


def test_cli_trains_one_epoch_and_tests_on_the_device_wire(ranks):
    """Each rank trains on its shard of the 8 training images (one batch
    of 4), validates on its 2 of 4, and tests all 4 test images on the
    device wire; the ranks end with equal weights and equal results."""
    runs = [r['cli']['train'] for r in ranks]
    for run in runs:
        assert run['summaries'][0]['num_samples'] == 4
        assert len(run['sizes']) == 4 and min(run['sizes']) > 0
        assert run['best'] is not None
        assert 'stage stage1 epoch 0' in ' '.join(run['messages'])
    assert runs[0]['result'] == runs[1]['result']
    assert runs[0]['sizes'] == runs[1]['sizes']
    for k, v in runs[0]['state'].items():
        assert torch.equal(v, runs[1]['state'][k]), k


def test_cli_resume_starts_after_the_saved_epoch(ranks):
    """`-resume` on two ranks reads the state rank 0 saved after stage
    1's first epoch and runs its second, then stage 2; `-adjust_lr`
    scales the learning rates by the group's size."""
    for r in ranks:
        text = '\n'.join(r['cli']['resume']['messages'])
        assert 'resumed stage stage1 at epoch 1' in text
        assert 'stage stage1 epoch 0' not in text
        assert 'stage stage1 epoch 1' in text
        assert 'stage stage2 epoch 0' in text
        assert '(world=2)' in text
    states = [r['cli']['resume']['state'] for r in ranks]
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def test_cli_profile_dir_writes_a_trace_on_each_rank(setup, ranks):
    d, _, _ = setup
    for r in range(WORLD):
        trace = json.loads((d / 'profile' / f'trace_rank{r}.json')
                           .read_text())
        names = {e.get('name') for e in trace['traceEvents']}
        assert 'aten::conv2d' in names


def test_cli_test_only_equals_one_process(ranks, one_process):
    """`-test_only` of one checkpoint on the device wire: every rank
    tests the whole test set, so num_samples, the multiset of per-image
    sizes, acc1/acc5 and the teacher anchor's numbers equal one
    process's."""
    want = one_process['cli']['test']
    for r in ranks:
        got = r['cli']['test']
        assert got['summaries'][0]['num_samples'] \
            == want['summaries'][0]['num_samples'] == 4
        assert Counter(got['sizes']) == Counter(want['sizes'])
        for k in ('acc1', 'acc5'):
            assert got['result'][k] == want['result'][k], k
            assert got['teacher'][k] == want['teacher'][k], k


@pytest.mark.parametrize('task,metric', [('seg', 'miou'), ('det', 'AP')])
def test_seg_and_det_test_only_equal_one_process(ranks, one_process, task,
                                                 metric):
    """The confusion matrix summed over the ranks and the COCO results
    gathered by image id give one process's mIoU and AP (equal), with
    the data sizes of every image."""
    want = one_process['cli'][task]
    for r in ranks:
        got = r['cli'][task]
        assert got['result'][metric] == want['result'][metric]
        assert Counter(got['sizes']) == Counter(want['sizes'])
        assert got['summaries'][0]['num_samples'] \
            == want['summaries'][0]['num_samples'] > 0
