"""The port's spans and counters (`utils/profiling.py`) on the CPU, at small
sizes, and the benchmark's per-layer readers of them.

With no profiler active a span makes no profiler range and records no CUDA
event, and the recorder stays empty; the runtimes' `timings` still fill.
Under `trace` a deploy call, the tiled NMS and a training step record
their spans and counters, and give what they give untraced."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
import math
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from sc2bench_tpu_torch.models.backbone import splittable_resnet
from sc2bench_tpu_torch.models.resnet import ResNet
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.ops import boxes as B
from sc2bench_tpu_torch.train.box import DistillationBox
from sc2bench_tpu_torch.utils import profiling
from sc2bench_tpu_torch.utils.profiling import recorder, trace

FP = {'key': 'FPBasedResNetBottleneck',
      'kwargs': {'num_bottleneck_channels': 8, 'num_target_channels': 256}}
STAGE = {'optimizer': {'key': 'Adam', 'kwargs': {'lr': 1e-3}},
         'train_bn': False,
         'criterion': {'key': 'WeightedSumLoss', 'kwargs': {'sub_terms': {
             'hint1': {'criterion': {'key': 'MSELoss', 'kwargs': {
                 'student_module_path': 'bottleneck_layer_out',
                 'teacher_module_path': 'layer1_out', 'reduction': 'sum'}},
                 'weight': 1.0},
             'bpp': {'criterion': {'key': 'BppLoss', 'kwargs': {
                 'entropy_module_path': 'bottleneck_layer.eb_out',
                 'reduction': 'batchmean'}}, 'weight': 0.08}}}}}
TRAIN_SPANS = ('train.teacher_forward', 'train.student_forward',
               'train.loss', 'train.backward', 'train.optimizer_step')


@pytest.fixture(scope='module')
def runtime():
    torch.manual_seed(0)
    model = splittable_resnet(FP, stage_sizes=(1, 1, 1, 1), num_classes=10,
                              device='cpu')
    rt = SplitClassifierRuntime(model, device='cpu')
    rt.update()
    return rt.eval()


@pytest.fixture(scope='module')
def images():
    g = torch.Generator().manual_seed(1)
    return [torch.randn(1, 3, 32, 32, generator=g) for _ in range(3)]


def _student_and_teacher():
    torch.manual_seed(2)
    student = splittable_resnet(FP, stage_sizes=(1, 1, 1, 1),
                                num_classes=10, device='cpu')
    return student, ResNet((1, 1, 1, 1), num_classes=10)


def _batch():
    g = torch.Generator().manual_seed(3)
    return torch.randn(2, 3, 32, 32, generator=g), torch.tensor([1, 3])


def _box(student, teacher, seed=4):
    return DistillationBox(student, STAGE, teacher=teacher,
                           generator=torch.Generator().manual_seed(seed))


def _boom(*args, **kwargs):
    raise AssertionError('a profiler range or a CUDA event')


@pytest.fixture
def ranges_raise(monkeypatch):
    """The ways a span could open a profiler range (`record_function`
    of `torch.profiler`) or record a CUDA event raise; CUDA looks
    initialized, so a device-timed span would try. (torch's optimizers
    open their own `torch.autograd.profiler` ranges.)"""
    monkeypatch.setattr(torch.profiler, 'record_function', _boom)
    monkeypatch.setattr(torch.cuda, 'Event', _boom)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    recorder.clear()


def test_spans_off_make_no_range_and_record_nothing(runtime, images,
                                                     ranges_raise):
    """Both wires, a training step and a counter with no profiler active:
    no range, no event, an empty recorder, the `timings` filled."""
    timings = {}
    runtime.stream_deploy_device(images, wire_batch=2, timings=timings)
    runtime.stream_deploy_device(images, timings=timings)
    runtime.stream_deploy(images, timings=timings)
    _box(*_student_and_teacher()).train_step(*_batch())
    profiling.count('test.off')
    assert recorder.summarize() == {}
    assert set(timings) == {'decode_dispatch', 'account_d2h', 'd2h_sync',
                            'host_code'}
    assert all(v > 0 for v in timings.values())


def test_the_patches_catch_a_span_while_tracing(ranges_raise):
    """The fixture's patches bite once a profiler runs: a plain span and a
    device-timed one under the profiler reach them."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for kw in ({}, {'device': True}):
            with pytest.raises(AssertionError, match='profiler range'):
                with profiling.span('test.on', **kw):
                    pass


def _sizes(rt):
    return list(rt.analyzers[0].file_size_list)


def test_a_traced_deploy_call(runtime, images, tmp_path):
    """Two `stream_deploy_device(wire_batch=2)` calls under `trace`: one
    `deploy.request` a call in the Chrome trace, one `deploy.encode` a
    coding launch (a group of two images, then one), the drain's read a
    wait span nested in each request, the images counted, and the logits
    and wire sizes of untraced calls."""
    runtime.clear_analysis()
    want = [runtime.stream_deploy_device(images, wire_batch=2)
            for _ in range(2)]
    want_sizes = _sizes(runtime)
    runtime.clear_analysis()
    timings = {}
    with trace(tmp_path):
        got = [runtime.stream_deploy_device(images, wire_batch=2,
                                            timings=timings)
               for _ in range(2)]
    assert _sizes(runtime) == want_sizes
    for g, w in zip(got, want):
        assert len(g) == len(w) == len(images)
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(timings) == {'decode_dispatch', 'account_d2h'}
    s = json.loads((tmp_path / 'spans_rank0.json').read_text())
    n = len(images)
    assert s['deploy.request']['count'] == 2
    assert s['deploy.images']['count'] == 2 * n
    assert s['deploy.encode']['count'] == s['deploy.rans_encode'][
        'count'] == s['deploy.rans_decode']['count'] == s[
        'deploy.decode_tail']['count'] == 4
    assert s['deploy.drain']['count'] == s['deploy.drain.read']['count'] == 2
    read = s['deploy.drain.read']
    assert read['wait'] and read['wait_ms'] == read['total_ms'] > 0
    assert not s['deploy.request']['wait']
    # the CPU has no throttle or final sync: the drain's read is the wait
    assert s['deploy.request']['wait_ms'] == pytest.approx(read['total_ms'])
    assert s['deploy.drain']['wait_ms'] == pytest.approx(read['total_ms'])
    req = s['deploy.request']
    assert 0 < req['self_ms'] < req['total_ms']
    assert timings['account_d2h'] * 1e3 == pytest.approx(
        s['deploy.drain']['total_ms'], rel=0.05, abs=0.05)
    events = json.loads((tmp_path / 'trace_rank0.json').read_text())[
        'traceEvents']
    requests = sorted((e for e in events if e.get('name') ==
                       'deploy.request'), key=lambda e: e['ts'])
    reads = sorted((e for e in events if e.get('name') ==
                    'deploy.drain.read'), key=lambda e: e['ts'])
    assert len(requests) == len(reads) == 2
    for r, e in zip(requests, reads):
        assert r['ts'] <= e['ts'] and e['ts'] + e['dur'] <= r['ts'] + r['dur']


def test_the_host_wire_records_its_spans(runtime, images, tmp_path):
    """`stream_deploy` under `trace`: its request, the host coder's spans,
    the symbols' wait, and its four `timings` keys."""
    timings = {}
    with trace(tmp_path):
        runtime.stream_deploy(images, timings=timings)
    s = json.loads((tmp_path / 'spans_rank0.json').read_text())
    n = len(images)
    assert s['deploy.request']['count'] == 1
    assert s['deploy.images']['count'] == s['deploy.encode']['count'] == n
    assert s['deploy.host_encode']['count'] == n
    assert s['deploy.host_decode']['count'] == n
    assert s['deploy.d2h_sync']['wait']
    assert set(timings) == {'decode_dispatch', 'd2h_sync', 'host_code'}
    assert timings['host_code'] * 1e3 == pytest.approx(
        s['deploy.host_encode']['total_ms']
        + s['deploy.host_decode']['total_ms'], rel=0.05, abs=0.05)


@pytest.fixture
def counted_tolist(monkeypatch):
    calls = []
    tolist = torch.Tensor.tolist

    def counted(self):
        calls.append(1)
        return tolist(self)
    monkeypatch.setattr(torch.Tensor, 'tolist', counted)
    return calls


def _nms_inputs(n=1200):
    g = torch.Generator().manual_seed(5)
    xy = torch.rand(n, 2, generator=g) * 200
    wh = torch.rand(n, 2, generator=g) * 40 + 4
    boxes = torch.cat([xy, xy + wh], dim=1)
    return (boxes, torch.rand(n, generator=g),
            torch.randint(0, 3, (n,), generator=g))


@pytest.mark.parametrize('max_out', [100, 1000])
def test_nms_counts_its_host_reads(counted_tolist, max_out, tmp_path):
    """`nms.host_reads` equals the `.tolist()` calls of the tiled NMS, each
    a wait span; `nms.tiles` the tiles swept; the result is unchanged."""
    boxes, scores, idxs = _nms_inputs()
    want = B.batched_nms_mask(boxes, scores, idxs, 0.5, max_out)
    untraced = len(counted_tolist)
    counted_tolist.clear()
    with trace(tmp_path):
        got = B.batched_nms_mask(boxes, scores, idxs, 0.5, max_out)
    reads = len(counted_tolist)
    assert reads == untraced > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    s = json.loads((tmp_path / 'spans_rank0.json').read_text())
    assert s['nms.host_reads']['count'] == reads
    assert s['detect.nms.read']['count'] == reads
    assert s['detect.nms.read']['wait']
    assert s['detect.nms']['count'] == 1
    assert 1 <= s['nms.tiles']['count'] <= math.ceil(len(boxes) / 512)
    assert s['detect.nms']['wait_ms'] == pytest.approx(
        s['detect.nms.read']['total_ms'])


def test_a_traced_train_step(tmp_path):
    """`DistillationBox.train_step` under `trace` records the five
    `train.*` spans and `train.steps`, and gives the loss of an untraced
    step from the same weights and generator state."""
    student, teacher = _student_and_teacher()
    start = {k: v.clone() for k, v in student.state_dict().items()}
    x, y = _batch()
    want = _box(student, teacher).train_step(x, y)
    student.load_state_dict(start)
    with trace(tmp_path):
        got = _box(student, teacher).train_step(x, y)
    for k, v in want['loss'].items():
        assert torch.equal(got['loss'][k], v), k
    assert torch.equal(got['aux_loss'], want['aux_loss'])
    s = json.loads((tmp_path / 'spans_rank0.json').read_text())
    for name in TRAIN_SPANS:
        assert s[name]['count'] == 1 and s[name]['total_ms'] > 0, name
    assert s['train.steps']['count'] == 1
    # no card: the device-timed backward has no device time to report
    assert 'device_ms' not in s['train.backward']


def test_nested_spans_split_self_and_wait_time(tmp_path):
    """A span's self time is its total less its children's; its wait time
    is the wait spans' time inside it, at any depth."""
    with trace(tmp_path):
        with profiling.span('test.outer'):
            with profiling.span('test.inner'):
                time.sleep(0.002)
                with profiling.span('test.wait', wait=True):
                    time.sleep(0.002)
            time.sleep(0.001)
    s = json.loads((Path(tmp_path) / 'spans_rank0.json').read_text())
    outer, inner, wait = s['test.outer'], s['test.inner'], s['test.wait']
    assert outer['self_ms'] == pytest.approx(
        outer['total_ms'] - inner['total_ms'])
    assert inner['self_ms'] == pytest.approx(
        inner['total_ms'] - wait['total_ms'])
    assert outer['wait_ms'] == inner['wait_ms'] == wait['total_ms'] >= 2


# ---- the benchmark's readers ------------------------------------------------

SUMMARY = {'deploy.encode': {'count': 128, 'total_ms': 64.0},
           'deploy.encode_graph.replays': {'count': 96},
           'deploy.images': {'count': 128},
           'deploy.request': {'count': 2, 'total_ms': 130.0,
                              'wait_ms': 20.0},
           'nms.host_reads': {'count': 32},
           'train.backward': {'count': 2, 'total_ms': 1.0,
                              'device_ms': 600.0},
           'train.steps': {'count': 2}}
READERS = {'encode_dispatch_ms_per_image.wb32': 64.0 / 128,
           'host_busy_ms_per_image.wb32': 110.0 / 128,
           'host_busy_ms_per_image.serve': 110.0 / 128,
           'nms_host_reads_per_image.det': 32 / 128,
           'backward_ms_per_step.train': 300.0,
           'encode_graph_share.wb32': 100.0 * 96 / 128}


class _Recorder:
    def __init__(self, summary):
        self.summary = summary

    def summarize(self):
        return self.summary


@pytest.mark.parametrize('name', sorted(READERS))
def test_a_reader_finds_nothing_without_a_trace(name, monkeypatch):
    monkeypatch.setattr(profiling, 'recorder', _Recorder(SUMMARY))
    read = harness.metric_reader(name)
    assert read({'trace': None, 'counters': {}, 'system': None}) is None
    # a traced run whose program recorded nothing (tracing off, or a
    # program without the recorder)
    monkeypatch.setattr(profiling, 'recorder', _Recorder({}))
    assert read({'trace': {'busy_s': 1.0}, 'counters': {}}) is None
    monkeypatch.delattr(profiling, 'recorder')
    assert read({'trace': {'busy_s': 1.0}, 'counters': {}}) is None


@pytest.mark.parametrize('name', sorted(READERS))
def test_a_reader_divides_the_recorder_totals(name, monkeypatch):
    monkeypatch.setattr(profiling, 'recorder', _Recorder(SUMMARY))
    read = harness.metric_reader(name)
    got = read({'trace': {'busy_s': 1.0}, 'counters': {}, 'system': None})
    assert got == pytest.approx(READERS[name])


def test_the_readers_are_in_the_benchmark():
    listed = {m['name']: m for m in harness.benchmark()['per_layer']}
    for name in READERS:
        assert listed[name]['source'] == 'program_counter'
        assert len(listed[name]['workloads']) == 1
