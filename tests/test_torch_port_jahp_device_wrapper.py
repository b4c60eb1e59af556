"""The neural input-compression wrapper on the joint autoregressive codec's
device wire (`NeuralInputCompressionClassifier(wire='device')`), on the
CPU at a small size: codec n=8, m=12, ResNet-50 of 10 classes, images of
60x50 and 48x40 padded to 64 px (AdaptivePad(64)), weights drawn by the
benchmark's rule (`portbench/reference/jahp.py`).

Against its host wire: equal latents, symbols and rows, logits equal.
Against the plain reference (`portbench/reference/jahp.py`, which
imports nothing of the port): the decoded latent equals round(y - mean)
+ mean with the mean of the context model teacher-forced on that latent,
the scale rows equal, the wire bytes equal the reference's count of the
symbols and rows, and the reconstruction and logits are within 1e-5 of
the largest magnitude (float32 on one CPU, the same operations in
another order). Three faults planted in the codec make the benchmark's
check come out false; the escape path, the engine's `deploy_wire:
device`, the errors for a codec and a wrapper without a device wire, and
the spans and counters are checked too. This file imports neither JAX
nor `sc2bench_tpu`.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import jahp as J
from portbench.reference import rans as RR
from portbench.weights import load_into, make_state
from sc2bench_tpu_torch.models.resnet import resnet50
from sc2bench_tpu_torch.models.wrapper import (
    NeuralInputCompressionClassifier, get_wrapped_classification_model)
from sc2bench_tpu_torch.models.zoo_jahp import (ContextModel,
                                                JointAutoregressiveCodec,
                                                JointAutoregressiveRuntime,
                                                Schedule)
from sc2bench_tpu_torch.utils.profiling import recorder, trace

N, M, FACTOR, CLASSES = 8, 12, 64, 10
TOL = 1e-5
PAD = [{'key': 'AdaptivePad', 'kwargs': {'factor': FACTOR}}]
ANALYSIS = {'analyzes_after_compress': True, 'analyzer_configs': [
    {'key': 'FileSizeAnalyzer', 'kwargs': {'unit': 'B'}}]}
SMALL_CELL = {
    'config': {'model': {'n': N, 'm': M, 'input_size': [48, 40],
                         'num_classes': CLASSES}},
    'traffic': {'pool': {'count': 3, 'sizes': [[48, 40]],
                         'canvas': {'min_size': 40, 'max_size': 48}},
                'request_images': 2, 'check_share': 1.0}}


@pytest.fixture(scope='module')
def weights():
    dev = torch.device('cpu')
    sd = J.codec_state(make_state(J.codec_specs(N, M), 2 ** 31 + 3, dev), M)
    g = torch.Generator().manual_seed(3)
    J.spread_scales(sd, M, J.pad(torch.rand((1, 3, 48, 40), generator=g)))
    from portbench.reference import resnet_fp as R
    tsd = make_state(R.teacher_specs({'num_classes': CLASSES}), 11, dev)
    return sd, tsd


def _wrapper(weights, wire, codec_module=None):
    sd, tsd = weights
    module = codec_module or load_into(JointAutoregressiveCodec(n=N, m=M),
                                       sd)
    rt = JointAutoregressiveRuntime(module, device='cpu')
    rt.update()
    classifier = load_into(resnet50(num_classes=CLASSES), tsd)
    return NeuralInputCompressionClassifier(
        classifier, compression_model=rt, pre_transform=PAD,
        analysis_config=ANALYSIS, device='cpu', wire=wire)


def _images():
    rng = np.random.default_rng(5)
    hwc = [rng.random((60, 50, 3)).astype(np.float32),
           rng.random((48, 40, 3)).astype(np.float32)]
    nchw = torch.from_numpy(rng.random((1, 3, 48, 40)).astype(np.float32))
    return hwc + [nchw]


def _reference_of(weights, x):
    """(latent check, rows, bytes) of the reference for an NCHW padded
    image through the runtime's device wire."""
    sd, _ = weights
    y = J.analysis(sd, x)
    zs = J.z_symbols(sd, y)
    return y, zs, J.hyper_from_symbols(sd, zs)


def test_the_device_wire_equals_the_host_wire_and_the_reference(weights):
    dev_w, host_w = _wrapper(weights, 'device'), _wrapper(weights, 'host')
    for w in (dev_w, host_w):
        w.activate_analysis()
    images = _images()
    got = dev_w(images)
    want = host_w(images[:2] + [images[2][0].permute(1, 2, 0).numpy()])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert dev_w.escapes == {'ok': 0} and dev_w.invalid == 0
    sd, tsd = weights
    g_tables = J.gaussian_tables()
    z_tables = RR.factorized_tables(RR.params_of(sd, J.EB))
    rt = dev_w.compression_model
    sizes = dev_w.analyzers[0].file_size_list
    import pickle
    import sys as _sys
    for i, img in enumerate(images):
        x = dev_w._device_input(img)
        assert x.shape[-2:] == (64, 64)
        ops = rt.encode_device_wire(x)
        latent, valid = rt.decode_device_latent(ops)
        host_latent = rt.decompress_latent(**rt.compress(x))
        assert bool(valid) and torch.equal(latent, host_latent)
        y, zs, hyper = _reference_of(weights, x)
        scales, means = J.gaussian_params(sd, hyper, latent)
        assert torch.equal(torch.round(y - means) + means, latent)
        syms, idxs, _ = rt.forward_scan(*rt._encode_ops(x)[::2])
        layout = J.lane_layout(*y.shape[2:])
        act = layout[2]
        assert torch.equal(idxs[act], J.on_lanes(
            J.scale_indexes(scales)[0], layout)[act])
        assert torch.equal(syms[act], J.on_lanes(
            torch.round(latent - means)[0].to(torch.int32), layout)[act])
        nbytes = J.y_lane_nbytes(syms, idxs, act, g_tables) \
            + J.z_nbytes(zs, z_tables)
        assert int(ops['nbytes']) == nbytes
        obj = {'strings': [[bytes(nbytes)]]}
        assert sizes[i] == _sys.getsizeof(pickle.dumps(obj))
        img_ref = J.synthesis(sd, latent)
        with torch.no_grad():
            img_got = rt.module.decode_image(latent)
        assert float((img_got - img_ref).abs().max()) \
            <= TOL * float(img_ref.abs().max())
    with torch.no_grad():
        recon = torch.cat([J.synthesis(sd, rt.decode_device_latent(
            rt.encode_device_wire(dev_w._device_input(img)))[0])
            for img in images])
        ref_logits = J.logits(tsd, recon)
    assert float((got - ref_logits).abs().max()) \
        <= TOL * float(ref_logits.abs().max())


def test_symbols_out_of_support_escape_to_the_host_wire(weights):
    """A latent twenty times as wide and scales shrunk to the table's
    least (0.11, whose rows code -1 ... 1) put symbols out of support:
    each image is re-coded on the host wire, whose coder has an escape
    path, and the logits are the host wire's."""
    sd, tsd = weights
    small = dict(sd)
    small['g_a.6.weight'] = sd['g_a.6.weight'] * 20.0
    small['entropy_parameters.4.weight'] = \
        sd['entropy_parameters.4.weight'] * 1e-3
    module = load_into(JointAutoregressiveCodec(n=N, m=M), small)
    dev_w = _wrapper(weights, 'device', module)
    host_w = _wrapper(weights, 'host', module)
    images = _images()[:2]
    got = dev_w(images)
    assert dev_w.escapes == {'ok': 2} and dev_w.invalid == 0
    torch.testing.assert_close(got, host_w(images), rtol=0, atol=0)


def test_spans_and_counters_one_range_a_loop(weights, tmp_path):
    dev_w = _wrapper(weights, 'device')
    images = _images()
    dev_w(images)
    with trace(str(tmp_path)):
        dev_w(images)
        s = recorder.summarize()
    k = len(images)
    for name in ('codec.encode', 'codec.scan', 'codec.masked_encode',
                 'codec.decode_z', 'codec.fronts', 'codec.synthesis'):
        assert s[name]['count'] == k, name
    assert s['codec.classify']['count'] == 1
    assert s['codec.images']['count'] == k
    assert s['codec.front_steps']['count'] == 2 * k * 13   # 4x4: 13 fronts
    assert 'codec.escapes' not in s


def test_a_codec_or_a_wrapper_without_a_device_wire_raises(weights):
    from sc2bench_tpu_torch.models.registry import get_compression_model
    fp = get_compression_model({'key': 'factorized_prior',
                                'kwargs': {'n': 8, 'm': 12}}, device='cpu')
    with pytest.raises(ValueError, match='device wire'):
        NeuralInputCompressionClassifier(resnet50(num_classes=CLASSES),
                                         compression_model=fp,
                                         device='cpu', wire='device')
    with pytest.raises(ValueError, match='pre_transform'):
        _wrapper(weights, 'device').__class__(
            resnet50(num_classes=CLASSES),
            compression_model=_wrapper(weights, 'host').compression_model,
            pre_transform=[{'key': 'CustomToTensor'}], device='cpu',
            wire='device')
    from sc2bench_tpu_torch.train.engine import ClassificationEngine
    cfg = {'models': {'wrapper': {
        'key': 'CodecInputCompressionClassifier',
        'classification_model': {'key': 'resnet50',
                                 'kwargs': {'num_classes': CLASSES}}}},
        'deploy_wire': 'device'}
    with pytest.raises(ValueError, match='NeuralInputCompressionClassifier'):
        ClassificationEngine(cfg, device='cpu')


def test_the_cli_tests_the_config_on_the_device_wire():
    """The normal path: the test CLI on the JAHP config with `deploy_wire:
    device` (narrowed), every image on the device wire."""
    from sc2bench_tpu_torch.train.engine import ClassificationEngine
    from sc2bench_tpu_torch.config import load_config
    cfg = load_config('configs/ilsvrc2012/input_compression/'
                      'joint_autoregressive_hierarchical_prior-resnet50.yaml')
    cfg['deploy_wire'] = 'device'
    wrapper = cfg['models']['wrapper']
    wrapper['classification_model']['kwargs']['num_classes'] = CLASSES
    wrapper['compression_model']['kwargs'].update(n=N, m=M)
    wrapper['compression_model'].pop('ckpt')
    cfg['test'] = {'test_data_loader': {'dataset': {
        'key': 'SyntheticClassificationDataset',
        'kwargs': {'num_samples': 2, 'image_size': [48, 40],
                   'num_classes': CLASSES, 'normalized': False}},
        'batch_size': 1}}
    engine = ClassificationEngine(cfg, device='cpu')
    assert engine.wrapper.wire == 'device'
    result, summary = engine.test()
    assert summary[0]['num_samples'] == 2
    assert 0.0 <= result['acc1'] <= 1.0


def _faulty(kind):
    """Patch the program's codec; returns the undo."""
    undo = []

    def patch(owner, attr, fn):
        old = getattr(owner, attr)
        setattr(owner, attr, fn(old))
        undo.append(lambda: setattr(owner, attr, old))

    if kind == 'means_shifted':
        def make(old):
            calls = [0]

            def shifted(self, y_hat, hyper, ii, jj):
                scales, means = old(self, y_hat, hyper, ii, jj)
                calls[0] += 1
                # the decoder's fourth front (the 4x4 latent has 13 a loop)
                if calls[0] % 26 == 17:
                    means = means + 0.75
                return scales, means
            return shifted
        patch(ContextModel, 'front_params', make)
    elif kind == 'write_skipped':
        def make(old):
            def skipping(self, y_hat_pad, t, values):
                if t != 3:
                    old(self, y_hat_pad, t, values)
            return skipping
        patch(Schedule, 'write', make)
    elif kind == 'taps_reordered':
        def make(old):
            def reordered(self, module):
                old(self, module)
                self.dr, self.dc = self.dr.flip(0), self.dc.flip(0)
            return reordered
        patch(ContextModel, '__init__', make)
    return lambda: [u() for u in reversed(undo)]


def _run_cell():
    return harness.run_cell('jahp-q8-r50-serve-r8', 2 ** 31 + 5, 0.3, 0,
                            'cpu', time.perf_counter(),
                            overrides=SMALL_CELL)


def test_the_benchmark_check_passes_a_sound_run():
    result = _run_cell()
    assert result['correct'], result['checks']
    assert result['checks']['nbytes_gap']['value'] == 0


@pytest.mark.parametrize('kind', ['means_shifted', 'write_skipped',
                                  'taps_reordered'])
def test_the_benchmark_check_fails_a_broken_codec(kind):
    undo = _faulty(kind)
    try:
        result = _run_cell()
    finally:
        undo()
    assert not result['correct'], result['checks']
    assert result['checks']['symbol_mismatch_share']['value'] > 1e-3


def test_the_engine_builds_the_device_wire_from_the_config(weights):
    cfg = {'key': 'NeuralInputCompressionClassifier',
           'classification_model': {'key': 'resnet50',
                                    'kwargs': {'num_classes': CLASSES}},
           'compression_model': {
               'key': 'joint_autoregressive_hierarchical_prior',
               'kwargs': {'quality': 8, 'n': N, 'm': M}},
           'kwargs': {'pre_transform': PAD}}
    w = get_wrapped_classification_model(cfg, device='cpu', wire='device')
    assert w.wire == 'device' and w._pads[0].factor == FACTOR
    with pytest.raises(ValueError, match="'host' or 'device'"):
        get_wrapped_classification_model(cfg, device='cpu', wire='card')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('the wavefront loops replay as CUDA graphs on a card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_the_loop_graphs_replay_the_eager_loops_bit_for_bit(weights, card):
    """On the card the first call of a latent shape runs the two loops
    eagerly, the second captures them and the later ones replay: every
    call gives the same wire, latent and launches."""
    from sc2bench_tpu_torch.ops.rans import kernels
    sd, _ = weights
    module = load_into(JointAutoregressiveCodec(n=N, m=M).to(card),
                       {k: v.to(card) for k, v in sd.items()})
    rt = JointAutoregressiveRuntime(module, device=card)
    rt.update()
    x = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(
        9)).to(card)
    calls = []
    for _ in range(4):
        kernels.reset_launches()
        ops = rt.encode_device_wire(x)
        latent, valid = rt.decode_device_latent(ops)
        torch.cuda.synchronize()
        calls.append((ops, latent, bool(valid), dict(kernels.LAUNCHES)))
    first = calls[0]
    assert first[2] and torch.equal(first[1], first[0]['y_hat'])
    for ops, latent, valid, launches in calls[1:]:
        assert valid and launches == first[3]
        assert torch.equal(latent, first[1])
        for k in ('y_streams', 'y_states', 'y_lengths', 'nbytes'):
            assert torch.equal(ops[k], first[0][k]), k
    assert rt._scan_graphs.captures == rt._front_graphs.captures == 1
    assert rt._scan_graphs.replays == rt._front_graphs.replays == 3
