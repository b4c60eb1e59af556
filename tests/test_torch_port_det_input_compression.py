"""The port's input compression before Faster R-CNN (the COCO
`input_compression` family: `RCNNTransformWithCompression`,
`InputCompressionDetectionModel`, the detection engine's test of a
wrapper config) against the JAX package on the CPU.

Small size: the `faster_rcnn_small` detector of
`test_torch_port_detection.py` (stages (1, 1, 1, 1), a plain ResNet body
as the configs' `faster_rcnn_model`, 5 classes) on one set of randomized
Flax variables, the codecs of `test_torch_port_codecs.py` (FP n=8, m=12;
JAHP n=m=8), images resized to a shorter side of 64 (longer at most 96)
on the 96 px square canvas. Equal means equal: the codec's reconstruction
(JPEG), every `compress` string and the KB summaries. Detections: the
same labels and validity in every slot, boxes within 1e-3 of the largest
coordinate (the neural reconstructions agree within 1e-4 of the image's
largest magnitude, as in `test_torch_port_codecs.py`).

The JAX wrapper's default analyzer (`FileSizeAccumulator`) divides what
it is given by 1024, which a neural codec's compressed object is not: the
port's default for a neural codec is `FileSizeAnalyzer` (KB of the pickled
object), and the JAX side is given that analyzer explicitly here.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.models.detection import wrapper as jax_det_wrapper
from sc2bench_tpu.models.detection.transform import \
    RCNNTransformWithCompression as JaxTransform
from sc2bench_tpu.train.det_engine import DetectionEngine as JaxEngine
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
from sc2bench_tpu_torch.config import load_config
from sc2bench_tpu_torch.models.detection import wrapper as det_wrapper
from sc2bench_tpu_torch.models.detection.registry import \
    load_detection_model
from sc2bench_tpu_torch.models.detection.transform import \
    RCNNTransformWithCompression
from sc2bench_tpu_torch.models import zoo
from sc2bench_tpu_torch.tasks.object_detection import main
from sc2bench_tpu_torch.transforms import codec as port_codec
from sc2bench_tpu.models import zoo as jax_zoo
from sc2bench_tpu.models.zoo_jahp import \
    JointAutoregressiveRuntime as JaxJahpRuntime
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax
import sc2bench_tpu.ops.entropy.tables as jax_tables_module
import sc2bench_tpu_torch.models.zoo_jahp as port_zoo_jahp
from sc2bench_tpu_torch.ops.entropy.tables import build_gaussian_tables
from sc2bench_tpu.registry import get as jax_registry_get
from test_torch_port_codecs import HW, JAHP, WIDTHS, _cached
from test_torch_port_model import _randomize
from test_torch_port_detection import (CLASSES, SMALL, det_variables,
                                       jax_small, port_of, register_small)

REPO = Path(__file__).resolve().parents[1]
COCO_IC = REPO / 'configs/coco2017/input_compression'
CONFIGS = sorted(COCO_IC.glob('*.yaml'))
RUNNABLE = [p for p in CONFIGS if not p.name.startswith('bpg-')]
SIZE = {'min_size': 64, 'max_size': 96}
ANALYZER = {'analyzer_configs': [{'key': 'FileSizeAnalyzer',
                                  'kwargs': {'unit': 'KB'}}]}
CODEC = {'key': 'PILImageModule', 'kwargs': {'format': 'JPEG',
                                             'quality': 75}}
# the JAX detector's jitted forward, compiled once for the module's
# wrappers (it takes the variables as an argument)
_JAX_FORWARD = {}


@pytest.fixture(scope='module', autouse=True)
def gaussian_tables_built_once():
    """The default Gaussian tables built once for the module, by the
    port's builder, and handed to the JAX package as its own type (the
    two builders are bit-equal: `test_torch_port_hyper.py`)."""
    port_tables = _cached({}, build_gaussian_tables)

    def jax_tables(scale_table=None, *args, **kwargs):
        return jax_tables_module.CodingTables(**dataclasses.asdict(
            port_tables(scale_table)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tables_module, 'build_gaussian_tables', jax_tables)
        mp.setattr(port_zoo_jahp, 'build_gaussian_tables', port_tables)
        yield


@pytest.fixture(scope='module')
def detector():
    """(JAX module, variables, port module) of the small plain-body
    detector."""
    module = jax_small({})
    variables = det_variables(module, 5)
    return module, variables, port_of(variables, {})


def _codec_variables(key, seed):
    """`test_torch_port_codecs._codec_variables` from the shapes alone
    (no compiled init): randomized Flax variables of a small codec, the
    JAHP's scale biases at 4 so that its symbols stay in support."""
    n, m = WIDTHS[key]
    module = jax_registry_get('model', key)(n=n, m=m)
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jnp.zeros((1, HW, HW, 3)), mode='train'))
    variables = _randomize({'params': shapes['params']},
                           np.random.default_rng(seed))
    variables['batch_stats'] = {}
    if key == JAHP:
        variables['params']['ep2']['bias'][:m] = 4.0
    return module, variables


@pytest.fixture(scope='module')
def codecs():
    """{key: (JAX runtime, port runtime)} of the FP and JAHP codecs on
    shared randomized weights, tables built."""
    out = {}
    for key, seed in (('factorized_prior', 40), (JAHP, 43)):
        module, variables = _codec_variables(key, seed)
        jrt = JaxJahpRuntime(module, variables) if key == JAHP \
            else jax_zoo.ImageCodecRuntime(module, variables)
        jrt.update()
        n, m = WIDTHS[key]
        port = zoo.registry_get('model', key)(n=n, m=m, device='cpu')
        port.load_state_dict(state_dict_from_flax(variables))
        rt = zoo.codec_runtime(port, device='cpu')
        rt.update()
        out[key] = (jrt, rt)
    return out


def _images(n, seed=0, hw=(50, 70)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for _ in range(n)]


class _Recording:
    """A codec runtime whose `compress` outputs are kept."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.compressed = []

    def compress(self, x):
        out = self.runtime.compress(x)
        self.compressed.append(out)
        return out

    def decompress(self, **kwargs):
        return self.runtime.decompress(**kwargs)


@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: p.stem.split('-')[0])
def test_config_builds_at_full_width(path):
    """Each COCO input-compression config's wrapper at full width on the
    meta device: the wrapper class, the detector's parameter count
    (torchvision's fasterrcnn_resnet50_fpn at 91 classes, 41,755,286, and
    the 53,120 BatchNorm affine parameters that its FrozenBatchNorm keeps
    as buffers), its codec transform or the neural codec at the config's
    quality."""
    cfg = load_config(path)['models']['wrapper']
    with torch.device('meta'):
        model = load_detection_model(cfg['detection_model'], device='meta')
        kwargs = {}
        cm = cfg.get('compression_model')
        if cm is not None:
            module = zoo.registry_get('model', cm['key'])(
                device='meta', **cm['kwargs'])
            kwargs['compression_model'] = zoo.codec_runtime(module,
                                                            device='meta')
        wrapper = det_wrapper.InputCompressionDetectionModel(
            model, **cfg['kwargs'], device='meta', **kwargs)
    assert type(wrapper).__name__ == cfg['key']
    assert sum(p.numel() for p in model.parameters()) == 41_755_286 + 53_120
    t = wrapper.transform
    assert isinstance(t, RCNNTransformWithCompression)
    assert (t.min_size, t.max_size, t.canvas_hw()) == (800, 1333,
                                                        (1344, 1344))
    if cm is None:
        want = {'jpeg': port_codec.PILImageModule,
                'webp': port_codec.PILImageModule,
                'bpg': port_codec.BPGModule}[path.stem.split('-')[0]]
        assert isinstance(t.compressor, want) and t.compressor \
            .returns_file_size
        assert type(wrapper.analyzers[0]).__name__ == 'FileSizeAccumulator'
    else:
        assert t.compression_model is kwargs['compression_model']
        assert type(wrapper.analyzers[0]).__name__ == 'FileSizeAnalyzer'
        want = (192, 192) if cm['key'] == JAHP else (128, 192)
        assert (module.n, module.m) == want


def test_bpg_config_raises_without_its_binary(detector):
    """The BPG config builds; its first image raises the classification
    BPG wrappers' FileNotFoundError."""
    cfg = load_config(COCO_IC / 'bpg-faster_rcnn_resnet50_fpn.yaml')
    wrapper = det_wrapper.InputCompressionDetectionModel(
        detector[2], **cfg['models']['wrapper']['kwargs'],
        transform_kwargs=SIZE, device='cpu')
    with pytest.raises(FileNotFoundError, match='bpgenc'):
        wrapper(_images(1))


def test_transform_without_a_codec_equals_jax():
    """No codec: the resized, normalized image on the square canvas."""
    imgs = _images(2, seed=3)
    want = JaxTransform(**SIZE)(imgs)
    got = RCNNTransformWithCompression(**SIZE)(imgs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize('kind', ['jpeg', 'factorized_prior', JAHP])
def test_wrapper_equals_jax(kind, detector, codecs):
    """Two images through each package's `InputCompressionDetectionModel`:
    the canvases (equal for JPEG, within 1e-4 for the neural codecs), the
    compressed strings and KB summaries, the scales, and the detections
    (labels and validity equal, boxes within 1e-3 of the largest)."""
    module, variables, port = detector
    kwargs = {'transform_kwargs': SIZE}
    jkw, pkw = dict(kwargs), dict(kwargs)
    if kind == 'jpeg':
        jkw['codec_config'] = pkw['codec_config'] = CODEC
    else:
        jrt, prt = codecs[kind]
        jkw['compression_model'] = _Recording(jrt)
        pkw['compression_model'] = _Recording(prt)
        jkw['analysis_config'] = ANALYZER
    jw = jax_det_wrapper.InputCompressionDetectionModel(
        module, jax.tree.map(np.asarray, variables), **jkw)
    jw._fwd = _JAX_FORWARD.get('fwd')
    pw = det_wrapper.InputCompressionDetectionModel(port, device='cpu',
                                                    **pkw)
    imgs = _images(2)
    canvas_w, scales_w, _ = jw.transform(imgs)
    canvas_g, scales_g, _ = pw.transform(imgs)
    np.testing.assert_array_equal(scales_g, scales_w)
    tol = 0.0 if kind == 'jpeg' else 1e-4
    np.testing.assert_allclose(canvas_g, canvas_w, rtol=tol, atol=tol * max(
        1.0, float(np.abs(canvas_w).max())))
    jw.analyzers[0].clear()
    pw.analyzers[0].clear()
    if kind != 'jpeg':
        jkw['compression_model'].compressed.clear()
        pkw['compression_model'].compressed.clear()
    want, got = jw(imgs), pw(imgs)
    _JAX_FORWARD['fwd'] = jw._fwd
    assert pw.summarize() == jw.summarize()
    assert pw.summarize()[0]['num_samples'] == 2
    if kind != 'jpeg':
        w_objs = jkw['compression_model'].compressed
        g_objs = pkw['compression_model'].compressed
        assert len(g_objs) == len(w_objs) == 2
        for g, w in zip(g_objs, w_objs):
            assert g['strings'] == w['strings']
            assert tuple(g['shape']) == tuple(w['shape'])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g['labels'], np.asarray(w['labels']))
        wb = np.asarray(w['boxes'])
        np.testing.assert_allclose(g['boxes'], wb, rtol=1e-3, atol=1e-3 * max(
            1.0, float(np.abs(wb).max()) if wb.size else 1.0))
        np.testing.assert_allclose(g['scores'], np.asarray(w['scores']),
                                   rtol=1e-3, atol=1e-4)


def _engine_config(path, ckpt, n=2):
    over = {'models': {'wrapper': {'detection_model': {
        'key': SMALL, 'kwargs': {'num_classes': CLASSES},
        'init_image_size': [96, 96], 'ckpt': ckpt},
        'kwargs': {'transform_kwargs': SIZE}}},
        'test': {'test_data_loader': {
            'dataset': {'key': 'SyntheticDetectionDataset',
                        'kwargs': {'num_samples': n, 'image_size': [50, 70],
                                   'num_classes': CLASSES}},
            'batch_size': 1}}}
    return over


def test_cli_test_only_equals_jax_engine(detector, monkeypatch, tmp_path):
    """`-test_only` on the JPEG config with a synthetic COCO loader: the
    12 bbox metrics and the data-size summary equal the JAX engine's on
    the same detector checkpoint; training raises as in JAX."""
    register_small(monkeypatch)
    ckpt = str(tmp_path / 'detector.ckpt')
    jax_save_ckpt(ckpt, detector[1])
    path = COCO_IC / 'jpeg-faster_rcnn_resnet50_fpn.yaml'
    over = _engine_config(path, ckpt)
    want = JaxEngine(jax_load_config(path, over), mesh=None).test()
    out = main(['--config', str(path), '--json', json.dumps(over),
                '-test_only', '--device', 'cpu'])
    res = out['result']
    for k in ('AP', 'AP50', 'AP75', 'AP_small', 'AP_medium', 'AP_large',
              'AR_1', 'AR_10', 'AR_100', 'AR_small', 'AR_medium',
              'AR_large'):
        assert res[k] == pytest.approx(want[k], abs=1e-12), k
    assert out['summaries'] == want['data_size'] == res['data_size']
    assert out['summaries'][0]['num_samples'] == 2
    assert res['model_time'] > 0 and out['teacher'] is None
    with pytest.raises(ValueError, match='test-only'):
        main(['--config', str(path), '--json', json.dumps(over),
              '--device', 'cpu'])


@pytest.mark.parametrize('path', RUNNABLE,
                         ids=lambda p: p.stem.split('-')[0])
def test_config_tests_in_the_port(path, monkeypatch):
    """Each runnable config through the port's CLI with the small
    detector, a narrowed codec and two synthetic images: the metrics, the
    data size of both images, a positive size."""
    register_small(monkeypatch)
    cm = load_config(path)['models']['wrapper'].get('compression_model')
    over = _engine_config(path, None)
    del over['models']['wrapper']['detection_model']['ckpt']
    if cm is not None:
        n, m = WIDTHS[cm['key']]
        over['models']['wrapper']['compression_model'] = {
            'kwargs': {'n': n, 'm': m}}
    out = main(['--config', str(path), '--json', json.dumps(over),
                '-test_only', '--device', 'cpu'])
    s, = out['summaries']
    assert s['num_samples'] == 2 and s['mean'] > 0 and s['unit'] == 'KB'
    assert -1.0 <= out['result']['AP'] <= 1.0
