"""The port's classification test protocol against the JAX package.

Config loading, the registries, the full `ResNet` teacher, the 'finetune'
forward and `__call__`, the model-size analysis, checkpoints written by
the JAX `save_ckpt`, the top-k ranking, and end to end the port CLI's
`-test_only` run against the JAX `ClassificationEngine.test()` on
`configs/sample/tiny_entropic_student.yaml` with one set of weights (a
Flax checkpoint that both read), on the host wire and on the device wire.
Accuracies and data-size summaries must be equal; logits agree within
rtol=atol=1e-4 (same symbols; only float summation order differs between
XLA:CPU and PyTorch's CPU kernels)."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sc2bench_tpu.analysis import analyze_model_size as jax_model_size
from sc2bench_tpu.config import load_config as jax_load_config
from sc2bench_tpu.config import \
    train_stage_configs as jax_train_stage_configs
from sc2bench_tpu.datasets.image import DataLoader as JaxDataLoader
from sc2bench_tpu.datasets.image import build_dataset as jax_build_dataset
from sc2bench_tpu.datasets.image import \
    build_sharded_loader as jax_build_loader
from sc2bench_tpu.models.registry import \
    load_classification_model as jax_load_model
from sc2bench_tpu.models.resnet import ResNet as JaxResNet
import sc2bench_tpu.train.engine as jax_engine_module
from sc2bench_tpu.train.engine import ClassificationEngine as JaxEngine
from sc2bench_tpu.train.engine import top_k_accuracy as jax_top_k
from sc2bench_tpu.utils.ckpt import save_ckpt as jax_save_ckpt
from sc2bench_tpu.utils.torch_convert import RESNET_RULES, convert_state_dict
from sc2bench_tpu_torch.analysis import (analyze_model_size,
                                         check_if_analyzable)
from sc2bench_tpu_torch.config import load_config, train_stage_configs
from sc2bench_tpu_torch.datasets.image import build_sharded_loader
from sc2bench_tpu_torch.models.backbone import resnet_builder, \
    splittable_resnet
from sc2bench_tpu_torch.models.layer import get_layer
from sc2bench_tpu_torch.models.registry import load_classification_model
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.registry import (get, import_dependencies,
                                         port_module_name)
from sc2bench_tpu_torch.tasks.image_classification import main
from sc2bench_tpu_torch.train.engine import (ClassificationEngine,
                                             top_k_accuracy)
from sc2bench_tpu_torch.utils.ckpt import load_ckpt, save_ckpt
from sc2bench_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_port_model import (BCH, CLASSES, HW, STAGES, TARGET,  # noqa
                                   _nchw, _randomize, models)

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / 'configs/sample/tiny_entropic_student.yaml')
CONFIG_GROUPS = sorted(p.name for p in (REPO / 'configs').iterdir()
                       if p.is_dir())


@pytest.mark.parametrize('group', CONFIG_GROUPS)
def test_load_config_equals_jax(group):
    paths = sorted((REPO / 'configs' / group).rglob('*.yaml'))
    assert paths
    for path in paths:
        config = load_config(path)
        assert config == jax_load_config(path), path
        train = config.get('train', {})
        assert train_stage_configs(train) == jax_train_stage_configs(train)


def test_load_config_json_override_equals_jax():
    over = {'deploy_wire': 'device', 'models': {'student_model': {
        'ckpt': 'x.ckpt', 'kwargs': {'num_classes': 3}}}}
    for arg in (over, json.dumps(over)):
        got = load_config(TINY, arg)
        assert got == jax_load_config(TINY, arg)
        assert got['models']['student_model']['kwargs']['resnet_name'] \
            == 'resnet50'


def test_registry_maps_the_jax_package_and_names_what_it_knows(caplog):
    with caplog.at_level(logging.WARNING):
        import_dependencies(['sc2bench_tpu.models',
                             'sc2bench_tpu.transforms',
                             'sc2bench_tpu.models.segmentation',
                             'sc2bench_tpu.models.detection',
                             'sc2bench_tpu.parallel.mesh',
                             'sc2bench_tpu.utils.cache',
                             {'name': 'json'}])
    assert 'sc2bench_tpu.utils.cache has no counterpart' in caplog.text
    for ported in ('transforms', 'models.segmentation', 'models.detection',
                   'parallel.mesh'):
        assert f'sc2bench_tpu.{ported} has no counterpart' not in caplog.text
    assert port_module_name('sc2bench_tpu.models.layer') \
        == 'sc2bench_tpu_torch.models.layer'
    assert port_module_name('sc2bench_tpu_x') == 'sc2bench_tpu_x'
    assert get('model', 'splittable_resnet') is splittable_resnet
    assert get('model', 'resnet') is resnet_builder
    with pytest.raises(KeyError, match='MSHPBasedResNetBottleneck'):
        get_layer('no_such_bottleneck')
    assert type(get_layer('SHPBasedResNetBottleneck')).__name__ \
        == 'SHPBasedResNetBottleneck'
    with pytest.raises(KeyError, match='splittable_resnet'):
        load_classification_model({'key': 'no_such_model'}, device='cpu')


def test_teacher_resnet_equals_jax():
    """The full ResNet (stem, layer1-4, fc) in the key space that
    `state_dict_from_flax` targets and the JAX package's own torch
    converter reads back."""
    fm = JaxResNet(stage_sizes=STAGES, num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3)), train=False))
    variables = _randomize({'params': shapes['params'],
                            'batch_stats': shapes['batch_stats']},
                           np.random.default_rng(5))
    x = np.random.default_rng(6).normal(0, 1, (2, HW, HW, 3)).astype(
        np.float32)
    ref = jax.jit(lambda v, x: fm.apply(v, x, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    pm = resnet_builder(stage_sizes=STAGES, num_classes=CLASSES,
                        device='cpu').eval()
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = pm(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)
    back = convert_state_dict(pm.state_dict(), RESNET_RULES)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()


def _jax_finetune(jrt, x):
    """The JAX runtime's jitted 'finetune' forward (its training-mode
    `__call__`), compiled once per runtime."""
    try:
        return np.asarray(jrt.train()(jnp.asarray(x)))
    finally:
        jrt.eval()


def test_call_and_finetune_forward_equal_jax(models):  # noqa: F811
    """`__call__` deploys through the host coder in eval mode (data size
    accounted) and runs the 'finetune' forward while training, BatchNorm
    on its running statistics on both sides; the module's own 'finetune'
    forward is the same. Before `update()` it runs the 'train' forward,
    its noise from a generator seeded with 0."""
    _, jrt, prt, images = models
    x = images[0]
    try:
        for rt in (jrt, prt):
            rt.clear_analysis()
            rt.activate_analysis()
        j, p = jrt(jnp.asarray(x)), prt(_nchw(x))
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
        assert prt.analyzers[0].file_size_list \
            == jrt.analyzers[0].file_size_list
        assert len(prt.analyzers[0].file_size_list) == 1
        p = prt.train()(_nchw(x))
        np.testing.assert_allclose(p.numpy(), _jax_finetune(jrt, x),
                                   rtol=1e-4, atol=1e-4)
        with torch.no_grad():
            got = prt.module(_nchw(x), mode='finetune')
        assert torch.equal(p, got)
        assert len(prt.analyzers[0].file_size_list) == 1
    finally:
        for rt in (jrt, prt):
            rt.eval()
            rt.deactivate_analysis()
    assert prt.get_aux_module() is prt.module.bottleneck_layer
    # a module in training mode (as builders return it) is served with
    # BatchNorm's running statistics, whatever the runtime's flag
    prt.module.train()
    fresh = SplitClassifierRuntime(prt.module, device='cpu')
    assert not prt.module.training
    assert not fresh.train().module.training
    got = fresh(_nchw(x))
    with torch.no_grad():
        want = fresh.module(_nchw(x), mode='train',
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, want) and torch.isfinite(got).all()
    assert not torch.equal(got, fresh.module(_nchw(x), mode='finetune'))


def test_analyze_model_size_equals_jax(models):  # noqa: F811
    variables, _, prt, _ = models
    params = dict(prt.module.named_parameters())
    for j_paths, p_paths, rest in (
            (['bottleneck_layer.enc_'], ['bottleneck_layer.encoder'], None),
            (['bottleneck_layer.'], ['bottleneck_layer.'],
             ['bottleneck_layer.entropy_bottleneck.quantiles'])):
        want = jax_model_size(variables['params'], encoder_paths=j_paths,
                              additional_rest_paths=rest)
        assert analyze_model_size(params, encoder_paths=p_paths,
                                  additional_rest_paths=rest) == want
        assert 0 < want['encoder'] < want['model']
    assert check_if_analyzable(prt) and not check_if_analyzable(prt.module)


def test_checkpoints_flax_and_port_format(models, tmp_path,  # noqa: F811
                                          monkeypatch):
    """A checkpoint of the JAX `save_ckpt` loads through `load_ckpt` (by
    its content) and gives the JAX logits; the port's own format
    round-trips with both sidecars; other content is refused."""
    variables, jrt, prt, images = models
    flax_path = tmp_path / 'student.ckpt'
    jax_save_ckpt(flax_path, variables, meta={'best_metric': 0.5})
    state_dict, tables, meta = load_ckpt(flax_path)
    assert tables is None and meta == {'best_metric': 0.5}
    pm = splittable_resnet(
        {'key': 'FPBasedResNetBottleneck',
         'kwargs': {'num_bottleneck_channels': BCH,
                    'num_target_channels': TARGET}},
        stage_sizes=STAGES, num_classes=CLASSES, device='cpu').eval()
    pm.load_state_dict(state_dict, strict=True)
    x = images[1]
    with torch.no_grad():
        got = pm(_nchw(x), mode='finetune').numpy()
    np.testing.assert_allclose(got, _jax_finetune(jrt, x), rtol=1e-4,
                               atol=1e-4)

    port_path = tmp_path / 'port' / 'student.ckpt'
    save_ckpt(port_path, pm.state_dict(), tables=prt.codec.tables,
              meta={'epoch': 3})
    state_dict2, tables2, meta2 = load_ckpt(port_path)
    assert meta2 == {'epoch': 3}
    np.testing.assert_array_equal(tables2['quantized_cdf'],
                                  prt.codec.tables.quantized_cdf)
    assert state_dict2.keys() == state_dict.keys()
    for k, v in state_dict.items():
        assert torch.equal(state_dict2[k], v), k

    junk = tmp_path / 'junk.ckpt'
    junk.write_bytes(b'not a checkpoint')
    with pytest.raises(ValueError, match='neither'):
        load_ckpt(junk)
    with pytest.raises(FileNotFoundError):
        load_ckpt(tmp_path / 'missing.ckpt')
    monkeypatch.setitem(sys.modules, 'msgpack', None)
    with pytest.raises(ImportError, match='msgpack'):
        load_ckpt(flax_path)


def test_top_k_accuracy_ranks_ties_as_jax():
    """Logits full of ties: the port's ranking (stable ascending sort,
    reversed) picks the classes the JAX package picks."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, (256, 10)).astype(np.float32)
    targets = rng.integers(0, 10, 256)
    want = jax_top_k(jnp.asarray(logits), jnp.asarray(targets), ks=(1, 3, 5))
    got = top_k_accuracy(torch.from_numpy(logits), torch.from_numpy(targets),
                         ks=(1, 3, 5))
    assert {k: float(v) for k, v in got.items()} \
        == {k: float(v) for k, v in want.items()}
    descending = torch.argsort(torch.from_numpy(logits), dim=-1,
                               descending=True)[:, 0]
    assert float((descending == torch.from_numpy(targets)).float().mean()) \
        != float(want['acc1'])


@pytest.fixture(scope='module')
def tiny_run(tmp_path_factory):
    """The JAX engine's test protocol on the tiny config, teacher and
    student from Flax checkpoints with randomized values (8 test images).
    Returns the override that points the config at them and the JAX
    results: per wire (metrics, summaries), the teacher's metrics, and the
    student's 'finetune' metrics."""
    cfg = jax_load_config(TINY)
    ckpt_dir = tmp_path_factory.mktemp('tiny_ckpt')
    rng = np.random.default_rng(3)
    models_over = {}
    for role, kwargs in (('teacher_model', {'train': False}),
                         ('student_model', {'mode': 'train'})):
        module = jax_load_model(cfg['models'][role])
        shapes = jax.eval_shape(lambda m=module, kw=kwargs: m.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, 64, 64, 3)), **kw))
        path = str(ckpt_dir / f'{role}.ckpt')
        jax_save_ckpt(path, _randomize(
            {'params': shapes['params'],
             'batch_stats': shapes['batch_stats']}, rng))
        models_over[role] = {'ckpt': path}
    over = {'models': models_over, 'test': {'test_data_loader': {
        'dataset': {'kwargs': {'num_samples': 8}}}}}

    def zeros_like_init(module, image_size, seed=0, init_kwargs=None):
        # the checkpoints replace every value: a template of the right
        # structure is enough, and costs no compile of the init program
        shapes = jax.eval_shape(lambda: module.init(
            {'params': jax.random.key(0), 'noise': jax.random.key(1)},
            jnp.zeros((1, *image_size, 3)), **(init_kwargs or {})))
        return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                            {'params': shapes['params'],
                             'batch_stats': shapes['batch_stats']})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine_module, 'init_model', zeros_like_init)
        engine = JaxEngine(jax_load_config(TINY, over),
                           image_size=(64, 64), mesh=None)
    per_wire = {}
    for wire in ('host', 'device'):
        engine.config['deploy_wire'] = wire
        engine.runtime.clear_analysis()
        per_wire[wire] = engine.test()
    loader = engine.build_loader(engine.config['test']['test_data_loader'])
    teacher = engine.evaluate_teacher(loader)
    finetune = engine.evaluate(loader)
    return over, per_wire, teacher, finetune


@pytest.mark.parametrize('wire', ['host', 'device'])
def test_cli_test_only_equals_jax_engine(tiny_run, wire):
    over, per_wire, teacher, _ = tiny_run
    want, want_summaries = per_wire[wire]
    out = main(['--config', TINY, '--json',
                json.dumps({**over, 'deploy_wire': wire}), '-test_only',
                '--device', 'cpu'])
    assert out['engine'].device.type == 'cpu'
    for k in ('acc1', 'acc5'):
        assert out['result'][k] == want[k]
    assert out['summaries'] == want_summaries
    assert out['summaries'][0]['num_samples'] == 8
    assert out['teacher'] == teacher
    # the symbols are the same on both wires: so is the accuracy
    assert per_wire['host'][0]['acc1'] == per_wire['device'][0]['acc1']
    assert 0 < want['acc5'] < 1


def test_engine_finetune_eval_equals_jax(tiny_run):
    over, _, _, finetune = tiny_run
    engine = ClassificationEngine(load_config(TINY, over), device='cpu')
    loader = engine.build_loader(engine.config['test']['test_data_loader'])
    assert engine.evaluate(loader) == finetune


@pytest.mark.parametrize('normalized', [True, False],
                         ids=['float32', 'uint8'])
def test_loader_equals_jax_and_runs_in_one_process(normalized, monkeypatch):
    """The port's loader gives the JAX loader's NHWC batches (uint8 stays
    uint8), the last batch short, in one process; in a group of two
    processes a loader sharded over them gives each rank JAX's shard and
    an unsharded one (a test loader) stays whole."""
    split = {'dataset': {'key': 'SyntheticClassificationDataset',
                         'kwargs': {'num_samples': 5, 'image_size': [8, 6],
                                    'num_classes': 7,
                                    'normalized': normalized}},
             'batch_size': 2}
    got = list(build_sharded_loader(split))
    want = list(jax_build_loader(split))
    assert len(got) == len(want) == 3 and len(got[-1][1]) == 1
    for (x, y), (xj, yj) in zip(got, want):
        assert x.dtype == xj.dtype == (np.float32 if normalized
                                       else np.uint8)
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)
    monkeypatch.setattr(torch.distributed, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.distributed, 'get_world_size', lambda: 2)
    assert len(list(build_sharded_loader(split))) == 3
    for r in range(2):
        monkeypatch.setattr(torch.distributed, 'get_rank', lambda: r)
        got = list(build_sharded_loader(split, shard_over_processes=True))
        want = list(JaxDataLoader(jax_build_dataset(split['dataset']),
                                  batch_size=2, num_shards=2, shard_index=r,
                                  prefetch=False))
        assert len(got) == len(want) == 2
        for (x, y), (xj, yj) in zip(got, want):
            np.testing.assert_array_equal(x, xj)
            np.testing.assert_array_equal(y, yj)


def test_cli_needs_test_only_and_a_card(monkeypatch):
    """Without a card the CLI raises, training or testing; wrapper
    configs are test-only: training one raises whatever the device."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for extra in ([], ['-test_only']):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            main(['--config', TINY, *extra])
    wrapper = {'models': {'wrapper': {
        'key': 'CodecInputCompressionClassifier',
        'classification_model': {'key': 'resnet', 'kwargs': {
            'stage_sizes': [1, 1, 1, 1], 'num_classes': 10}}}}}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ClassificationEngine(wrapper)
    with pytest.raises(ValueError, match='test-only'):
        ClassificationEngine(wrapper, device='cpu').train()
