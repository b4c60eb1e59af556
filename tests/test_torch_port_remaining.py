"""The last names of the JAX package to be ported, on the CPU against JAX:
the mesh's shape rule and its one-process helpers, the interleaved host
coder, Fast NMS, the aspect-ratio-grouped sampler, the loader's worker
pool, the RegNet design-space generator, `split_wire`, the coding
tables' state dict, the analyzers' base class, the `check_if_updatable_*`
tests, `MetricLogger.log_every`, `ClearTargetTransform`, and the two
packages' registries. The sharded encoder over two ranks is in the gloo
job of `tests/test_torch_port_parallel.py`."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import importlib
import json
import logging
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sc2bench_tpu
import sc2bench_tpu_torch
from sc2bench_tpu.analysis import BaseAnalyzer as JaxBaseAnalyzer
from sc2bench_tpu.datasets.coco import CocoDetectionDataset as JaxCoco
from sc2bench_tpu.datasets.image import DataLoader as JaxDataLoader
from sc2bench_tpu.datasets.image import \
    build_sharded_loader as jax_build_sharded_loader
from sc2bench_tpu.datasets.sampler import \
    GroupedBatchSampler as JaxGroupedBatchSampler
from sc2bench_tpu.datasets.sampler import \
    compute_aspect_ratios as jax_compute_aspect_ratios
from sc2bench_tpu.datasets.sampler import \
    create_aspect_ratio_groups as jax_create_aspect_ratio_groups
from sc2bench_tpu.models.detection.base import \
    check_if_updatable_detection_model as jax_check_detection
from sc2bench_tpu.models.regnet import \
    generate_regnet_params as jax_generate_regnet_params
from sc2bench_tpu.models.segmentation.base import \
    check_if_updatable_segmentation_model as jax_check_segmentation
from sc2bench_tpu.ops.boxes import fast_nms_mask as jax_fast_nms_mask
from sc2bench_tpu.ops.entropy.tables import CodingTables as JaxCodingTables
from sc2bench_tpu.ops.rans import coder as jax_coder
from sc2bench_tpu.ops.rans.device import split_wire as jax_split_wire
from sc2bench_tpu.parallel.mesh import get_mesh as jax_get_mesh
from sc2bench_tpu.utils.metrics import MetricLogger as JaxMetricLogger
from sc2bench_tpu_torch import registry
from sc2bench_tpu_torch.analysis import BaseAnalyzer, FileSizeAnalyzer
from sc2bench_tpu_torch.datasets.coco import CocoDetectionDataset
from sc2bench_tpu_torch.datasets.image import (DataLoader,
                                               SyntheticClassificationDataset,
                                               build_sharded_loader)
from sc2bench_tpu_torch.datasets.sampler import (GroupedBatchSampler,
                                                 compute_aspect_ratios,
                                                 create_aspect_ratio_groups)
from sc2bench_tpu_torch.models.detection.base import \
    check_if_updatable_detection_model
from sc2bench_tpu_torch.models.layer import FPBasedResNetBottleneck
from sc2bench_tpu_torch.models.regnet import (REGNET_PRESETS,
                                              generate_regnet_params)
from sc2bench_tpu_torch.models.segmentation.base import \
    check_if_updatable_segmentation_model
from sc2bench_tpu_torch.ops.boxes import fast_nms_mask
from sc2bench_tpu_torch.ops.entropy.factorized import EntropyBottleneck
from sc2bench_tpu_torch.ops.entropy.tables import (CodingTables,
                                                   build_factorized_tables,
                                                   build_gaussian_tables)
from sc2bench_tpu_torch.ops.rans import coder
from sc2bench_tpu_torch.ops.rans.coder import RansCoder
from sc2bench_tpu_torch.ops.rans.device import (device_rans_encode,
                                                pack_stream, split_wire,
                                                wire_nbytes)
from sc2bench_tpu_torch.parallel import dist as port_dist
from sc2bench_tpu_torch.parallel import mesh as port_mesh
from sc2bench_tpu_torch.utils.metrics import MetricLogger


@pytest.fixture(scope='module')
def tables():
    """The default Gaussian tables (64 rows), the same in both packages."""
    return build_gaussian_tables()


def _coders(t):
    args = (t.quantized_cdf, t.cdf_length, t.offset)
    return (RansCoder(*args), RansCoder(*args, use_cpp=False),
            jax_coder.RansCoder(*args))


# ---- the mesh --------------------------------------------------------------

@pytest.mark.parametrize('n', range(1, 9))
def test_mesh_shape_equals_jax(n):
    """The 1-D and 2-D shapes for n ranks equal JAX's `get_mesh` over n of
    the CPU devices (8 as (2, 4), 4 as (1, 4), 6 as (3, 2), odd as (n,
    1)), and the ranks sit where JAX's devices do."""
    for axes in (('data',), ('data', 'model')):
        jm = jax_get_mesh(n, axes=axes)
        assert port_mesh.mesh_shape(n, axes) == jm.devices.shape
        assert jm.axis_names == axes
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        assert (np.arange(n).reshape(jm.devices.shape) == ids).all()


def test_mesh_of_one_process_is_the_identity():
    """Without a group the mesh is this process alone on either layout;
    the batch, the replica and the sharded encoder are what they were
    (the encoder bitwise the plain one), and a mesh of more ranks than
    the group raises."""
    for axes in (('data',), ('data', 'model')):
        mesh = port_mesh.get_mesh(axes=axes)
        assert mesh.size == 1 and set(mesh.shape.values()) == {1}
    mesh = port_mesh.get_mesh(1, axes=('data', 'model'))
    assert port_mesh.data_sharding(mesh) == port_mesh.DataSharding(0, 1)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    batch = {'x': x, 'y': np.arange(2)}
    got = port_mesh.shard_batch(mesh, batch)
    assert torch.equal(got['x'], x)
    assert (got['y'] == np.arange(2)).all()
    assert port_mesh.replicate(mesh, x) is x
    bneck = FPBasedResNetBottleneck(num_bottleneck_channels=8).eval()
    with torch.no_grad():
        want = bneck.encoder(x)
    assert torch.equal(port_mesh.sharded_encode(
        bneck, port_mesh.shard_spatial(mesh, x), mesh), want)
    with pytest.raises(ValueError, match='n_devices=2'):
        port_mesh.get_mesh(2, axes=('data', 'model'))
    assert port_mesh.get_mesh(axes=('data', 'model'), local=True).size == 1


def test_destroy_forgets_the_mesh_subgroups():
    """A mesh's sub-groups belong to the process group they were made
    in: they are made once a layout, and `destroy` forgets them, so a
    group started after it makes its own."""
    made = []

    def make():
        made.append(len(made))
        return made[-1]
    key = ('test', (1, 2))
    assert port_dist.subgroups(key, make) == 0
    assert port_dist.subgroups(key, make) == 0
    port_dist.destroy()
    assert port_dist.subgroups(key, make) == 1
    port_dist.destroy()
    assert made == [0, 1]


@pytest.mark.parametrize('count,index', [(2, 1), (4, 3)])
def test_data_sharding_is_jax_data_block(count, index):
    """Block `index` of `count` along 'data' holds the rows JAX's
    `P('data')` puts on that device of the axis: [i*b, (i+1)*b)."""
    jm = jax_get_mesh(count)
    x = jnp.arange(8 * 3).reshape(8, 3)
    placed = jax.device_put(x, jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec('data')))
    shard = [s for s in placed.addressable_shards
             if s.device == jm.devices[index]][0]
    rows = port_mesh.DataSharding(index, count).rows(8)
    assert (np.asarray(shard.data) == np.asarray(x)[rows]).all()
    with pytest.raises(ValueError, match='equal blocks'):
        port_mesh.DataSharding(index, count).rows(7)


# ---- the interleaved host coder ----------------------------------------

def _escape_symbols(t, n, rng):
    """n symbols inside the rows' support, with escapes of every size
    below 2^27 (which JAX's coder codes) at a few places, and their rows."""
    idx = rng.integers(0, t.quantized_cdf.shape[0], n).astype(np.int32)
    lo = t.offset[idx]
    hi = lo + t.cdf_length[idx] - 2
    sym = rng.integers(lo, hi).astype(np.int32)
    big = [hi[0] + 1, lo[1] - 1, 5000, -70000, 2 ** 26, -(2 ** 27) + 1,
           2 ** 27 - 1]
    where = rng.choice(n, len(big), replace=False)
    sym[where] = big
    return sym, idx


@pytest.mark.parametrize('lanes', [1, 8, 13])
def test_interleaved_bytes_equal_jax(tables, lanes):
    """1,003 symbols (divisible by neither 8 nor 13) with escapes below
    2^27: the bytes equal JAX's `encode_interleaved`, the Python
    reference's and those of one thread; the C++ and Python decoders and
    JAX's give the symbols back."""
    rng = np.random.default_rng(lanes)
    sym, idx = _escape_symbols(tables, 1003, rng)
    cpp, py, jax_side = _coders(tables)
    data = cpp.encode_interleaved(sym, idx, num_lanes=lanes)
    assert data == jax_side.encode_interleaved(sym, idx, num_lanes=lanes)
    assert data == py.encode_interleaved(sym, idx, num_lanes=lanes)
    assert data == cpp._encode_interleaved(sym, idx, lanes, threads=1)
    assert int(np.frombuffer(data[:4], '<i4')[0]) == lanes
    for dec in (cpp, py, jax_side):
        assert (dec.decode_interleaved(data, idx) == sym).all()
    assert (cpp._decode_interleaved(data, idx, threads=lanes) == sym).all()


def test_interleaved_codes_every_int32(tables):
    """The port alone codes +-(2^31 - 1) and -2^31 on interleaved lanes
    (JAX's coder does not end above 2^27), the C++ and Python bytes
    equal."""
    cpp, py, _ = _coders(tables)
    sym = np.asarray([2 ** 31 - 1, -(2 ** 31) + 1, -(2 ** 31), 0, 3],
                     np.int32)
    idx = np.asarray([0, 5, 63, 7, 1], np.int32)
    for lanes in (1, 2, 4):
        data = cpp.encode_interleaved(sym, idx, num_lanes=lanes)
        assert data == py.encode_interleaved(sym, idx, num_lanes=lanes)
        assert (cpp.decode_interleaved(data, idx) == sym).all()
        assert (py.decode_interleaved(data, idx) == sym).all()


@pytest.mark.parametrize('stream', [
    b'', b'\x01\x00', np.asarray([0], '<i4').tobytes(),
    np.asarray([-2, 4], '<i4').tobytes(),
    np.asarray([2 ** 30], '<i4').tobytes(),
    np.asarray([2, 5, 100, 0, 0], '<i4').tobytes(),
    np.asarray([2, 8, -4, 0, 0], '<i4').tobytes()],
    ids=['empty', 'short', 'no-lanes', 'negative-lanes', 'huge-lanes',
         'past-the-end', 'negative-size'])
def test_interleaved_corrupt_stream_raises(tables, stream):
    cpp, py, _ = _coders(tables)
    for dec in (cpp, py):
        with pytest.raises(ValueError, match='corrupt'):
            dec.decode_interleaved(stream, np.zeros(5, np.int32))


def test_module_level_coders_equal_jax(tables):
    rng = np.random.default_rng(3)
    sym, idx = _escape_symbols(tables, 300, rng)
    args = (tables.quantized_cdf, tables.cdf_length, tables.offset)
    data = coder.encode_with_indexes(sym, idx, *args)
    assert data == jax_coder.encode_with_indexes(sym, idx, *args)
    assert (coder.decode_with_indexes(data, idx, *args) == sym).all()


# ---- Fast NMS --------------------------------------------------------------

def _nms_case(n, seed):
    """n boxes in a few overlapping clusters, scores on a 0.1 grid (many
    ties) and a tenth of them -inf."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 180, (6, 2))[rng.integers(0, 6, n)]
    wh = rng.uniform(10, 60, (n, 2))
    xy = centers + rng.normal(0, 8, (n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)
    scores[rng.choice(n, n // 10, replace=False)] = -np.inf
    return boxes, scores


@pytest.mark.parametrize('n,max_out,thresh', [
    (60, 100, 0.5), (300, 100, 0.7), (450, 100, 0.5), (1, 4, 0.5),
    (4096, 1000, 0.7)])
def test_fast_nms_equals_jax(n, max_out, thresh):
    """Indices (int32) and validity equal JAX's `fast_nms_mask` for n
    below max_out, between, and above 4 max_out (the top-k cut), on
    tied and -inf scores; the RPN's per-level shape (4,096 boxes, 1,000
    out, IoU 0.7) too."""
    boxes, scores = _nms_case(n, n)
    idx, valid = fast_nms_mask(torch.from_numpy(boxes),
                               torch.from_numpy(scores), thresh, max_out)
    j_idx, j_valid = jax_fast_nms_mask(jnp.asarray(boxes),
                                       jnp.asarray(scores), thresh, max_out)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    assert idx.shape == valid.shape == (max_out,)
    assert (valid.numpy() == np.asarray(j_valid)).all()
    assert (idx.numpy() == np.asarray(j_idx)).all()
    assert 0 < int(valid.sum()) < max(n, 2)


# ---- the grouped sampler ---------------------------------------------------

@pytest.mark.parametrize('shuffle,k,batch', [(True, 3, 4), (False, 1, 3),
                                             (True, 0, 5)])
def test_grouped_batch_sampler_equals_jax(shuffle, k, batch):
    """Three epochs of index lists (padded leftovers included) and the
    length equal JAX's, for groups from `create_aspect_ratio_groups`."""
    ratios = np.random.default_rng(9).uniform(0.4, 2.5, 53).tolist()
    groups = create_aspect_ratio_groups(ratios, k)
    assert groups == jax_create_aspect_ratio_groups(ratios, k)
    port = GroupedBatchSampler(groups, batch, shuffle=shuffle, seed=4)
    ref = JaxGroupedBatchSampler(groups, batch, shuffle=shuffle, seed=4)
    for _ in range(3):
        got = list(port)
        assert got == list(ref)
        assert len(port) == len(ref) == len(got)
        assert all(len(b) == batch for b in got)
        assert set(sum(got, [])) == set(range(len(groups)))


def test_compute_aspect_ratios_equals_jax(tmp_path):
    """From a COCO dataset's index (images without annotations left
    out), from `get_height_and_width`, and from the loaded images."""
    ann = {'images': [{'id': i, 'file_name': f'{i}.jpg', 'width': w,
                       'height': h} for i, (w, h) in
                      enumerate([(640, 480), (480, 640), (500, 500),
                                 (800, 600)], start=1)],
           'categories': [{'id': 1, 'name': 'a'}],
           'annotations': [{'id': j, 'image_id': i, 'category_id': 1,
                            'bbox': [1, 1, 5, 5], 'area': 25, 'iscrowd': 0}
                           for j, i in enumerate([1, 2, 4], start=1)]}
    path = tmp_path / 'ann.json'
    path.write_text(json.dumps(ann))
    got = compute_aspect_ratios(CocoDetectionDataset(tmp_path, path))
    assert got == jax_compute_aspect_ratios(JaxCoco(tmp_path, path))
    assert got == [640 / 480, 480 / 640, 800 / 600]

    class Images:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return np.zeros((10 + i, 20, 3)), 0

    class Sized(Images):
        def get_height_and_width(self, i):
            return 20 + i, 10

    for ds, want in ((Sized(), [10 / 20, 10 / 21, 10 / 22]),
                     (Images(), [2.0, 20 / 11, 20 / 12])):
        assert compute_aspect_ratios(ds) == jax_compute_aspect_ratios(ds) \
            == want


# ---- the loader's worker pool ----------------------------------------------

@pytest.mark.parametrize('workers', [0, 2])
def test_loader_batches_equal_jax(workers):
    """A shuffled loader (seed 5) of uint8 synthetic images, with and
    without prefetch, gives JAX's batches over two epochs, in order;
    `close` ends the pool."""
    ds = SyntheticClassificationDataset(num_samples=11, image_size=(8, 8),
                                        num_classes=7, normalized=False)
    for prefetch in (True, False):
        kw = dict(batch_size=3, shuffle=True, seed=5, prefetch=prefetch,
                  num_workers=workers)
        port, ref = DataLoader(ds, **kw), JaxDataLoader(ds, **kw)
        for _ in range(2):
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port) == 4
            for (x, y), (wx, wy) in zip(got, want):
                assert x.dtype == wx.dtype == np.uint8
                assert (x == wx).all() and (y == wy).all()
        assert (port._pool is not None) == (workers > 0)
        port.close()
        ref.close()
        assert port._pool is None


def test_build_sharded_loader_passes_num_workers():
    split = {'dataset': {'key': 'SyntheticClassificationDataset',
                         'kwargs': {'num_samples': 6, 'image_size': [8, 8],
                                    'num_classes': 3}},
             'batch_size': 2, 'num_workers': 2}
    port, ref = build_sharded_loader(split), jax_build_sharded_loader(split)
    assert port.num_workers == ref.num_workers == 2
    for (x, y), (wx, wy) in zip(port, ref):
        assert (x == wx).all() and (y == wy).all()
    port.close()
    ref.close()


# ---- the remaining names -----------------------------------------------

@pytest.mark.parametrize('params', [
    (112, 33.22, 2.27, 25, 72), (48, 36.97, 2.48, 18, 72),
    (24, 36.44, 2.49, 13, 8), (80, 42.63, 2.66, 27, 24)])
def test_generate_regnet_params_equal_jax(params):
    """Widths and depths equal JAX's; (112, 33.22, 2.27, 25, 72), timm's
    RegNetY-6.4GF, gives the `regnety_064` teacher's stages."""
    got = generate_regnet_params(*params)
    assert got == jax_generate_regnet_params(*params)
    if params[0] == 112:
        widths, depths, group = REGNET_PRESETS['regnety_064']
        assert got == ([144, *widths], [2, *depths])


def test_split_wire_equals_jax():
    """A z wire then a y wire (the hyperprior's pulled wire) split back
    into the two, as JAX splits them."""
    rng = np.random.default_rng(6)
    t = build_gaussian_tables()
    wires = []
    for n, lanes in ((14 * 14 * 16, 16), (55 * 55 * 24, 384)):
        sym = torch.from_numpy(rng.integers(-3, 4, n).astype(np.int32))
        wires.append(pack_stream(device_rans_encode(
            sym, t.quantized_cdf, t.cdf_length, t.offset, num_lanes=lanes,
            cyclic_channels=16, device='cpu')))
    data = b''.join(wires)
    assert split_wire(data) == jax_split_wire(data) == tuple(wires)
    assert wire_nbytes(data) == len(wires[0])


def test_coding_tables_round_trip(tables):
    """Factorized tables (with medians) and Gaussian tables (with the
    scale table) come back equal from their state dict, JAX's
    `from_state_dict` reads it, and the round-tripped tables code the
    same bytes."""
    torch.manual_seed(0)
    eb = EntropyBottleneck(8)
    with torch.no_grad():
        eb.quantiles.add_(torch.randn_like(eb.quantiles) * 0.3)
    rng = np.random.default_rng(8)
    for t in (build_factorized_tables(eb), tables):
        state = t.state_dict()
        back = CodingTables.from_state_dict(state)
        jax_back = JaxCodingTables.from_state_dict(state)
        for f in ('quantized_cdf', 'cdf_length', 'offset', 'medians',
                  'scale_table'):
            a, b, c = (getattr(x, f) for x in (t, back, jax_back))
            assert (a is None) == (f not in state)
            if a is not None:
                assert np.array_equal(a, b) and np.array_equal(a, c)
                assert b.dtype == a.dtype
        sym, idx = _escape_symbols(t, 500, rng)
        assert RansCoder(back.quantized_cdf, back.cdf_length,
                         back.offset).encode_with_indexes(sym, idx) \
            == RansCoder(t.quantized_cdf, t.cdf_length,
                         t.offset).encode_with_indexes(sym, idx)


def test_analyzers_derive_from_base_analyzer():
    assert issubclass(FileSizeAnalyzer, BaseAnalyzer)
    for cls in (BaseAnalyzer, JaxBaseAnalyzer):
        for name in ('analyze', 'summarize', 'clear'):
            with pytest.raises(NotImplementedError):
                getattr(cls(), name)()


def test_check_if_updatable_equal_jax():
    class Updatable:
        def update(self):
            return True

    class WithBackbone(Updatable):
        backbone = None

    for obj in (object(), Updatable(), WithBackbone()):
        assert check_if_updatable_detection_model(obj) \
            == jax_check_detection(obj)
        assert check_if_updatable_segmentation_model(obj) \
            == jax_check_segmentation(obj)
    assert check_if_updatable_segmentation_model(WithBackbone())
    assert not check_if_updatable_segmentation_model(Updatable())


def _logged(logger_cls, caplog):
    logger = logging.getLogger('log_every')
    metric = logger_cls()
    metric.update(loss=torch.tensor(2.0) if logger_cls is MetricLogger
                  else 2.0)
    with caplog.at_level(logging.INFO, logger='log_every'):
        caplog.clear()
        items = list(metric.log_every(range(5), 2, logger, header='Epoch'))
        return items, [r.getMessage() for r in caplog.records]


def test_metric_logger_log_every_equals_jax(caplog):
    """The items pass through, and the log lines are JAX's: items 0, 2
    and 4 with the meters, then the total."""
    got, lines = _logged(MetricLogger, caplog)
    want, jax_lines = _logged(JaxMetricLogger, caplog)
    assert got == want == list(range(5))
    assert len(lines) == len(jax_lines) == 4
    for a, b in zip(lines, jax_lines):
        assert a.split('iter_time')[0] == b.split('iter_time')[0]
    assert lines[0].startswith('Epoch [0]  loss: 2.0000 (2.0000)')
    assert lines[-1].startswith('Epoch done in ')


def test_image_codec_runtime_forward_is_the_module_forward():
    """`ImageCodecRuntime.forward` (JAX's `module.apply`): the codec's
    forward on the image taken to the runtime's device, both modes."""
    from sc2bench_tpu_torch.models.zoo import (FactorizedPriorCodec,
                                               ImageCodecRuntime)
    torch.manual_seed(0)
    rt = ImageCodecRuntime(FactorizedPriorCodec(8, 8), device='cpu')
    x = np.random.default_rng(5).uniform(0, 1, (1, 3, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        for mode in ('train', 'eval'):
            got = rt.forward(x, mode, torch.Generator().manual_seed(1))
            want = rt.module(torch.from_numpy(x), mode=mode,
                             generator=torch.Generator().manual_seed(1))
            assert got.shape == (1, 3, 32, 32) and torch.equal(got, want)


def test_clear_target_transform():
    cls = registry.get('transform', 'ClearTargetTransform')
    x = np.ones(3)
    out = cls()(x, {'boxes': 1})
    assert out[0] is x and out[1] is None


def test_registries_equal_namespace_by_namespace():
    """With every module of both packages imported, each registry
    namespace holds the same names in both (transform: 12 = 12)."""
    from sc2bench_tpu import registry as jax_registry
    for pkg in (sc2bench_tpu, sc2bench_tpu_torch):
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
            importlib.import_module(m.name)
    jr, pr = jax_registry._REGISTRIES, registry._REGISTRIES
    assert set(jr) == set(pr)
    for ns in jr:
        assert set(jr[ns]) == set(pr[ns]), ns
    assert len(pr['transform']) == 12
