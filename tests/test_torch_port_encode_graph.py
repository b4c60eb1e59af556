"""The device wire's encoder replayed as a CUDA graph
(`sc2bench_tpu_torch/utils/graphs.py`, `SplitClassifierRuntime._wire_symbols`).

On the CPU the cache is driven with an injected capture whose replay
recomputes the captured function into the same output tensors, as a
graph's replay rewrites its static output: the key (k, shape, dtype, the
encoder module), capture on a key's second call only, the LRU limit,
keys seen once leaving the graphs in place, capture again after a weight gets new storage, inputs the cache leaves
eager, and the runtime's default cache staying eager (counters 0) on the
CPU. The `cuda` tests hold graph replay against the eager path bitwise on
a card; they skip without one (`python -m pytest
tests/test_torch_port_encode_graph.py -m cuda --noconftest` on a card).
This file imports neither JAX nor `sc2bench_tpu`."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import json

import pytest
import torch

from sc2bench_tpu_torch.models.backbone import splittable_resnet
from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
from sc2bench_tpu_torch.utils.graphs import (GRAPH_LIMIT, SEEN_LIMIT,
                                              GraphCache)
from sc2bench_tpu_torch.utils.profiling import trace

FP = {'key': 'FPBasedResNetBottleneck',
      'kwargs': {'num_bottleneck_channels': 8, 'num_target_channels': 256}}
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


class FakeCapture:
    """A capture on the CPU: `fn` runs at capture, and a replay runs it
    again and writes the result into the captured output tensors."""

    def __init__(self):
        self.calls = []

    def __call__(self, fn, rows):
        self.calls.append(len(rows))
        out = fn(rows)

        def replay():
            new = fn(rows)
            out[0].copy_(new[0])
        return replay, out


def _runtime(seed=0, input_norm=None):
    torch.manual_seed(seed)
    model = splittable_resnet(FP, stage_sizes=(1, 1, 1, 1), num_classes=10,
                              device='cpu')
    rt = SplitClassifierRuntime(model, device='cpu', input_norm=input_norm)
    rt.update()
    return rt.eval()


def _graphed(rt):
    """Give `rt` a cache that takes CPU tensors, with a fake capture."""
    fake = FakeCapture()
    rt._encode_graphs = GraphCache('deploy.encode_graph', capture=fake,
                                   device_type='cpu')
    return fake


def _images(n, hw=32, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.uint8:
        return [torch.randint(0, 256, (1, 3, hw, hw), generator=g,
                              dtype=torch.uint8) for _ in range(n)]
    return [torch.randn(1, 3, hw, hw, generator=g) for _ in range(n)]


def _eager(rt, xs):
    flat, shape = rt._encode_rows(xs, rt._encode_module())
    return flat.clone(), shape


def test_capture_on_the_second_call_only():
    """Launch 1 runs eagerly, launch 2 captures and replays, launch 3
    replays into the same static output; each launch's symbols, on
    distinct images, equal the eager path's bitwise."""
    rt = _runtime()
    fake = _graphed(rt)
    outs = []
    for launch in range(3):
        xs = _images(4, seed=10 + launch)
        got, shape = rt._wire_symbols(xs)
        want, want_shape = _eager(rt, xs)
        assert shape == want_shape
        assert torch.equal(got, want)
        outs.append(got)
        assert rt._encode_graphs.captures == (0 if launch == 0 else 1)
        assert rt._encode_graphs.replays == 4 * launch
    assert fake.calls == [4]
    assert outs[2] is outs[1] and outs[0] is not outs[1]


def _vary(rt, what):
    """A runtime state and images for the second call that differ from
    the first call's (float, 4 images of 32 px, the float32 encoder) in
    `what` only."""
    if what == 'k':
        return _images(3, seed=3)
    if what == 'shape':
        return _images(4, hw=40, seed=3)
    if what == 'dtype':
        return _images(4, seed=3, dtype=torch.uint8)
    if what == 'encoder':
        rt.deploy_bf16_encode = True
    return _images(4, seed=3)


@pytest.mark.parametrize('what', ['nothing', 'k', 'shape', 'dtype',
                                  'encoder'])
def test_the_key_covers_k_shape_dtype_and_encoder(what):
    """After one launch, a second launch captures only if it has the
    first's key: the same number of images, shape, dtype and encoder
    module (the bfloat16 clone under `deploy_bf16_encode` is another)."""
    rt = _runtime(input_norm=NORM)
    fake = _graphed(rt)
    rt._wire_symbols(_images(4, seed=2))
    xs = _vary(rt, what)
    got, _ = rt._wire_symbols(xs)
    assert torch.equal(got, _eager(rt, xs)[0])
    assert fake.calls == ([4] if what == 'nothing' else [])
    cache = rt._encode_graphs
    assert (len(cache._graphs), len(cache._seen)) == (
        (1, 0) if what == 'nothing' else (0, 2))
    # that launch's key captures on its own second call
    got, _ = rt._wire_symbols(xs)
    assert torch.equal(got, _eager(rt, xs)[0])
    assert len(fake.calls) == 1
    assert rt._encode_graphs.captures == 1


def _counting_cache():
    """A CPU cache of `rows -> stack(rows) * 2`, and a call of it on one
    row of `n` ones (one key per `n`) that checks the result."""
    cache = GraphCache('test.graph', capture=FakeCapture(), device_type='cpu')

    def fn(rows):
        return (torch.stack(rows) * 2,)

    def call(n):
        xs = [torch.ones(1, n)]
        out = cache('f', (), xs, fn)
        assert torch.equal(out[0], torch.stack(xs) * 2)
    return cache, call


def _widths(keys):
    return [k[1][0][0][1] for k in keys]


def test_the_lru_limit_holds():
    """At most `GRAPH_LIMIT` graphs stay; when a key captures beyond it
    the least recently used graph goes, and its key starts its count
    again (eager, then a capture)."""
    cache, call = _counting_cache()
    for n in range(1, GRAPH_LIMIT + 1):
        call(n)
        call(n)
    assert cache.captures == GRAPH_LIMIT == len(cache._graphs)
    call(1)                 # the oldest is now the most recently used
    call(GRAPH_LIMIT + 1)   # seen once: eager, no graph goes
    assert _widths(cache._graphs) == [*range(2, GRAPH_LIMIT + 1), 1]
    call(GRAPH_LIMIT + 1)   # captures and pushes out the least recent: 2
    assert _widths(cache._graphs) == [
        *range(3, GRAPH_LIMIT + 1), 1, GRAPH_LIMIT + 1]
    assert not cache._seen
    call(2)                 # seen again: eager, then captures next time
    assert cache.captures == GRAPH_LIMIT + 1
    call(2)
    assert cache.captures == GRAPH_LIMIT + 2
    assert len(cache._graphs) == GRAPH_LIMIT


def test_keys_seen_once_never_push_a_graph_out():
    """A run of new shapes, each seen once, leaves every graph in place
    and replaying; the eager keys' count is bounded by `SEEN_LIMIT`, the
    least recently seen forgotten first."""
    cache, call = _counting_cache()
    for n in range(1, GRAPH_LIMIT + 1):
        call(n)
        call(n)
    for n in range(100, 100 + SEEN_LIMIT + 5):
        call(n)
    assert _widths(cache._graphs) == list(range(1, GRAPH_LIMIT + 1))
    assert _widths(cache._seen) == list(range(105, 100 + SEEN_LIMIT + 5))
    replays = cache.replays
    for n in range(1, GRAPH_LIMIT + 1):
        call(n)
    assert cache.replays == replays + GRAPH_LIMIT
    assert cache.captures == GRAPH_LIMIT
    call(105)               # still counted: its second call captures
    assert cache.captures == GRAPH_LIMIT + 1
    call(100)               # forgotten: eager again
    assert cache.captures == GRAPH_LIMIT + 1
    assert len(cache._seen) == SEEN_LIMIT


def test_inputs_of_several_shapes_and_a_tally():
    """A function of tensors of two shapes and dtypes (a wavefront loop's
    latent and lane states, say) is cached like same-shape rows; what its
    host code adds to `tally` is taken back after the capture and added
    again after every replay, so the tally counts every call's launches
    once; `rows` sets what `replays` counts."""
    tally = {'launches': 0}
    fake = FakeCapture()

    def capture(fn, rows):
        replay, out = fake(fn, rows)

        def device_only():      # a replay runs no host code
            saved = dict(tally)
            replay()
            tally.update(saved)
        return device_only, out

    cache = GraphCache('test.loop', capture=capture, device_type='cpu',
                       tally=tally)

    def fn(t):
        tally['launches'] += 3
        return (t[0] * t[1].sum().to(t[0].dtype),)

    for i in range(4):
        xs = [torch.full((2, 3), float(i)), torch.arange(5) + i]
        out = cache('loop', (), xs, fn, rows=1)
        assert torch.equal(out[0], xs[0] * xs[1].sum().float())
        assert tally['launches'] == 3 * (i + 1)
    assert fake.calls == [2]
    assert (cache.captures, cache.replays) == (1, 3)


@pytest.mark.parametrize('change', ['new_weight_storage', 'new_medians',
                                    'in_place'])
def test_new_weight_storage_captures_again(change):
    """A weight given new storage (a parameter's `.data`, or `update()`'s
    new medians) makes the next launch capture again; an in-place update
    does not (the graph reads it where it lies). Either way the symbols
    follow the new weights."""
    rt = _runtime()
    fake = _graphed(rt)
    xs = _images(2, seed=4)
    rt._wire_symbols(xs)
    rt._wire_symbols(xs)
    conv = rt._bneck.encoder[0]
    with torch.no_grad():
        if change == 'new_weight_storage':
            conv.weight.data = conv.weight.data * 1.5
        elif change == 'new_medians':
            rt.update()
        else:
            conv.weight.mul_(1.5)
    got, _ = rt._wire_symbols(xs)
    assert torch.equal(got, _eager(rt, xs)[0])
    assert fake.calls == ([2] if change == 'in_place' else [2, 2])
    assert rt._encode_graphs.captures == len(fake.calls)


@pytest.mark.parametrize('inputs', ['mixed_shapes', 'not_contiguous',
                                    'misaligned', 'numpy'])
def test_inputs_a_graph_cannot_hold_stay_eager(inputs):
    """Images of two shapes (which raise, as before), non-contiguous or
    misaligned tensors and arrays run eagerly twice and leave the cache
    empty."""
    rt = _runtime()
    fake = _graphed(rt)
    xs = _images(2, seed=5)
    if inputs == 'not_contiguous':
        xs = [x.transpose(2, 3) for x in xs]
    elif inputs == 'misaligned':
        xs = [torch.cat([x.reshape(-1), x.new_zeros(1)])[1:].view(x.shape)
              for x in xs]
    elif inputs == 'numpy':
        xs = [x.numpy() for x in xs]
    for _ in range(2):
        if inputs == 'mixed_shapes':
            with pytest.raises(ValueError, match='one shape'):
                rt._wire_symbols(xs + _images(1, hw=40))
            continue
        got, _ = rt._wire_symbols(xs)
        assert torch.equal(got, _eager(rt, xs)[0])
    assert fake.calls == []
    assert not rt._encode_graphs._graphs and not rt._encode_graphs._seen


def test_the_serving_loop_replays_equal_to_eager(tmp_path):
    """`stream_deploy_device(wire_batch=2)` over three requests of four
    images with the graph cache: logits and wire sizes bitwise those of
    a runtime without graphs, the first request's two launches eager,
    one capture, every later launch replayed; the counters under a
    trace, and the benchmark's reader of them."""
    from portbench import harness
    rt, ref = _runtime(), _runtime()
    fake = _graphed(rt)
    requests = [_images(4, seed=20 + r) for r in range(3)]
    for r, imgs in enumerate(requests):
        if r == 2:
            with trace(tmp_path):
                got = rt.stream_deploy_device(imgs, wire_batch=2)
        else:
            got = rt.stream_deploy_device(imgs, wire_batch=2)
        want = ref.stream_deploy_device(imgs, wire_batch=2)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert list(rt.analyzers[0].file_size_list) == list(
        ref.analyzers[0].file_size_list)
    assert fake.calls == [2]
    assert rt._encode_graphs.replays == 8 + 2
    s = json.loads((tmp_path / 'spans_rank0.json').read_text())
    assert s['deploy.encode_graph.replays']['count'] == 4
    assert 'deploy.encode_graph.captures' not in s
    assert s['deploy.images']['count'] == 4
    share = harness.metric_reader('encode_graph_share.wb32')
    # the reader reads the process's recorder, which `trace` left filled
    assert share({'trace': {'busy_s': 1.0}, 'counters': {}}) == 100.0


def test_on_the_cpu_the_default_cache_stays_eager(tmp_path):
    """The runtime's own cache takes CUDA tensors only: on the CPU both
    wires and both encoders run eagerly, record no graph counter, and
    keep no key."""
    rt = _runtime()
    imgs = _images(4, seed=6)
    with trace(tmp_path):
        for _ in range(3):
            rt.stream_deploy_device(imgs, wire_batch=2)
            rt.stream_deploy_device(imgs)
    s = json.loads((tmp_path / 'spans_rank0.json').read_text())
    assert not [k for k in s if k.startswith('deploy.encode_graph')]
    assert s['deploy.images']['count'] == 24
    g = rt._encode_graphs
    assert g.captures == g.replays == 0
    assert not g._graphs and not g._seen


# ---- on a card ----------------------------------------------------------

FP24 = {'key': 'FPBasedResNetBottleneck',
        'kwargs': {'num_bottleneck_channels': 24,
                   'num_target_channels': 256}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def _wider_latent(bottleneck):
    """Double the encoder's convolutions, so that most symbols are not 0
    (up to about +-5, in the CDF support of the untrained prior)."""
    with torch.no_grad():
        for m in bottleneck.encoder:
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(2.0)


def _eager_only(rt):
    """`rt`'s device wire with the eager encoder, the graphs' reference."""
    rt._wire_symbols = lambda xs: rt._encode_rows(xs, rt._encode_module())
    return rt


def _card_runtime(dev, graphs=True):
    torch.manual_seed(0)
    model = splittable_resnet(FP24, num_classes=1000, device=dev)
    _wider_latent(model.bottleneck_layer)
    rt = SplitClassifierRuntime(model, device=dev)
    rt.update()
    return rt.eval() if graphs else _eager_only(rt.eval())


def _card_images(n, dev, hw=(224, 224), seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((1, 3, *hw), generator=g, device=dev)
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize('k', [1, 32])
def test_replay_equals_eager_on_the_card(k):
    """FP-24 at 224x224: four launches of k distinct images (eager,
    capture, replay, replay) give each image's eager batch-1 symbols
    bitwise."""
    dev = _card()
    rt = _card_runtime(dev)
    enc = rt._encode_module()
    for launch in range(4):
        xs = _card_images(k, dev, seed=100 * k + launch)
        got, shape = rt._wire_symbols(xs)
        got = got.clone()
        want = torch.cat([rt._symbols_nhwc(x, enc)[0] for x in xs])
        torch.cuda.synchronize()
        assert torch.equal(got, want), launch
        assert float((want != 0).float().mean()) > 0.3
    assert rt._encode_graphs.captures == 1
    assert rt._encode_graphs.replays == 3 * k


@pytest.mark.cuda
def test_the_serving_loop_equals_eager_on_the_card():
    """`stream_deploy_device(wire_batch=32, depth=4)` over three requests
    of 128 images: metas, valid flags and logits bitwise those of a
    runtime without graphs."""
    dev = _card()
    runs = {}
    for graphs in (True, False):
        rt = _card_runtime(dev, graphs)
        metas, valids = [], []
        encode, decode = rt._wire_encode_batch, rt._wire_decode_batch

        def recorded_encode(xs, lanes, encode=encode, metas=metas):
            ops = encode(xs, lanes)
            metas.append(ops['meta'])
            return ops

        def recorded_decode(ops, lanes, decode=decode, valids=valids):
            out = decode(ops, lanes)
            valids.append(out[1])
            return out
        rt._wire_encode_batch = recorded_encode
        rt._wire_decode_batch = recorded_decode
        logits = [torch.cat(rt.stream_deploy_device(
            _card_images(128, dev, seed=7 + r), wire_batch=32, depth=4))
            for r in range(3)]
        runs[graphs] = (torch.cat(metas), torch.cat(valids),
                        torch.cat(logits), rt)
    (m1, v1, l1, rt), (m0, v0, l0, _) = runs[True], runs[False]
    assert torch.equal(m1, m0) and torch.equal(v1, v0)
    assert torch.equal(l1, l0)
    assert int(m1[:, 0].sum()) > 0
    assert rt._encode_graphs.captures == 1
    assert rt._encode_graphs.replays == 3 * 128 - 32


@pytest.mark.cuda
def test_the_detection_runtime_on_both_canvases():
    """The Faster R-CNN FP-24 runtime's device wire at k = 1 on 800x1344
    and 1344x800 canvases in turns: one graph a canvas, each image's
    symbols and coded meta those of the eager path."""
    from sc2bench_tpu_torch.models.detection.registry import \
        load_detection_model
    from sc2bench_tpu_torch.models.detection.wrapper import \
        SplitDetectionRuntime
    dev = _card()
    torch.manual_seed(0)
    model = load_detection_model({
        'key': 'faster_rcnn_model', 'ckpt': None,
        'kwargs': {'num_classes': 91, 'backbone_config': {
            'resnet_name': 'resnet50', 'bottleneck_config': FP24}}},
        device=dev)
    _wider_latent(model.backbone.body.bottleneck_layer)
    rt, eager = (SplitDetectionRuntime(model, device=dev) for _ in range(2))
    for r in (rt, eager):
        r.update()
        r.eval()
    _eager_only(eager)
    enc = rt._encode_module()
    for i in range(6):
        hw = (800, 1344) if i % 2 == 0 else (1344, 800)
        x = _card_images(1, dev, hw=hw, seed=50 + i)[0]
        meta = rt.encode_device_wire(x)['meta'].clone()
        got = rt._wire_symbols([x])[0].clone()
        want = rt._symbols_nhwc(x, enc)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want), (i, hw)
        assert torch.equal(meta, eager.encode_device_wire(x)['meta']), \
            (i, hw)
    assert rt._encode_graphs.captures == 2
    assert len(rt._encode_graphs._graphs) == 2
