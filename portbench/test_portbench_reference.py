"""The plain references against the port, on the CPU at small sizes: the
same weights and inputs in, the same symbols, tables, wire bytes,
logits, detections and training steps out."""
import numpy as np
import pytest
import torch

from portbench import traffic as gen
from portbench.reference import frcnn as D
from portbench.reference import rans
from portbench.reference import resnet_fp as R
from portbench.reference import train_stage1 as T
from portbench.weights import load_into, make_state

CFG = {'bottleneck_channels': 24, 'target_channels': 256, 'num_classes': 1000}
SEED = 2 ** 31 + 77


@pytest.fixture(scope='module')
def classifier():
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    from portbench.families.split_classifier import build_student
    state = make_state(R.student_specs(CFG), SEED, 'cpu')
    rt = SplitClassifierRuntime(build_student(CFG, state, 'cpu'),
                                device='cpu')
    rt.update()
    return state, rt


def test_weights_repeat_from_the_seed():
    specs = R.bottleneck_specs('b', 24, 256)
    a, b = make_state(specs, SEED, 'cpu'), make_state(specs, SEED, 'cpu')
    c = make_state(specs, SEED + 1, 'cpu')
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['b.encoder.0.weight'], c['b.encoder.0.weight'])


def test_tables_equal_the_port(classifier):
    state, rt = classifier
    ref = rans.factorized_tables(rans.params_of(
        state, 'bottleneck_layer.entropy_bottleneck'))
    for key in ('quantized_cdf', 'cdf_length', 'offset', 'medians'):
        assert np.array_equal(ref[key], getattr(rt.codec.tables, key)), key


def test_symbols_bytes_and_logits_equal_the_port(classifier):
    state, rt = classifier
    x = torch.randn(4, 3, 40, 48, generator=torch.Generator().manual_seed(1))
    sizes, flats = [], []
    analyze, tail = rt.analyze, rt._decode_tail
    rt.analyze = lambda o: (sizes.append(len(o['strings'][0][0])),
                            analyze(o))[1]

    def capture(flat, shape, input_hw=None, module=None):
        flats.append(flat)
        return tail(flat, shape, input_hw, module)
    rt._decode_tail = capture
    try:
        out = torch.cat(rt.stream_deploy_device(list(x[:, None]),
                                                wire_batch=2))
    finally:
        rt.analyze, rt._decode_tail = analyze, tail
    with torch.no_grad():
        sym = R.symbols(state, x)
        flat = sym.permute(0, 2, 3, 1).reshape(4, -1)
        assert torch.equal(flat, torch.cat(flats))
        tables = rans.factorized_tables(rans.params_of(
            state, 'bottleneck_layer.entropy_bottleneck'))
        assert rans.wire_nbytes(flat, tables).tolist() == sizes
        assert bool(rans.in_support(flat, tables).all())
        ref = R.logits_from_symbols(state, sym)
    assert float((ref - out).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_wire_bytes_equal_the_port_coder_with_padding():
    """A lane count that does not divide the symbols: the pad rule."""
    from sc2bench_tpu_torch.ops.rans.device import device_rans_encode
    rng = np.random.default_rng(3)
    c = 4
    pmf = rng.dirichlet(np.ones(7), size=c)
    cdf = np.stack([rans.pmf_to_quantized_cdf(np.append(p, 1e-6))
                    for p in pmf])
    tables = {'quantized_cdf': cdf, 'cdf_length': np.full(c, 9, np.int32),
              'offset': np.full(c, -3, np.int32)}
    sym = torch.as_tensor(rng.integers(-3, 4, (3, 1001)), dtype=torch.int32)
    got = device_rans_encode(sym, cdf, tables['cdf_length'],
                             tables['offset'], num_lanes=32,
                             cyclic_channels=c, device='cpu')['nbytes']
    assert rans.wire_nbytes(sym, tables, lanes=32).tolist() == got.tolist()


def test_auto_lanes_equals_the_port():
    from sc2bench_tpu_torch.ops.rans.device import auto_lanes
    for n, c in ((72600, 24), (1599960, 24), (1000, 24), (64, 4)):
        assert rans.auto_lanes(n, c) == auto_lanes(n, cyclic_channels=c)


def _detector(state):
    from sc2bench_tpu_torch.models.detection.registry import \
        load_detection_model
    model = load_detection_model({
        'key': 'faster_rcnn_model', 'ckpt': None,
        'kwargs': {'num_classes': 91, 'backbone_config': {
            'resnet_name': 'resnet50', 'bottleneck_config': {
                'key': 'FPBasedResNetBottleneck',
                'kwargs': {'num_bottleneck_channels': 24,
                           'num_target_channels': 256}}}}}, device='cpu')
    return load_into(model, state).eval()


def test_detector_equals_the_port():
    cfg = dict(CFG, num_classes=91)
    state = make_state(D.specs(cfg), SEED, 'cpu')
    model = _detector(state)
    x = gen.image_pool({'count': 1, 'sizes': [[48, 64]], 'pixels': 'uniform',
                        'canvas': {'min_size': 96, 'max_size': 128}},
                       SEED, 'cpu')[0]
    canvas = tuple(x.shape[-2:])
    with torch.no_grad():
        sym = R.symbols(state, x, D.PREFIX)
        med = R.medians(state, D.PREFIX)
        out = model.forward_from_bottleneck(model.decode_ops(sym, med),
                                            canvas)
        feats = D.features(state, sym)
        for a, b in zip(out['features'], feats):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        assert torch.equal(D.anchors(feats, canvas), out['anchors'])
        props, valid = D.rpn(state, feats, canvas)
        assert torch.equal(props, out['proposals'][0])
        assert torch.equal(valid, out['proposal_valid'][0])
        logits, deltas = D.box_head(state, feats, props, canvas)
        assert float((logits - out['class_logits'][0]).abs().max()) <= 1e-5
        assert float((deltas - out['box_regression'][0]).abs().max()) <= 1e-5
        from sc2bench_tpu_torch.models.detection.rcnn import \
            postprocess_detections
        got = postprocess_detections(out)
        want = D.detections(out['class_logits'][0], out['box_regression'][0],
                            props, valid, canvas)
    for key in want:
        assert torch.equal(got[key][0], want[key]), key


def test_nms_keeps_the_greedy_set():
    from sc2bench_tpu_torch.ops.boxes import batched_nms_mask
    g = torch.Generator().manual_seed(5)
    xy = torch.rand(600, 2, generator=g) * 100
    boxes = torch.cat([xy, xy + 5 + torch.rand(600, 2, generator=g) * 30], 1)
    scores = torch.rand(600, generator=g)
    scores[::7] = scores[0]                 # ties go to the lower index
    groups = torch.randint(0, 3, (600,), generator=g)
    want = batched_nms_mask(boxes, scores, groups, 0.5, 100)
    got = D.nms(boxes, scores, groups, 0.5, 100)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][got[1]], want[0][want[1]])


def test_training_steps_equal_the_port():
    from sc2bench_tpu_torch.models.resnet import resnet50
    from sc2bench_tpu_torch.train.box import DistillationBox
    from portbench.families.split_classifier import build_student
    from portbench.harness import load_json
    stage = load_json('configs', 'ilsvrc2012-es-resnet50-fp24')['stage1']
    cfg = dict(CFG, num_classes=10)
    state = make_state(R.student_specs(cfg), SEED, 'cpu')
    tstate = make_state(R.teacher_specs(cfg), SEED + 1, 'cpu')
    box = DistillationBox(
        build_student(cfg, state, 'cpu'), stage,
        teacher=load_into(resnet50(num_classes=10), tstate),
        generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(2, 3, 32, 32, generator=g) for _ in range(2)]
    noises, losses = [], []
    for x in xs:
        state_before = box.generator.get_state()
        losses.append(box.train_step(x, None))
        n = torch.Generator()
        n.set_state(state_before)
        noises.append(torch.empty(2, 24, 7, 7).uniform_(-0.5, 0.5,
                                                        generator=n))
    ref_losses, _, after = T.train(state, tstate, xs, noises, stage)
    for got, want in zip(losses, ref_losses):
        for k, v in got['loss'].items():
            assert abs(float(v) - want[k]) <= 1e-5 * abs(want[k]), k
        assert abs(float(got['aux_loss']) - want['aux']) <= 1e-5 * want['aux']
    for name, p in box.student.named_parameters():
        assert float((p.detach() - after[name]).abs().max()) <= 1e-6, name
