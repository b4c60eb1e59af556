"""Faster R-CNN R50-FPN behind the FP bottleneck, served on the device
wire (`SplitDetectionRuntime.stream_detect_device`).

The benchmark's weights go into the program's detector, the runtime
builds its coding tables, and each request is one call of
`stream_detect_device` on one canvas; its detections (boxes, scores,
labels, valid) come back to the host. Wrapped from outside for the check,
besides the classifier's `analyze` and `_decode_tail`: the detection
module's `postprocess_detections`, whose input (the proposals and the box
head's class logits and box regression) a captured request keeps; and in
a traced run `batched_nms_mask` and `multiscale_roi_align`, as the
ranges `nms` and `roi_align`.

`correct` compares, on the captured requests:
    symbol_mismatch_share  as the classifier's
    nbytes_gap, escape_gap as the classifier's
    proposal_mismatch_share  proposals (of either side) that the other
                           side lacks (IoU under 0.999), over both sides'
                           valid proposals: the reference's RPN on the
                           decoded symbols against the program's
    head_gap               max |program - reference| of the box head's
                           class logits and box regression on the
                           program's proposals, over the reference's
                           largest magnitude, worst of the two, worst
                           image
    detection_mismatch     final detection slots (of 100 an image) whose
                           box, score, label or validity differ from the
                           reference's detections of the program's head
                           outputs: an exact comparison
"""
from __future__ import annotations

import torch

from ..reference import frcnn as D
from ..reference import rans
from ..reference import resnet_fp as R
from ..roofline import count_flops
from ..weights import load_into, make_state
from .split_classifier import ClassifierServer, _nchw, _nhwc, tf32

PREFIX = D.PREFIX
MATCH_IOU = 0.999


def build(config, traffic, seed, device):
    return DetectionServer(config, traffic, seed, device)


class DetectionServer(ClassifierServer):
    ranges = ('nms', 'roi_align')
    prefix = PREFIX

    def __init__(self, config, traffic, seed, device):
        from sc2bench_tpu_torch.models.detection import rcnn
        from sc2bench_tpu_torch.models.detection.registry import \
            load_detection_model
        from sc2bench_tpu_torch.models.detection.wrapper import \
            SplitDetectionRuntime
        self.cfg = config['model']
        self.device = torch.device(device)
        self.serve_kwargs = dict(traffic.get('serve', {}))
        self.state = make_state(D.specs(self.cfg), seed, self.device)
        model = load_detection_model({
            'key': 'faster_rcnn_model', 'ckpt': None,
            'kwargs': {'num_classes': self.cfg['num_classes'],
                       'backbone_config': {
                           'resnet_name': 'resnet50',
                           'bottleneck_config': {
                               'key': 'FPBasedResNetBottleneck',
                               'kwargs': {
                                   'num_bottleneck_channels':
                                       self.cfg['bottleneck_channels'],
                                   'num_target_channels':
                                       self.cfg['target_channels']}}}}},
            device=self.device)
        self.rt = SplitDetectionRuntime(load_into(model, self.state),
                                        device=self.device)
        self.rt.update()
        self.rt.eval()
        self.timings = {}
        self._sizes, self._flats, self._heads = [], [], []
        self._capture = False
        self._rcnn = rcnn
        self._wrap_runtime()
        post = rcnn.postprocess_detections

        def captured(outputs, *args, **kwargs):
            if self._capture:
                self._heads.append({k: outputs[k] for k in (
                    'proposals', 'proposal_valid', 'class_logits',
                    'box_regression')})
            return post(outputs, *args, **kwargs)

        self._post = post
        rcnn.postprocess_detections = captured

    def serve(self, images, capture=False):
        self._heads.clear()
        out, rec = super().serve(images, capture)
        if rec is not None:
            rec['heads'] = list(self._heads)
        return out, rec

    def _call(self, images):
        out = self.rt.stream_detect_device(images, timings=self.timings,
                                           **self.serve_kwargs)
        return [{k: v.cpu() for k, v in d.items()} for d in out]

    def spans(self):
        return [(self._rcnn, 'batched_nms_mask', 'nms'),
                (self._rcnn, 'multiscale_roi_align', 'roi_align'),
                (self.rt, '_wire_encode', 'wire_encode'),
                (self.rt, '_wire_decode', 'wire_decode')]

    def close(self):
        self._rcnn.postprocess_detections = self._post
        super().close()

    # ---- the yardstick ------------------------------------------------------
    def flops_per_image(self):
        sd = {k: v.to('meta') for k, v in self.state.items()}
        x = torch.empty((1, 3, *self.input_hw), device='meta')

        def one():
            sym = R.symbols(sd, x, PREFIX)
            D.flops_forward(sd, sym.to(torch.float32), self.input_hw)
        return count_flops(one)

    @torch.no_grad()
    def check(self, records, served, pool, stand_in=None):
        sd, tables = self.state, self.tables()
        mismatch = total = 0
        nbytes_gap, head_gap = 0, 0.0
        prop_diff = prop_total = 0
        det_diff = 0
        for rec in records:
            for i, x in enumerate(rec['images']):
                canvas = tuple(x.shape[-2:])
                ref4 = R.symbols(sd, x, PREFIX)
                ref = _nhwc(ref4)
                if stand_in:
                    got, heads, dets = self._stand_in(x, stand_in)
                    nbytes = rans.wire_nbytes(got, tables)
                else:
                    got = rec['symbols'][i:i + 1]
                    heads = {k: v[0] for k, v in rec['heads'][i].items()}
                    dets = {k: v[0].to(x.device)
                            for k, v in rec['outputs'][i].items()}
                    nbytes = torch.as_tensor(rec['nbytes'][i:i + 1],
                                             device=x.device)
                mismatch += int((got != ref).sum())
                total += got.numel()
                nbytes_gap = max(nbytes_gap, int(
                    (nbytes - rans.wire_nbytes(got, tables)).abs().max()))
                feats = D.features(sd, _nchw(got, ref4.shape))
                props, valid = D.rpn(sd, feats, canvas)
                d, t = _proposal_mismatch(heads['proposals'],
                                          heads['proposal_valid'], props,
                                          valid)
                prop_diff += d
                prop_total += t
                logits, deltas = D.box_head(sd, feats, heads['proposals'],
                                            canvas)
                head_gap = max(head_gap, _gap(heads['class_logits'], logits),
                               _gap(heads['box_regression'], deltas))
                want = D.detections(heads['class_logits'],
                                    heads['box_regression'],
                                    heads['proposals'],
                                    heads['proposal_valid'], canvas)
                det_diff += _detection_mismatch(dets, want)
        return {'symbol_mismatch_share': mismatch / max(total, 1),
                'nbytes_gap': nbytes_gap,
                'escape_gap': 0 if stand_in else abs(
                    self._escapes - self.expected_escapes(served, pool)),
                'proposal_mismatch_share': prop_diff / max(prop_total, 1),
                'head_gap': head_gap,
                'detection_mismatch': det_diff}

    def _stand_in(self, x, kind):
        """The reference in the program's place, TF32 on: (symbols, head
        inputs and outputs, detections) of one canvas."""
        if kind != 'tf32':
            raise KeyError(f'no stand-in {kind!r} for the detector')
        sd, canvas = self.state, tuple(x.shape[-2:])
        with tf32(True):
            sym = R.symbols(sd, x, PREFIX)
            feats = D.features(sd, sym)
            props, valid = D.rpn(sd, feats, canvas)
            logits, deltas = D.box_head(sd, feats, props, canvas)
        heads = {'proposals': props, 'proposal_valid': valid,
                 'class_logits': logits, 'box_regression': deltas}
        return _nhwc(sym), heads, D.detections(logits, deltas, props, valid,
                                               canvas)


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _proposal_mismatch(p_boxes, p_valid, r_boxes, r_valid):
    """(proposals of either side unmatched on the other, valid proposals
    of both sides)."""
    a, b = p_boxes[p_valid], r_boxes[r_valid]
    if len(a) == 0 or len(b) == 0:
        return len(a) + len(b), len(a) + len(b)
    m = D.iou(a, b) >= MATCH_IOU
    return (int((~m.any(1)).sum()) + int((~m.any(0)).sum()),
            len(a) + len(b))


def _detection_mismatch(got, want):
    """Slots whose box, score, label or validity differ."""
    diff = (got['labels'] != want['labels']) \
        | (got['valid'] != want['valid']) \
        | (got['scores'] != want['scores']) \
        | (got['boxes'] != want['boxes']).any(-1)
    return int(diff.sum())
