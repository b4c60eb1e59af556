"""The splittable ResNet-50 + FP bottleneck, served on the device wire
(`SplitClassifierRuntime.stream_deploy_device`) and trained in stage 1
(`DistillationBox.train_step`) of the Entropic Student.

Serving: the benchmark's weights go into the program's model, the runtime
builds its coding tables, and each request is one call of
`stream_deploy_device` with the traffic mix's `serve` arguments; its
logits come back to the host. Two program attributes are wrapped from
outside for the check: the runtime's `analyze` (each image's wire size)
and `_decode_tail` (the decoded symbols of a captured request).

`correct` compares, on the captured requests (module `check`):
    symbol_mismatch_share  decoded symbols that differ from the
                           reference encoder's, a share of all
    nbytes_gap             |program wire bytes - the reference coder's
                           bytes for the decoded symbols|, worst image
    escape_gap             |images the program re-coded on the host -
                           images the reference finds out of support|,
                           over the whole window
    logit_gap              max |program logits - reference logits of the
                           decoded symbols|, over the reference's largest
                           |logit|, worst request
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..reference import rans
from ..reference import resnet_fp as R
from ..roofline import count_flops, rans_bound_s
from ..weights import load_into, make_state

REF_BLOCK = 32


@contextlib.contextmanager
def tf32(on):
    """TF32 for convolutions and matrix products on (the lower-precision
    control) or off (the configuration's float32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def build_student(model_cfg, state, device):
    from sc2bench_tpu_torch.models.backbone import splittable_resnet
    model = splittable_resnet(
        {'key': 'FPBasedResNetBottleneck',
         'kwargs': {'num_bottleneck_channels': model_cfg['bottleneck_channels'],
                    'num_target_channels': model_cfg['target_channels']}},
        resnet_name='resnet50', num_classes=model_cfg['num_classes'],
        device=device)
    return load_into(model, state)


def build(config, traffic, seed, device):
    if traffic['driver'] == 'train_steps':
        from .stage1_trainer import Stage1Trainer
        return Stage1Trainer(config, traffic, seed, device)
    return ClassifierServer(config, traffic, seed, device)


class ClassifierServer:
    """One runtime serving requests of images; see the module doc."""

    ranges = ()
    prefix = 'bottleneck_layer'

    def __init__(self, config, traffic, seed, device):
        from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
        self.cfg = config['model']
        self.device = torch.device(device)
        self.serve_kwargs = dict(traffic.get('serve', {}))
        self.state = make_state(R.student_specs(self.cfg), seed, self.device)
        self.rt = SplitClassifierRuntime(
            build_student(self.cfg, self.state, self.device),
            device=self.device)
        self.rt.update()
        self.rt.eval()
        self.timings = {}
        self._sizes, self._flats, self._capture = [], [], False
        self._wrap_runtime()

    def _wrap_runtime(self):
        """Wrap the runtime's `analyze` (each image's wire size) and
        `_decode_tail` (a captured request's decoded symbols)."""
        analyze, decode_tail = self.rt.analyze, self.rt._decode_tail

        def sized(obj):
            self._sizes.append(len(obj['strings'][0][0]))
            return analyze(obj)

        def captured(flat, shape, input_hw=None, module=None):
            if self._capture:
                self._flats.append(flat.reshape(-1, math.prod(shape)))
            return decode_tail(flat, shape, input_hw, module)

        self.rt.analyze = sized
        self.rt._decode_tail = captured

    # ---- the driver's calls -------------------------------------------------
    def reset(self):
        """Zero the counters at the start of the window."""
        self.timings.clear()
        self.rt.escapes = {'ok': 0, 'valid': 0}
        self.rt.clear_analysis()

    def serve(self, images, capture=False):
        """One request: its outputs on the host; with `capture`, also the
        record the check reads."""
        self._sizes.clear()
        self._flats.clear()
        self._capture = capture
        self.input_hw = tuple(images[0].shape[-2:])
        out = self._call(images)
        self._capture = False
        if not capture:
            return out, None
        return out, {'images': list(images), 'outputs': out,
                     'symbols': torch.cat(self._flats),
                     'nbytes': list(self._sizes)}

    def _call(self, images):
        """The timed call; its outputs on the host."""
        out = self.rt.stream_deploy_device(images, timings=self.timings,
                                           **self.serve_kwargs)
        return torch.cat(out).cpu()

    def counters(self):
        return {'timings': dict(self.timings)}

    def spans(self):
        """(owner, attribute, range) wrapped in a traced run."""
        return [(self.rt, '_wire_encode_batch', 'wire_encode'),
                (self.rt, '_wire_decode_batch', 'wire_decode'),
                (self.rt, '_wire_encode', 'wire_encode'),
                (self.rt, '_wire_decode', 'wire_decode')]

    def close(self):
        """Free the program's state before the reference runs."""
        self.rt = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ---- the yardstick ------------------------------------------------------
    def tables(self):
        return rans.factorized_tables(rans.params_of(
            self.state, f'{self.prefix}.entropy_bottleneck'))

    def flops_per_image(self):
        """Encoder, decoder, tail and fc of one image of the served size,
        on meta tensors."""
        sd = {k: v.to('meta') for k, v in self.state.items()}
        x = torch.empty((1, 3, *self.input_hw), device='meta')

        def one():
            R.logits_from_symbols(sd, R.symbols(sd, x).to(torch.float32))
        return count_flops(one)

    def rans_bounds(self):
        """{kernel name part: bound seconds a launch} at the served
        shapes: the aligned pair over `wire_batch` images, or the batch-1
        pair."""
        t = self.tables()
        c = t['quantized_cdf'].shape[0]
        h, w = self.input_hw
        for _ in range(2):
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        n = (h - 1) * (w - 1) * c
        lanes = rans.auto_lanes(n, c)
        steps = -(-n // lanes)
        cols = t['quantized_cdf'].shape[1]
        search = int(t['cdf_length'][[j % c for j in range(lanes)]].sum())
        k = int(self.serve_kwargs.get('wire_batch') or 1)
        shape = (lanes, steps, cols, search)
        if k > 1:
            return {'rans_encode_aligned': rans_bound_s('encode', k, *shape),
                    'rans_decode_aligned': rans_bound_s('decode', k, *shape)}
        return {'rans_encode_warp': rans_bound_s('encode', 1, *shape),
                'rans_decode_warp': rans_bound_s('decode', 1, *shape)}

    @torch.no_grad()
    def check(self, records, served, pool, stand_in=None):
        """The numbers of the module doc over the captured `records`;
        `served` images were served from `pool` in turn. `stand_in` puts
        the reference in the program's place: 'tf32' computes it with
        TF32 on (the control), 'reorder' in float32 on blocks of
        another size (a witness of float32's own rounding)."""
        sd, tables = self.state, self.tables()
        mismatch = total = 0
        nbytes_gap, logit_gap = 0, 0.0
        for rec in records:
            x = torch.cat(rec['images'])
            for lo in range(0, len(x), REF_BLOCK):
                xb = x[lo:lo + REF_BLOCK]
                ref4 = R.symbols(sd, xb)
                ref = _nhwc(ref4)
                if stand_in:
                    got, logits = self._stand_in(xb, stand_in)
                    nbytes = rans.wire_nbytes(got, tables)
                else:
                    got = rec['symbols'][lo:lo + REF_BLOCK]
                    logits = rec['outputs'][lo:lo + REF_BLOCK].to(xb.device)
                    nbytes = torch.as_tensor(
                        rec['nbytes'][lo:lo + REF_BLOCK], device=xb.device)
                mismatch += int((got != ref).sum())
                total += got.numel()
                nbytes_gap = max(nbytes_gap, int(
                    (nbytes - rans.wire_nbytes(got, tables)).abs().max()))
                want = R.logits_from_symbols(sd, _nchw(got, ref4.shape))
                logit_gap = max(logit_gap, float(
                    (logits - want).abs().max() / want.abs().max()))
        return {'symbol_mismatch_share': mismatch / max(total, 1),
                'nbytes_gap': nbytes_gap,
                'escape_gap': 0 if stand_in else abs(
                    self._escapes - self.expected_escapes(served, pool)),
                'logit_gap': logit_gap}

    def _stand_in(self, x, kind):
        """The reference's (symbols, logits) of images x, in the program's
        place: TF32 on, or float32 one image (symbols) and seven images
        (logits) at a time."""
        sd = self.state
        if kind == 'tf32':
            with tf32(True):
                sym = R.symbols(sd, x)
                return _nhwc(sym), R.logits_from_symbols(sd, sym)
        sym = torch.cat([R.symbols(sd, x[i:i + 1]) for i in range(len(x))])
        return _nhwc(sym), torch.cat([
            R.logits_from_symbols(sd, sym[i:i + 7])
            for i in range(0, len(x), 7)])

    def expected_escapes(self, served, pool):
        """Images among the `served` (pool taken in turn) whose symbols
        leave the CDF support."""
        tables = self.tables()
        bad = [not bool(rans.in_support(_nhwc(R.symbols(
            self.state, x, self.prefix)), tables)) for x in pool]
        p = len(pool)
        return sum(served // p + (1 if i < served % p else 0)
                   for i, b in enumerate(bad) if b)

    def finish(self):
        """Read the window's counters the check needs, then free the
        program."""
        self._escapes = sum(self.rt.escapes.values())
        self.close()


def _nhwc(sym):
    """NCHW symbols -> (n, h*w*c), the wire's channels-last order."""
    return sym.permute(0, 2, 3, 1).reshape(sym.shape[0], -1)


def _nchw(flat, shape):
    """Inverse of `_nhwc` for an NCHW `shape`."""
    n, c, h, w = shape
    return flat.reshape(n, h, w, c).permute(0, 3, 1, 2).contiguous()
