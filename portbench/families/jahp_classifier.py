"""mbt2018, the joint autoregressive and hierarchical prior codec, in front
of ResNet-50: the program's `NeuralInputCompressionClassifier` with
`wire='device'`, its codec runtime `JointAutoregressiveRuntime` coding
every image on the device wire (the wavefront scan, y on the masked rANS
lanes, z on the cyclic ones, the front decoder), then the classifier on
the request's reconstructions.

The benchmark's weights go into the program's codec and classifier
(`reference/jahp.py` `codec_specs`, the scales' layer spread by
`spread_scales` on an image drawn from the seed; ResNet-50 as
`resnet_fp.teacher_specs`). The pool's images come from the one generator
normalized with ImageNet's mean and std on a canvas of their own size;
each request maps them back to [0, 1] pixels (x * std + mean), the
codec's input. Program attributes wrapped from outside for the check: the
codec runtime's `encode_device_wire` (with `_encode_ops`: z's symbols, and
`masked_values`: y's symbols and rows a front), `decode_device_latent`
(the decoded latent), `decode_device_wire` (the reconstruction) and the
wrapper's `analyze` (each image's wire size).

`correct` compares, on the captured requests' images that stayed on the
device wire (module `check`):
    symbol_mismatch_share  decoded latent values that differ from the
                           reference's round(y - mean) + mean, the mean
                           from the context model teacher-forced on that
                           latent, plus the scale rows and z's symbols
                           that differ, a share of all three
    nbytes_gap             |program wire bytes - the reference's count of
                           the program's symbols and rows|, worst image
    escape_gap             |images the program re-coded on the host wire -
                           images whose serial reference symbols leave the
                           tables' support|, over the whole window
    invalid_images         decodes that did not return to the lanes'
                           initial states, over the whole window
    recon_gap              max |program g_s output - the reference's g_s
                           of the program's latent| over the reference's
                           largest |value|, worst image
    logit_gap              max |program logits - the reference ResNet-50's
                           of that reference reconstruction| over the
                           reference's largest |logit|, worst image
"""
from __future__ import annotations

import torch

from ..reference import jahp as J
from ..reference import rans
from ..reference import resnet_fp as R
from ..roofline import count_flops
from ..roofline_masked import masked_bounds
from ..traffic import IMAGENET_MEAN, IMAGENET_STD
from ..weights import load_into, make_state
from .split_classifier import tf32

REF_BLOCK = 16


def build(config, traffic, seed, device):
    return JahpServer(config, traffic, seed, device)


def calibration_image(seed, hw, device):
    """The image on which `spread_scales` sets the scales: uniform pixels
    from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 7) % (1 << 63))
    return torch.rand((1, 3, *hw), generator=g, device=device)


class JahpServer:
    """The wrapper serving requests of images; see the module doc."""

    ranges = ()

    def __init__(self, config, traffic, seed, device):
        from sc2bench_tpu_torch.models.resnet import resnet50
        from sc2bench_tpu_torch.models.wrapper import \
            NeuralInputCompressionClassifier
        from sc2bench_tpu_torch.models.zoo_jahp import (
            JointAutoregressiveCodec, JointAutoregressiveRuntime)
        cfg = config['model']
        self.n, self.m = cfg['n'], cfg['m']
        self.factor = cfg['pad_factor']
        self.device = torch.device(device)
        self.state = J.codec_state(make_state(
            J.codec_specs(self.n, self.m), seed, self.device), self.m)
        J.spread_scales(self.state, self.m, J.pad(calibration_image(
            seed, cfg['input_size'], self.device), self.factor))
        self.tstate = make_state(R.teacher_specs(
            {'num_classes': cfg['num_classes']}), int(seed) ^ 0x5EED,
            self.device)
        codec = load_into(JointAutoregressiveCodec(n=self.n, m=self.m).to(
            self.device), self.state)
        self.rt = JointAutoregressiveRuntime(codec, device=self.device)
        self.rt.update()
        classifier = load_into(resnet50(num_classes=cfg['num_classes']).to(
            self.device), self.tstate)
        self.wrapper = NeuralInputCompressionClassifier(
            classifier, compression_model=self.rt,
            pre_transform=[{'key': 'AdaptivePad',
                            'kwargs': {'factor': self.factor}}],
            analysis_config={'analyzes_after_compress': True,
                             'analyzer_configs': [
                                 {'key': 'FileSizeAnalyzer',
                                  'kwargs': {'unit': 'KB'}}]},
            device=self.device, **traffic.get('serve', {}))
        if getattr(self.wrapper, 'wire', 'host') != \
                traffic.get('serve', {}).get('wire', 'host'):
            raise RuntimeError('the program\'s wrapper has no device wire')
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device)[
            :, None, None]
        self.std = torch.tensor(IMAGENET_STD, device=self.device)[
            :, None, None]
        self.input_hw = tuple(cfg['input_size'])
        self._rec, self._in_encode = None, False
        self._wrap_program()

    def _wrap_program(self):
        """Capture what the check reads while a request is captured."""
        rt, wrapper = self.rt, self.wrapper
        encode, encode_ops = rt.encode_device_wire, rt._encode_ops
        masked_values = rt.masked_values
        decode_latent, decode_wire = rt.decode_device_latent, \
            rt.decode_device_wire
        analyze = wrapper.analyze

        def put(key, value):
            if self._rec is not None:
                self._rec[key].append(value)

        def encoded(x):
            self._in_encode = True
            try:
                return encode(x)
            finally:
                self._in_encode = False

        def ops_of(x):
            y, z_symbols, hyper = encode_ops(x)
            if self._in_encode:
                put('z', z_symbols)
            return y, z_symbols, hyper

        def values(syms, idxs, sch):
            put('syms', syms)
            put('idxs', idxs)
            return masked_values(syms, idxs, sch)

        def latent(ops):
            y_hat, valid = decode_latent(ops)
            put('latents', y_hat)
            return y_hat, valid

        def recon(ops):
            img, valid = decode_wire(ops)
            put('recon', img)
            return img, valid

        def sized(obj):
            # the device wire's object holds its bytes alone; an escaped
            # image's host-wire object has its shape too
            put('nbytes', None if 'shape' in obj
                else len(obj['strings'][0][0]))
            return analyze(obj)

        rt.encode_device_wire, rt._encode_ops = encoded, ops_of
        rt.masked_values = values
        rt.decode_device_latent, rt.decode_device_wire = latent, recon
        wrapper.analyze = sized

    # ---- the driver's calls -------------------------------------------------
    def reset(self):
        self.wrapper.escapes = {'ok': 0}
        self.wrapper.invalid = 0
        self.wrapper.clear_analysis()

    def serve(self, images, capture=False):
        """One request: its logits on the host; with `capture`, also the
        record the check reads."""
        if capture:
            self._rec = {k: [] for k in ('z', 'syms', 'idxs', 'latents',
                                         'recon', 'nbytes')}
        pixels = [x * self.std + self.mean for x in images]
        try:
            out = self.wrapper(pixels).cpu()
        finally:
            rec, self._rec = self._rec, None
        if not capture:
            return out, None
        rec.update(images=pixels, outputs=out)
        return out, rec

    def counters(self):
        return {}

    def spans(self):
        return []

    def finish(self):
        """Read the window's counters the check needs, then free the
        program."""
        self._escapes = self.wrapper.escapes['ok']
        self._invalid = self.wrapper.invalid
        self.wrapper = self.rt = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # ---- the yardstick ------------------------------------------------------
    def _latent_hw(self):
        h, w = (-(-s // self.factor) * self.factor for s in self.input_hw)
        return h // 16, w // 16

    def flops_per_image(self):
        """g_a, h_a, h_s, the context model and entropy parameters at every
        position once, g_s and ResNet-50 on the padded image, on meta
        tensors."""
        sd = {k: v.to('meta') for k, v in self.state.items()}
        tsd = {k: v.to('meta') for k, v in self.tstate.items()}
        h, w = self._latent_hw()
        x = torch.empty((1, 3, 16 * h, 16 * w), device='meta')
        return count_flops(lambda: J.flops_of_image(sd, tsd, x))

    def masked_bounds(self):
        """{kernel name part: bound seconds a launch} at the served
        shape."""
        _, _, act = J.lane_layout(*self._latent_hw())
        return masked_bounds(act.sum(dim=1).tolist(), self.m)

    def tables(self):
        return J.gaussian_tables(), rans.factorized_tables(
            rans.params_of(self.state, J.EB))

    @torch.no_grad()
    def check(self, records, served, pool, stand_in=None):
        """The numbers of the module doc over the captured `records`;
        `served` images were served from `pool` in turn. `stand_in`
        'tf32' puts the reference, computed with TF32 on, in the
        program's place (the control)."""
        sd, tsd = self.state, self.tstate
        g_tables, z_tables = self.tables()
        layout = J.lane_layout(*self._latent_hw())
        act = layout[2]
        mism = total = nbytes_gap = 0
        recon_gap = logit_gap = 0.0
        for rec in records:
            for i, img in enumerate(rec['images']):
                if rec['nbytes'][i] is None:
                    continue
                x = J.pad(img, self.factor)
                y = J.analysis(sd, x)
                zs = J.z_symbols(sd, y)
                hyper = J.hyper_from_symbols(sd, zs)
                if stand_in:
                    got = self._stand_in(x, rec['latents'][i], layout)
                    got['nbytes'] = J.y_lane_nbytes(
                        got['syms'], got['idxs'], act, g_tables) \
                        + J.z_nbytes(got['z'], z_tables)
                else:
                    got = {k: rec[k][i] for k in ('z', 'syms', 'idxs',
                                                  'latents', 'recon',
                                                  'nbytes')}
                    got['logits'] = rec['outputs'][i:i + 1].to(x.device)
                latent = got['latents']
                scales, means = J.gaussian_params(sd, hyper, latent)
                want = torch.round(y - means) + means
                idx = J.on_lanes(J.scale_indexes(scales)[0], layout)[act]
                mism += int(((want - latent).abs() > 0.5).sum()) \
                    + int((got['idxs'][act] != idx).sum()) \
                    + int((got['z'] != zs).sum())
                total += want.numel() + idx.numel() + zs.numel()
                nbytes_gap = max(nbytes_gap, abs(
                    got['nbytes'] - J.y_lane_nbytes(got['syms'],
                                                    got['idxs'], act,
                                                    g_tables)
                    - J.z_nbytes(got['z'], z_tables)))
                ref_img = J.synthesis(sd, latent)
                recon_gap = max(recon_gap, float(
                    (got['recon'] - ref_img).abs().max()
                    / ref_img.abs().max()))
                ref_logits = J.logits(tsd, ref_img)
                logit_gap = max(logit_gap, float(
                    (got['logits'] - ref_logits).abs().max()
                    / ref_logits.abs().max()))
        return {'symbol_mismatch_share': mism / max(total, 1),
                'nbytes_gap': nbytes_gap,
                'escape_gap': 0 if stand_in else abs(
                    self._escapes - self.expected_escapes(served, pool)),
                'invalid_images': 0 if stand_in else self._invalid,
                'recon_gap': recon_gap, 'logit_gap': logit_gap}

    def _stand_in(self, x, latent, layout):
        """The reference's outputs with TF32 on, in the program's place,
        its context model teacher-forced on the program's latent."""
        sd, tsd = self.state, self.tstate
        with tf32(True):
            y = J.analysis(sd, x)
            zs = J.z_symbols(sd, y)
            scales, means = J.gaussian_params(
                sd, J.hyper_from_symbols(sd, zs), latent)
            sym = torch.round(y - means)
            own = sym + means
            recon = J.synthesis(sd, own)
            logits = J.logits(tsd, recon)
        return {'z': zs, 'latents': own, 'recon': recon, 'logits': logits,
                'syms': J.on_lanes(sym[0].to(torch.int32), layout),
                'idxs': J.on_lanes(J.scale_indexes(scales)[0], layout)}

    def expected_escapes(self, served, pool):
        """Images among the `served` (pool taken in turn) whose serial
        reference symbols leave their tables' support."""
        sd = self.state
        g_tables, z_tables = self.tables()
        bad = []
        for lo in range(0, len(pool), REF_BLOCK):
            x = J.pad(torch.cat([p * self.std + self.mean
                                 for p in pool[lo:lo + REF_BLOCK]]),
                      self.factor)
            y = J.analysis(sd, x)
            zs = J.z_symbols(sd, y)
            _, sym, idx = J.serial_latent(sd, y, J.hyper_from_symbols(sd,
                                                                      zs))
            z_ok = rans.in_support(zs.permute(0, 2, 3, 1).reshape(
                len(x), -1), z_tables)
            bad += [not (bool(z_ok[k]) and J.y_in_support(sym[k], idx[k],
                                                          g_tables))
                    for k in range(len(x))]
        p = len(pool)
        return sum(served // p + (1 if i < served % p else 0)
                   for i, b in enumerate(bad) if b)
