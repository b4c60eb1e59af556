"""The joint autoregressive codec's device wire (counterpart of
`sc2bench_tpu/models/zoo_jahp_device.py`), format "jahp-lane-v1".

Both halves of coding stay on the device. The wavefront scan
(`JointAutoregressiveRuntime.forward_scan`) quantizes y front by front;
y is then coded on masked rANS lanes: lane (slot, channel), N = F x m
lanes for fronts of at most F positions, codes at most one symbol a front,
its row chosen by the symbol's scale index. A lane whose slot is a pad
slot of front t is inert at step t (no renormalisation, no state change,
no emission), so encoder and decoder renormalise at the same steps and
the time-aligned layout applies: column t of the (N, T) streams holds the
chunk of front t, and the decoder reads it there directly.

  encode  `rans_masked_encode_aligned`, one launch an image on the
          Gaussian tables' prepared form that `update()` builds once: the
          T fronts in reverse, then z on the cyclic aligned lanes
          (`rans_cyclic_encode_aligned`);
  decode  z (`rans_cyclic_decode_aligned`), h_s, then per front the
          context model (on the card four hand-written kernels,
          `zoo_jahp_front.py`; elsewhere `ContextModel.front_params`), one
          masked decode step for every lane (`rans_masked_decode_front`, on
          the Gaussian tables' prepared form that `update()` builds once)
          and the front's write into y_hat.

Wire bytes: 4 + 6N + 2 * sum(lengths) for y (header, lengths and states
as the lane wire packs them, then the chunks) plus z's lane wire. A symbol
outside its row's support cannot be coded on lanes: it clears `ok` (the
caller re-codes the image on the host wire). `valid` is true when z
decoded valid and every y lane returned to its initial state.

Each wavefront loop queues hundreds of small launches an image (on the
card four a scan front of at most 8 positions and six a decode front, the
masked step and the write included; about 15 a front as library ops),
more than the host can queue in the time the card runs them. On the card
the device wire replays each loop as one CUDA graph a latent shape
(`utils/graphs.py` `GraphCache`: the runtime's `_scan_graphs` and
`_front_graphs`, which `update()` makes anew), eager on the CPU and at a
shape's first call; a replay computes what the eager loop computes, bit
for bit, and counts its launches in
`kernels.LAUNCHES` as the eager loop does.

While a profiler runs, each stage of an image is one span
(`utils/profiling.py`), never one a front: `codec.encode` (g_a, h_a, h_s
and z's lanes), `codec.scan` (the encoder's wavefront loop),
`codec.masked_encode` (y's lanes), `codec.decode_z` (z and h_s),
`codec.fronts` (the decoder's wavefront loop) and `codec.synthesis`
(g_s); the counter `codec.front_steps` adds the fronts each loop runs,
and `codec.fused_fronts` those that the front kernels run.
"""
from __future__ import annotations

import torch

from ..ops.rans import kernels
from ..ops.rans.device import (RANS_L, auto_lanes, device_rans_decode,
                               device_rans_encode)
from ..utils.profiling import span
from .zoo import nchw


class JointAutoregressiveDeviceMixin:
    """`encode_device_wire(x)` -> ops dict on the device,
    `decode_device_wire(ops)` -> (image, valid)."""

    def _z_lanes(self, zh: int, zw: int) -> int:
        n = self.module.n
        return auto_lanes(zh * zw * n, cyclic_channels=n)

    def masked_values(self, syms: torch.Tensor, idxs: torch.Tensor, sch):
        """The masked encoder's inputs from the scan's (T, F, m) symbols
        and indexes on schedule `sch`: (values (T, N) int32 clamped into each row's coded
        support, rows (T, N) int32, ok: every active symbol in support)."""
        T = syms.shape[0]
        idx = idxs.reshape(T, -1).contiguous()
        cdf, cdf_len, off = self._g_tables_dev
        v = syms.reshape(T, -1) - off[idx]
        maxv = cdf_len[idx] - 2                 # the escape slot excluded
        lane_act = sch.active.bool().repeat_interleave(syms.shape[2], dim=1)
        ok = ((~lane_act) | ((v >= 0) & (v < maxv))).all()
        vc = torch.minimum(v.clamp_min(0), (maxv - 1).clamp_min(0))
        return vc.contiguous(), idx, ok

    @torch.no_grad()
    def encode_device_wire(self, x) -> dict:
        """The mobile side for an NCHW batch of one: g_a, h_a, h_s, the
        wavefront scan and both wires, every tensor on the device. Returns
        {'y_streams' (N, T) int32, 'y_states' (N,) int64, 'y_lengths' (N,)
        int32, 'z' (the cyclic encode's dict), 'ok', 'nbytes', 'y_hat'
        (1, m, h, w), 'shape' (h, w) of y}."""
        with span('codec.encode'):
            y, z_symbols, hyper = self._encode_ops(x)
            zh, zw = z_symbols.shape[2:]
            z_out = device_rans_encode(
                z_symbols.permute(0, 2, 3, 1).reshape(-1), *self._z_tables,
                num_lanes=self._z_lanes(zh, zw),
                cyclic_channels=self.module.n, aligned=True)
        hh, ww, m = y.shape
        sch = self.schedule(hh, ww)
        self._count_fronts(sch)
        with span('codec.scan'):
            syms, idxs, y_hat = _copies(self._scan_graphs(
                'scan', (), (y.contiguous(), hyper),
                lambda t: self._scan_loop(*t), rows=1))
        with span('codec.masked_encode'):
            vc, idx, ok = self.masked_values(syms, idxs, sch)
            streams, lengths, states = kernels.masked_encode_aligned(
                self._g_tables_dev[0], vc, idx, sch.active, m,
                prepared=self._g_prepared)
        N = idx.shape[1]
        nbytes = 4 + 6 * N + 2 * lengths.sum() + z_out['nbytes']
        return {'y_streams': streams, 'y_states': states,
                'y_lengths': lengths, 'z': z_out,
                'ok': ok & z_out['ok'], 'nbytes': nbytes,
                'y_hat': self.latent(y_hat), 'shape': (hh, ww)}

    @torch.no_grad()
    def decode_device_latent(self, ops):
        """(y_hat (1, m, h, w), valid) of `encode_device_wire`'s ops."""
        hh, ww = ops['shape']
        n = self.module.n
        zh, zw = -(-hh // 4), -(-ww // 4)
        with span('codec.decode_z'):
            z_flat, z_valid = device_rans_decode(
                ops['z']['streams'], ops['z']['states'], *self._z_tables,
                n_symbols=zh * zw * n, num_lanes=self._z_lanes(zh, zw),
                cyclic_channels=n, aligned=True)
            hyper = self._hyper(nchw(z_flat.reshape(1, zh, zw, n)))
        sch = self.schedule(hh, ww)
        self._count_fronts(sch)
        with span('codec.fronts'):
            y_hat, x = _copies(self._front_graphs(
                'fronts', (), (ops['y_streams'], ops['y_states'], hyper),
                lambda t: self._fronts_loop(sch, *t), rows=1))
        valid = z_valid & (x == RANS_L).all()
        return self.latent(y_hat), valid

    def _fronts_loop(self, sch, streams, x, hyper):
        """The decoder's wavefront loop on schedule `sch`: (halo-padded
        y_hat, the lanes' final states) of y's streams and initial states
        and the hyper feature."""
        cdf, cdf_len, off = self._g_tables_dev
        m = self.module.m
        y_hat = self._new_latent(sch.h, sch.w)
        fk = self._front_kernels
        for t in range(sch.steps):
            if fk is None:
                scales, means = self.context.front_params(
                    y_hat, hyper, sch.ii[t], sch.jj[t])
                idx = self._indexes(scales).reshape(-1)
            else:
                means, idx = fk.front(y_hat, hyper, sch, t)
            sym, x = kernels.masked_decode_front(
                streams, t, x, cdf, cdf_len, off, idx, sch.active[t], m,
                prepared=self._g_prepared)
            if fk is None:
                sch.write(y_hat, t,
                          sym.reshape(-1, m).to(torch.float32) + means)
            else:
                fk.write(y_hat, sch, t, sym, means)
        return y_hat, x

    def decode_device_wire(self, ops):
        """The server side: (NCHW image, valid)."""
        y_hat, valid = self.decode_device_latent(ops)
        with torch.no_grad(), span('codec.synthesis'):
            img = self.module.decode_image(y_hat)
        return img, valid


def _copies(out):
    """Copies of a loop's outputs, which the next replay rewrites."""
    return tuple(t.clone() for t in out)
