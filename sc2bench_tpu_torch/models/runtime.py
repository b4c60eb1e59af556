"""Deploy-path runtime (counterpart of `sc2bench_tpu/models/runtime.py`).

`SplitClassifierRuntime` owns the model, its coding tables (built by
`update()`) and the analyzers, and serves the device-rANS wire:

    encode_device_wire     image -> encoder -> round(y - median) -> rANS
                           streams on the device (rANS encode kernel)
    decode_device_streams  streams -> rANS decode kernel -> IGDN decoder
                           -> ResNet layer2-4 -> logits

`stream_deploy_device` runs that loop over a stream of images, batch 1 or
`wire_batch=k` images per coding launch (time-aligned streams), and
accounts each image's exact wire size.

`stream_deploy` is the same loop with the entropy coding on the host (the
JAX runtime's default wire): int16 symbols cross to the host, the cyclic
int16 coder of `ops/rans/coder.py` codes and decodes them, and the
decoded symbols go back to the device for the decoder and tail.
`__call__` is the reference's forward: deploy through `encode`/`decode`
once the tables are built, the 'finetune' forward while training, and the
'train' (noise) forward before `update()`.

The host CompressAI-format coder (`encode`/`decode`, `ops/rans/coder.py`)
is also the escape path: an image whose latent leaves the CDF support
(`ok=False`) or whose device decode fails (`valid=False`) is re-coded on
the host, accounted with those bytes, and served from that path's logits,
as in the JAX runtime. `SplitClassifierRuntime.escapes` counts them by the
check that failed. `ok=False` is a property of the data; the device coder
is exact, so `valid=False` means a faulty kernel or stream, and each one is
also logged as a warning.

Numerics: symbols are bit-identical to the float32 reference only if the
encoder runs in true float32. cuDNN runs float32 convolutions in TF32 by
default, which moves symbols across rounding boundaries, so a runtime on a
CUDA device sets `torch.backends.cudnn.allow_tf32 = False` and
`torch.backends.cuda.matmul.allow_tf32 = False` (process-wide flags).
"""
from __future__ import annotations

import logging
import time
from collections import deque

import numpy as np
import torch

from ..analysis import AnalyzerHolder
from ..device import resolve_device
from ..ops.entropy.tables import CodingTables, build_factorized_tables
from ..ops.rans.coder import RansCoder
from ..ops.rans.device import (auto_lanes, device_rans_decode,
                               device_rans_encode, pack_stream)
from .layer import FPBasedResNetBottleneck

logger = logging.getLogger(__name__)


def add_timing(timings, key, dt):
    """Accumulate into a caller-owned timings dict (None: no-op)."""
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + dt


def _channel_major(symbols: np.ndarray) -> np.ndarray:
    """(h, w, c) -> channel-major flat order (c, h*w) for per-channel CDFs."""
    return np.transpose(symbols, (2, 0, 1)).reshape(symbols.shape[-1], -1)


class FactorizedCodec:
    """Coding tables and host coder for an `EntropyBottleneck`-only
    bottleneck (FP)."""

    def __init__(self):
        self.tables: CodingTables | None = None
        self.coder: RansCoder | None = None

    def update(self, module):
        self.tables = build_factorized_tables(
            module.bottleneck_layer.entropy_bottleneck)
        self.coder = RansCoder(self.tables.quantized_cdf,
                               self.tables.cdf_length, self.tables.offset)

    def compress_symbols(self, symbols: np.ndarray):
        """symbols: (n, h, w, c) int32 -> list of per-sample byte strings,
        coded channel-major (symbol order of the JAX codec)."""
        n, h, w, c = symbols.shape
        indexes = np.repeat(np.arange(c, dtype=np.int32), h * w)
        return [self.coder.encode_with_indexes(
            _channel_major(symbols[i]).ravel(), indexes) for i in range(n)]

    def decompress_symbols(self, strings, shape, channels):
        """Inverse of `compress_symbols`: -> (n, h, w, c) int32."""
        h, w = shape
        indexes = np.repeat(np.arange(channels, dtype=np.int32), h * w)
        out = []
        for s in strings:
            flat = self.coder.decode_with_indexes(s, indexes)
            out.append(np.transpose(flat.reshape(channels, h, w), (1, 2, 0)))
        return np.stack(out)

    def compress_wire(self, symbols: np.ndarray):
        """symbols: (n, h, w, c) int16, the device layout -> per-sample byte
        strings on the cyclic int16 wire: the NHWC ravel, symbol i coded
        with channel i mod c (the host reorders nothing)."""
        n, h, w, c = symbols.shape
        flat = symbols.reshape(n, -1)
        return [self.coder.encode_cyclic_i16(flat[i], c) for i in range(n)]

    def decompress_wire(self, strings, shape, channels):
        """Inverse of `compress_wire`: -> (n, h, w, c) int16."""
        h, w = shape
        return np.stack([
            self.coder.decode_cyclic_i16(s, h * w * channels,
                                         channels).reshape(h, w, channels)
            for s in strings])


class SplitClassifierRuntime(AnalyzerHolder):
    """Runtime for `SplittableResNet` with an FP bottleneck: `update()`,
    `bottleneck_updated`, the analyzable surface and the device-rANS wire.
    Images are NCHW tensors (or arrays): float, or uint8 when the runtime
    has `input_norm=(mean, std)`."""

    def __init__(self, module, analyzer_configs=None, analysis_unit='KB',
                 input_norm=None, device=None):
        if analyzer_configs is None:
            analyzer_configs = [{'key': 'FileSizeAnalyzer',
                                 'kwargs': {'unit': analysis_unit}}]
        super().__init__(analyzer_configs)
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            # true float32 encoder: byte-identical bitstreams (module doc)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.module = module.to(self.device).eval()
        self.bottleneck_updated = False
        self.training = False
        # uint8 images are converted to (x/255 - mean)/std on the device
        if input_norm is not None:
            mean, std = input_norm
            self._norm_mean = torch.as_tensor(mean, dtype=torch.float32,
                                              device=self.device)
            self._norm_std = torch.as_tensor(std, dtype=torch.float32,
                                             device=self.device)
        else:
            self._norm_mean = None
        self._bneck = module.bottleneck_layer
        if not isinstance(self._bneck, FPBasedResNetBottleneck):
            raise NotImplementedError(
                f'{type(self._bneck).__name__} is not ported yet; the port '
                'serves the FP bottleneck')
        self.codec = FactorizedCodec()
        # images re-coded on the host coder, by the check they failed
        self.escapes = {'ok': 0, 'valid': 0}
        self._medians = None
        self._tables_dev = None

    # ---- reference API surface -----------------------------------------
    def update(self):
        """Build the coding tables from the learned entropy-bottleneck
        parameters and keep device copies for the wire."""
        self.codec.update(self.module)
        t = self.codec.tables
        self._medians = torch.as_tensor(t.medians, device=self.device)
        self._tables_dev = tuple(
            torch.as_tensor(a, dtype=torch.int32, device=self.device)
            for a in (t.quantized_cdf, t.cdf_length, t.offset))
        self.bottleneck_updated = True
        return True

    def get_aux_module(self):
        return self._bneck

    def train(self, mode=True):
        """Set the flag `__call__` dispatches on. The module stays in eval
        mode: BatchNorm uses its running statistics on every path, as the
        JAX runtime's forward does (`train=False`)."""
        self.training = mode
        return self

    def eval(self):
        return self.train(False)

    @torch.no_grad()
    def __call__(self, x, generator: torch.Generator | None = None):
        """Deploy through the host coder when the tables are built and the
        runtime is in eval mode; the 'finetune' forward (no bitstream) when
        they are built and it is training; before `update()` the 'train'
        forward, its noise from `generator` (by default a new one seeded
        with 0, as the JAX runtime's default key). BatchNorm uses its
        running statistics on every path."""
        if self.bottleneck_updated and not self.training:
            compressed = self.encode(x)
            self.analyze(compressed)
            return self.decode(**compressed)
        mode = 'finetune' if self.bottleneck_updated else 'train'
        if mode == 'train' and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.module(self._prep_input(x), mode=mode,
                           generator=generator).to(torch.float32)

    def _prep_input(self, x):
        """To the runtime's device; uint8 -> normalized float32 there.
        uint8 without `input_norm` is rejected: raw 0-255 values would
        reach the network."""
        x = torch.as_tensor(x, device=self.device)
        if x.dtype == torch.uint8:
            if self._norm_mean is None:
                raise ValueError(
                    'uint8 input requires input_norm=(mean, std) on the '
                    'runtime; configure input_norm or convert to '
                    'normalized float32 first')
            x = x.to(torch.float32) / 255.0
            x = (x - self._norm_mean[:, None, None]) \
                / self._norm_std[:, None, None]
        return x

    # ---- host coder (escape path) ----------------------------------------
    @torch.no_grad()
    def encode(self, x):
        """Mobile side with the host coder: the encoder runs on the
        runtime's device, the symbols cross to the host and are coded
        there. Returns the compressed object {'strings', 'shape'}."""
        flat, (h, w, c) = self._symbols_nhwc(x)
        symbols = flat.reshape(-1, h, w, c).cpu().numpy()
        return {'strings': [self.codec.compress_symbols(symbols)],
                'shape': (h, w)}

    @torch.no_grad()
    def decode(self, strings, shape):
        """Host decoding, then the decoded symbols go back to the device
        for the IGDN decoder and the tail. Returns logits (n, K)."""
        channels = self.codec.tables.medians.shape[0]
        symbols = self.codec.decompress_symbols(strings[0], shape, channels)
        flat = torch.from_numpy(symbols.reshape(len(symbols), -1))
        return self._decode_tail(flat.to(self.device),
                                 (*shape, channels))

    def _escape(self, x, ok, index):
        """Re-code image `index` on the host coder: count the escape by
        the check it failed (`ok`, else `valid`), account its bytes and
        return that path's logits."""
        flag = 'valid' if ok else 'ok'
        self.escapes[flag] += 1
        if flag == 'valid':
            logger.warning('image %d: device rANS decode did not return to '
                           'its initial state (valid=False); re-coded on the '
                           'host coder', index)
        compressed = self.encode(x)
        self.analyze(compressed)
        return self.decode(**compressed)

    # ---- host wire (stream_deploy) -----------------------------------------
    @torch.no_grad()
    def encode_device(self, x):
        """Mobile side of the host wire, on the device: encoder and
        round(y - median), symbols (n, h, w, c) narrowed to int16, the wire
        dtype (the JAX runtime's `to_wire`; lossless while
        |round(y - median)| < 2^15)."""
        flat, (h, w, c) = self._symbols_nhwc(x)
        return {'symbols': flat.reshape(-1, h, w, c).to(torch.int16)}

    def _encode_to_host(self, x):
        """Dispatch `encode_device` and the copy of its symbols to the
        host. Returns the host tensor and, on a CUDA device, the event after
        which it holds the symbols (None on the CPU)."""
        sym = self.encode_device(x)['symbols']
        if self.device.type != 'cuda':
            return sym, None
        host = sym.to('cpu', non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    @torch.no_grad()
    def stream_deploy(self, images, depth: int = 8,
                      timings: dict | None = None, decode_batch: int = 1):
        """Serve a stream of images through the host coder at batch 1, the
        reference's eval protocol: per image, the encoder on the device,
        the cyclic int16 wire coded and decoded on the host with its size
        accounted, then the decoder and tail on the device. Returns the
        logits, one tensor per image.

        Up to `depth` encodes (and the copies of their symbols) are queued
        on the device ahead of the host coder, so the card works while the
        host codes; one host thread codes. `decode_batch=k` runs the
        decoder and tail once per k images; each image is still coded and
        accounted alone."""
        images = list(images)
        if not images:
            return []
        channels = self.codec.tables.medians.shape[0]
        results, decoded = [], []

        def flush():
            t0 = time.perf_counter()
            sym = torch.from_numpy(np.concatenate(decoded)).to(self.device)
            logits = self._decode_tail(sym.reshape(len(sym), -1),
                                       tuple(sym.shape[1:]))
            results.extend(torch.split(logits, [len(d) for d in decoded]))
            decoded.clear()
            add_timing(timings, 'decode_dispatch', time.perf_counter() - t0)

        def host_stage(host, ready):
            t0 = time.perf_counter()
            if ready is not None:
                ready.synchronize()
            sym = host.numpy()
            t1 = time.perf_counter()
            compressed = {'strings': [self.codec.compress_wire(sym)],
                          'shape': tuple(sym.shape[1:3])}
            self.analyze(compressed)
            decoded.append(self.codec.decompress_wire(
                compressed['strings'][0], compressed['shape'], channels))
            add_timing(timings, 'd2h_sync', t1 - t0)
            add_timing(timings, 'host_code', time.perf_counter() - t1)
            if len(decoded) == max(int(decode_batch), 1):
                flush()

        in_flight = deque()
        for x in images:
            if len(in_flight) >= max(int(depth), 1):
                host_stage(*in_flight.popleft())
            in_flight.append(self._encode_to_host(x))
        while in_flight:
            host_stage(*in_flight.popleft())
        if decoded:
            flush()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return results

    # ---- device-rANS wire -----------------------------------------------
    def _latent_shape(self, x_shape):
        """(h, w, c) of the bottleneck latent for an NCHW input shape."""
        return self._bneck.latent_shape(int(x_shape[-2]), int(x_shape[-1]))

    @staticmethod
    def _auto_wire_lanes(latent_shape):
        """Cyclic lane count (a multiple of C) for a latent shape."""
        return auto_lanes(int(np.prod(latent_shape)),
                          cyclic_channels=int(latent_shape[-1]))

    def _symbols_nhwc(self, x):
        """Encoder + round(y - median), flattened channels-last: lane j
        then always codes channel j mod C, as in the JAX wire format."""
        sym = self._bneck.encode_ops(self._prep_input(x),
                                     self._medians)['symbols']
        n, c, h, w = sym.shape
        return sym.permute(0, 2, 3, 1).reshape(n, -1), (h, w, c)

    def _with_meta(self, out, shape):
        # ok + exact wire size in one small tensor, read once at harvest
        out['meta'] = torch.stack([out['ok'].to(torch.int32), out['nbytes']],
                                  dim=-1)
        out['shape'] = shape
        return out

    @torch.no_grad()
    def encode_device_wire(self, x, num_lanes=None):
        """Mobile side: encoder and rANS encode on the device, compacted
        streams (`device_rans_encode`)."""
        flat, shape = self._symbols_nhwc(x)
        if num_lanes is None:
            num_lanes = self._auto_wire_lanes(shape)
        cdf, cdf_len, off = self._tables_dev
        out = device_rans_encode(flat.reshape(-1), cdf, cdf_len, off,
                                 num_lanes=num_lanes,
                                 cyclic_channels=shape[-1])
        return self._with_meta(out, shape)

    @torch.no_grad()
    def encode_device_wire_batch(self, xs_list, num_lanes=None):
        """`encode_device_wire` for k images with ONE coding launch over
        time-aligned streams. The encoder runs per image, at the batch-1
        shape: cuDNN may choose another algorithm for a batch of k, and its
        float sums could move a symbol across a rounding boundary, while
        each image's bitstream must equal its batch-1 one."""
        rows = [self._symbols_nhwc(x) for x in xs_list]
        shape = rows[0][1]
        if any(s != shape for _, s in rows):
            raise ValueError('encode_device_wire_batch needs images of one '
                             'shape')
        if num_lanes is None:
            num_lanes = self._auto_wire_lanes(shape)
        cdf, cdf_len, off = self._tables_dev
        out = device_rans_encode(torch.cat([f for f, _ in rows]), cdf,
                                 cdf_len, off, num_lanes=num_lanes,
                                 cyclic_channels=shape[-1], aligned=True)
        return self._with_meta(out, shape)

    def _decode_tail(self, flat, shape):
        h, w, c = shape
        sym = flat.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        feat = self._bneck.decode_ops(sym, self._medians)
        return self.module.forward_tail(feat).to(torch.float32)

    @torch.no_grad()
    def decode_device_streams(self, streams, states, shape, num_lanes=None):
        """Server side from device-resident (or uploaded) compacted streams:
        rANS decode + bottleneck decoder + tail. Returns (logits (1, K),
        valid)."""
        if num_lanes is None:
            num_lanes = self._auto_wire_lanes(shape)
        cdf, cdf_len, off = self._tables_dev
        flat, valid = device_rans_decode(
            streams, states, cdf, cdf_len, off,
            n_symbols=int(np.prod(shape)), num_lanes=num_lanes,
            cyclic_channels=shape[-1], device=self.device)
        return self._decode_tail(flat, shape), valid

    @torch.no_grad()
    def decode_device_streams_batch(self, streams, states, shape,
                                    num_lanes=None):
        """k images' time-aligned streams (k, N, T) -> (logits (k, K),
        valid (k,)), one decode launch and one batched tail."""
        if num_lanes is None:
            num_lanes = self._auto_wire_lanes(shape)
        cdf, cdf_len, off = self._tables_dev
        flat, valid = device_rans_decode(
            streams, states, cdf, cdf_len, off,
            n_symbols=int(np.prod(shape)), num_lanes=num_lanes,
            cyclic_channels=shape[-1], aligned=True, device=self.device)
        return self._decode_tail(flat, shape), valid

    def _pull_device_wire(self, ops):
        """Pack the device streams into the wire bytes: lengths first, then
        only the used prefix of the stream matrix crosses to the host."""
        lengths = ops['lengths'].cpu().numpy()
        lmax = max(int(lengths.max()), 1)
        return pack_stream({'streams': ops['streams'][:, :lmax].cpu().numpy(),
                            'lengths': lengths,
                            'states': ops['states'].cpu().numpy()})

    def _throttle(self, inflight: deque, depth: int):
        """Bound the queued device work to `depth` items without reading
        any result: wait on the event of the item `depth` places back."""
        if self.device.type != 'cuda':
            return
        ev = torch.cuda.Event()
        ev.record()
        inflight.append(ev)
        while len(inflight) > max(int(depth), 1):
            inflight.popleft().synchronize()

    def stream_deploy_device(self, images, depth: int = 8, workers: int = 4,
                             num_lanes: int | None = None,
                             pull_wire: bool = False,
                             wire_batch: int | None = None,
                             timings: dict | None = None):
        """Serve a stream of images through the device-rANS wire: encode
        and entropy-code on the device, decode from the device-resident
        streams, and account each image's exact wire size. Returns the
        logits, one (1, K) tensor per image.

        `depth` bounds the images in flight; `workers` is accepted for
        signature parity with the JAX runtime (eager PyTorch needs no host
        pool). The [ok, nbytes] metas and `valid` flags are read once,
        after the stream drains; an image that fails either (a latent
        symbol outside the CDF support, or a lane that did not return to
        its initial state) is re-coded on the host coder, accounted with
        those bytes, served from that path's logits, and counted in
        `escapes`. `pull_wire=True`
        packs and accounts the real wire bytes per image. `wire_batch=k`
        codes k images per launch."""
        del workers
        images = list(images)
        n = len(images)
        if n == 0:
            return []
        if num_lanes is None:
            num_lanes = self._auto_wire_lanes(
                self._latent_shape(images[0].shape))
        if wire_batch is not None and wire_batch > 1:
            if pull_wire:
                raise ValueError('wire_batch grouping does not support '
                                 'pull_wire packing')
            return self._stream_deploy_device_batched(
                images, wire_batch, depth, num_lanes, timings)

        staged, inflight = [], deque()
        for i, x in enumerate(images):
            ops = self.encode_device_wire(x, num_lanes=num_lanes)
            t0 = time.perf_counter()
            logits, valid = self.decode_device_streams(
                ops['streams'], ops['states'], ops['shape'],
                num_lanes=num_lanes)
            add_timing(timings, 'decode_dispatch', time.perf_counter() - t0)
            shape_hw = ops['shape'][:2]
            if pull_wire:
                # packing needs the stream content: sync here
                ok, nbytes = ops['meta'].tolist()
                if ok and bool(valid):
                    wire = self._pull_device_wire(ops)
                    if len(wire) != nbytes:
                        raise RuntimeError(
                            f'image {i}: packed {len(wire)} bytes, encoder '
                            f'reported {nbytes}')
                    staged.append((wire, shape_hw, logits, ok))
                else:
                    staged.append((None, shape_hw, None, ok))
                continue
            staged.append((ops['meta'], shape_hw, logits, valid))
            self._throttle(inflight, depth)

        t_acct = time.perf_counter()
        results = []
        if pull_wire:
            for i, (wire, shape_hw, logits, ok) in enumerate(staged):
                if wire is None:
                    results.append(self._escape(images[i], ok, i))
                    continue
                self.analyze({'strings': [[wire]], 'shape': shape_hw})
                results.append(logits)
        else:
            metas = torch.stack([s[0] for s in staged]).cpu().numpy()
            valids = torch.stack([s[3] for s in staged]).cpu().numpy()
            for i, (_, shape_hw, logits, _) in enumerate(staged):
                if not metas[i, 0] or not valids[i]:
                    results.append(self._escape(images[i], metas[i, 0], i))
                    continue
                # the pickled size of a bytes object depends only on its
                # length: account the exact wire size without its content
                self.analyze({'strings': [[bytes(int(metas[i, 1]))]],
                              'shape': shape_hw})
                results.append(logits)
        add_timing(timings, 'account_d2h', time.perf_counter() - t_acct)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return results

    def _stream_deploy_device_batched(self, images, k, depth, num_lanes,
                                      timings):
        """Groups of up to k consecutive same-shape images per coding
        launch; per-image bitstreams, byte accounting and logits match the
        batch-1 path. The last group may be short (eager PyTorch has no
        fixed program shape to pad to)."""
        n = len(images)
        groups, i = [], 0
        while i < n:
            j = i + 1
            while j < n and j - i < k \
                    and tuple(images[j].shape) == tuple(images[i].shape):
                j += 1
            groups.append((i, j))
            i = j

        staged, inflight = [], deque()
        for j0, j1 in groups:
            ops = self.encode_device_wire_batch(images[j0:j1],
                                                num_lanes=num_lanes)
            t0 = time.perf_counter()
            logits, valid = self.decode_device_streams_batch(
                ops['streams'], ops['states'], ops['shape'],
                num_lanes=num_lanes)
            add_timing(timings, 'decode_dispatch', time.perf_counter() - t0)
            staged.append((ops['meta'], ops['shape'][:2], logits, valid))
            self._throttle(inflight, depth)

        t_acct = time.perf_counter()
        metas = torch.cat([s[0] for s in staged]).cpu().numpy()
        valids = torch.cat([s[3] for s in staged]).cpu().numpy()
        results, i = [], 0
        for _, shape_hw, logits, _ in staged:
            for j in range(logits.shape[0]):
                if not metas[i, 0] or not valids[i]:
                    results.append(self._escape(images[i], metas[i, 0], i))
                    i += 1
                    continue
                self.analyze({'strings': [[bytes(int(metas[i, 1]))]],
                              'shape': shape_hw})
                results.append(logits[j:j + 1])
                i += 1
        add_timing(timings, 'account_d2h', time.perf_counter() - t_acct)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return results
