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

A hyperprior bottleneck (SHP/MSHP) codes two latents per image, z then y
on the wire: z with the factorized tables on the cyclic kernels, y with
the Gaussian tables on the general per-index kernels, its rows (the scale
indexes) computed by h_s from z's symbols. The decoder decodes z,
recomputes the indexes from the decoded z and decodes y, so the indexes
must be bit-equal on both sides: h_s runs per image at the batch-1 shape
on both, on contiguous NCHW input, with cuDNN's deterministic algorithms
and no benchmarking (`_exact_cudnn`). An image's size is that of both
wires, accounted under z's spatial shape as in the JAX runtime.

`stream_deploy` is the same loop with the entropy coding on the host (the
JAX runtime's default wire): int16 symbols cross to the host, the cyclic
int16 coder of `ops/rans/coder.py` codes and decodes them, and the
decoded symbols go back to the device for the decoder and tail.
`__call__` is the reference's forward: deploy through `encode`/`decode`
once the tables are built, the 'finetune' forward while training, and the
'train' (noise) forward before `update()`.

Two more model kinds run on the host wire only, as in the JAX runtime:
a model with module-level deploy ops and no `bottleneck_layer` (the
fine-tuning family's `EntropicClassifierModule`, its own
`entropy_bottleneck` coded: `encode_ops`, then `decode_ops_to_logits`),
whose device-wire methods raise `ValueError`; and a bottleneck without an
entropy model (the CR+BQ family's `SimpleBottleneck`), which has no codec:
`update()` returns False and `__call__` is the 'train' forward.

The host CompressAI-format coder (`encode`/`decode`, `ops/rans/coder.py`)
is also the escape path: an image whose latent leaves the CDF support
(`ok=False`) or whose device decode fails (`valid=False`) is re-coded on
the host, accounted with those bytes, and served from that path's logits,
as in the JAX runtime. `SplitClassifierRuntime.escapes` counts them by the
check that failed. `ok=False` is a property of the data; the device coder
is exact, so `valid=False` means a faulty kernel or stream, and each one is
also logged as a warning.

Spans and counters (`utils/profiling.py`, recorded while a profiler runs):
a serving call is `deploy.request`; in it the encoder and rounding of
the images of one coding launch is `deploy.encode` (one range for a
group of `wire_batch` images, as a profiler range costs tens to hundreds
of us amid the serving loop's work; on the device wire that is one copy
and one CUDA graph replay once the launch's key has been seen twice, and
the counter `deploy.encode_graph.replays` counts the images a replay
encoded), the coder launches
`deploy.rans_encode` and `deploy.rans_decode`, the decoder and tail
`deploy.decode_tail` (inside `deploy.decode`, the server half's
dispatch), the read of the sizes and flags `deploy.drain` and an escape
`deploy.escape`. Where the host blocks
on the device is a wait span: `deploy.throttle`, `deploy.drain.read`,
`deploy.sync`, `pull_wire`'s `deploy.pull.read` and the host wire's
`deploy.d2h_sync`. The counter `deploy.images` counts the images served.
A caller's `timings` dict gets the host seconds of `decode_dispatch`,
`account_d2h` (the drain), `d2h_sync` and `host_code` whether or not a
profiler runs.

The segmentation and detection runtimes (`models/segmentation/wrapper.py`,
`models/detection/wrapper.py`) reuse both wires through three hooks:
`_split_bottleneck` (where the bottleneck sits), `_decode_tail` (given
each image's input (h, w), which travels with its ops as `input_hw`) and
`_recode_on_host` (the escape path). A decode tail may return a dict of
tensors (detection's), split by image as a tensor is. Lanes follow each
image's latent shape unless the caller fixes them.

Numerics: symbols are bit-identical to the float32 reference only if the
encoder runs in true float32. cuDNN runs float32 convolutions in TF32 by
default, which moves symbols across rounding boundaries, so a runtime on a
CUDA device sets `torch.backends.cudnn.allow_tf32 = False` and
`torch.backends.cuda.matmul.allow_tf32 = False` (process-wide flags).

Three opt-in bfloat16 options, as in the JAX runtime (none of them turns
TF32 on):

    deploy_bf16_tail    the host wire's decode: the bottleneck's decoder
                        in float32, layer2-4 and fc on a bfloat16 copy of
                        their weights, made again whenever a weight of the
                        model changes (or the model is replaced)
    deploy_bf16_decode  the device wire's decode: the decoder and the tail
                        of a clone of the model whose compute dtype is
                        bfloat16 (`models/precision.py`), over the same
                        weights. The encoder is untouched, so the wire
                        bytes equal the float32 runtime's; a hyperprior's
                        h_s stays float32, so the decoder's Gaussian
                        indexes equal the encoder's
    deploy_bf16_encode  the device wire's encoder convolutions on that
                        clone; the symbols' rounding and the entropy model
                        stay float32. The bytes change by design (a latent
                        near a rounding boundary moves by one) and the
                        streams still decode to the symbols sent
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import logging
from collections import deque

import numpy as np
import torch

from ..analysis import AnalyzerHolder
from ..device import resolve_device
from ..ops.entropy.tables import (CodingTables, build_factorized_tables,
                                  build_gaussian_tables)
from ..ops.rans.coder import RansCoder
from ..ops.rans.device import (auto_lanes, device_rans_decode,
                               device_rans_encode, pack_stream,
                               pack_stream_aligned)
from ..ops.rans.indexed_tables import prepare_indexed_tables
from ..utils.graphs import GraphCache
from ..utils.profiling import count, span
from .layer import (EntropyBottleneckLayer, FPBasedResNetBottleneck,
                    SHPBasedResNetBottleneck)
from .precision import with_compute_dtype

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def _exact_cudnn():
    """cuDNN's deterministic algorithms and no benchmarking, for the
    convolutions whose output must be bit-equal at encode and decode
    (the hyperprior's h_s); the previous flags come back after."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC -> contiguous NCHW (the layout the encoder's convolutions saw)."""
    return t.permute(0, 3, 1, 2).contiguous()


def _rows(out, i: int, j: int):
    """Images i..j-1 of a decode tail's output: a tensor, or a dict of
    tensors (detection's)."""
    if isinstance(out, dict):
        return {k: v[i:j] for k, v in out.items()}
    return out[i:j]


def _num_rows(out) -> int:
    return len(next(iter(out.values())) if isinstance(out, dict) else out)


def _channel_major(symbols: np.ndarray) -> np.ndarray:
    """(h, w, c) -> channel-major flat order (c, h*w) for per-channel CDFs."""
    return np.transpose(symbols, (2, 0, 1)).reshape(symbols.shape[-1], -1)


class FactorizedCodec:
    """Coding tables and host coder of one `EntropyBottleneck` (FP, or a
    module-level one)."""

    def __init__(self):
        self.tables: CodingTables | None = None
        self.coder: RansCoder | None = None

    def update(self, entropy_bottleneck):
        self.tables = build_factorized_tables(entropy_bottleneck)
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


class HyperpriorCodec(FactorizedCodec):
    """Coding tables and host coders of an SHP/MSHP bottleneck: z with the
    factorized tables (`FactorizedCodec`), y with the Gaussian tables, each
    symbol with its own row (the scale index)."""

    def __init__(self):
        super().__init__()
        self.g_tables: CodingTables | None = None
        self.g_coder: RansCoder | None = None

    def update(self, entropy_bottleneck, scale_table=None):
        super().update(entropy_bottleneck)
        self.g_tables = build_gaussian_tables(scale_table)
        self.g_coder = RansCoder(self.g_tables.quantized_cdf,
                                 self.g_tables.cdf_length,
                                 self.g_tables.offset)

    def compress_y(self, y_symbols: np.ndarray, y_indexes: np.ndarray):
        """(n, h, w, c) symbols and indexes -> per-sample byte strings, in
        the NHWC ravel order."""
        return [self.g_coder.encode_with_indexes(y_symbols[i].ravel(),
                                                 y_indexes[i].ravel())
                for i in range(y_symbols.shape[0])]

    def decompress_y(self, strings, y_indexes: np.ndarray):
        return np.stack([
            self.g_coder.decode_with_indexes(s, y_indexes[i].ravel())
            .reshape(y_indexes[i].shape) for i, s in enumerate(strings)])

    def compress_y_wire(self, y_symbols: np.ndarray, y_indexes: np.ndarray):
        """`compress_y` of int16 symbols and indexes, the wire dtype."""
        return [self.g_coder.encode_with_indexes_i16(y_symbols[i],
                                                     y_indexes[i])
                for i in range(y_symbols.shape[0])]

    def decompress_y_wire(self, strings, y_indexes: np.ndarray):
        return np.stack([
            self.g_coder.decode_with_indexes_i16(s, y_indexes[i])
            .reshape(y_indexes[i].shape) for i, s in enumerate(strings)])


class SplitClassifierRuntime(AnalyzerHolder):
    """Runtime for `SplittableResNet` with an FP, SHP, MSHP or entropy-free
    bottleneck, or for a model with module-level deploy ops
    (`EntropicClassifierModule`): `update()`, `bottleneck_updated`, the
    analyzable surface, the host wire and, for the splittable FP/SHP/MSHP
    models, the device-rANS wire. Images are NCHW tensors (or arrays):
    float, or uint8 when the runtime has `input_norm=(mean, std)`.
    `deploy_bf16_tail`, `deploy_bf16_decode` and `deploy_bf16_encode` are
    the opt-in bfloat16 options of the module doc."""

    def __init__(self, module, analyzer_configs=None, analysis_unit='KB',
                 input_norm=None, device=None, deploy_bf16_tail=False,
                 deploy_bf16_decode=False, deploy_bf16_encode=False):
        if analyzer_configs is None:
            analyzer_configs = [{'key': 'FileSizeAnalyzer',
                                 'kwargs': {'unit': analysis_unit}}]
        super().__init__(analyzer_configs)
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            # true float32 encoder: byte-identical bitstreams (module doc)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.deploy_bf16_tail = bool(deploy_bf16_tail)
        self.deploy_bf16_decode = bool(deploy_bf16_decode)
        self.deploy_bf16_encode = bool(deploy_bf16_encode)
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
        # module-level deploy ops (EntropicClassifierModule) or a
        # bottleneck_layer submodule (the SplittableResNet family)
        self._module_level_ops = self._bneck is None \
            and hasattr(module, 'encode_ops')
        self.hyper = isinstance(self._bneck, SHPBasedResNetBottleneck)
        if self.hyper:
            self.codec = HyperpriorCodec()
        elif self._module_level_ops or isinstance(
                self._bneck, (FPBasedResNetBottleneck,
                              EntropyBottleneckLayer)):
            self.codec = FactorizedCodec()
        else:
            self.codec = None
        # images re-coded on the host coder, by the check they failed
        self.escapes = {'ok': 0, 'valid': 0}
        self._medians = None
        self._tables_dev = None
        self._gtables_dev = None
        self._gprepared = None
        self._scale_table = None
        # the device wire's encoder of a coding launch, as a CUDA graph
        self._encode_graphs = GraphCache('deploy.encode_graph')

    @property
    def module(self):
        return self._module

    @module.setter
    def module(self, value):
        # another model (of the same kind): its bottleneck, and no bfloat16
        # clone or tail copy of the old one
        self._module = value
        self._bneck = self._split_bottleneck(value)
        self._bf16_module = None
        self._bf16_tail = None

    @staticmethod
    def _split_bottleneck(module):
        """The model's bottleneck layer; None for module-level deploy
        ops."""
        return getattr(module, 'bottleneck_layer', None)

    # ---- the bfloat16 options ----------------------------------------------
    def _bf16_clone(self):
        """The model with a bfloat16 compute dtype over its own weights,
        built once."""
        if self._bf16_module is None:
            self._bf16_module = with_compute_dtype(self.module,
                                                   torch.bfloat16)
        return self._bf16_module

    def _decode_module(self):
        """The model of the device wire's decode."""
        return self._bf16_clone() if self.deploy_bf16_decode \
            else self.module

    def _encode_module(self):
        """The model of the device wire's encoder."""
        return self._bf16_clone() if self.deploy_bf16_encode \
            else self.module

    def _bf16_tail_module(self):
        """A bfloat16 copy of the model without its bottleneck, made again
        when any weight of the model has changed in place since (the
        tensors' version counters)."""
        if self._bf16_tail is not None:
            weights, versions, tail = self._bf16_tail
            if versions == [t._version for t in weights]:
                return tail
        weights = list(itertools.chain(self.module.parameters(),
                                       self.module.buffers()))
        tail = copy.deepcopy(self.module, {id(self._bneck): None}).to(
            torch.bfloat16)
        self._bf16_tail = (weights, [t._version for t in weights], tail)
        return tail

    # ---- reference API surface -----------------------------------------
    def update(self, scale_table=None):
        """Build the coding tables from the learned entropy-bottleneck
        parameters (and, for a hyperprior, the Gaussian tables of
        `scale_table`, by default the 64-entry log-spaced one) and keep
        device copies for the wire (and the Gaussian tables' prepared form
        for the general-path kernels). Returns False, and builds
        nothing, when the model has no entropy model."""
        if self.codec is None:
            return False
        eb = (self.module if self._module_level_ops
              else self._bneck).entropy_bottleneck
        if self.hyper:
            self.codec.update(eb, scale_table)
            g = self.codec.g_tables
            self._scale_table = torch.as_tensor(g.scale_table,
                                                device=self.device)
            self._gtables_dev = self._device_tables(g)
            self._gprepared = prepare_indexed_tables(*self._gtables_dev)
        else:
            self.codec.update(eb)
        t = self.codec.tables
        self._medians = torch.as_tensor(t.medians, device=self.device)
        self._tables_dev = self._device_tables(t)
        self.bottleneck_updated = True
        return True

    def _device_tables(self, t: CodingTables):
        return tuple(torch.as_tensor(a, dtype=torch.int32, device=self.device)
                     for a in (t.quantized_cdf, t.cdf_length, t.offset))

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
        with 0, as the JAX runtime's default key); without a codec always
        the 'train' forward. BatchNorm uses its running statistics on
        every path."""
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
        runtime's device, the symbols (and a hyperprior's y indexes) cross
        to the host and are coded there. Returns the compressed object
        {'strings', 'shape'}: one list of strings for FP; y's then z's for
        a hyperprior, whose shape is z's."""
        self._require_codec()
        if self.hyper:
            ops = {k: _nhwc(v).cpu().numpy()
                   for k, v in self._hyper_ops(x).items()}
            z_sym = ops['z_symbols']
            return {'strings': [self.codec.compress_y(ops['y_symbols'],
                                                      ops['y_indexes']),
                                self.codec.compress_symbols(z_sym)],
                    'shape': tuple(z_sym.shape[1:3])}
        flat, (h, w, c) = self._symbols_nhwc(x)
        symbols = flat.reshape(-1, h, w, c).cpu().numpy()
        return {'strings': [self.codec.compress_symbols(symbols)],
                'shape': (h, w)}

    @torch.no_grad()
    def decode(self, strings, shape):
        """Host decoding, then the decoded symbols go back to the device
        for the decoder and the tail (a hyperprior's y indexes are
        recomputed there from the decoded z first). Returns logits (n, K)."""
        self._require_codec()
        if self.hyper:
            z_sym = self.codec.decompress_symbols(
                strings[1], shape, self._bneck.num_latent_channels)
            z = torch.from_numpy(z_sym).to(self.device)
            y_idx, means = self._hyper_scales(z)
            y_sym = self.codec.decompress_y(strings[0], y_idx.cpu().numpy())
            return self._decode_tail_hyper(
                torch.from_numpy(y_sym).to(self.device), means)
        channels = self.codec.tables.medians.shape[0]
        symbols = self.codec.decompress_symbols(strings[0], shape, channels)
        flat = torch.from_numpy(symbols.reshape(len(symbols), -1))
        return self._host_decode_tail(flat.to(self.device),
                                      (*shape, channels))

    # ---- hyperprior pieces -----------------------------------------------
    def _hyper_ops(self, x, bneck=None) -> dict:
        """NCHW `encode_ops` of each image at the batch-1 shape (the shape
        the decoder's h_s sees), concatenated; `bneck` the bottleneck to
        run (by default the model's)."""
        x = self._prep_input(x)
        bneck = self._bneck if bneck is None else bneck
        with _exact_cudnn():
            ops = [bneck.encode_ops(x[i:i + 1], self._medians,
                                    self._scale_table)
                   for i in range(x.shape[0])]
        return {k: torch.cat([o[k] for o in ops]) for k in ops[0]}

    def _hyper_scales(self, z_nhwc: torch.Tensor):
        """(y indexes (n, hy, wy, cy) int32, means NCHW or None) from z's
        symbols (n, hz, wz, cz), h_s per image at the batch-1 shape, as
        the encoder computed them."""
        z = _nchw(z_nhwc)
        with _exact_cudnn():
            out = [self._bneck.decode_scales(z[i:i + 1], self._medians,
                                             self._scale_table)
                   for i in range(z.shape[0])]
        means = (None if out[0][1] is None
                 else torch.cat([m for _, m in out]))
        return _nhwc(torch.cat([idx for idx, _ in out])), means

    def _decode_tail_hyper(self, y_nhwc: torch.Tensor,
                           means: torch.Tensor | None,
                           module=None) -> torch.Tensor:
        """Decoder and tail (of `module`, by default the model) from y's
        symbols (NHWC) and the means of `_hyper_scales`."""
        m = self.module if module is None else module
        with _exact_cudnn():
            feat = self._split_bottleneck(m).decode_ops(_nchw(y_nhwc), means)
        return m.forward_tail(feat).to(torch.float32)

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
        with span('deploy.escape'):
            return self._recode_on_host(x)

    def _recode_on_host(self, x):
        """The escape path: `encode` on the host coder, accounted, then
        `decode`."""
        compressed = self.encode(x)
        self.analyze(compressed)
        return self.decode(**compressed)

    @torch.no_grad()
    def _recode_on_host_wire(self, x):
        """The escape path of the segmentation and detection runtimes (the
        JAX package's `FactorizedDeviceWire`): the batch through the host
        wire as one compressed object, the encoder's int16 symbols coded
        and decoded on the cyclic host coder (accounted), then the decode
        tail on the device for the input's (h, w)."""
        sym = self.encode_device(x)['symbols'].cpu().numpy()
        compressed = {'strings': [self.codec.compress_wire(sym)],
                      'shape': tuple(sym.shape[1:3])}
        self.analyze(compressed)
        decoded = self.codec.decompress_wire(
            compressed['strings'][0], compressed['shape'], sym.shape[-1])
        flat = torch.from_numpy(decoded.reshape(len(decoded), -1))
        return self._decode_tail(flat.to(self.device), decoded.shape[1:],
                                 tuple(x.shape[-2:]))

    # ---- host wire (stream_deploy) -----------------------------------------
    @torch.no_grad()
    def encode_device(self, x):
        """Mobile side of the host wire, on the device: the encoder and
        round(y - median), symbols (n, h, w, c) narrowed to int16, the wire
        dtype (the JAX runtime's `to_wire`; lossless while
        |round(y - median)| < 2^15). A hyperprior's y symbols, y indexes
        and z symbols, each (n, h, w, c) int16."""
        self._require_codec()
        with span('deploy.encode'):
            if self.hyper:
                return {k: _nhwc(v).to(torch.int16)
                        for k, v in self._hyper_ops(x).items()}
            flat, (h, w, c) = self._symbols_nhwc(x)
            return {'symbols': flat.reshape(-1, h, w, c).to(torch.int16)}

    def _encode_to_host(self, x):
        """Dispatch `encode_device` and the copy of its tensors to the
        host. Returns the host tensors and, on a CUDA device, the event
        after which they hold the symbols (None on the CPU)."""
        ops = self.encode_device(x)
        if self.device.type != 'cuda':
            return ops, None
        host = {k: v.to('cpu', non_blocking=True) for k, v in ops.items()}
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _decode_hyper_wire(self, strings, shape):
        """A hyperprior's host wire: z from the cyclic int16 stream, y's
        indexes recomputed on the device and shipped back as int16, y from
        the int16 indexed stream. Returns logits."""
        z_sym = self.codec.decompress_wire(strings[1], shape,
                                           self._bneck.num_latent_channels)
        z = torch.from_numpy(z_sym).to(self.device)
        y_idx, means = self._hyper_scales(z)
        y_sym = self.codec.decompress_y_wire(
            strings[0], y_idx.to(torch.int16).cpu().numpy())
        return self._decode_tail_hyper(
            torch.from_numpy(y_sym).to(self.device), means)

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
        accounted alone. A hyperprior codes y on the int16 indexed wire
        and z on the cyclic one, and decodes each image as it comes
        (`decode_batch` 1 only, as in the JAX runtime, and so does a
        model with module-level deploy ops)."""
        self._require_codec()
        images = list(images)
        if not images:
            return []
        if (self.hyper or self._module_level_ops) and int(decode_batch) > 1:
            raise ValueError('decode_batch > 1 is implemented for the '
                             'factorized-prior bottleneck runtime only; run '
                             'with decode_batch=1')
        channels = self.codec.tables.medians.shape[0]
        results, decoded = [], []
        decoded_hw = None   # the input (h, w) of the pending decodes

        def flush():
            with span('deploy.decode_tail', timings, 'decode_dispatch'):
                sym = torch.from_numpy(np.concatenate(decoded)).to(
                    self.device)
                logits = self._host_decode_tail(sym.reshape(len(sym), -1),
                                                tuple(sym.shape[1:]),
                                                decoded_hw)
                starts = np.cumsum([0] + [len(d) for d in decoded])
                results.extend(_rows(logits, int(i), int(j))
                               for i, j in zip(starts[:-1], starts[1:]))
                decoded.clear()

        def host_stage(host, ready, input_hw):
            nonlocal decoded_hw
            with span('deploy.d2h_sync', timings, 'd2h_sync', wait=True):
                if ready is not None:
                    ready.synchronize()
                ops = {k: v.numpy() for k, v in host.items()}
            with span('deploy.host_encode', timings, 'host_code'):
                if self.hyper:
                    z_sym = ops['z_symbols']
                    compressed = {
                        'strings': [self.codec.compress_y_wire(
                            ops['y_symbols'], ops['y_indexes']),
                            self.codec.compress_wire(z_sym)],
                        'shape': tuple(z_sym.shape[1:3])}
                else:
                    sym = ops['symbols']
                    compressed = {'strings': [self.codec.compress_wire(sym)],
                                  'shape': tuple(sym.shape[1:3])}
                self.analyze(compressed)
            if self.hyper:
                with span('deploy.decode', timings, 'decode_dispatch'):
                    results.append(self._decode_hyper_wire(
                        compressed['strings'], compressed['shape']))
                return
            with span('deploy.host_decode', timings, 'host_code'):
                if decoded and input_hw != decoded_hw:
                    flush()     # a decode batch holds images of one shape
                decoded.append(self.codec.decompress_wire(
                    compressed['strings'][0], compressed['shape'], channels))
            decoded_hw = input_hw
            if len(decoded) == max(int(decode_batch), 1):
                flush()

        count('deploy.images', len(images))
        with span('deploy.request'):
            in_flight = deque()
            for x in images:
                if len(in_flight) >= max(int(depth), 1):
                    host_stage(*in_flight.popleft())
                in_flight.append((*self._encode_to_host(x),
                                  tuple(x.shape[-2:])))
            while in_flight:
                host_stage(*in_flight.popleft())
            if decoded:
                flush()
            self._sync()
        return results

    # ---- device-rANS wire -----------------------------------------------
    def _latent_shape(self, x_shape):
        """(h, w, c) of the bottleneck latent for an NCHW input shape; for a
        hyperprior ((hy, wy, cy), (hz, wz, cz))."""
        return self._bneck.latent_shape(int(x_shape[-2]), int(x_shape[-1]))

    @staticmethod
    def _auto_wire_lanes(latent_shape):
        """Cyclic lane count (a multiple of C) for a latent shape."""
        return auto_lanes(int(np.prod(latent_shape)),
                          cyclic_channels=int(latent_shape[-1]))

    @staticmethod
    def _auto_hyper_lanes_from_shapes(shapes):
        """(y lanes, z lanes): y on the general path (a power of two), z
        cyclic (a multiple of its channels)."""
        (hy, wy, cy), (hz, wz, cz) = shapes
        return (auto_lanes(hy * wy * cy),
                auto_lanes(hz * wz * cz, cyclic_channels=cz))

    def _default_lanes(self, x_shape):
        """The lane count `stream_deploy_device` uses when given none: y's
        for a hyperprior."""
        shape = self._latent_shape(x_shape)
        if self.hyper:
            return self._auto_hyper_lanes_from_shapes(shape)[0]
        return self._auto_wire_lanes(shape)

    def _require_codec(self):
        if self.codec is None:
            raise ValueError(f'{type(self._bneck).__name__} has no entropy '
                             'model: there is no bitstream to code')

    def _require_splittable(self):
        """The device wire's guard: the JAX runtime serves it for the
        splittable FP/SHP/MSHP bottlenecks only."""
        if self._module_level_ops:
            raise ValueError('device-rANS wire supports the splittable '
                             'bottleneck runtimes')
        self._require_codec()

    def _symbols_nhwc(self, x, module=None):
        """Encoder (of `module`, by default the model) + round(y - median),
        flattened channels-last: lane j then always codes channel j mod C,
        as in the JAX wire format."""
        m = self.module if module is None else module
        ops = m if self._module_level_ops else self._split_bottleneck(m)
        sym = ops.encode_ops(self._prep_input(x), self._medians)['symbols']
        n, c, h, w = sym.shape
        return sym.permute(0, 2, 3, 1).reshape(n, -1), (h, w, c)

    def _encode_rows(self, xs, module):
        """`_symbols_nhwc` of each tensor of `xs` (one call each, at its
        own shape) with `module`, concatenated: (flat (k, N), (h, w, c))."""
        rows = [self._symbols_nhwc(x, module) for x in xs]
        shape = rows[0][1]
        if any(s != shape for _, s in rows):
            raise ValueError('encode_device_wire_batch needs images of one '
                             'shape')
        if len(rows) == 1:
            return rows[0]
        return torch.cat([f for f, _ in rows]), shape

    def _wire_symbols(self, xs):
        """The device wire's `_encode_rows` of one coding launch, replayed
        as a CUDA graph per (encoder module, k, shape, dtype) once a
        launch of that key has run eagerly (`utils/graphs.py`): the
        graph's kernels are the eager calls', one batch-1 encoder call an
        image, so the symbols are bitwise the eager ones. Its flat
        symbols are the graph's static output, rewritten by the next
        launch of the key: read them on this stream before then."""
        enc = self._encode_module()
        ops = self._split_bottleneck(enc)
        weights = itertools.chain(ops.parameters(), ops.buffers(),
                                  (self._medians,), () if self._norm_mean
                                  is None else (self._norm_mean,
                                                self._norm_std))
        return self._encode_graphs(ops, weights, xs,
                                   lambda rows: self._encode_rows(rows, enc))

    def _with_meta(self, out, shape, input_hw):
        # ok + exact wire size in one small tensor, read once at harvest
        out['meta'] = torch.stack([out['ok'].to(torch.int32), out['nbytes']],
                                  dim=-1)
        out['shape'] = shape
        out['input_hw'] = input_hw
        return out

    @torch.no_grad()
    def encode_device_wire(self, x, num_lanes=None):
        """Mobile side: encoder and rANS encode on the device, compacted
        streams (`device_rans_encode`; aligned at k = 1 when the latent is
        beyond the batch-1 kernels, and then `aligned` says so). The
        encoder is replayed as a CUDA graph per input shape, as in
        `encode_device_wire_batch` at k = 1."""
        self._require_splittable()
        with span('deploy.encode'):
            flat, shape = self._wire_symbols([x])
        if num_lanes is None:
            num_lanes = self._auto_wire_lanes(shape)
        cdf, cdf_len, off = self._tables_dev
        with span('deploy.rans_encode'):
            out = device_rans_encode(flat.reshape(-1), cdf, cdf_len, off,
                                     num_lanes=num_lanes,
                                     cyclic_channels=shape[-1])
        return self._with_meta(out, shape, tuple(x.shape[-2:]))

    @torch.no_grad()
    def encode_device_wire_batch(self, xs_list, num_lanes=None):
        """`encode_device_wire` for k images with ONE coding launch over
        time-aligned streams. The encoder runs per image, at the batch-1
        shape: cuDNN may choose another algorithm for a batch of k, and its
        float sums could move a symbol across a rounding boundary, while
        each image's bitstream must equal its batch-1 one.

        On a CUDA device the launch's k encoder calls, roundings and
        flattens are replayed as one CUDA graph (`_wire_symbols`): a
        launch of k images of one shape and dtype runs eagerly the first
        time, is captured the second, and is one copy of the images into
        the graph's static input and one replay after that, where the
        eager path dispatches about 25 kernels an image. The runtime
        keeps a few graphs (`utils/graphs.py`); keys seen once never push
        one out. `_encode_graphs.captures` counts the captures and, with
        a profiler running, `deploy.encode_graph.replays` the images a
        replay encoded."""
        self._require_splittable()
        with span('deploy.encode'):
            flat, shape = self._wire_symbols(xs_list)
        if num_lanes is None:
            num_lanes = self._auto_wire_lanes(shape)
        cdf, cdf_len, off = self._tables_dev
        with span('deploy.rans_encode'):
            out = device_rans_encode(flat, cdf, cdf_len, off,
                                     num_lanes=num_lanes,
                                     cyclic_channels=shape[-1], aligned=True)
        return self._with_meta(out, shape, tuple(xs_list[0].shape[-2:]))

    def _decode_tail(self, flat, shape, input_hw=None, module=None):
        """The output of `module` (by default the model) from flat NHWC
        symbols (n, h*w*c) of latent `shape`; `input_hw`, the encoded
        images' (h, w), is unused by a classifier."""
        m = self.module if module is None else module
        h, w, c = shape
        sym = flat.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        if self._module_level_ops:
            return m.decode_ops_to_logits(
                sym, self._medians).to(torch.float32)
        feat = self._split_bottleneck(m).decode_ops(sym, self._medians)
        return m.forward_tail(feat).to(torch.float32)

    def _host_decode_tail(self, flat, shape, input_hw=None):
        """The host wire's `_decode_tail`; with `deploy_bf16_tail`, the
        bottleneck's decoder in float32, then the tail on the bfloat16
        copy of its weights."""
        if not self.deploy_bf16_tail or self._bneck is None:
            return self._decode_tail(flat, shape, input_hw)
        h, w, c = shape
        sym = flat.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        feat = self._bneck.decode_ops(sym, self._medians)
        return self._bf16_tail_module().forward_tail(
            feat.to(torch.bfloat16)).to(torch.float32)

    @torch.no_grad()
    def decode_device_streams(self, streams, states, shape, num_lanes=None,
                              aligned: bool = False, input_hw=None):
        """Server side from device-resident (or uploaded) streams, compacted
        unless `aligned` (the encode result's): rANS decode + bottleneck
        decoder + tail. Returns (logits (1, K), valid)."""
        self._require_splittable()
        if num_lanes is None:
            num_lanes = self._auto_wire_lanes(shape)
        cdf, cdf_len, off = self._tables_dev
        with span('deploy.rans_decode'):
            flat, valid = device_rans_decode(
                streams, states, cdf, cdf_len, off,
                n_symbols=int(np.prod(shape)), num_lanes=num_lanes,
                cyclic_channels=shape[-1], aligned=aligned,
                device=self.device)
        with span('deploy.decode_tail'):
            return self._decode_tail(flat, shape, input_hw,
                                     module=self._decode_module()), valid

    @torch.no_grad()
    def decode_device_streams_batch(self, streams, states, shape,
                                    num_lanes=None, input_hw=None):
        """k images' time-aligned streams (k, N, T) -> (logits (k, K),
        valid (k,)), one decode launch and one batched tail."""
        return self.decode_device_streams(streams, states, shape,
                                          num_lanes=num_lanes, aligned=True,
                                          input_hw=input_hw)

    # ---- hyperprior device wire -------------------------------------------
    def _hyper_encode(self, xs_list, num_lanes, aligned):
        """Both latents of k same-shape images coded on the device: z on
        the cyclic kernels, y on the per-index ones (batched when
        `aligned`)."""
        bneck = self._split_bottleneck(self._encode_module())
        with span('deploy.encode'):
            ops = [self._hyper_ops(x, bneck) for x in xs_list]
        shapes = self._latent_shape(xs_list[0].shape)
        if any(tuple(o['z_symbols'].shape[1:]) != tuple(
                ops[0]['z_symbols'].shape[1:]) for o in ops):
            raise ValueError('a hyperprior wire batch needs images of one '
                             'shape')
        auto_y, z_lanes = self._auto_hyper_lanes_from_shapes(shapes)
        num_lanes = auto_y if num_lanes is None else num_lanes

        def flat(key):
            t = torch.cat([_nhwc(o[key]).reshape(1, -1) for o in ops])
            return t if aligned else t[0]

        cdf, cdf_len, off = self._tables_dev
        g_cdf, g_len, g_off = self._gtables_dev
        with span('deploy.rans_encode'):
            z_out = device_rans_encode(flat('z_symbols'), cdf, cdf_len, off,
                                       num_lanes=z_lanes,
                                       cyclic_channels=shapes[1][-1],
                                       aligned=aligned)
            y_out = device_rans_encode(flat('y_symbols'), g_cdf, g_len,
                                       g_off, num_lanes=num_lanes,
                                       aligned=aligned,
                                       indexes=flat('y_indexes'),
                                       prepared=self._gprepared)
        meta = torch.stack([(z_out['ok'] & y_out['ok']).to(torch.int32),
                            z_out['nbytes'] + y_out['nbytes']], dim=-1)
        return {'z': z_out, 'y': y_out, 'meta': meta, 'shapes': shapes,
                'lanes': (num_lanes, z_lanes)}

    @torch.no_grad()
    def encode_device_wire_hyper(self, x, num_lanes=None):
        """SHP/MSHP mobile side: the encoder, then z (factorized tables,
        cyclic lanes) and y (Gaussian tables, per-element indexes computed
        on the device, `num_lanes` general lanes) coded on the device,
        compacted streams. `meta` is [ok_z & ok_y, nbytes_z + nbytes_y];
        `lanes` the (y, z) lane counts the decoder uses."""
        return self._hyper_encode([x], num_lanes, aligned=False)

    @torch.no_grad()
    def encode_device_wire_hyper_batch(self, xs_list, num_lanes=None):
        """`encode_device_wire_hyper` of k images with one coding launch per
        latent over time-aligned streams; the encoder and h_s per image at
        the batch-1 shape. `meta` is (k, 2)."""
        return self._hyper_encode(list(xs_list), num_lanes, aligned=True)

    @torch.no_grad()
    def decode_device_streams_hyper(self, ops):
        """Server side of `encode_device_wire_hyper` (or of its batch, whose
        aligned streams it decodes with h_s per image at the batch-1 shape
        and the decoder and tail batched): decode z, recompute y's indexes
        and means from it (bit-equal to the encoder's), decode y, then the
        decoder and tail on those means. Returns (logits (k, K), valid (k,)), or (logits (1, K),
        valid) for a batch-1 result."""
        (hy, wy, cy), (hz, wz, cz) = ops['shapes']
        y_lanes, z_lanes = ops['lanes']
        z, y = ops['z'], ops['y']
        cdf, cdf_len, off = self._tables_dev
        with span('deploy.rans_decode'):
            z_flat, z_valid = device_rans_decode(
                z['streams'], z['states'], cdf, cdf_len, off,
                n_symbols=hz * wz * cz, num_lanes=z_lanes,
                cyclic_channels=cz, aligned=z['aligned'], device=self.device)
        z_sym = z_flat.reshape(-1, hz, wz, cz)
        y_idx, means = self._hyper_scales(z_sym)
        y_idx = y_idx.reshape(z_sym.shape[0], -1)
        g_cdf, g_len, g_off = self._gtables_dev
        with span('deploy.rans_decode'):
            y_flat, y_valid = device_rans_decode(
                y['streams'], y['states'], g_cdf, g_len, g_off,
                n_symbols=hy * wy * cy, num_lanes=y_lanes,
                aligned=y['aligned'], device=self.device,
                indexes=y_idx if z_flat.dim() == 2 else y_idx[0],
                prepared=self._gprepared)
        with span('deploy.decode_tail'):
            logits = self._decode_tail_hyper(y_flat.reshape(-1, hy, wy, cy),
                                             means, self._decode_module())
        return logits, z_valid & y_valid

    decode_device_streams_hyper_batch = decode_device_streams_hyper

    # ---- one serving loop for both bottleneck kinds ------------------------
    def _wire_encode(self, x, num_lanes):
        if self.hyper:
            return self.encode_device_wire_hyper(x, num_lanes=num_lanes)
        return self.encode_device_wire(x, num_lanes=num_lanes)

    def _wire_decode(self, ops, num_lanes):
        if self.hyper:
            return self.decode_device_streams_hyper(ops)
        return self.decode_device_streams(
            ops['streams'], ops['states'], ops['shape'], num_lanes=num_lanes,
            aligned=ops['aligned'], input_hw=ops['input_hw'])

    def _wire_encode_batch(self, xs_list, num_lanes):
        if self.hyper:
            return self.encode_device_wire_hyper_batch(xs_list,
                                                       num_lanes=num_lanes)
        return self.encode_device_wire_batch(xs_list, num_lanes=num_lanes)

    def _wire_decode_batch(self, ops, num_lanes):
        if self.hyper:
            return self.decode_device_streams_hyper_batch(ops)
        return self.decode_device_streams_batch(
            ops['streams'], ops['states'], ops['shape'], num_lanes=num_lanes,
            input_hw=ops['input_hw'])

    def _shape_hw(self, ops):
        """The spatial shape accounted with an image: z's for a
        hyperprior."""
        return ops['shapes'][1][:2] if self.hyper else ops['shape'][:2]

    def _pull_device_wire(self, ops):
        """Pack the device streams into the wire bytes (a hyperprior's: z's
        then y's, each self-describing). Compacted streams: lengths first,
        then only the used prefix crosses to the host; aligned ones with
        their masks."""
        if self.hyper and 'z' in ops:
            return self._pull_device_wire(ops['z']) \
                + self._pull_device_wire(ops['y'])
        lengths = ops['lengths'].cpu().numpy()
        states = ops['states'].cpu().numpy()
        if ops.get('aligned'):
            return pack_stream_aligned({
                'streams': ops['streams'].cpu().numpy(),
                'masks': ops['masks'].cpu().numpy(), 'lengths': lengths,
                'states': states})
        lmax = max(int(lengths.max()), 1)
        return pack_stream({'streams': ops['streams'][:, :lmax].cpu().numpy(),
                            'lengths': lengths, 'states': states})

    def _throttle(self, inflight: deque, depth: int):
        """Bound the queued device work to `depth` items without reading
        any result: wait on the event of the item `depth` places back."""
        if self.device.type != 'cuda':
            return
        ev = torch.cuda.Event()
        ev.record()
        inflight.append(ev)
        while len(inflight) > max(int(depth), 1):
            with span('deploy.throttle', wait=True):
                inflight.popleft().synchronize()

    def _sync(self):
        """The end of a serving call: wait for the device's queued
        work."""
        if self.device.type == 'cuda':
            with span('deploy.sync', wait=True):
                torch.cuda.synchronize(self.device)

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
        codes k images per launch. `num_lanes` None picks each image's
        lanes from its latent's shape (`_default_lanes`). A hyperprior
        codes z and y of each image and accounts both wires together;
        `num_lanes` is then y's.
        A model with module-level deploy ops, or without an entropy model,
        raises `ValueError`, as in the JAX runtime."""
        del workers
        self._require_splittable()
        images = list(images)
        if not images:
            return []
        batched = wire_batch is not None and wire_batch > 1
        if batched and pull_wire:
            raise ValueError('wire_batch grouping does not support '
                             'pull_wire packing')
        count('deploy.images', len(images))
        with span('deploy.request'):
            if batched:
                results = self._stream_deploy_device_batched(
                    images, wire_batch, depth, num_lanes, timings)
            else:
                results = self._stream_deploy_device_single(
                    images, depth, num_lanes, pull_wire, timings)
            self._sync()
        return results

    def _stream_deploy_device_single(self, images, depth, num_lanes,
                                     pull_wire, timings):
        """One image per coding launch (`stream_deploy_device`)."""
        staged, inflight = [], deque()
        for i, x in enumerate(images):
            ops = self._wire_encode(x, num_lanes)
            with span('deploy.decode', timings, 'decode_dispatch'):
                logits, valid = self._wire_decode(ops, num_lanes)
            shape_hw = self._shape_hw(ops)
            if pull_wire:
                # packing needs the stream content: sync here
                with span('deploy.pull.read', wait=True):
                    ok, nbytes = ops['meta'].tolist()
                    valid = bool(valid)
                if ok and valid:
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

        results = []
        with span('deploy.drain', timings, 'account_d2h'):
            if pull_wire:
                for i, (wire, shape_hw, logits, ok) in enumerate(staged):
                    if wire is None:
                        results.append(self._escape(images[i], ok, i))
                        continue
                    self.analyze({'strings': [[wire]], 'shape': shape_hw})
                    results.append(logits)
                return results
            with span('deploy.drain.read', wait=True):
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
            ops = self._wire_encode_batch(images[j0:j1], num_lanes)
            with span('deploy.decode', timings, 'decode_dispatch'):
                logits, valid = self._wire_decode_batch(ops, num_lanes)
            staged.append((ops['meta'], self._shape_hw(ops), logits, valid))
            self._throttle(inflight, depth)

        with span('deploy.drain', timings, 'account_d2h'):
            with span('deploy.drain.read', wait=True):
                metas = torch.cat([s[0] for s in staged]).cpu().numpy()
                valids = torch.cat([s[3] for s in staged]).cpu().numpy()
            results, i = [], 0
            for _, shape_hw, logits, _ in staged:
                for j in range(_num_rows(logits)):
                    if not metas[i, 0] or not valids[i]:
                        results.append(self._escape(images[i], metas[i, 0],
                                                    i))
                        i += 1
                        continue
                    self.analyze({'strings': [[bytes(int(metas[i, 1]))]],
                                  'shape': shape_hw})
                    results.append(_rows(logits, j, j + 1))
                    i += 1
        return results
