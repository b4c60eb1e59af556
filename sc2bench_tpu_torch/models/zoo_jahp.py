"""Joint autoregressive and hierarchical prior image codec, mbt2018
(counterpart of `sc2bench_tpu/models/zoo_jahp.py`), NCHW, in CompressAI's
key space.

The training forward is parallel: the masked 5x5 context convolution runs
teacher-forced over the whole noisy (or rounded) y. Coding is serial by
construction: the Gaussian parameters of each position depend on the
positions decoded before it. The runtime codes in anti-diagonal
wavefronts (`wavefronts`): front d holds the positions with 3i + j = d,
every causal tap of which lies in an earlier front, so one front is one
batched evaluation of the context model (the 12 causal taps packed into
one matmul, then the entropy-parameters MLP with LeakyReLU 0.01) --
61 fronts instead of 256 positions for a 16x16 latent.

Two wires share that scan:

  host    `compress`/`decompress`: the context model runs on the runtime's
          device front by front; y's symbols and indexes cross to the host
          and are coded in one stream with the Gaussian tables (the
          decoder decodes one front a call through `StreamingDecoder`), z
          with the factorized prior -- the JAX package's strings;
  device  `encode_device_wire`/`decode_device_wire` (`zoo_jahp_device.py`):
          y on masked rANS lanes, one CUDA launch an image to encode and
          one a front to decode, z on the cyclic aligned lanes.

Both evaluate the context model with the same function on the same shapes
(every front padded to the widest one), so the host path's y_hat and the
device wire's are bit-equal. On the card that function is four
hand-written kernels a front (`zoo_jahp_front.py`, `csrc/jahp_front.cu`),
chosen once by `update()`; on the CPU it is `ContextModel.front_params`,
their plain version. Encoder and decoder agree bit for bit only if the
arithmetic is repeatable: the kernels sum in one fixed order, and on the
card the runtime turns TF32 off and runs h_s with cuDNN's deterministic
algorithms.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.entropy.factorized import EntropyBottleneck
from ..ops.entropy.gaussian import GaussianConditional, get_scale_table
from ..ops.entropy.tables import build_gaussian_tables
from ..ops.math import quantize_noise
from ..ops.rans import kernels
from ..ops.rans.coder import RansCoder, StreamingDecoder
from ..ops.rans.indexed_tables import prepare_indexed_tables
from ..registry import register_model
from ..utils.graphs import GraphCache
from ..utils.profiling import count, span
from .runtime import FactorizedCodec, _exact_cudnn
from .zoo import (_conv, _deconv, _on, analysis_transform, nchw,
                  synthesis_transform)
from .zoo_jahp_device import JointAutoregressiveDeviceMixin
from .zoo_jahp_front import front_kernels

HALO = 2                      # the 5x5 context kernel's reach


def causal_mask(k: int = 5) -> np.ndarray:
    """(k, k) 'A' mask: the positions strictly before the centre in raster
    order."""
    mask = np.ones((k, k), np.float32)
    mask[k // 2, k // 2:] = 0
    mask[k // 2 + 1:] = 0
    return mask


class MaskedConv2d(nn.Conv2d):
    """k x k convolution with the 'A' mask: an output position sees only
    strictly earlier raster positions of its input. The mask is a buffer
    of the weight's shape, as CompressAI keeps it."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 5):
        super().__init__(in_channels, out_channels, kernel,
                         padding=kernel // 2)
        self.register_buffer('mask', torch.from_numpy(np.broadcast_to(
            causal_mask(kernel), self.weight.shape).copy()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.mask, self.bias,
                        padding=self.padding)


class JointAutoregressiveCodec(nn.Module):
    """mbt2018: the mean-scale hyperprior's transforms, a masked context
    model over y and the entropy-parameters network, which gives each
    position's Gaussian (scale, mean) from the hyper and context
    features."""

    def __init__(self, n: int = 192, m: int = 192):
        super().__init__()
        self.n, self.m = n, m
        self.g_a = analysis_transform(n, m)
        self.g_s = synthesis_transform(n, m)

        def act():
            return nn.LeakyReLU(0.01)
        self.h_a = nn.Sequential(_conv(m, n, 3, 1), act(), _conv(n, n, 5, 2),
                                 act(), _conv(n, n, 5, 2))
        self.h_s = nn.Sequential(_deconv(n, m, 5, 2), act(),
                                 _deconv(m, m * 3 // 2, 5, 2), act(),
                                 _conv(m * 3 // 2, 2 * m, 3, 1))
        self.context_prediction = MaskedConv2d(m, 2 * m)
        self.entropy_parameters = nn.Sequential(
            nn.Conv2d(4 * m, m * 10 // 3, 1), act(),
            nn.Conv2d(m * 10 // 3, m * 8 // 3, 1), act(),
            nn.Conv2d(m * 8 // 3, 2 * m, 1))
        self.entropy_bottleneck = EntropyBottleneck(n)
        self.gaussian_conditional = GaussianConditional()

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """The reconstruction, teacher-forced: 'train' quantizes z and y
        with uniform noise from `generator`, any other mode rounds y and
        dequantizes z with its medians; the context model sees the whole
        quantized y. `io` gets `eb_out` (z) and `gc_out` (y)."""
        y = self.g_a(x)
        z = self.h_a(y)
        eb_mode = 'noise' if mode == 'train' else 'dequantize'
        z_hat, z_lik = self.entropy_bottleneck(z, mode=eb_mode,
                                               generator=generator)
        hyper = self.h_s(z_hat)
        if mode == 'train':
            if generator is None:
                raise ValueError("the 'train' mode needs a torch.Generator")
            y_hat = quantize_noise(y, generator)
        else:
            y_hat = torch.round(y)
        ctx = self.context_prediction(y_hat)
        params = self.entropy_parameters(torch.cat([hyper, ctx], dim=1))
        scales, means = torch.chunk(params, 2, dim=1)
        y_lik = self.gaussian_conditional.likelihood(y_hat, scales, means)
        if io is not None:
            io['eb_out'] = (z_hat, z_lik)
            io['gc_out'] = (y_hat, y_lik)
        return self.g_s(y_hat)

    def encode_ops(self, x: torch.Tensor, z_medians: torch.Tensor) -> dict:
        """The parallel half of coding: y, z's symbols and the hyper
        feature h_s(z_hat), NCHW."""
        y = self.g_a(x)
        z = self.h_a(y)
        z_symbols = torch.round(z - z_medians[:, None, None]).to(torch.int32)
        return {'y': y, 'z_symbols': z_symbols,
                'hyper': self.hyper_from_z(z_symbols, z_medians)}

    def hyper_from_z(self, z_symbols: torch.Tensor,
                     z_medians: torch.Tensor) -> torch.Tensor:
        return self.h_s(z_symbols.to(torch.float32)
                        + z_medians[:, None, None])

    def decode_image(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.g_s(y_hat)


def causal_taps(k: int = 5):
    """(rows, cols) of the 'A' mask's nonzero positions, raster order."""
    pos = np.argwhere(causal_mask(k) > 0)
    return pos[:, 0], pos[:, 1]


class ContextModel:
    """The context model and entropy-parameters MLP at the positions of
    one front, over HWC tensors on the module's device: the 12 causal taps
    of the masked kernel gathered from the halo-padded y_hat and packed
    into one (F, 12m) x (12m, 2m) matmul, then the three 1x1 layers as
    matmuls with LeakyReLU 0.01 (the host half of the JAX package's
    `_HostAutoregressive` and its device twin, one op order). As library
    ops that is about 15 launches a front; `front_params` is the plain
    version of the front kernels (`zoo_jahp_front.py`), which the loops
    run on the card."""

    def __init__(self, module: JointAutoregressiveCodec):
        cp = module.context_prediction
        dev = cp.weight.device
        rows, cols = causal_taps(cp.kernel_size[0])
        self.dr = torch.as_tensor(rows, device=dev)
        self.dc = torch.as_tensor(cols, device=dev)
        w = (cp.weight * cp.mask).detach()               # (2m, m, k, k)
        # (2m, m, taps) -> (taps, m, 2m) -> (taps * m, 2m)
        self.kernel = w[:, :, self.dr, self.dc].permute(2, 1, 0) \
            .reshape(-1, w.shape[0]).contiguous()
        self.bias = cp.bias.detach()
        self.ep = [(conv.weight.detach()[:, :, 0, 0].t().contiguous(),
                    conv.bias.detach())
                   for conv in module.entropy_parameters
                   if isinstance(conv, nn.Conv2d)]

    def front_params(self, y_hat_pad: torch.Tensor, hyper: torch.Tensor,
                     ii: torch.Tensor, jj: torch.Tensor):
        """(scales, means), each (F, m), at positions (ii, jj) of the
        (H+4, W+4, m) halo-padded y_hat and the (H, W, 2m) hyper feature.
        Pad slots (ii < 0) read position (0, 0); the caller drops them."""
        ii = ii.clamp_min(0)
        jj = jj.clamp_min(0)
        taps = y_hat_pad[ii[:, None] + self.dr, jj[:, None] + self.dc]
        feat = torch.cat([hyper[ii, jj],
                          taps.reshape(taps.shape[0], -1) @ self.kernel
                          + self.bias], dim=1)
        for li, (w, b) in enumerate(self.ep):
            feat = feat @ w + b
            if li < 2:
                feat = torch.where(feat > 0, feat, 0.01 * feat)
        half = feat.shape[1] // 2
        return feat[:, :half], feat[:, half:]


def scale_indexes(scales: torch.Tensor,
                  scale_table: torch.Tensor) -> torch.Tensor:
    """Row of the Gaussian tables of each scale: the count of entries of
    `scale_table` (float64, the last excluded) strictly below max(s, 0.11)
    taken in float32, as the JAX package's host coder counts them."""
    s = scales.clamp_min(0.11).to(torch.float64)
    return (s[..., None] > scale_table[:-1]).sum(dim=-1).to(torch.int32)


def wavefronts(h: int, w: int, k: int = 5):
    """The anti-diagonal schedule d = a*i + j, a = k//2 + 1: every causal
    dependency of (i, j) under the masked k x k kernel has a smaller d.
    A list of (ii, jj) int arrays, one per non-empty front."""
    a = k // 2 + 1
    fronts = []
    for d in range(a * (h - 1) + w):
        ii = np.arange(max(0, (d - w + 1 + a - 1) // a), min(h, d // a + 1))
        jj = d - a * ii
        keep = (jj >= 0) & (jj < w)
        if np.any(keep):
            fronts.append((ii[keep], jj[keep]))
    return fronts


def front_arrays(fronts):
    """The schedule padded to (T, F): ii (-1 in pad slots), jj (0 there)
    and `active`; the active slots of each front come first."""
    T = len(fronts)
    F_ = max(len(ii) for ii, _ in fronts)
    ii = np.full((T, F_), -1, np.int32)
    jj = np.zeros((T, F_), np.int32)
    act = np.zeros((T, F_), bool)
    for t, (fi, fj) in enumerate(fronts):
        ii[t, :len(fi)] = fi
        jj[t, :len(fi)] = fj
        act[t, :len(fi)] = True
    return ii, jj, act


class Schedule:
    """The padded wavefront schedule of an h x w latent on a device: `ii`,
    `jj` (T, F) int64 and `active` (T, F) uint8 tensors, and each front's
    count of active slots `counts` on the host."""

    def __init__(self, h: int, w: int, device):
        ii, jj, act = front_arrays(wavefronts(h, w))
        self.h, self.w = h, w
        self.ii = torch.as_tensor(ii, dtype=torch.int64, device=device)
        self.jj = torch.as_tensor(jj, dtype=torch.int64, device=device)
        self.active = torch.as_tensor(act, dtype=torch.uint8, device=device)
        self.active_host = act
        self.counts = act.sum(axis=1).tolist()

    @property
    def steps(self) -> int:
        return len(self.counts)

    @property
    def slots(self) -> int:
        return self.ii.shape[1]

    def write(self, y_hat_pad, t: int, values: torch.Tensor) -> None:
        """Store front t's active rows of `values` (F, m) into y_hat."""
        n = self.counts[t]
        y_hat_pad[self.ii[t, :n] + HALO, self.jj[t, :n] + HALO] = values[:n]


class JointAutoregressiveRuntime(JointAutoregressiveDeviceMixin):
    """The joint autoregressive codec's host wire (`compress`,
    `decompress`) and device wire (`encode_device_wire`,
    `decode_device_wire`), on `device` (CUDA unless asked otherwise).
    `timings` accumulates the host coder's seconds (`host_encode`,
    `host_decode`)."""

    def __init__(self, module: JointAutoregressiveCodec, device=None):
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.module = module.to(self.device).eval()
        self.codec = FactorizedCodec()
        self.scale_table = get_scale_table()
        self.g_tables = None
        self.g_coder = None
        self.timings = {}
        self._schedules = {}
        self._front_kernels = None

    def update(self):
        """Build z's tables, the Gaussian tables of y, their device copies
        and their prepared form (for the masked encoder and front
        decoder), and the context model from the current weights."""
        self.codec.update(self.module.entropy_bottleneck)
        if self.g_tables is None:
            self.g_tables = build_gaussian_tables(self.scale_table)
            self.g_coder = RansCoder(self.g_tables.quantized_cdf,
                                     self.g_tables.cdf_length,
                                     self.g_tables.offset)
        dev = self.device
        self._medians = torch.as_tensor(self.codec.tables.medians,
                                        device=dev)
        self._scale_table = torch.as_tensor(self.scale_table,
                                            dtype=torch.float64, device=dev)
        self._z_tables = tuple(
            torch.as_tensor(a, dtype=torch.int32, device=dev)
            for a in (self.codec.tables.quantized_cdf,
                      self.codec.tables.cdf_length,
                      self.codec.tables.offset))
        self._g_tables_dev = tuple(
            torch.as_tensor(a, dtype=torch.int32, device=dev)
            for a in (self.g_tables.quantized_cdf, self.g_tables.cdf_length,
                      self.g_tables.offset))
        self._g_prepared = prepare_indexed_tables(*self._g_tables_dev)
        self.context = ContextModel(self.module)
        self._front_kernels = front_kernels(self.context, self._scale_table,
                                            self.module.m)
        self._scan_graphs = GraphCache('codec.scan_graph',
                                       tally=kernels.LAUNCHES)
        self._front_graphs = GraphCache('codec.front_graph',
                                        tally=kernels.LAUNCHES)
        return True

    def schedule(self, h: int, w: int) -> Schedule:
        if (h, w) not in self._schedules:
            self._schedules[(h, w)] = Schedule(h, w, self.device)
        return self._schedules[(h, w)]

    def _count_fronts(self, sch: Schedule) -> None:
        """The counters of a loop over `sch`'s fronts: `codec.front_steps`,
        and `codec.fused_fronts` when the front kernels run them."""
        count('codec.front_steps', sch.steps)
        if self._front_kernels is not None:
            count('codec.fused_fronts', sch.steps)

    # ---- the shared scan ------------------------------------------------------
    def _encode_ops(self, x):
        """(y, z_symbols, hyper) of an NCHW batch of one: y and hyper HWC
        on the device, z's symbols NCHW."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with _exact_cudnn():
            ops = self.module.encode_ops(x, self._medians)
        return (ops['y'][0].permute(1, 2, 0), ops['z_symbols'],
                ops['hyper'][0].permute(1, 2, 0).contiguous())

    def _hyper(self, z_symbols: torch.Tensor) -> torch.Tensor:
        with _exact_cudnn():
            hyper = self.module.hyper_from_z(z_symbols, self._medians)
        return hyper[0].permute(1, 2, 0).contiguous()

    def _indexes(self, scales: torch.Tensor) -> torch.Tensor:
        return scale_indexes(scales, self._scale_table)

    def _new_latent(self, h: int, w: int) -> torch.Tensor:
        return torch.zeros((h + 2 * HALO, w + 2 * HALO, self.module.m),
                           dtype=torch.float32, device=self.device)

    def forward_scan(self, y: torch.Tensor, hyper: torch.Tensor):
        """Quantize y front by front: (symbols (T, F, m) int32, indexes
        (T, F, m) int32, halo-padded y_hat), pad slots included (the
        caller drops them). The loop is the span `codec.scan`."""
        self._count_fronts(self.schedule(y.shape[0], y.shape[1]))
        with span('codec.scan'):
            return self._scan_loop(y, hyper)

    def _scan_loop(self, y: torch.Tensor, hyper: torch.Tensor):
        """`forward_scan`'s loop."""
        sch = self.schedule(y.shape[0], y.shape[1])
        y_hat = self._new_latent(sch.h, sch.w)
        if self._front_kernels is not None:
            return self._front_kernels.scan(y, hyper, sch, y_hat)
        syms, idxs = [], []
        for t in range(sch.steps):
            ii, jj = sch.ii[t], sch.jj[t]
            scales, means = self.context.front_params(y_hat, hyper, ii, jj)
            sym = torch.round(y[ii.clamp_min(0), jj] - means)
            sch.write(y_hat, t, sym + means)
            syms.append(sym.to(torch.int32))
            idxs.append(self._indexes(scales))
        return torch.stack(syms), torch.stack(idxs), y_hat

    @staticmethod
    def latent(y_hat_pad: torch.Tensor) -> torch.Tensor:
        """The (1, m, h, w) latent inside the halo."""
        return nchw(y_hat_pad[None, HALO:-HALO, HALO:-HALO])

    # ---- host wire ------------------------------------------------------------
    @torch.no_grad()
    def compress_latent(self, x):
        """(`compress`'s object, the encoder's y_hat (1, m, h, w))."""
        y, z_symbols, hyper = self._encode_ops(x)
        syms, idxs, y_hat = self.forward_scan(y, hyper)
        sch = self.schedule(y.shape[0], y.shape[1])
        act = sch.active_host
        syms, idxs = syms.cpu().numpy()[act], idxs.cpu().numpy()[act]
        z_sym = z_symbols.permute(0, 2, 3, 1).cpu().numpy()
        with span('codec.host_encode', self.timings, 'host_encode'):
            y_strings = [self.g_coder.encode_with_indexes(syms.ravel(),
                                                          idxs.ravel())]
            z_strings = self.codec.compress_symbols(z_sym)
        return ({'strings': [y_strings, z_strings],
                 'shape': tuple(z_sym.shape[1:3])}, self.latent(y_hat))

    def compress(self, x) -> dict:
        """{'strings': [[y's stream], [z's]], 'shape': z's (h, w)} of the
        NCHW batch of one `x`: y's symbols in wavefront order, the
        positions of a front in row order, channels innermost."""
        return self.compress_latent(x)[0]

    @torch.no_grad()
    def decompress_latent(self, strings, shape) -> torch.Tensor:
        """The decoded y_hat (1, m, h, w): z, then front by front the
        context model on the device and that front's symbols from the
        streaming host decoder."""
        with span('codec.host_decode', self.timings, 'host_decode'):
            z_sym = self.codec.decompress_symbols(strings[1], shape,
                                                  self.module.n)
        hyper = self._hyper(nchw(torch.from_numpy(z_sym).to(self.device)))
        sch = self.schedule(hyper.shape[0], hyper.shape[1])
        y_hat = self._new_latent(sch.h, sch.w)
        decoder = StreamingDecoder(self.g_coder, strings[0][0])
        m = self.module.m
        fk = self._front_kernels
        for t in range(sch.steps):
            n = sch.counts[t]
            if fk is None:
                scales, means = self.context.front_params(
                    y_hat, hyper, sch.ii[t], sch.jj[t])
                idx = self._indexes(scales[:n]).cpu().numpy()
            else:
                means, rows = fk.front(y_hat, hyper, sch, t)
                idx = rows[:n * m].cpu().numpy()
            with span('codec.host_decode', self.timings, 'host_decode'):
                sym = decoder.decode(idx.ravel()).reshape(n, m)
            sym = torch.from_numpy(sym).to(self.device)
            sch.write(y_hat, t, sym.to(torch.float32) + means[:n])
        return self.latent(y_hat)

    @torch.no_grad()
    def decompress(self, strings, shape) -> torch.Tensor:
        """The NCHW reconstruction of `compress`'s output."""
        return self.module.decode_image(
            self.decompress_latent(strings, shape))


@register_model
def joint_autoregressive_hierarchical_prior(quality=1, n=None, m=None,
                                            device=None, **kwargs):
    qn, qm = (192, 192) if int(quality) <= 5 else (192, 320)
    return _on(JointAutoregressiveCodec(n=n or qn, m=m or qm), device)


@register_model
def mbt2018(quality=1, **kwargs):
    return joint_autoregressive_hierarchical_prior(quality, **kwargs)
