"""The context model of one wavefront front as hand-written CUDA kernels
(`csrc/jahp_front.cu`): the card's path of the joint autoregressive
codec's two wavefront loops, whose plain version is
`ContextModel.front_params` (with `scale_indexes`, the round and
`Schedule.write`).

A front is four launches: the context model's product over the 12 causal
taps (`jahp_front_ctx`), the entropy-parameters MLP's two hidden layers
(`jahp_front_hidden`, twice) and its last layer with the scale indexes
(`jahp_front_params`), which in the scan also rounds the symbols and
writes y_hat. The decoder's front adds its write (`jahp_front_write`)
after the masked decode step. Each layer's sums run in one fixed order,
so the encoder's and decoder's fronts give the same bits; they differ
from `front_params`' only by float32 reordering (scales and means within
about 1e-6 relative), so an index or symbol on a table or rounding
boundary may land one step away from the plain version's.

A launch takes at most `MAX_SLOTS` positions; a wider front launches
each layer once a group of at most `MAX_SLOTS` of its rows (`groups`),
layer by layer. A row's sums do not depend on the other rows, so the
bits are those of one launch. `front_kernels` builds the kernels for a
`ContextModel` on a card, where they take every front, and raises there
for weights they cannot take (not float32, more than `MAX_TAPS` taps, a
layer whose slice exceeds a block's shared memory); elsewhere it gives
None and the loops run `front_params`. `FrontKernels` holds the weights
padded once to the kernels' tiles and launches them, counting each
launch in `kernels.LAUNCHES` (so that `GraphCache`'s tally follows
replays). The library is built like the rANS kernels'
(`ops/rans/kernels.py` `build_libraries`), at first use.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from ..ops.rans import kernels

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'jahp_front.cu'
MAX_SLOTS = 8          # positions a launch; csrc/jahp_front.cu's MAX_SLOTS
TILE = 64              # output columns a cluster; its TN

_lib = None
_lock = threading.Lock()


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(kernels.build_libraries((SOURCE,))[0]))
            p, i = ctypes.c_void_p, ctypes.c_int
            for name, args, res in (
                    ('jahp_front_smem', [i, i, i], ctypes.c_longlong),
                    ('jahp_front_max_slots', [], i),
                    ('jahp_front_init', [i], i),
                    ('jahp_front_max_taps', [], i),
                    ('jahp_front_tile', [], i),
                    ('jahp_front_ctx', [i, p, i, i, p, i, p, p, p, i, p, p],
                     i),
                    ('jahp_front_hidden',
                     [i, p, i, i, p, p, i, i, p, p, i, p, p], i),
                    ('jahp_front_params',
                     [i, p, i, i, p, i, i, p, p, i, p, i, p, p, p, p, p, p,
                      p], i),
                    ('jahp_front_write', [i, p, i, i, p, p, p, p], i)):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            if (lib.jahp_front_max_slots(), lib.jahp_front_tile()) != \
                    (MAX_SLOTS, TILE):
                raise RuntimeError('csrc/jahp_front.cu and zoo_jahp_front.py '
                                   'disagree on the slots or the tile')
            _lib = lib
    return _lib


def groups(slots: int):
    """(first row, rows) of each launch of a layer of a front of `slots`
    positions: its rows in order, at most `MAX_SLOTS` a launch."""
    return [(g, min(MAX_SLOTS, slots - g))
            for g in range(0, slots, MAX_SLOTS)]


def _ptr(t, row=0, width=0):
    """The address of row `row` of `t`, `width` elements a row."""
    return None if t is None else t.data_ptr() + row * width * t.element_size()


class FrontKernels:
    """The front kernels on a `ContextModel`'s float32 weights on a card
    and the float64 `scale_table` on its device: `scan` runs the encoder's
    loop, `front` and `write` one front of the decoder's. A launch takes
    its positions and the taps by value, from host copies made once a
    schedule. Raises for weights the kernels cannot take."""

    def __init__(self, context, scale_table: torch.Tensor, m: int):
        self.m = int(m)
        self.device = context.kernel.device
        if context.kernel.dtype != torch.float32:
            raise ValueError('the front kernels take float32 weights, not '
                             f'{context.kernel.dtype}')
        self.taps = np.ascontiguousarray(np.concatenate([
            context.dr.cpu().numpy(), context.dc.cpu().numpy()]),
            dtype=np.int32)
        self.table = scale_table.contiguous()
        self.layers = []       # (weight (K, np), bias (np,), K) a layer
        for li, (w, b) in enumerate([(context.kernel, context.bias)]
                                    + list(context.ep)):
            k, n = w.shape
            # the third and fourth layers read the previous one's padded
            # activations: zero rows below its real width
            rows = k if li < 2 else self.layers[-1][0].shape[1]
            cols = -(-n // TILE) * TILE
            wp = w.new_zeros((rows, cols))
            wp[:k, :n] = w
            bp = b.new_zeros(cols)
            bp[:n] = b
            self.layers.append((wp.contiguous(), bp, rows))
        self._positions = {}
        lib = _library()
        if self.taps.size > 2 * lib.jahp_front_max_taps():
            raise ValueError(f'the front kernels take at most '
                             f'{lib.jahp_front_max_taps()} taps, not '
                             f'{self.taps.size // 2}')
        with torch.cuda.device(self.device):
            optin = torch.cuda.get_device_properties(
                self.device).shared_memory_per_block_optin
            rc = lib.jahp_front_init(optin)
        if rc != 0:
            raise RuntimeError(f'jahp_front_init failed: CUDA error {rc}')
        # a launch of MAX_SLOTS rows takes the most shared memory
        tables = [0, 0, 0, self.table.numel()]
        for li, ((_, _, k), n) in enumerate(zip(self.layers, tables)):
            need = lib.jahp_front_smem(MAX_SLOTS, k, n)
            if not 0 <= need <= optin:
                raise ValueError(f'layer {li} of the front kernels ({k} '
                                 f'inputs) needs {need} bytes of shared '
                                 f'memory a block; the card gives {optin}')

    def _pos(self, sch, t: int, gi: int) -> int:
        """The host address of group gi of front t's positions: its rows,
        then its columns (int32, as many as the group has)."""
        key = (sch.h, sch.w)
        if key not in self._positions:
            ii, jj = sch.ii.cpu().numpy(), sch.jj.cpu().numpy()
            parts = groups(sch.slots)
            pos = np.zeros((sch.steps, len(parts), 2 * MAX_SLOTS), np.int32)
            for k, (g, n) in enumerate(parts):
                pos[:, k, :n] = ii[:, g:g + n]
                pos[:, k, n:2 * n] = jj[:, g:g + n]
            self._positions[key] = pos
        return self._positions[key][t, gi].ctypes.data

    def _launch(self, name, fn, *args):
        with torch.cuda.device(self.device):
            rc = fn(*args, torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
        kernels.LAUNCHES[name] += 1

    def buffers(self, slots: int):
        """The activations of a front's first three layers, (slots, np)
        each; a loop allocates them once for all its fronts."""
        return [torch.empty((slots, w.shape[1]), dtype=torch.float32,
                            device=self.device) for w, _, _ in self.layers[:3]]

    def layer(self, i: int, y_hat, hyper, sch, t: int, acts) -> None:
        """Launch layer i (0: the context model, 1 and 2: the hidden
        layers) of front t, into acts[i]."""
        lib = _library()
        w, b, k = self.layers[i]
        np_ = w.shape[1]
        for gi, (g, n) in enumerate(groups(sch.slots)):
            front = (n, self._pos(sch, t, gi), sch.w, self.m)
            if i == 0:
                self._launch('jahp_front_ctx', lib.jahp_front_ctx, *front,
                             self.taps.ctypes.data, self.taps.size // 2,
                             _ptr(y_hat), _ptr(w), _ptr(b), np_,
                             _ptr(acts[0], g, np_))
            else:
                src = acts[i - 1]
                self._launch('jahp_front_hidden', lib.jahp_front_hidden,
                             *front, _ptr(hyper) if i == 1 else None,
                             _ptr(src, g, src.shape[1]), src.shape[1], k,
                             _ptr(w), _ptr(b), np_, _ptr(acts[i], g, np_))

    def _hidden(self, y_hat, hyper, sch, t, acts):
        """The first three layers of front t into `acts`."""
        for i in range(3):
            self.layer(i, y_hat, hyper, sch, t, acts)

    def params(self, acts, sch, t: int, idxs, y=None, y_hat=None, syms=None,
               means=None, scales=None) -> None:
        """Launch the last layer of front t on acts[2]: its rows into
        `idxs` (F, m) int32; with `y` the scan's tail (`syms` (F, m) int32
        and the write into `y_hat`), else the means into `means` (F, m)
        (and the scales into `scales`, where given)."""
        w3, b3, k3 = self.layers[3]
        src, m = acts[2], self.m
        for gi, (g, n) in enumerate(groups(sch.slots)):
            self._launch('jahp_front_params', _library().jahp_front_params,
                         n, self._pos(sch, t, gi), sch.w, m,
                         _ptr(src, g, src.shape[1]), src.shape[1], k3,
                         _ptr(w3), _ptr(b3), w3.shape[1], _ptr(self.table),
                         self.table.numel() - 1, _ptr(y), _ptr(y_hat),
                         _ptr(syms, g, m), _ptr(idxs, g, m),
                         _ptr(means, g, m), _ptr(scales, g, m))

    def scan(self, y: torch.Tensor, hyper: torch.Tensor, sch,
             y_hat: torch.Tensor):
        """The encoder's loop on schedule `sch`: y (h, w, m) and hyper (h,
        w, 2m) HWC, y_hat the zeroed halo-padded latent -> (symbols (T, F,
        m) int32, indexes (T, F, m) int32, y_hat), as the plain scan's."""
        y, hyper = y.contiguous(), hyper.contiguous()
        syms = torch.empty((sch.steps, sch.slots, self.m), dtype=torch.int32,
                           device=self.device)
        idxs = torch.empty_like(syms)
        acts = self.buffers(sch.slots)
        for t in range(sch.steps):
            self._hidden(y_hat, hyper, sch, t, acts)
            self.params(acts, sch, t, idxs[t], y=y, y_hat=y_hat,
                        syms=syms[t])
        return syms, idxs, y_hat

    def front(self, y_hat, hyper, sch, t: int, scales=None):
        """The decoder's front t: (means (F, m) float32, the rows of its
        lanes (F * m,) int32); `scales` (F, m), where given, gets its
        scales."""
        acts = self.buffers(sch.slots)
        means = torch.empty((sch.slots, self.m), dtype=torch.float32,
                            device=self.device)
        idx = torch.empty(sch.slots * self.m, dtype=torch.int32,
                          device=self.device)
        self._hidden(y_hat, hyper.contiguous(), sch, t, acts)
        self.params(acts, sch, t, idx, means=means, scales=scales)
        return means, idx

    def write(self, y_hat, sch, t, sym: torch.Tensor, means: torch.Tensor):
        """y_hat at front t's active positions = sym (F * m,) int32 + means
        (F, m)."""
        for gi, (g, n) in enumerate(groups(sch.slots)):
            self._launch('jahp_front_write', _library().jahp_front_write,
                         n, self._pos(sch, t, gi), sch.w, self.m,
                         _ptr(sym, g, self.m), _ptr(means, g, self.m),
                         _ptr(y_hat))


def front_kernels(context, scale_table: torch.Tensor, m: int):
    """`FrontKernels` for a `ContextModel` on a card, where they run every
    front (and raise for weights they cannot take); None elsewhere: the
    loops then run `front_params`."""
    if context.kernel.device.type != 'cuda':
        return None
    return FrontKernels(context, scale_table, m)
