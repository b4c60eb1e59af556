"""Lane-interleaved rANS codec ("tpu-lane-v1" wire format), the
counterpart of `sc2bench_tpu/ops/rans/device.py`.

N independent rANS lanes code a flat symbol array: lane j codes positions
j, j+N, j+2N, ... The state is 32-bit, the probability precision 16 bits
and renormalization moves 16 bits at a time, so each encode step emits
exactly 0 or 1 u16 and each decode step reads exactly 0 or 1. Two ways to
choose each symbol's CDF row:
  cyclic   lanes a multiple of the channel count C, symbols flattened
           channels-last: lane j always codes channel j mod C, so each lane
           codes against one fixed row (the factorized prior's latents);
  general  any lane count, each symbol p with its own row indexes[p] (the
           hyperprior's y-stream, one of the Gaussian tables' rows), the
           decoder finding each symbol by bisection of its row
           (`cdf_bisect`). It runs where `cyclic_channels` is None or the
           lane count is not a multiple of it, as in the JAX package.

Two in-memory stream layouts give the same packed wire bytes:
  compacted  streams[j, :lengths[j]] are lane j's chunks in decode order
             (batch-1 path, `pack_stream`);
  aligned    streams[j, t] is the chunk emitted while coding symbol row t,
             0 where none (`wire_batch` path; the decoder reads column t
             directly, no per-lane pointer).
The batch-1 cyclic kernels stage each lane's row in shared memory and take
at most `kernels.max_steps` steps; a compacted cyclic encode beyond that
(or beyond the decoder's limit) is coded in the aligned layout at k = 1,
whose packed bytes are the same, and its result says so (`aligned`).

The per-lane loops have two implementations with one contract:
  - the CUDA kernels in `kernels.py` (`csrc/rans_cyclic.cu`,
    `csrc/rans_indexed.cu`), which `device_rans_encode`/
    `device_rans_decode` launch for CUDA tensors;
  - the plain PyTorch versions below (`cyclic_encode_plain`,
    `cyclic_decode_plain`, `indexed_encode_plain`, `indexed_decode_plain`),
    which the same wrappers run for CPU tensors and which the tests and
    `chip_smoke.py` hold the kernels against.
The joint autoregressive codec's masked lanes (`models/zoo_jahp_device.py`)
have their two kernels beside the indexed ones and their plain versions
here too (`masked_encode_plain`, `masked_decode_front_plain`).

Torch-side dtypes: streams int32 (values 0..65535), lengths int32, states
int64 (values 0..2^32-1). The plain versions carry the state in int64,
masked to 32 bits after every operation that can wrap in uint32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...device import resolve_device

PRECISION = 16
RANS_L = 1 << 16              # state lower bound (= renorm base)
_MASK16 = (1 << 16) - 1
_MASK32 = (1 << 32) - 1


def auto_lanes(n_symbols: int, target_steps: int = 256, lo: int = 16,
               hi: int = 4096, cyclic_channels: int | None = None) -> int:
    """Lane count aiming at ~target_steps steps per lane. With
    `cyclic_channels=C` the count is C * 2^k (every lane holds ONE fixed
    channel), else a power of two."""
    want = max(n_symbols // target_steps, 1)
    if cyclic_channels:
        c = int(cyclic_channels)
        k = max((want // c), 1)
        lanes = c * (1 << max((k - 1).bit_length(), 0))
        while lanes > hi and lanes > c:
            lanes //= 2
        return max(min(lanes, hi if hi >= c else lanes), min(lo, lanes))
    lanes = 1 << (want - 1).bit_length()
    return max(lo, min(hi, lanes))


def lane_tables(quantized_cdf, cdf_length, offset, num_lanes: int,
                cyclic_channels: int, device):
    """Lane-expanded tables for the cyclic layout: (cdf (N, cols) int32,
    cdf_length (N,) int32, offset (N,) int32) of channel j mod C."""
    lanes, c = int(num_lanes), int(cyclic_channels)
    if lanes % c:
        raise ValueError(f'num_lanes={lanes} is not a multiple of '
                         f'cyclic_channels={c}: not a cyclic layout')
    lane_ch = torch.arange(lanes, device=device) % c
    return tuple(
        torch.as_tensor(a, dtype=torch.int32, device=device)[lane_ch]
        .contiguous() for a in (quantized_cdf, cdf_length, offset))


def _blocks(symbols: torch.Tensor, num_lanes: int, pad_value: torch.Tensor):
    """(k, n) symbols -> (k, steps, lanes) lane-major blocks. Pad positions
    get `pad_value[lane]` (the lane's lowest in-support symbol)."""
    k, n = symbols.shape
    lanes = int(num_lanes)
    steps = -(-n // lanes)
    pad = steps * lanes - n
    if pad:
        lane_of_pad = torch.arange(n, n + pad, device=symbols.device) % lanes
        symbols = torch.cat(
            [symbols, pad_value[lane_of_pad].expand(k, pad)], dim=1)
    return symbols.reshape(k, steps, lanes), n, pad


def _index_blocks(symbols: torch.Tensor, indexes: torch.Tensor,
                  num_lanes: int, pad_symbol: torch.Tensor):
    """The general layout's blocks: (k, n) symbols and their rows -> two
    (k, steps, lanes) lane-major blocks, pad positions coded as row 0's
    lowest in-support symbol `pad_symbol` (offset[0])."""
    k, n = indexes.shape
    lanes = int(num_lanes)
    steps = -(-n // lanes)
    pad = steps * lanes - n
    if pad:
        indexes = torch.cat([indexes, indexes.new_zeros((k, pad))], dim=1)
        if symbols is not None:
            symbols = torch.cat([symbols, pad_symbol.expand(k, pad)], dim=1)
    if symbols is not None:
        symbols = symbols.reshape(k, steps, lanes)
    return symbols, indexes.reshape(k, steps, lanes)


def _batched(a: torch.Tensor, ndim: int):
    """(a with a leading batch dim, whether one was added)."""
    if a.dim() == ndim:
        return a.unsqueeze(0), True
    return a, False


def _is_cyclic(num_lanes: int, cyclic_channels) -> bool:
    return bool(cyclic_channels) and int(num_lanes) % int(cyclic_channels) \
        == 0


def _row_indexes(indexes, k: int, n: int, cyclic_channels,
                 device) -> torch.Tensor:
    """(k, n) int32 rows of the general path: the caller's `indexes` ((n,)
    shared by the batch, or (k, n)), else p mod C for `cyclic_channels=C`
    at a lane count that is not a multiple of C."""
    if indexes is None:
        if not cyclic_channels:
            raise ValueError('the general (per-index) rANS path needs '
                             '`indexes` or `cyclic_channels`')
        indexes = torch.arange(n, device=device) % int(cyclic_channels)
    idx = torch.as_tensor(indexes, device=device).to(torch.int32)
    idx = idx.reshape(-1, n) if idx.numel() != n else idx.reshape(1, n)
    return idx.expand(k, n) if idx.shape[0] == 1 else idx


def _tables_on(quantized_cdf, cdf_length, offset, device):
    return tuple(torch.as_tensor(a, dtype=torch.int32, device=device)
                 .contiguous() for a in (quantized_cdf, cdf_length, offset))


def device_rans_encode(symbols, quantized_cdf, cdf_length, offset,
                       num_lanes: int, cyclic_channels: int | None = None,
                       aligned: bool = False, want_masks: bool = False,
                       device=None, indexes=None, prepared=None):
    """Encode flat int `symbols` (n,) -- or a batch (k, n), each row coded
    independently. In the cyclic layout position p codes channel p mod C;
    in the general one (`cyclic_channels` None or not dividing the lanes)
    position p codes row `indexes[p]` ((n,) or (k, n)). Returns a dict
    (batch dims leading when batched):
      streams (N, L) int32   per-lane u16 chunks (compacted or aligned)
      lengths (N,) int32     chunks per lane
      states  (N,) int64     final per-lane states (decoder init)
      ok      () bool        all symbols in CDF support
      nbytes  () int32       exact packed wire size
      n_symbols int
      aligned bool           the layout the streams hold
    plus `masks` (N, L) bool when the streams are aligned and the caller
    asked for them (`want_masks`) or asked for compacted streams that the
    batch-1 cyclic kernels cannot hold (see the module doc).

    A tensor `symbols` is coded where it lies (CUDA: the hand-written
    kernels; CPU: their plain versions); other array types go to `device`
    (default CUDA). `prepared`: the tables' `prepare_indexed_tables`, built
    once by a caller that codes more than once, for the general path's
    encoders, batch 1 and aligned (else they prepare them for this
    call)."""
    from . import kernels
    if not isinstance(symbols, torch.Tensor):
        symbols = torch.as_tensor(symbols, dtype=torch.int32,
                                  device=resolve_device(device))
    dev = symbols.device
    sym, single = _batched(symbols.to(torch.int32), 1)
    lanes = int(num_lanes)
    k, n = sym.shape
    steps = -(-n // lanes)
    if _is_cyclic(lanes, cyclic_channels):
        cdf_lane, len_lane, off_lane = lane_tables(
            quantized_cdf, cdf_length, offset, lanes, cyclic_channels, dev)
        sym3, _, _ = _blocks(sym, lanes, off_lane)
        v = sym3 - off_lane
        maxv = len_lane - 2                      # escape slot excluded
        if not aligned and not kernels.batch1_fits(steps, dev):
            aligned, want_masks = True, True
        encode, encode_aligned = kernels.cyclic_encode, \
            kernels.cyclic_encode_aligned
        table, rows = cdf_lane, ()
    else:
        cdf, cdf_len, off = _tables_on(quantized_cdf, cdf_length, offset,
                                       dev)
        idx = _row_indexes(indexes, k, n, cyclic_channels, dev)
        sym3, idx3 = _index_blocks(sym, idx, lanes, off[0])
        v = sym3 - off[idx3]
        maxv = cdf_len[idx3] - 2                 # escape slot excluded
        encode = functools.partial(kernels.indexed_encode,
                                   prepared=prepared)
        encode_aligned = functools.partial(kernels.indexed_encode_aligned,
                                           prepared=prepared)
        table, rows = cdf, (idx3.contiguous(),)
    ok = ((v >= 0) & (v < maxv)).flatten(1).all(dim=1)
    args = (table, torch.minimum(torch.clamp_min(v, 0), maxv - 1)
            .contiguous()) + rows
    masks = None
    if aligned:
        streams, lengths, states, masks = encode_aligned(*args, want_masks)
    else:
        streams, lengths, states = encode(*args)
    nbytes = (4 + 6 * lanes + 2 * lengths.sum(dim=1)).to(torch.int32)
    out = {'streams': streams, 'lengths': lengths, 'states': states,
           'ok': ok, 'nbytes': nbytes}
    if masks is not None:
        out['masks'] = masks
    if single:
        out = {key: t[0] for key, t in out.items()}
    out['n_symbols'] = n
    out['aligned'] = aligned
    return out


def device_rans_decode(streams, states, quantized_cdf, cdf_length, offset,
                       n_symbols: int, num_lanes: int,
                       cyclic_channels: int | None = None,
                       aligned: bool = False, device=None, indexes=None,
                       prepared=None):
    """Decode (N, L) `streams` + (N,) `states` -- or a batch (k, N, L) +
    (k, N) -- back into flat int32 symbols (n_symbols,) / (k, n_symbols).
    Returns (symbols, valid): `valid` is true where every lane ended at
    RANS_L, which a corrupt stream cannot pass. `aligned=True` consumes the
    time-aligned layout (pass the encode result's `aligned`). The layout
    and `indexes` are chosen as in `device_rans_encode`; device placement
    too. `prepared`: the tables' `prepare_indexed_tables`, for the general
    path's decoders (batch 1 and aligned)."""
    from . import kernels
    if not isinstance(streams, torch.Tensor):
        streams = torch.as_tensor(np.asarray(streams).astype(np.int32),
                                  device=resolve_device(device))
    dev = streams.device
    states = torch.as_tensor(np.asarray(states, np.int64)
                             if not isinstance(states, torch.Tensor)
                             else states, dtype=torch.int64, device=dev)
    streams, single = _batched(streams.to(torch.int32), 2)
    states, _ = _batched(states, 1)
    lanes = int(num_lanes)
    n = int(n_symbols)
    steps = -(-n // lanes)
    if aligned:
        if streams.shape[-1] < steps:
            raise ValueError(
                f'aligned decode needs stream width >= steps ({steps}); got '
                f'{streams.shape[-1]} -- compacted wire?')
        streams = streams[..., :steps]
    streams, states = streams.contiguous(), states.contiguous()
    if _is_cyclic(lanes, cyclic_channels):
        cdf_lane, len_lane, off_lane = lane_tables(
            quantized_cdf, cdf_length, offset, lanes, cyclic_channels, dev)
        decode = kernels.cyclic_decode_aligned if aligned \
            else kernels.cyclic_decode
        out, xend = decode(streams, states, cdf_lane, len_lane, off_lane,
                           steps)
    else:
        cdf, cdf_len, off = _tables_on(quantized_cdf, cdf_length, offset,
                                       dev)
        idx = _row_indexes(indexes, streams.shape[0], n, cyclic_channels,
                           dev)
        _, idx3 = _index_blocks(None, idx, lanes, None)
        decode = kernels.indexed_decode_aligned if aligned \
            else kernels.indexed_decode
        out, xend = decode(streams, states, cdf, cdf_len, off,
                           idx3.contiguous(), steps, prepared=prepared)
    valid = (xend == RANS_L).all(dim=1)
    flat = out.reshape(out.shape[0], -1)[:, :n]
    if single:
        return flat[0], valid[0]
    return flat, valid


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the four kernels (CPU path, and the yardstick the
# kernels are held against on the card)
# ---------------------------------------------------------------------------

def _row_lookup(cdf_lane: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """cdf_lane[j, col[..., j]] for col (..., N), as int64."""
    n, cols = cdf_lane.shape
    base = torch.arange(n, device=cdf_lane.device) * cols
    return cdf_lane.reshape(-1).to(torch.int64)[base + col]


def _encode_plain(start: torch.Tensor, freq: torch.Tensor, aligned: bool,
                  want_masks: bool):
    """The reverse-order encode loop over (k, T, N) int64 chunk starts and
    frequencies: compacted or aligned streams as the kernels give them."""
    k, steps, lanes = start.shape
    x = torch.full((k, lanes), RANS_L, dtype=torch.int64,
                   device=start.device)
    chunks = torch.zeros((k, steps, lanes), dtype=torch.int64,
                         device=start.device)
    masks = torch.zeros((k, steps, lanes), dtype=torch.bool,
                        device=start.device)
    for t in range(steps - 1, -1, -1):
        st, fr = start[:, t], freq[:, t]
        renorm = x >= ((fr << 16) & _MASK32)
        chunks[:, t] = x & _MASK16
        masks[:, t] = renorm
        x = torch.where(renorm, x >> 16, x)
        x = (((x // fr) << PRECISION) + x % fr + st) & _MASK32
    lengths = masks.sum(dim=1).to(torch.int32)
    emitted = torch.where(masks, chunks, 0).to(torch.int32)
    if aligned:
        streams = emitted.transpose(1, 2).contiguous()
        m = masks.transpose(1, 2).contiguous() if want_masks else None
        return streams, lengths, x, m
    # compact each lane's chunks to the front, stable (decode) order
    order = torch.sort((~masks).to(torch.uint8), dim=1, stable=True).indices
    streams = torch.take_along_dim(emitted, order, dim=1)
    return streams.transpose(1, 2).contiguous(), lengths, x


def cyclic_encode_plain(cdf_lane: torch.Tensor, vc: torch.Tensor,
                        aligned: bool = False, want_masks: bool = False):
    """Reverse-order rANS encode of in-support values `vc` (k, T, N) int32
    against lane rows `cdf_lane` (N, cols) int32.

    Returns (streams (k, N, T) int32, lengths (k, N) int32,
    states (k, N) int64) and, with `aligned=True`, masks (k, N, T) bool or
    None. Compacted streams hold each lane's chunks at the front in decode
    order (`_finish_encode`); aligned streams hold step t's chunk at
    column t."""
    vcl = vc.to(torch.int64)
    start = _row_lookup(cdf_lane, vcl)
    freq = _row_lookup(cdf_lane, vcl + 1) - start
    return _encode_plain(start, freq, aligned, want_masks)


def indexed_encode_plain(cdf: torch.Tensor, vc: torch.Tensor,
                         idx: torch.Tensor, aligned: bool = False,
                         want_masks: bool = False):
    """`cyclic_encode_plain` of the general layout: value vc[i, t, j] coded
    against row idx[i, t, j] of `cdf` (R, cols) int32; same outputs."""
    flat = cdf.reshape(-1).to(torch.int64)
    pos = idx.to(torch.int64) * cdf.shape[1] + vc.to(torch.int64)
    start = flat[pos]
    return _encode_plain(start, flat[pos + 1] - start, aligned, want_masks)


def cyclic_decode_plain(streams: torch.Tensor, states: torch.Tensor,
                        cdf_lane: torch.Tensor, len_lane: torch.Tensor,
                        off_lane: torch.Tensor, steps: int,
                        aligned: bool = False):
    """Forward rANS decode of (k, N, W) int32 `streams` from (k, N) int64
    `states`. The symbol v of a step is the largest index below the lane's
    cdf_length with cdf[v] <= slot. Compacted streams are read through a
    per-lane pointer, and a read past the row yields 0; aligned streams
    are read at column t. Returns (symbols (k, steps, N) int32 with the
    lane offset added, final states (k, N) int64)."""
    k, lanes, width = streams.shape
    dev = streams.device
    cdf = cdf_lane.to(torch.int64)
    in_row = (torch.arange(cdf.shape[1], device=dev)[None, :]
              < len_lane[:, None].to(torch.int64))            # (N, cols)
    s = torch.cat([streams.to(torch.int64),
                   torch.zeros((k, lanes, 1), dtype=torch.int64,
                               device=dev)], dim=2)
    x = states.to(torch.int64).clone()
    ptr = torch.zeros((k, lanes), dtype=torch.int64, device=dev)
    out = torch.empty((k, steps, lanes), dtype=torch.int32, device=dev)
    for t in range(steps):
        slot = x & _MASK16
        within = (cdf[None] <= slot[..., None]) & in_row[None]
        v = within.sum(dim=-1) - 1
        st = _row_lookup(cdf_lane, v)
        fr = _row_lookup(cdf_lane, v + 1) - st
        x = (fr * (x >> 16) + slot - st) & _MASK32
        need = x < RANS_L
        if aligned:
            chunk = s[:, :, t]
        else:
            chunk = torch.gather(s, 2, ptr.clamp_max(width)[..., None])[..., 0]
            ptr = ptr + need.to(torch.int64)
        x = torch.where(need, ((x << 16) | chunk) & _MASK32, x)
        out[:, t] = (v + off_lane.to(torch.int64)).to(torch.int32)
    return out, x


def cdf_bisect(cdf: torch.Tensor, cdf_len: torch.Tensor, idx: torch.Tensor,
               slot: torch.Tensor, steps: int | None = None) -> torch.Tensor:
    """v with cdf[idx, v] <= slot < cdf[idx, v+1], int64: a fixed-depth
    binary search from (lo, hi) = (0, len - 1), point lookups only. Every
    row starts at 0 and ends at 2^16 > slot within cdf_len, and `steps` >=
    ceil(log2(row width)) probes reach hi == lo + 1 (the kernels stop
    there)."""
    cols = cdf.shape[-1]
    if steps is None:
        steps = max(int(np.ceil(np.log2(max(int(cols), 2)))), 1)
    flat = cdf.reshape(-1).to(torch.int64)
    row = idx.to(torch.int64) * cols
    lo = torch.zeros_like(row)
    hi = torch.clamp_max(cdf_len.to(torch.int64)[idx.to(torch.int64)],
                         cols) - 1
    for _ in range(steps):
        mid = (lo + hi) // 2
        go_right = flat[row + mid] <= slot
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def indexed_decode_plain(streams: torch.Tensor, states: torch.Tensor,
                         cdf: torch.Tensor, cdf_len: torch.Tensor,
                         off: torch.Tensor, idx: torch.Tensor, steps: int,
                         aligned: bool = False):
    """`cyclic_decode_plain` of the general layout: step t of lane j
    decodes against row idx[i, t, j] of `cdf` (R, cols), its symbol found
    by `cdf_bisect`. Returns (symbols (k, steps, N) int32 with the row
    offset added, final states (k, N) int64)."""
    k, lanes, width = streams.shape
    dev = streams.device
    flat = cdf.reshape(-1).to(torch.int64)
    cols = cdf.shape[1]
    s = torch.cat([streams.to(torch.int64),
                   torch.zeros((k, lanes, 1), dtype=torch.int64,
                               device=dev)], dim=2)
    x = states.to(torch.int64).clone()
    ptr = torch.zeros((k, lanes), dtype=torch.int64, device=dev)
    off64 = off.to(torch.int64)
    out = torch.empty((k, steps, lanes), dtype=torch.int32, device=dev)
    for t in range(steps):
        rows = idx[:, t].to(torch.int64)
        slot = x & _MASK16
        v = cdf_bisect(cdf, cdf_len, rows, slot)
        st = flat[rows * cols + v]
        fr = flat[rows * cols + v + 1] - st
        x = (fr * (x >> 16) + slot - st) & _MASK32
        need = x < RANS_L
        if aligned:
            chunk = s[:, :, t]
        else:
            chunk = torch.gather(s, 2, ptr.clamp_max(width)[..., None])[..., 0]
            ptr = ptr + need.to(torch.int64)
        x = torch.where(need, ((x << 16) | chunk) & _MASK32, x)
        out[:, t] = (v + off64[rows]).to(torch.int32)
    return out, x


def masked_encode_plain(cdf: torch.Tensor, vc: torch.Tensor,
                        idx: torch.Tensor, act: torch.Tensor, m: int):
    """Reverse-order encode of the joint autoregressive codec's masked
    lanes: value vc[t, j] (T, N) int32 coded against row idx[t, j] of `cdf`
    (R, cols) int32 where its slot j // m is active in front t (`act`
    (T, F) uint8), N = F * m; an inactive lane is inert at that step.
    Returns (streams (N, T) int32 aligned, lengths (N,) int32, states (N,)
    int64)."""
    steps, lanes = vc.shape
    lane_act = act.bool().repeat_interleave(int(m), dim=1)
    flat = cdf.reshape(-1).to(torch.int64)
    pos = idx.to(torch.int64) * cdf.shape[1] + vc.to(torch.int64)
    start = flat[pos]
    freq = torch.clamp_min(flat[pos + 1] - start, 1)
    x = torch.full((lanes,), RANS_L, dtype=torch.int64, device=vc.device)
    chunks = torch.zeros((steps, lanes), dtype=torch.int64, device=vc.device)
    lengths = torch.zeros((lanes,), dtype=torch.int32, device=vc.device)
    for t in range(steps - 1, -1, -1):
        a, st, fr = lane_act[t], start[t], freq[t]
        renorm = a & (x >= ((fr << 16) & _MASK32))
        chunks[t] = torch.where(renorm, x & _MASK16, 0)
        lengths += renorm.to(torch.int32)
        x = torch.where(renorm, x >> 16, x)
        x = torch.where(a, (((x // fr) << PRECISION) + x % fr + st)
                        & _MASK32, x)
    return chunks.t().to(torch.int32).contiguous(), lengths, x


def masked_decode_front_plain(streams: torch.Tensor, t: int,
                              states: torch.Tensor, cdf: torch.Tensor,
                              cdf_len: torch.Tensor, off: torch.Tensor,
                              idx: torch.Tensor, act: torch.Tensor, m: int):
    """One masked decode step, front t, for every lane: the symbol by
    `cdf_bisect` of row idx[j] (N,), the state update, and chunk column t
    of the aligned (N, T) `streams` read where the state drops below
    RANS_L; lanes whose slot j // m is inactive in `act` (F,) uint8 keep
    their state and give 0. Returns (symbols (N,) int32 with the row
    offset added, states (N,) int64)."""
    a = act.bool().repeat_interleave(int(m))
    x = states.to(torch.int64)
    rows = idx.to(torch.int64)
    cols = cdf.shape[1]
    flat = cdf.reshape(-1).to(torch.int64)
    slot = x & _MASK16
    v = cdf_bisect(cdf, cdf_len, rows, slot)
    st = flat[rows * cols + v]
    fr = torch.clamp_min(flat[rows * cols + v + 1] - st, 1)
    x_new = (fr * (x >> 16) + slot - st) & _MASK32
    chunk = streams[:, t].to(torch.int64)
    x_new = torch.where(x_new < RANS_L, ((x_new << 16) | chunk) & _MASK32,
                        x_new)
    sym = torch.where(a, v + off.to(torch.int64)[rows], 0)
    return sym.to(torch.int32), torch.where(a, x_new, x)


# ---------------------------------------------------------------------------
# Host packing of the wire format (exact nbytes as reported by encode)
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _header(lanes: int, lengths: np.ndarray, states: np.ndarray) -> list:
    if lengths.size and int(lengths.max()) > 0xFFFF:
        raise ValueError(
            f'lane stream length {int(lengths.max())} exceeds the u16 wire '
            'header; raise num_lanes')
    return [np.asarray([lanes, 0], np.uint16).tobytes(),
            lengths.astype(np.uint16).tobytes(),
            states.astype(np.uint32).tobytes()]


def pack_stream(encoded: dict) -> bytes:
    """[u16 num_lanes][u16 reserved][N u16 lengths][N u32 states]
    [concat per-lane u16 chunks] -- little endian."""
    streams = _host(encoded['streams'])
    lengths = _host(encoded['lengths'])
    lanes = streams.shape[0]
    body = _header(lanes, lengths, _host(encoded['states']))
    for j in range(lanes):
        body.append(streams[j, :lengths[j]].astype(np.uint16).tobytes())
    return b''.join(body)


def pack_stream_aligned(encoded: dict) -> bytes:
    """Pack an `aligned=True, want_masks=True` encode result into the SAME
    wire bytes as `pack_stream` on the compacted layout: per lane, the
    mask-selected chunks in time order are the compacted decode order."""
    streams = _host(encoded['streams'])
    masks = _host(encoded['masks']).astype(bool)
    lengths = _host(encoded['lengths'])
    lanes = streams.shape[0]
    body = _header(lanes, lengths, _host(encoded['states']))
    for j in range(lanes):
        body.append(streams[j][masks[j]].astype(np.uint16).tobytes())
    return b''.join(body)


def wire_nbytes(data: bytes) -> int:
    """Size of the (self-describing) lane wire at the head of `data`."""
    lanes = int(np.frombuffer(data[:2], np.uint16)[0])
    lengths = np.frombuffer(data[4:4 + 2 * lanes], np.uint16)
    return 4 + 6 * lanes + 2 * int(lengths.sum())


def split_wire(data: bytes) -> tuple:
    """A concatenation of two lane wires (the hyperprior's pulled wire: z
    then y) split into its two parts, at the first one's `wire_nbytes`."""
    k = wire_nbytes(data)
    return data[:k], data[k:]


def unpack_stream(data: bytes):
    """-> (streams (N, Lmax) uint16 zero-padded, states (N,) uint32)."""
    lanes = int(np.frombuffer(data[:2], np.uint16)[0])
    o = 4
    lengths = np.frombuffer(data[o:o + 2 * lanes], np.uint16).astype(np.int64)
    o += 2 * lanes
    states = np.frombuffer(data[o:o + 4 * lanes], np.uint32).copy()
    o += 4 * lanes
    lmax = int(lengths.max()) if lanes else 0
    streams = np.zeros((lanes, max(lmax, 1)), np.uint16)
    for j in range(lanes):
        k = int(lengths[j])
        streams[j, :k] = np.frombuffer(data[o:o + 2 * k], np.uint16)
        o += 2 * k
    return streams, states


# ---------------------------------------------------------------------------
# Numpy oracle: pins the lane format independently of torch
# ---------------------------------------------------------------------------

def numpy_oracle_encode(symbols, indexes, cdf, cdf_length, offset,
                        num_lanes=256, cyclic_channels=None):
    """`cyclic_channels=C` replicates the fixed-lane-channel pad rule
    (pad symbol = v=0 of the pad position's OWN channel)."""
    symbols = np.asarray(symbols, np.int64)
    indexes = np.asarray(indexes, np.int64)
    n = len(symbols)
    steps = -(-n // num_lanes)
    pad = steps * num_lanes - n
    if pad:
        if cyclic_channels and num_lanes % int(cyclic_channels) == 0:
            pad_idx = (np.arange(n, n + pad) % int(cyclic_channels))
        else:
            pad_idx = np.zeros(pad, np.int64)
        symbols = np.concatenate(
            [symbols, np.asarray(offset)[pad_idx].astype(np.int64)])
        indexes = np.concatenate([indexes, pad_idx.astype(np.int64)])
    sym2 = symbols.reshape(steps, num_lanes)
    idx2 = indexes.reshape(steps, num_lanes)
    x = np.full(num_lanes, RANS_L, np.uint64)
    streams = [[] for _ in range(num_lanes)]
    for t in range(steps - 1, -1, -1):
        v = sym2[t] - np.asarray(offset)[idx2[t]]
        if not np.all((v >= 0) & (v < np.asarray(cdf_length)[idx2[t]] - 2)):
            raise ValueError('symbol outside the CDF support')
        st = np.asarray(cdf)[idx2[t], v].astype(np.uint64)
        fr = (np.asarray(cdf)[idx2[t], v + 1]
              - np.asarray(cdf)[idx2[t], v]).astype(np.uint64)
        renorm = x >= (fr << np.uint64(16))
        for j in np.nonzero(renorm)[0]:
            streams[j].append(int(x[j] & np.uint64(0xFFFF)))
            x[j] >>= np.uint64(16)
        x = ((x // fr) << np.uint64(PRECISION)) + (x % fr) + st
    # decode order = reverse emission order per lane
    streams = [list(reversed(s)) for s in streams]
    return streams, x.astype(np.uint32)


def numpy_oracle_decode(streams, states, indexes, cdf, cdf_length, offset,
                        n_symbols, num_lanes=256):
    indexes = np.asarray(indexes, np.int64)
    steps = -(-n_symbols // num_lanes)
    pad = steps * num_lanes - n_symbols
    if pad:
        indexes = np.concatenate([indexes, np.zeros(pad, np.int64)])
    idx2 = indexes.reshape(steps, num_lanes)
    x = [int(s) for s in np.asarray(states)]
    ptr = [0] * num_lanes
    out = np.zeros((steps, num_lanes), np.int64)
    cdf = np.asarray(cdf)
    cdf_length = np.asarray(cdf_length)
    offset = np.asarray(offset)
    for t in range(steps):
        for j in range(num_lanes):
            slot = x[j] & 0xFFFF
            row = cdf[idx2[t, j]][:int(cdf_length[idx2[t, j]])]
            v = int(np.searchsorted(row, slot, side='right')) - 1
            st, fr = int(row[v]), int(row[v + 1] - row[v])
            x[j] = fr * (x[j] >> 16) + slot - st
            if x[j] < RANS_L:
                x[j] = (x[j] << 16) | int(streams[j][ptr[j]])
                ptr[j] += 1
            out[t, j] = v + int(offset[idx2[t, j]])
    if any(s != RANS_L for s in x):
        raise ValueError('corrupt stream')
    return out.reshape(-1)[:n_symbols]
