"""Host rANS coder in the CompressAI-style byte format (counterpart of
`sc2bench_tpu/ops/rans/coder.py`: single-stream coding with indexes, its
streaming decoder, the cyclic int16 wire, and the interleaved multi-lane
coder).

Format: 32-bit state, 8-bit renormalization, 16-bit probability precision.
A symbol outside its CDF row's support escapes to the row's last slot and
its overflow is bypass-coded in 4-bit chunks, so every int32 symbol codes.
This is what the device wire cannot do; the runtime re-codes an image here
when its latent leaves the support (`ok=False`) or its device decode fails
(`valid=False`). The cyclic int16 wire (`encode_cyclic_i16`) is the host
wire of `stream_deploy`: int16 symbols in NHWC-flat order, symbol i coded
with distribution i mod C. The hyperprior's y-stream crosses as int16
symbols with int16 per-element indexes (`encode_with_indexes_i16`).
`encode_interleaved` codes symbol i on lane i mod L, each lane a stream
of the single-stream format, behind a header of the lane count and the
lanes' byte sizes (int32 each, the JAX package's layout); the lanes code
and decode on threads, and the bytes do not depend on how many.

Two implementations of one format:
  - `host.cpp`, compiled with g++ into `sc2bench_tpu_torch/build/` the
    first time a coder needs it (named by the source's hash) and bound with
    ctypes. A failed build raises; nothing drops silently to Python.
  - the pure-Python reference below, which runs only when the caller asks
    for it (`RansCoder(..., use_cpp=False)`), as the tests do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / 'host.cpp'

_PRECISION = 16
_BYPASS_BITS = 4
_MAX_BYPASS = (1 << _BYPASS_BITS) - 1
_RANS_L = 1 << 23

_lib = None
_lib_lock = threading.Lock()


def build_library() -> Path:
    """Compile `host.cpp` with g++ into a shared library named by the
    source's hash, unless it is already built. Returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f'libhost_rans_{digest}.so'
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    cmd = ['g++', '-O3', '-std=c++17', '-shared', '-fPIC', '-pthread', '-o',
           str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError('g++ not found: the host rANS coder needs a C++ '
                           'compiler') from e
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i = ctypes.c_int
            lib.rans_encode_with_indexes.restype = i
            lib.rans_encode_with_indexes.argtypes = [
                i32p, i32p, i, i32p, i, i32p, i32p, u8p, i]
            lib.rans_decode_with_indexes.restype = i
            lib.rans_decode_with_indexes.argtypes = [
                u8p, i, i32p, i, i32p, i, i32p, i32p, i32p]
            i16p = ctypes.POINTER(ctypes.c_int16)
            lib.rans_encode_cyclic_i16.restype = i
            lib.rans_encode_cyclic_i16.argtypes = [
                i16p, i, i, i32p, i, i32p, i32p, u8p, i]
            lib.rans_decode_cyclic_i16_coarse.restype = i
            lib.rans_decode_cyclic_i16_coarse.argtypes = [
                u8p, i, i, i, i32p, i, i32p, i32p, i16p, i, i16p]
            lib.rans_encode_with_indexes_i16.restype = i
            lib.rans_encode_with_indexes_i16.argtypes = [
                i16p, i16p, i, i32p, i, i32p, i32p, u8p, i]
            lib.rans_decode_with_indexes_i16_coarse.restype = i
            lib.rans_decode_with_indexes_i16_coarse.argtypes = [
                u8p, i, i16p, i, i32p, i, i32p, i32p, i16p, i, i16p]
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.rans_stream_init.restype = None
            lib.rans_stream_init.argtypes = [u8p, i, i64p]
            lib.rans_stream_decode.restype = i
            lib.rans_stream_decode.argtypes = [
                u8p, i, i64p, i32p, i, i32p, i, i32p, i32p, i32p]
            lib.rans_encode_interleaved.restype = i
            lib.rans_encode_interleaved.argtypes = [
                i32p, i32p, i, i, i32p, i, i32p, i32p, u8p, i, i]
            lib.rans_decode_interleaved.restype = i
            lib.rans_decode_interleaved.argtypes = [
                u8p, i, i32p, i, i32p, i, i32p, i32p, i32p, i]
            _lib = lib
    return _lib


def _as_i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i16p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _cyclic_indexes(n: int, num_dists: int) -> np.ndarray:
    """Distribution of each position of the cyclic wire: i mod num_dists."""
    return (np.arange(n) % num_dists).astype(np.int32)


def _coarse_lut(cdfs, cdf_lengths) -> np.ndarray:
    """(num_dists, 256) int16: for each 256-slot bucket, the last symbol
    whose CDF entry is at or below the bucket's first slot; the decoder
    scans forward from there."""
    slots = np.arange(0, 1 << _PRECISION, 256)
    return np.ascontiguousarray(np.stack([
        np.searchsorted(cdfs[i, :int(cdf_lengths[i])], slots, 'right') - 1
        for i in range(cdfs.shape[0])]).astype(np.int16))


# ---------------------------------------------------------------------------
# Pure-Python reference codec (same bitstream format as host.cpp).
# ---------------------------------------------------------------------------

def _py_encode(symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    ops = []
    for sym, idx in zip(symbols.tolist(), indexes.tolist()):
        cdf = cdfs[idx]
        max_value = int(cdf_lengths[idx]) - 2
        value = sym - int(offsets[idx])
        raw_val = None
        if value < 0:
            raw_val, value = -2 * value - 1, max_value
        elif value >= max_value:
            raw_val, value = 2 * (value - max_value), max_value
        ops.append((int(cdf[value]), int(cdf[value + 1] - cdf[value])))
        if raw_val is not None:
            bfreq = 1 << (_PRECISION - _BYPASS_BITS)
            n_bypass = 0
            while (raw_val >> (n_bypass * _BYPASS_BITS)) != 0:
                n_bypass += 1
            val = n_bypass
            while val >= _MAX_BYPASS:
                ops.append((_MAX_BYPASS << (_PRECISION - _BYPASS_BITS), bfreq))
                val -= _MAX_BYPASS
            ops.append((val << (_PRECISION - _BYPASS_BITS), bfreq))
            for j in range(n_bypass):
                chunk = (raw_val >> (j * _BYPASS_BITS)) & _MAX_BYPASS
                ops.append((chunk << (_PRECISION - _BYPASS_BITS), bfreq))

    x = _RANS_L
    buf = bytearray()
    for start, freq in reversed(ops):
        x_max = ((_RANS_L >> _PRECISION) << 8) * freq
        while x >= x_max:
            buf.append(x & 0xff)
            x >>= 8
        x = ((x // freq) << _PRECISION) + (x % freq) + start
    for _ in range(4):
        buf.append(x & 0xff)
        x >>= 8
    return bytes(reversed(buf))


class _PyStreamingState:
    """Decoder state (x, byte position) of the pure-Python reference; it
    persists across `decode` calls, as `StreamingDecoder` needs."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.x = 0
        for _ in range(4):
            self.x = (self.x << 8) | self._byte()

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def _advance(self, start, freq):
        mask = (1 << _PRECISION) - 1
        self.x = freq * (self.x >> _PRECISION) + (self.x & mask) - start
        while self.x < _RANS_L:
            self.x = (self.x << 8) | self._byte()

    def _get_bypass(self):
        mask = (1 << _PRECISION) - 1
        val = (self.x & mask) >> (_PRECISION - _BYPASS_BITS)
        self._advance(val << (_PRECISION - _BYPASS_BITS),
                      1 << (_PRECISION - _BYPASS_BITS))
        return val

    def decode(self, indexes, cdfs, cdf_lengths, offsets) -> np.ndarray:
        out = np.empty(len(indexes), np.int32)
        mask = (1 << _PRECISION) - 1
        for i, idx in enumerate(indexes.tolist()):
            cdf = cdfs[idx]
            max_value = int(cdf_lengths[idx]) - 2
            slot = self.x & mask
            s = int(np.searchsorted(cdf[:int(cdf_lengths[idx])], slot,
                                    'right')) - 1
            self._advance(int(cdf[s]), int(cdf[s + 1] - cdf[s]))
            value = s
            if s == max_value:
                n_bypass = 0
                while True:
                    val = self._get_bypass()
                    n_bypass += val
                    if val != _MAX_BYPASS:
                        break
                raw_val = 0
                for j in range(n_bypass):
                    raw_val |= self._get_bypass() << (j * _BYPASS_BITS)
                value = (-(raw_val + 1) // 2 if raw_val & 1
                         else raw_val // 2 + max_value)
            out[i] = value + int(offsets[idx])
        return out


def _py_decode(data: bytes, indexes, cdfs, cdf_lengths, offsets) -> np.ndarray:
    return _PyStreamingState(data).decode(indexes, cdfs, cdf_lengths, offsets)


def _py_encode_interleaved(symbols, indexes, num_lanes, cdfs, cdf_lengths,
                           offsets) -> bytes:
    lanes = [_py_encode(symbols[j::num_lanes], indexes[j::num_lanes], cdfs,
                        cdf_lengths, offsets) for j in range(num_lanes)]
    head = np.asarray([num_lanes] + [len(b) for b in lanes], '<i4')
    return head.tobytes() + b''.join(lanes)


def _interleaved_header(data: bytes) -> list:
    """The lanes' (start, size) in an interleaved stream; ValueError for a
    corrupt header (a lane count below 1, a negative size, sizes past the
    end)."""
    if len(data) < 4:
        raise ValueError('corrupt interleaved rANS stream: no header')
    num_lanes = int(np.frombuffer(data[:4], '<i4')[0])
    if num_lanes < 1 or 4 + 4 * num_lanes > len(data):
        raise ValueError(f'corrupt interleaved rANS stream: {num_lanes} '
                         f'lanes in {len(data)} bytes')
    sizes = np.frombuffer(data[4:4 + 4 * num_lanes], '<i4').astype(np.int64)
    starts = 4 + 4 * num_lanes + np.concatenate([[0], np.cumsum(sizes)])
    if (sizes < 0).any() or starts[-1] > len(data):
        raise ValueError('corrupt interleaved rANS stream: lane sizes run '
                         'past its end')
    return [(int(a), int(n)) for a, n in zip(starts[:-1], sizes)]


def _py_decode_interleaved(data: bytes, indexes, cdfs, cdf_lengths,
                           offsets) -> np.ndarray:
    lanes = _interleaved_header(data)
    out = np.empty(indexes.size, np.int32)
    for j, (start, size) in enumerate(lanes):
        out[j::len(lanes)] = _py_decode(data[start:start + size],
                                        indexes[j::len(lanes)], cdfs,
                                        cdf_lengths, offsets)
    return out


class RansCoder:
    """Host range coder bound to one set of coding tables (rows of
    `quantized_cdf`, selected per symbol by its index)."""

    def __init__(self, quantized_cdf: np.ndarray, cdf_length: np.ndarray,
                 offset: np.ndarray, use_cpp: bool = True):
        self.cdfs = _as_i32(quantized_cdf)
        self.cdf_lengths = _as_i32(cdf_length)
        self.offsets = _as_i32(offset)
        self.cdf_stride = self.cdfs.shape[1]
        self.lib = _library() if use_cpp else None
        self._coarse = _coarse_lut(self.cdfs, self.cdf_lengths) \
            if use_cpp else None

    def encode_with_indexes(self, symbols, indexes) -> bytes:
        symbols = _as_i32(symbols).ravel()
        indexes = _as_i32(indexes).ravel()
        if symbols.shape != indexes.shape:
            raise ValueError(f'{symbols.size} symbols but {indexes.size} '
                             'indexes')
        if self.lib is None:
            return _py_encode(symbols, indexes, self.cdfs, self.cdf_lengths,
                              self.offsets)
        capacity = max(1024, symbols.size * 8)
        while True:
            out = np.empty(capacity, np.uint8)
            n = self.lib.rans_encode_with_indexes(
                _i32p(symbols), _i32p(indexes), symbols.size,
                _i32p(self.cdfs), self.cdf_stride, _i32p(self.cdf_lengths),
                _i32p(self.offsets), _u8p(out), capacity)
            if n >= 0:
                return out[:n].tobytes()
            capacity *= 4

    def decode_with_indexes(self, data: bytes, indexes) -> np.ndarray:
        indexes = _as_i32(indexes).ravel()
        if self.lib is None:
            return _py_decode(data, indexes, self.cdfs, self.cdf_lengths,
                              self.offsets)
        byte_arr = np.frombuffer(data, np.uint8)
        out = np.empty(indexes.size, np.int32)
        self.lib.rans_decode_with_indexes(
            _u8p(byte_arr), byte_arr.size, _i32p(indexes), indexes.size,
            _i32p(self.cdfs), self.cdf_stride, _i32p(self.cdf_lengths),
            _i32p(self.offsets), _i32p(out))
        return out

    # ---- cyclic int16 wire (the device's channels-last layout) ----------
    def _check_dists(self, num_dists):
        if not 0 < num_dists <= self.cdfs.shape[0]:
            raise ValueError(f'num_dists {num_dists} not in '
                             f'[1, {self.cdfs.shape[0]}]')

    def encode_cyclic_i16(self, symbols, num_dists: int) -> bytes:
        """Code a channels-last flat int16 buffer whose symbol i uses
        distribution i mod num_dists (the NHWC ravel of a latent), in the
        format of `encode_with_indexes`."""
        self._check_dists(num_dists)
        symbols = np.ascontiguousarray(symbols, dtype=np.int16).ravel()
        if self.lib is None:
            return _py_encode(symbols.astype(np.int32),
                              _cyclic_indexes(symbols.size, num_dists),
                              self.cdfs, self.cdf_lengths, self.offsets)
        capacity = max(1024, symbols.size * 8)
        while True:
            out = np.empty(capacity, np.uint8)
            n = self.lib.rans_encode_cyclic_i16(
                _i16p(symbols), symbols.size, num_dists, _i32p(self.cdfs),
                self.cdf_stride, _i32p(self.cdf_lengths),
                _i32p(self.offsets), _u8p(out), capacity)
            if n >= 0:
                return out[:n].tobytes()
            capacity *= 4

    def decode_cyclic_i16(self, data: bytes, n: int,
                          num_dists: int) -> np.ndarray:
        """Inverse of `encode_cyclic_i16`: n symbols as int16, the wire
        dtype."""
        self._check_dists(num_dists)
        if self.lib is None:
            return _py_decode(data, _cyclic_indexes(n, num_dists), self.cdfs,
                              self.cdf_lengths,
                              self.offsets).astype(np.int16)
        byte_arr = np.frombuffer(data, np.uint8)
        out = np.empty(n, np.int16)
        self.lib.rans_decode_cyclic_i16_coarse(
            _u8p(byte_arr), byte_arr.size, n, num_dists, _i32p(self.cdfs),
            self.cdf_stride, _i32p(self.cdf_lengths), _i32p(self.offsets),
            _i16p(self._coarse), self._coarse.shape[1], _i16p(out))
        return out

    # ---- indexed int16 wire (the hyperprior's y-stream) --------------------
    def encode_with_indexes_i16(self, symbols, indexes) -> bytes:
        """`encode_with_indexes` of int16 symbols and int16 per-element
        indexes, neither widened on the host."""
        symbols = np.ascontiguousarray(symbols, dtype=np.int16).ravel()
        indexes = np.ascontiguousarray(indexes, dtype=np.int16).ravel()
        if symbols.shape != indexes.shape:
            raise ValueError(f'{symbols.size} symbols but {indexes.size} '
                             'indexes')
        if self.lib is None:
            return _py_encode(symbols.astype(np.int32),
                              indexes.astype(np.int32), self.cdfs,
                              self.cdf_lengths, self.offsets)
        capacity = max(1024, symbols.size * 8)
        while True:
            out = np.empty(capacity, np.uint8)
            n = self.lib.rans_encode_with_indexes_i16(
                _i16p(symbols), _i16p(indexes), symbols.size,
                _i32p(self.cdfs), self.cdf_stride, _i32p(self.cdf_lengths),
                _i32p(self.offsets), _u8p(out), capacity)
            if n >= 0:
                return out[:n].tobytes()
            capacity *= 4

    def decode_with_indexes_i16(self, data: bytes, indexes) -> np.ndarray:
        """Inverse of `encode_with_indexes_i16`: int16 symbols."""
        indexes = np.ascontiguousarray(indexes, dtype=np.int16).ravel()
        if self.lib is None:
            return _py_decode(data, indexes.astype(np.int32), self.cdfs,
                              self.cdf_lengths,
                              self.offsets).astype(np.int16)
        byte_arr = np.frombuffer(data, np.uint8)
        out = np.empty(indexes.size, np.int16)
        self.lib.rans_decode_with_indexes_i16_coarse(
            _u8p(byte_arr), byte_arr.size, _i16p(indexes), indexes.size,
            _i32p(self.cdfs), self.cdf_stride, _i32p(self.cdf_lengths),
            _i32p(self.offsets), _i16p(self._coarse), self._coarse.shape[1],
            _i16p(out))
        return out

    # ---- interleaved multi-lane coding ------------------------------------
    def encode_interleaved(self, symbols, indexes,
                           num_lanes: int = 8) -> bytes:
        """`encode_with_indexes` on `num_lanes` interleaved lanes (lane j
        codes symbols j, j + L, ...; a count below 1 codes one lane), one
        thread a lane up to the CPUs."""
        return self._encode_interleaved(symbols, indexes, num_lanes)

    def _encode_interleaved(self, symbols, indexes, num_lanes: int,
                            threads: int | None = None) -> bytes:
        """`encode_interleaved` on `threads` threads (None: one a lane,
        up to the CPUs)."""
        symbols = _as_i32(symbols).ravel()
        indexes = _as_i32(indexes).ravel()
        if symbols.shape != indexes.shape:
            raise ValueError(f'{symbols.size} symbols but {indexes.size} '
                             'indexes')
        num_lanes = max(int(num_lanes), 1)
        if self.lib is None:
            return _py_encode_interleaved(symbols, indexes, num_lanes,
                                          self.cdfs, self.cdf_lengths,
                                          self.offsets)
        threads = _threads(threads, num_lanes)
        capacity = max(4096, symbols.size * 8 + 4 * num_lanes + 4)
        while True:
            out = np.empty(capacity, np.uint8)
            n = self.lib.rans_encode_interleaved(
                _i32p(symbols), _i32p(indexes), symbols.size, num_lanes,
                _i32p(self.cdfs), self.cdf_stride, _i32p(self.cdf_lengths),
                _i32p(self.offsets), _u8p(out), capacity, threads)
            if n >= 0:
                return out[:n].tobytes()
            capacity *= 4

    def decode_interleaved(self, data: bytes, indexes) -> np.ndarray:
        """Inverse of `encode_interleaved` (the lane count is in the
        stream). A corrupt header raises ValueError."""
        return self._decode_interleaved(data, indexes)

    def _decode_interleaved(self, data: bytes, indexes,
                            threads: int | None = None) -> np.ndarray:
        """`decode_interleaved` on `threads` threads (as
        `_encode_interleaved`)."""
        indexes = _as_i32(indexes).ravel()
        if self.lib is None:
            return _py_decode_interleaved(data, indexes, self.cdfs,
                                          self.cdf_lengths, self.offsets)
        lanes = len(_interleaved_header(data))
        byte_arr = np.frombuffer(data, np.uint8)
        out = np.empty(indexes.size, np.int32)
        rc = self.lib.rans_decode_interleaved(
            _u8p(byte_arr), byte_arr.size, _i32p(indexes), indexes.size,
            _i32p(self.cdfs), self.cdf_stride, _i32p(self.cdf_lengths),
            _i32p(self.offsets), _i32p(out), _threads(threads, lanes))
        if rc != 0:
            raise ValueError('corrupt interleaved rANS stream')
        return out


def _threads(threads, num_lanes: int) -> int:
    if threads is None:
        threads = min(num_lanes, os.cpu_count() or 1)
    return max(1, int(threads))


def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths,
                        offsets) -> bytes:
    """One-shot `RansCoder(...).encode_with_indexes`."""
    return RansCoder(cdfs, cdf_lengths, offsets).encode_with_indexes(
        symbols, indexes)


def decode_with_indexes(data, indexes, cdfs, cdf_lengths,
                        offsets) -> np.ndarray:
    """One-shot `RansCoder(...).decode_with_indexes`."""
    return RansCoder(cdfs, cdf_lengths, offsets).decode_with_indexes(
        data, indexes)


class StreamingDecoder:
    """Incremental decoder over one stream of `encode_with_indexes`: each
    `decode(indexes)` call decodes the next len(indexes) symbols, so a
    consumer whose indexes depend on symbols it has decoded (the joint
    autoregressive codec's context model) decodes one chunk a wavefront.
    The state {x, byte position} persists across calls, in the C library
    or, for a coder built with `use_cpp=False`, in the Python reference."""

    def __init__(self, coder: RansCoder, data: bytes):
        self.coder = coder
        self.data = np.frombuffer(data, np.uint8)
        self.lib = coder.lib
        if self.lib is not None:
            self._state = np.empty(2, np.int64)
            self.lib.rans_stream_init(_u8p(self.data), self.data.size,
                                      _i64p(self._state))
        else:
            self._py = _PyStreamingState(bytes(data))

    def decode(self, indexes) -> np.ndarray:
        indexes = _as_i32(indexes).ravel()
        c = self.coder
        if self.lib is None:
            return self._py.decode(indexes, c.cdfs, c.cdf_lengths, c.offsets)
        out = np.empty(indexes.size, np.int32)
        self.lib.rans_stream_decode(
            _u8p(self.data), self.data.size, _i64p(self._state),
            _i32p(indexes), indexes.size, _i32p(c.cdfs), c.cdf_stride,
            _i32p(c.cdf_lengths), _i32p(c.offsets), _i32p(out))
        return out
