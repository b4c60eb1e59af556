"""Launch wrappers for the rANS CUDA kernels: the four cyclic-lane ones
(`sc2bench_tpu_torch/csrc/rans_cyclic.cu`) and the four general per-index
ones (`sc2bench_tpu_torch/csrc/rans_indexed.cu`).

Each wrapper takes tensors on one device. For CPU tensors it runs the
kernel's plain PyTorch version from `device.py`; for CUDA tensors it
launches the kernel or raises -- there is no fallback. The CUDA source is
compiled with nvcc for sm_90a into a shared library with a plain C
interface (one per source) the first time a kernel is needed, under
`sc2bench_tpu_torch/build/`, and loaded with ctypes; `build_libraries`
runs the two compilers at once.

`LAUNCHES` counts kernel launches per kernel name; a wrapper adds one where
it launches its kernel and nowhere else, so a caller can show that a path
went through the kernels (`reset_launches()` zeroes the counts). It is the
one tally of the port's hand-written kernels: the joint autoregressive
codec's context-model front kernels (`FRONT_KERNELS`, built and launched
by `models/zoo_jahp_front.py`) count their launches here too.

Every kernel keeps its lane tables (16 or 8 bytes per CDF entry and lane)
in shared memory when they fit beside the block's staging; when they do
not (wide CDF rows), the wrapper allocates a table buffer in device memory
and the same kernel, in its global-table form, reads them from there
(`table_bytes` says which, per launch). So every kernel takes CDF rows of
any width. The batch-1 kernels (`cyclic_encode`, `cyclic_decode`) also
stage each lane's stream row in shared memory, so they take at most
`max_steps(decode)` steps (encode) or stream columns min(W, T) (decode),
whatever the width; a wrapper raises beyond that (`device.py` routes such
a latent to the aligned pair, `batch1_fits`). The aligned (`wire_batch`)
kernels take any T. `aligned_group` says how many images share a block's
tables at a given shape.

The batch-1 indexed kernels (`indexed_encode`, `indexed_decode`), the
aligned indexed decoder (`indexed_decode_aligned`) and the joint
autoregressive codec's masked front decoder (`masked_decode_front`) read
prepared tables (`indexed_tables.prepare_indexed_tables`), which a caller
that codes more than once builds once and passes as `prepared`; without
them a wrapper prepares them for its one call. So do the aligned indexed
encoder (`indexed_encode_aligned`) and the masked encoder
(`masked_encode_aligned`), which read the encoder entries (`enc`) as the
batch-1 encoder does. The batch-1 pair and the aligned decoder have two
plans each, chosen here by size (`indexed_plan`): the decoder's tables in
shared memory or read from device memory, the encoder's output rows in
shared memory or (long latents) in a device buffer; the aligned pair's
images a block follow rules measured on the card
(`indexed_aligned_group`, `indexed_encode_aligned_plan`). The masked
front decoder reads the tables in place. All take any T and width; the
masked encoder stages its activity map in shared memory and raises for a
map beyond a block's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .device import (cyclic_decode_plain, cyclic_encode_plain,
                     indexed_decode_plain, indexed_encode_plain,
                     masked_decode_front_plain, masked_encode_plain)
from .indexed_tables import (IndexedTables, encode_entries,
                             prepare_indexed_tables)

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / 'csrc' / 'rans_cyclic.cu'
INDEXED_SOURCE = _PKG / 'csrc' / 'rans_indexed.cu'
BUILD_DIR = _PKG / 'build'

KERNELS = ('rans_cyclic_encode', 'rans_cyclic_decode',
           'rans_cyclic_encode_aligned', 'rans_cyclic_decode_aligned')
INDEXED_KERNELS = ('rans_indexed_encode', 'rans_indexed_decode',
                   'rans_indexed_encode_aligned',
                   'rans_indexed_decode_aligned')
MASKED_KERNELS = ('rans_masked_encode_aligned', 'rans_masked_decode_front')
FRONT_KERNELS = ('jahp_front_ctx', 'jahp_front_hidden', 'jahp_front_params',
                 'jahp_front_write')
ALL_KERNELS = KERNELS + INDEXED_KERNELS + MASKED_KERNELS + FRONT_KERNELS
LAUNCHES = dict.fromkeys(ALL_KERNELS, 0)

_lib = None
_indexed_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home and (Path(home) / 'bin' / 'nvcc').exists():
        return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit')


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f'lib{source.stem}_{digest}.so'


def _nvcc_command(source: Path, out: Path) -> list:
    return [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
            '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
            '-Xptxas', '-v', '-o', str(out), str(source)]


def build_libraries(sources=(SOURCE, INDEXED_SOURCE)) -> list:
    """Compile each CUDA source (sm_90a) into a shared library named by
    the source's hash, unless it is already built; the compilers run at
    once. Returns the libraries' paths; each compiler's output (with
    ptxas register counts) is kept beside its library (`.log`)."""
    libs = [_library_path(src) for src in sources]
    todo = [(src, lib) for src, lib in zip(sources, libs)
            if not lib.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
        procs.append((lib, tmp, subprocess.Popen(
            _nvcc_command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, tmp, proc in procs:
        log = proc.communicate()[0]
        lib.with_suffix('.log').write_text(log)
        if proc.returncode != 0:
            failed.append(f'{lib.name}: nvcc failed ({proc.returncode}):\n'
                          f'{log}')
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return libs


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_libraries((SOURCE,))[0]))
            p, i = ctypes.c_void_p, ctypes.c_int
            enc = [p, i, p, i, i, i, p, p, p]      # + masks?, tables, stream
            dec = [p, i, p, p, i, p, p, i, i, i, p, p]   # + tables, stream
            for name, args, res in (
                    ('rans_cyclic_encode', enc + [p, p], i),
                    ('rans_cyclic_encode_aligned', enc + [p, p, p], i),
                    ('rans_cyclic_decode', dec + [p, p], i),
                    ('rans_cyclic_decode_aligned', dec + [p, p], i),
                    ('rans_cyclic_max_steps', [i], i),
                    ('rans_cyclic_table_bytes', [i] * 6, ctypes.c_int64),
                    ('rans_cyclic_aligned_group', [i, i, i], i)):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
    return _lib


def _indexed_library():
    global _indexed_lib
    with _lib_lock:
        if _indexed_lib is None:
            lib = ctypes.CDLL(str(build_libraries((INDEXED_SOURCE,))[0]))
            p, i = ctypes.c_void_p, ctypes.c_int
            enc = [p, i, p, p, i, i, i, p, p, p, p]   # + rows/masks, stream
            dec = [p, i, p, p, i, i, i, i, p, i, i, i, p, p, p]
            for name, args, res in (
                    ('rans_indexed_encode', enc + [p], i),
                    ('rans_indexed_encode_aligned', enc + [p], i),
                    ('rans_indexed_decode', dec, i),
                    ('rans_indexed_decode_aligned', dec, i),
                    ('rans_indexed_decode_aligned_smem', [i, i, i],
                     ctypes.c_int64),
                    ('rans_indexed_aligned_group', [i, i, i, i], i),
                    ('rans_launch_floor', [i, p], i),
                    ('rans_indexed_encode_smem', [i, i], ctypes.c_int64),
                    ('rans_indexed_encode_aligned_tile', [i, i], i),
                    ('rans_indexed_encode_aligned_group', [i, i], i),
                    ('rans_indexed_encode_aligned_smem', [i, i],
                     ctypes.c_int64),
                    ('rans_masked_encode_aligned_smem', [i, i, i],
                     ctypes.c_int64),
                    ('rans_indexed_decode_smem', [i, i], ctypes.c_int64),
                    ('rans_indexed_smem_optin', [], i),
                    ('rans_masked_encode_aligned',
                     [p, i, p, p, p, i, i, i, i, p, p, p, p], i),
                    ('rans_masked_decode_front',
                     [p, i, i, p, p, i, i, p, p, i, i, p, p, p], i)):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _indexed_lib = lib
    return _indexed_lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def _launch(name: str, device: torch.device, tables, *args) -> None:
    """Launch kernel `name` with its lane tables in shared memory, or in
    the device buffer `tables` (kept alive here until the launch is
    queued: the caching allocator orders its reuse on this stream)."""
    fn = getattr(_library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, tables.data_ptr() if tables is not None else None,
                stream)
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
    LAUNCHES[name] += 1


_max_steps: dict = {}
_table_bytes: dict = {}


def max_steps(decode: bool, device) -> int:
    """Largest steps T (encode) or stream columns min(W, T) (decode) that
    the batch-1 kernels take on `device`, at any CDF width."""
    key = (torch.device(device), bool(decode))
    if key not in _max_steps:
        with torch.cuda.device(device):
            _max_steps[key] = int(_library().rans_cyclic_max_steps(
                int(decode)))
    return _max_steps[key]


def batch1_fits(steps: int, device) -> bool:
    """Whether the batch-1 cyclic kernels take a latent of `steps` steps on
    `device`, encode and decode (compacted streams of width T): always on
    the CPU, whose plain versions have no limit."""
    device = torch.device(device)
    if device.type != 'cuda':
        return True
    return steps <= min(max_steps(False, device), max_steps(True, device))


def table_bytes(name: str, cols: int, width: int, steps: int,
                num_images: int, lanes: int, device) -> int:
    """0 when a launch of kernel `name` at this shape keeps its lane tables
    in shared memory; else the bytes of the device buffer it reads them
    from."""
    key = (torch.device(device), name, cols, width, steps, num_images, lanes)
    if key not in _table_bytes:
        with torch.cuda.device(device):
            _table_bytes[key] = int(_library().rans_cyclic_table_bytes(
                KERNELS.index(name), cols, width, steps, num_images, lanes))
    return _table_bytes[key]


def _tables_buffer(name, cols, width, steps, num_images, lanes, device):
    """The global table buffer a launch needs, or None (shared tables)."""
    nbytes = table_bytes(name, cols, width, steps, num_images, lanes, device)
    return torch.empty(nbytes, dtype=torch.uint8, device=device) \
        if nbytes else None


def aligned_group(decode: bool, num_images: int, lanes: int) -> int:
    """Images per block that an aligned encode (or decode) launch at this
    shape uses on the current device."""
    return int(_library().rans_cyclic_aligned_group(
        int(decode), int(num_images), int(lanes)))


def _check_fits(name: str, n: int, decode: bool, device) -> None:
    limit = max_steps(decode, device)
    if n > limit:
        what = 'stream columns' if decode else 'steps'
        raise ValueError(f'{name} takes at most {limit} {what} on this '
                         f'device, got {n}; raise num_lanes')


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'rANS kernels run on CPU or CUDA tensors, '
                         f'got {t.device}')


def _encode_args(cdf_lane: torch.Tensor, vc: torch.Tensor):
    _require_cuda(vc)
    k, steps, lanes = vc.shape
    if k * lanes == 0 or steps == 0:
        raise ValueError(f'empty encode: vc shape {tuple(vc.shape)}')
    _check(vc, 'vc', torch.int32, (k, steps, lanes), vc.device)
    _check(cdf_lane, 'cdf_lane', torch.int32, (lanes, cdf_lane.shape[1]),
           vc.device)
    dev = vc.device
    streams = torch.empty((k, lanes, steps), dtype=torch.int32, device=dev)
    lengths = torch.empty((k, lanes), dtype=torch.int32, device=dev)
    states = torch.empty((k, lanes), dtype=torch.int64, device=dev)
    args = (cdf_lane.data_ptr(), cdf_lane.shape[1], vc.data_ptr(), k, steps,
            lanes, streams.data_ptr(), lengths.data_ptr(), states.data_ptr())
    return args, (streams, lengths, states)


def cyclic_encode(cdf_lane: torch.Tensor, vc: torch.Tensor):
    """Kernel 1, compacted encode: `vc` (k, T, N) int32 in-support values,
    `cdf_lane` (N, cols) int32 -> (streams (k, N, T) int32 compacted in
    decode order, lengths (k, N) int32, states (k, N) int64)."""
    if vc.device.type == 'cpu':
        return cyclic_encode_plain(cdf_lane, vc)
    args, outs = _encode_args(cdf_lane, vc)
    k, steps, lanes = vc.shape
    _check_fits('rans_cyclic_encode', steps, False, vc.device)
    tables = _tables_buffer('rans_cyclic_encode', cdf_lane.shape[1], steps,
                            steps, k, lanes, vc.device)
    _launch('rans_cyclic_encode', vc.device, tables, *args)
    return outs


def cyclic_encode_aligned(cdf_lane: torch.Tensor, vc: torch.Tensor,
                          want_masks: bool = False):
    """Kernel 3, aligned encode: as `cyclic_encode`, but column t of
    streams holds step t's chunk (0 where none). Returns
    (streams, lengths, states, masks (k, N, T) bool or None)."""
    if vc.device.type == 'cpu':
        return cyclic_encode_plain(cdf_lane, vc, aligned=True,
                                   want_masks=want_masks)
    args, (streams, lengths, states) = _encode_args(cdf_lane, vc)
    k, steps, lanes = vc.shape
    masks = torch.empty(streams.shape, dtype=torch.bool,
                        device=vc.device) if want_masks else None
    tables = _tables_buffer('rans_cyclic_encode_aligned', cdf_lane.shape[1],
                            steps, steps, k, lanes, vc.device)
    _launch('rans_cyclic_encode_aligned', vc.device, tables, *args,
            masks.data_ptr() if masks is not None else None)
    return streams, lengths, states, masks


def _decode_args(streams, states, cdf_lane, len_lane, off_lane, steps):
    _require_cuda(streams)
    k, lanes, width = streams.shape
    if k * lanes == 0 or steps <= 0:
        raise ValueError(f'empty decode: streams shape '
                         f'{tuple(streams.shape)}, steps {steps}')
    dev = streams.device
    _check(streams, 'streams', torch.int32, (k, lanes, width), dev)
    _check(states, 'states', torch.int64, (k, lanes), dev)
    _check(cdf_lane, 'cdf_lane', torch.int32, (lanes, cdf_lane.shape[1]),
           dev)
    _check(len_lane, 'len_lane', torch.int32, (lanes,), dev)
    _check(off_lane, 'off_lane', torch.int32, (lanes,), dev)
    out = torch.empty((k, steps, lanes), dtype=torch.int32, device=dev)
    xend = torch.empty((k, lanes), dtype=torch.int64, device=dev)
    args = (streams.data_ptr(), width, states.data_ptr(),
            cdf_lane.data_ptr(), cdf_lane.shape[1], len_lane.data_ptr(),
            off_lane.data_ptr(), k, int(steps), lanes, out.data_ptr(),
            xend.data_ptr())
    return args, (out, xend)


def cyclic_decode(streams, states, cdf_lane, len_lane, off_lane,
                  steps: int):
    """Kernel 2, compacted decode: streams (k, N, W) int32, states (k, N)
    int64 -> (symbols (k, T, N) int32 with offsets added, final states
    (k, N) int64). A read past a lane's row yields 0."""
    if streams.device.type == 'cpu':
        return cyclic_decode_plain(streams, states, cdf_lane, len_lane,
                                   off_lane, steps)
    args, outs = _decode_args(streams, states, cdf_lane, len_lane,
                              off_lane, steps)
    k, lanes, width = streams.shape
    _check_fits('rans_cyclic_decode', min(width, int(steps)), True,
                streams.device)
    tables = _tables_buffer('rans_cyclic_decode', cdf_lane.shape[1], width,
                            int(steps), k, lanes, streams.device)
    _launch('rans_cyclic_decode', streams.device, tables, *args)
    return outs


def cyclic_decode_aligned(streams, states, cdf_lane, len_lane, off_lane,
                          steps: int):
    """Kernel 4, aligned decode: streams (k, N, T) int32 with step t's
    chunk at column t; outputs as `cyclic_decode`."""
    if streams.device.type == 'cpu':
        return cyclic_decode_plain(streams, states, cdf_lane, len_lane,
                                   off_lane, steps, aligned=True)
    if streams.shape[-1] != steps:
        raise ValueError(f'aligned streams must be {steps} wide, got '
                         f'{streams.shape[-1]}')
    args, outs = _decode_args(streams, states, cdf_lane, len_lane,
                              off_lane, steps)
    k, lanes, width = streams.shape
    tables = _tables_buffer('rans_cyclic_decode_aligned', cdf_lane.shape[1],
                            width, int(steps), k, lanes, streams.device)
    _launch('rans_cyclic_decode_aligned', streams.device, tables, *args)
    return outs


# ---------------------------------------------------------------------------
# General per-index kernels (csrc/rans_indexed.cu)
# ---------------------------------------------------------------------------

def _launch_indexed(name: str, device: torch.device, *args) -> None:
    fn = getattr(_indexed_library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {rc}')
    LAUNCHES[name] += 1


_smem_optin: dict = {}


def _optin(device: torch.device) -> int:
    if device not in _smem_optin:
        with torch.cuda.device(device):
            _smem_optin[device] = int(
                _indexed_library().rans_indexed_smem_optin())
    return _smem_optin[device]


def indexed_plan(name: str, steps: int, pack_words: int, device) -> str:
    """'shared' or 'global': the plan of a launch of the indexed kernel
    `name` on `device` at T = `steps` -- the batch-1 encoder's u16 output
    rows in shared memory (up to about 2,600 steps) or in a device buffer;
    a decoder's prepared tables (`pack_words`, the size of their `dec`) in
    shared memory (the aligned decoder's beside one image's staging) or
    read from device memory."""
    device = torch.device(device)
    lib = _indexed_library()
    if name == 'rans_indexed_encode':
        need = lib.rans_indexed_encode_smem(int(steps), 0)
    elif name == 'rans_indexed_decode_aligned':
        need = lib.rans_indexed_decode_aligned_smem(int(pack_words), 0, 1)
    else:
        need = lib.rans_indexed_decode_smem(int(pack_words), 0)
    return 'shared' if need <= _optin(device) else 'global'


def indexed_aligned_group(num_images: int, lanes: int, pack_words: int,
                          device) -> int:
    """Images per block that an aligned indexed decode of `num_images`
    images on `lanes` lanes, with prepared tables of `pack_words` words,
    uses on `device` (the rule in `csrc/rans_indexed.cu`,
    `aligned_group_rule`)."""
    plan = indexed_plan('rans_indexed_decode_aligned', 0, pack_words, device)
    with torch.cuda.device(device):
        return int(_indexed_library().rans_indexed_aligned_group(
            int(num_images), int(lanes), int(pack_words),
            int(plan == 'global')))


def _check_prepared(prepared: IndexedTables | None, cdf: torch.Tensor,
                    cdf_len: torch.Tensor | None = None,
                    off: torch.Tensor | None = None) -> None:
    """Raise unless `prepared` is None or the prepared tables of `cdf` (and
    of `cdf_len` and `off`, where given) on their device (every wrapper
    checks, on any device; `IndexedTables.holds`)."""
    if prepared is None:
        return
    for name, given in (('cdf', cdf), ('cdf_len', cdf_len), ('off', off)):
        if given is None:
            continue
        given = torch.as_tensor(given)
        if not prepared.holds(name, given):
            mine = getattr(prepared, name)
            raise ValueError(
                f'prepared tables of another `{name}` ({tuple(mine.shape)} '
                f'on {mine.device}) than the one given '
                f'({tuple(given.shape)} on {given.device})')


def _indexed_encode_args(cdf: torch.Tensor, vc: torch.Tensor,
                         idx: torch.Tensor):
    _require_cuda(vc)
    k, steps, lanes = vc.shape
    if k * lanes == 0 or steps == 0:
        raise ValueError(f'empty encode: vc shape {tuple(vc.shape)}')
    dev = vc.device
    _check(vc, 'vc', torch.int32, (k, steps, lanes), dev)
    _check(idx, 'idx', torch.int32, (k, steps, lanes), dev)
    _check(cdf, 'cdf', torch.int32, (cdf.shape[0], cdf.shape[1]), dev)
    streams = torch.empty((k, lanes, steps), dtype=torch.int32, device=dev)
    lengths = torch.empty((k, lanes), dtype=torch.int32, device=dev)
    states = torch.empty((k, lanes), dtype=torch.int64, device=dev)
    args = (cdf.shape[1], vc.data_ptr(), idx.data_ptr(), k, steps, lanes,
            streams.data_ptr(), lengths.data_ptr(), states.data_ptr())
    return args, (streams, lengths, states)


def indexed_encode(cdf: torch.Tensor, vc: torch.Tensor, idx: torch.Tensor,
                   prepared: IndexedTables | None = None):
    """Indexed kernel 1, compacted encode: `vc` (k, T, N) int32 in-support
    values, `idx` (k, T, N) int32 their rows of `cdf` (R, cols) int32 ->
    (streams (k, N, T) int32 compacted in decode order, lengths (k, N)
    int32, states (k, N) int64). `prepared`: `cdf`'s prepared tables
    (else their encoder entries are built for this call)."""
    _check_prepared(prepared, cdf)
    if vc.device.type == 'cpu':
        return indexed_encode_plain(cdf, vc, idx)
    args, outs = _indexed_encode_args(cdf, vc, idx)
    enc = prepared.enc if prepared is not None else encode_entries(cdf)
    k, steps, lanes = vc.shape
    rows = None
    if indexed_plan('rans_indexed_encode', steps, 0, vc.device) == 'global':
        rows = torch.empty(k * -(-lanes // 32) * 32 * (steps + 1),
                           dtype=torch.int16, device=vc.device)
    _launch_indexed('rans_indexed_encode', vc.device, enc.data_ptr(), *args,
                    rows.data_ptr() if rows is not None else None)
    return outs


def indexed_encode_aligned(cdf: torch.Tensor, vc: torch.Tensor,
                           idx: torch.Tensor, want_masks: bool = False,
                           prepared: IndexedTables | None = None):
    """Indexed kernel 3, aligned encode: as `indexed_encode`, but column t
    of streams holds step t's chunk (0 where none). Returns
    (streams, lengths, states, masks (k, N, T) bool or None). `prepared`
    as for `indexed_encode`."""
    _check_prepared(prepared, cdf)
    if vc.device.type == 'cpu':
        return indexed_encode_plain(cdf, vc, idx, aligned=True,
                                    want_masks=want_masks)
    args, (streams, lengths, states) = _indexed_encode_args(cdf, vc, idx)
    masks = torch.empty(streams.shape, dtype=torch.bool,
                        device=vc.device) if want_masks else None
    enc = prepared.enc if prepared is not None else encode_entries(cdf)
    _launch_indexed('rans_indexed_encode_aligned', vc.device, enc.data_ptr(),
                    *args, masks.data_ptr() if masks is not None else None)
    return streams, lengths, states, masks


def indexed_encode_aligned_plan(num_images: int, lanes: int,
                                device) -> tuple:
    """(steps a staged tile, images a block) that an aligned indexed
    encode of `num_images` images on `lanes` lanes uses on `device` (the
    rule in `csrc/rans_indexed.cu`, `encode_plan_rule`)."""
    lib = _indexed_library()
    with torch.cuda.device(device):
        return (int(lib.rans_indexed_encode_aligned_tile(int(num_images),
                                                         int(lanes))),
                int(lib.rans_indexed_encode_aligned_group(int(num_images),
                                                          int(lanes))))


def _indexed_decode_outputs(streams, states, cdf, cdf_len, off, idx, steps):
    _require_cuda(streams)
    k, lanes, width = streams.shape
    if k * lanes == 0 or steps <= 0:
        raise ValueError(f'empty decode: streams shape '
                         f'{tuple(streams.shape)}, steps {steps}')
    dev = streams.device
    rows = cdf.shape[0]
    _check(streams, 'streams', torch.int32, (k, lanes, width), dev)
    _check(states, 'states', torch.int64, (k, lanes), dev)
    _check(cdf, 'cdf', torch.int32, (rows, cdf.shape[1]), dev)
    _check(cdf_len, 'cdf_len', torch.int32, (rows,), dev)
    _check(off, 'off', torch.int32, (rows,), dev)
    _check(idx, 'idx', torch.int32, (k, int(steps), lanes), dev)
    out = torch.empty((k, steps, lanes), dtype=torch.int32, device=dev)
    xend = torch.empty((k, lanes), dtype=torch.int64, device=dev)
    return out, xend


def _prepared_for(prepared: IndexedTables | None, cdf, cdf_len, off):
    """`prepared` (checked by the wrapper on entry), or the tables prepared
    for one call."""
    return prepared if prepared is not None \
        else prepare_indexed_tables(cdf, cdf_len, off)


def _launch_decoder(name, streams, states, prepared, idx, steps, out, xend):
    k, lanes, width = streams.shape
    words = prepared.dec.numel()
    plan = indexed_plan(name, steps, words, streams.device)
    _launch_indexed(name, streams.device, streams.data_ptr(), width,
                    states.data_ptr(), prepared.dec.data_ptr(), words,
                    prepared.bucket_at, prepared.base_at,
                    int(plan == 'global'), idx.data_ptr(), k, int(steps),
                    lanes, out.data_ptr(), xend.data_ptr())


def indexed_decode(streams, states, cdf, cdf_len, off, idx, steps: int,
                   prepared: IndexedTables | None = None):
    """Indexed kernel 2, compacted decode: streams (k, N, W) int32, states
    (k, N) int64, `idx` (k, T, N) int32 rows of `cdf` -> (symbols (k, T, N)
    int32 with the row offsets added, final states (k, N) int64). A read
    past a lane's row yields 0. `prepared`: the prepared tables of (cdf,
    cdf_len, off) (else they are built for this call)."""
    _check_prepared(prepared, cdf, cdf_len, off)
    if streams.device.type == 'cpu':
        return indexed_decode_plain(streams, states, cdf, cdf_len, off, idx,
                                    steps)
    out, xend = _indexed_decode_outputs(streams, states, cdf, cdf_len, off,
                                        idx, steps)
    _launch_decoder('rans_indexed_decode', streams, states,
                    _prepared_for(prepared, cdf, cdf_len, off), idx, steps,
                    out, xend)
    return out, xend


def indexed_decode_aligned(streams, states, cdf, cdf_len, off, idx,
                           steps: int, prepared: IndexedTables | None = None):
    """Indexed kernel 4, aligned decode: streams (k, N, T) int32 with step
    t's chunk at column t; outputs and `prepared` as `indexed_decode`."""
    _check_prepared(prepared, cdf, cdf_len, off)
    if streams.device.type == 'cpu':
        return indexed_decode_plain(streams, states, cdf, cdf_len, off, idx,
                                    steps, aligned=True)
    if streams.shape[-1] != steps:
        raise ValueError(f'aligned streams must be {steps} wide, got '
                         f'{streams.shape[-1]}')
    out, xend = _indexed_decode_outputs(streams, states, cdf, cdf_len, off,
                                        idx, steps)
    _launch_decoder('rans_indexed_decode_aligned', streams, states,
                    _prepared_for(prepared, cdf, cdf_len, off), idx, steps,
                    out, xend)
    return out, xend


# ---------------------------------------------------------------------------
# Masked-lane kernels of the joint autoregressive codec (csrc/rans_indexed.cu)
# ---------------------------------------------------------------------------

def masked_encode_aligned(cdf: torch.Tensor, vc: torch.Tensor,
                          idx: torch.Tensor, act: torch.Tensor, m: int,
                          prepared: IndexedTables | None = None):
    """Masked encode: values `vc` (T, N) int32 and their rows `idx` (T, N)
    int32 of `cdf` (R, cols), lane j active in front t where act[t, j // m]
    ((T, F) uint8, N = F * m) -> (streams (N, T) int32 aligned, lengths
    (N,) int32, states (N,) int64). `prepared`: `cdf`'s prepared tables
    (else their encoder entries are built for this call). The kernel
    stages `act` whole in shared memory: a map beyond a block's raises."""
    _check_prepared(prepared, cdf)
    if vc.device.type == 'cpu':
        return masked_encode_plain(cdf, vc, idx, act, m)
    _require_cuda(vc)
    dev = vc.device
    steps, lanes = vc.shape
    slots = act.shape[1]
    if steps == 0 or lanes != slots * int(m):
        raise ValueError(f'masked encode: vc {tuple(vc.shape)} is not '
                         f'(T, F * m) for act {tuple(act.shape)}, m={m}')
    _check(vc, 'vc', torch.int32, (steps, lanes), dev)
    _check(idx, 'idx', torch.int32, (steps, lanes), dev)
    _check(act, 'act', torch.uint8, (steps, slots), dev)
    _check(cdf, 'cdf', torch.int32, tuple(cdf.shape), dev)
    with torch.cuda.device(dev):
        need = _indexed_library().rans_masked_encode_aligned_smem(
            steps, slots, lanes)
    if need > _optin(dev):
        raise ValueError(f'masked encode: an activity map of {steps} x '
                         f'{slots} needs {need} bytes of shared memory, a '
                         f'block has {_optin(dev)}')
    enc = prepared.enc if prepared is not None else encode_entries(cdf)
    streams = torch.empty((lanes, steps), dtype=torch.int32, device=dev)
    lengths = torch.empty((lanes,), dtype=torch.int32, device=dev)
    states = torch.empty((lanes,), dtype=torch.int64, device=dev)
    _launch_indexed('rans_masked_encode_aligned', dev, enc.data_ptr(),
                    cdf.shape[1], vc.data_ptr(), idx.data_ptr(),
                    act.data_ptr(), steps, lanes, slots, int(m),
                    streams.data_ptr(), lengths.data_ptr(),
                    states.data_ptr())
    return streams, lengths, states


def masked_decode_front(streams: torch.Tensor, t: int, states: torch.Tensor,
                        cdf: torch.Tensor, cdf_len: torch.Tensor,
                        off: torch.Tensor, idx: torch.Tensor,
                        act: torch.Tensor, m: int,
                        prepared: IndexedTables | None = None):
    """One masked decode step, front t: aligned `streams` (N, T) int32,
    `states` (N,) int64, rows `idx` (N,) int32, `act` (F,) uint8 ->
    (symbols (N,) int32 with the row offset added, 0 on inactive lanes;
    states (N,) int64). `prepared`: the prepared tables of (cdf, cdf_len,
    off), built once for all fronts (else they are built for this
    call)."""
    _check_prepared(prepared, cdf, cdf_len, off)
    if streams.device.type == 'cpu':
        return masked_decode_front_plain(streams, t, states, cdf, cdf_len,
                                         off, idx, act, m)
    _require_cuda(streams)
    dev = streams.device
    lanes, steps = streams.shape
    if not 0 <= int(t) < steps or lanes != act.shape[0] * int(m):
        raise ValueError(f'masked decode: front {t} of {steps}, streams '
                         f'{tuple(streams.shape)}, act {tuple(act.shape)}, '
                         f'm={m}')
    _check(streams, 'streams', torch.int32, (lanes, steps), dev)
    _check(states, 'states', torch.int64, (lanes,), dev)
    _check(idx, 'idx', torch.int32, (lanes,), dev)
    _check(act, 'act', torch.uint8, (act.shape[0],), dev)
    _check(cdf, 'cdf', torch.int32, tuple(cdf.shape), dev)
    _check(cdf_len, 'cdf_len', torch.int32, (cdf.shape[0],), dev)
    _check(off, 'off', torch.int32, (cdf.shape[0],), dev)
    prepared = _prepared_for(prepared, cdf, cdf_len, off)
    out = torch.empty((lanes,), dtype=torch.int32, device=dev)
    x_out = torch.empty((lanes,), dtype=torch.int64, device=dev)
    _launch_indexed('rans_masked_decode_front', dev, streams.data_ptr(),
                    steps, int(t), states.data_ptr(),
                    prepared.dec.data_ptr(), prepared.bucket_at,
                    prepared.base_at, idx.data_ptr(), act.data_ptr(), lanes,
                    int(m), out.data_ptr(), x_out.data_ptr())
    return out, x_out


def launch_floor(lanes: int, device) -> None:
    """Launch an empty kernel on the grid of a masked front of `lanes`
    lanes: a measurement aid for the floor of that launch's device time
    (not a coder, not counted in `LAUNCHES`)."""
    device = torch.device(device)
    lib = _indexed_library()
    with torch.cuda.device(device):
        rc = lib.rans_launch_floor(
            int(lanes), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'rans_launch_floor launch failed: CUDA error '
                           f'{rc}')
